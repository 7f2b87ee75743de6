"""Byte and operation models of the three kernels, and the H100's rates.

Each model returns ``(bytes, operations)`` for one call: the bytes the
function must move (each input read where an output depends on it, each
output written once) and the arithmetic it does, from the call's shapes
and its data-dependent counts (live slots, violating slots, live
centers), which the caller passes.  ``chip_smoke.py`` passes the counts
of the inputs it measured (its bound column); the autotuner's cost
counter (:mod:`repro_torch.launch.cost`) passes the counts by shape,
every slot live and in V, as an HLO cost reading counts shapes.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "F64_OPS_PER_S",
           "BF16_OPS_PER_S",
           "lss_state_cost", "correction_cost", "correction_cost_v",
           "region_decide_cost", "global_cost", "bound_ms"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense


def lss_state_cost(n, D, d, k, live):
    """The fused status/violation function on ``n`` rows (the peers of
    every slot of a batched call) of ``D`` slots, ``d``-vectors, ``k``
    centers a family and ``live`` live slots."""
    nbytes = (4 * n * (d + 1)  # x_m, x_c
              + n * D  # mask
              + 4 * live * 2 * (d + 1)  # out and in moments, weights
              + 4 * n * (d + 1) + n * D + 4 * n)  # s_m, s_c, viol, dec
    decide = 2 * k * (d + 1)  # dot, scale and norm per candidate
    ops = (n * (d + 1 + d + decide)  # S, vec(S), f(S)
           + live * (4 * (d + 1) + 2 * d + 2 * decide))  # A, S-A, vecs, fs
    return nbytes, ops


def correction_cost(n, D, d, nv):
    """The Eq.-10 correction on ``n`` rows with ``nv`` violating slots.

    The function returns a corrected message for every slot, so every
    slot's ``in`` and ``a_c`` is read and every slot of ``out'`` written,
    under the rule :func:`lss_state_cost` follows too."""
    nbytes = (4 * n * (d + 1)  # s_m, s_c
              + 4 * n * D  # a_c
              + 4 * nv * d  # a_m on the violating set
              + 4 * n * D * (d + 1)  # in_m, in_c
              + n * D  # v_set
              + 4 * n * D * (d + 1))  # out_m', out_c'
    ops = nv * (d + 1) + n * (d + 5) + n * D * (2 + 2 * (d + 1))
    return nbytes, ops


def correction_cost_v(n, D, d, nv):
    """The part of the correction the main path keeps: ``lss.py`` blends
    ``out'`` in on the violating set V only, so this reads S, ``v_set``,
    and ``a`` and ``in`` on V, and writes V."""
    nbytes = (4 * n * (d + 1)  # s_m, s_c
              + n * D  # v_set
              + 4 * nv * 2 * (d + 1)  # a and in on V
              + 4 * nv * (d + 1))  # out_m', out_c' on V
    ops = nv * (d + 1) + n * (d + 5) + nv * (2 + 2 * (d + 1))
    return nbytes, ops


def region_decide_cost(q, m, d, k, voronoi_centers, others):
    """The packed decision of ``m`` vectors in each of ``q`` slots whose
    tables hold ``k`` centers: each vector read, each id written, each
    slot's table read once; per vector d products, d - 1 sums, a scale,
    an add and a compare for each of the ``voronoi_centers`` live centers
    of the Voronoi slots, and d products, d - 1 sums and a compare for
    each of the ``others`` slots (a halfspace test)."""
    nbytes = 4 * q * m * d + 4 * q * m + 4 * q * (d * (k + 1) + k + 4)
    return nbytes, m * (voronoi_centers * (2 * d + 2) + others * 2 * d)


def global_cost(q, n, d, k):
    """(bytes, float64 adds) of the global decision: x_m, x_c and alive
    read once, each slot's table and eps read, want and gx written; d + 1
    adds a peer."""
    nbytes = (q * n * (4 * d + 5) + 4 * q * (d * (k + 1) + k + 4 + 1)
              + 4 * q * (d + 2))
    return nbytes, q * n * (d + 1)


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time on the card: ``(ms, "bytes" | "operations")``, the
    larger of the bytes over the memory rate and the operations over
    ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
