"""Byte and operation models of the monitor's device work, and the H100's
published peaks.

A frozen copy of the program's ``kernels/cost.py`` arithmetic, counted for
what the main path needs from these inputs whatever kernel does it:

* ``lss_state``: each row's inputs and outputs once, and the out and in
  moments of the live slots only;
* ``correction``: the corrected messages of the violating set V only (the
  cycle keeps those and no others), reading S, the set, and ``a`` and
  ``in`` on V;
* the deliver: the pending flags and the tables once, and for each message
  sent its out moment read and its in moment written;
* the observe's global decision: every tenant's inputs and alive flags
  once, ``d + 1`` float64 adds a peer.

Every function returns ``(bytes, operations)`` summed over ``calls``
launches whose data-dependent counts (live slots, violating slots, sent
messages) are totals over those launches.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
POWER_W = 700.0  # the power limit the published rates assume


def lss_state_cost(rows, D, d, k, live, calls=1):
    """Status, agreements, violations and decisions on ``rows`` peer rows
    (all tenants) a call, with ``live`` live slots over the calls."""
    per_row = (4 * (d + 1) + D + 4 * (d + 1) + D + 4)  # x; mask; s, viol, f
    decide = 2 * k * (d + 1)
    nbytes = calls * rows * per_row + live * 4 * 2 * (d + 1)
    ops = (calls * rows * (d + 1 + d + decide)
           + live * (4 * (d + 1) + 2 * d + 2 * decide))
    return nbytes, ops


def correction_cost_v(rows, D, d, nv, calls=1):
    """The Eq.-10 correction on the violating set: ``nv`` slots over the
    calls."""
    nbytes = calls * rows * (4 * (d + 1) + D) + nv * 12 * (d + 1)
    ops = calls * rows * (d + 5) + nv * ((d + 1) + 2 + 2 * (d + 1))
    return nbytes, ops


def deliver_cost(rows, D, n, d, sent, calls=1):
    """A cycle's delivery: the pending flags read and cleared, the alive
    flags and the (n, D) tables read once, and for each sent message its
    out moment read and its in moment written."""
    nbytes = calls * (2 * rows * D + rows + 9 * n * D) + sent * 8 * (d + 1)
    return nbytes, 0


def global_cost(q, n, d, k, calls=1):
    """The observe's global decision of ``q`` tenants over ``n`` rows."""
    nbytes = calls * (q * n * (4 * d + 5) + 4 * q * (d * (k + 1) + k + 4 + 1)
                      + 4 * q * (d + 2))
    return nbytes, calls * q * n * (d + 1)


def bound_s(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time on the card: the larger of the bytes over the
    memory rate and the operations over ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
