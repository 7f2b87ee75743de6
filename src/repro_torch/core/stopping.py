"""The paper's local stopping rule (Def. 4) and quiescence predicates.

Port of ``repro/core/stopping.py``.  Def. 4: peer ``p_i`` can stop sending
in the context of a convex region ``R`` iff for every neighbor ``p_j``:

  * ``|A_ij| = 0``        or  ``vec(A_ij) in R``, and
  * ``|S_i - A_ij| = 0``  or  ``vec(S_i - A_ij) in R``,

with ``A_ij = X_ij (+) X_ji`` and ``S_i = X_ii (+) (+)_j (X_ji (-) X_ij)``.

All functions are batched over peers and slots and work in moment form;
they also take a leading query-slot axis (``(Q, n, D)`` arrays, ``decide``
batched over it, ``eps`` one value or one per slot).
"""

from __future__ import annotations

import torch

from . import wvs

__all__ = ["agreements", "status", "def4_satisfied", "violations_alg1",
           "slot_sum"]


def slot_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``x`` over ``dim`` in index order, one rounded add at a time.

    The kernels sum a peer's slots in this order; a library reduction may
    pair the terms otherwise and round differently in the last bit, which
    flips a decision at a near tie.  The plain versions sum this way so
    they stay bitwise equal to the kernels.
    """
    parts = x.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def agreements(out_m, out_c, in_m, in_c) -> wvs.WV:
    """A_ij = X_ij (+) X_ji for every slot: (n, D, d) moments."""
    return wvs.WV(out_m + in_m, out_c + in_c)


def status(x_m, x_c, out_m, out_c, in_m, in_c, mask) -> wvs.WV:
    """S_i = X_ii (+) (+)_j (X_ji (-) X_ij), masked over valid slots."""
    s_m = x_m + slot_sum(torch.where(mask[..., None], in_m - out_m, 0.0),
                         dim=-2)
    s_c = x_c + slot_sum(torch.where(mask, in_c - out_c, 0.0), dim=-1)
    return wvs.WV(s_m, s_c)


def _s_minus_a(s: wvs.WV, a: wvs.WV) -> wvs.WV:
    return wvs.WV(s.m[..., None, :] - a.m, s.c[..., None] - a.c)


def def4_satisfied(decide, s: wvs.WV, a: wvs.WV, mask, eps: float = 1e-9):
    """Def. 4 per peer: True where the peer may stop sending.

    ``decide`` maps vectors (..., d) -> region ids; the rule is evaluated in
    the context of R = region of vec(S_i).  Returns bool (n,).
    """
    region = decide(wvs.vec(s, eps))  # (n,)
    sa = _s_minus_a(s, a)
    a_zero = torch.abs(a.c) <= wvs.lead(eps, a.c)
    sa_zero = torch.abs(sa.c) <= wvs.lead(eps, sa.c)
    a_ok = a_zero | (decide(wvs.vec(a, eps)) == region[..., None])
    sa_ok = sa_zero | (decide(wvs.vec(sa, eps)) == region[..., None])
    slot_ok = (~mask) | (a_ok & sa_ok)
    return torch.all(slot_ok, dim=-1)


def violations_alg1(decide, s: wvs.WV, a: wvs.WV, mask, eps: float = 1e-9):
    """Alg. 1's violating set V_i, per slot (bool (n, D)).

    A slot violates iff ``f(vec(A_ij)) != f(vec(S_i))`` or
    ``f(vec(S_i - A_ij)) != f(vec(S_i))`` (weight-guarded), **or** the
    agreement still has zero weight — the clause that bootstraps
    communication from the all-zero initial state.
    """
    region = decide(wvs.vec(s, eps))  # (n,)
    sa = _s_minus_a(s, a)
    a_zero = torch.abs(a.c) <= wvs.lead(eps, a.c)
    sa_zero = torch.abs(sa.c) <= wvs.lead(eps, sa.c)
    a_bad = ~a_zero & (decide(wvs.vec(a, eps)) != region[..., None])
    sa_bad = ~sa_zero & (decide(wvs.vec(sa, eps)) != region[..., None])
    return (a_zero | a_bad | sa_bad) & mask
