"""Balance correction (Sec. IV): Thm. 8 and the weight-distribution schemes.

Port of ``repro/core/correction.py``.  When the stopping rule fails at
``p_i`` the peer computes new outgoing messages so that all its
agreements equal its new status (Eq. 1):

    A'_ij = (|A'_ij| / |T_i|) (.) T_i,
    T_i   = S_i (+) (+)_{k in V_i} A_ik                    (selective, Eq. 8)
    |A'_ij| = |A_ij| + (|S_i| - beta) / (2 |V_i|)           (Eq. 10)

and the message realizing a chosen agreement is ``X'_ij = A'_ij (-) X_ji``.
These formulas are the plain version of the ``correction`` kernel
(:mod:`repro_torch.kernels.ref`).  They take a leading query-slot axis too,
with ``beta`` and ``eps`` one value or one per slot.
"""

from __future__ import annotations

import torch

from . import stopping, wvs

__all__ = ["selective_target", "new_agreement_weights", "corrected_messages"]


def _safe(c, eps):
    return torch.where(torch.abs(c) > wvs.lead(eps, c), c, 1.0)


def selective_target(s: wvs.WV, a: wvs.WV, v_set, eps: float = 1e-9) -> wvs.WV:
    """T_i = S_i (+) (+)_{k in V_i} A_ik  (Eq. 8's normalization target).

    ``s``: (n, d)-moment WV;  ``a``: (n, D, d)-moment WV;  ``v_set``: bool
    (n, D).
    """
    t_m = s.m + stopping.slot_sum(torch.where(v_set[..., None], a.m, 0.0),
                                  dim=-2)
    t_c = s.c + stopping.slot_sum(torch.where(v_set, a.c, 0.0), dim=-1)
    return wvs.WV(t_m, t_c)


def new_agreement_weights(s_c, a_c, v_set, beta: float):
    """|A'_ij| = |A_ij| + (|S_i| - beta) / (2 |V_i|) on the violating set."""
    nv = torch.clamp(torch.sum(v_set, dim=-1), min=1)  # |V_i|, guard empty
    inc = (s_c - wvs.lead(beta, s_c)) / (2.0 * nv.to(s_c.dtype))
    return a_c + inc[..., None]


def corrected_messages(s: wvs.WV, a: wvs.WV, in_m, in_c, v_set, beta: float,
                       eps: float = 1e-9):
    """One Alg.-1 correction: new out-messages on ``v_set`` slots.

    Returns ``(out_m', out_c')`` for every slot; only the ``v_set`` slots
    are meaningful (callers blend with the previous messages).  Implements

        X'_ij = ( ((|S|-beta)/(2|V|) + |A_ij|) / |T| ) (.) T  (-)  X_ji.
    """
    t = selective_target(s, a, v_set, eps)
    w_new = new_agreement_weights(s.c, a.c, v_set, beta)  # (n, D)
    scale = w_new / _safe(t.c, eps)[..., None]
    new_a_m = scale[..., None] * t.m[..., None, :]
    new_a_c = scale * t.c[..., None]
    return new_a_m - in_m, new_a_c - in_c
