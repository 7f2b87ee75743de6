"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

They restate the kernels' math on the core formulas (:mod:`..core.stopping`,
:mod:`..core.correction`, :func:`..core.regions.decide_packed`), take
unpadded moment-form tensors and return what the kernels return (the
observe pass's global decision is the second entry of ``region_decide``),
with or without a leading query-slot axis (then the families are a
:class:`~repro_torch.core.regions.PackedRegions` and ``beta``/``eps`` one
number or one per slot).  A CPU tensor in :mod:`.ops` runs these;
``chip_smoke.py`` holds each CUDA kernel against them on the card.

``calls`` counts the calls of each plain version, so a run can show that
the main path on the card never took them (``global_decision_ref`` counts
as the ``region_decide_ref`` call it makes).
"""

from __future__ import annotations

from ..core import correction as corr_lib
from ..core import regions, stopping, wvs

__all__ = ["region_decide_ref", "lss_state_ref", "correction_ref",
           "global_decision_ref", "calls", "reset_calls"]

calls = {"region_decide_ref": 0, "lss_state_ref": 0, "correction_ref": 0}


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def _decide(region):
    """Decision fn of Q packed families, or of one packed slot / family /
    bare Voronoi centers."""
    if isinstance(region, regions.PackedRegions):
        return region.decide
    slot = regions.as_packed_slot(region)
    return lambda u: regions.decide_packed(u, *slot)


def region_decide_ref(v, region):
    """v: (n, d) with one family, or (Q, n, d) with Q families -> int32."""
    calls["region_decide_ref"] += 1
    return _decide(region)(v)


def lss_state_ref(x_m, x_c, out_m, out_c, in_m, in_c, mask, region,
                  eps=1e-9):
    """Fused S / A / Alg.-1 violations / decision.

    Returns (s_m (n,d), s_c (n,), viol (n,D) bool, decision (n,) int32).
    """
    calls["lss_state_ref"] += 1
    s = stopping.status(x_m, x_c, out_m, out_c, in_m, in_c, mask)
    a = stopping.agreements(out_m, out_c, in_m, in_c)
    decide = _decide(region)
    viol = stopping.violations_alg1(decide, s, a, mask, eps)
    decision = decide(wvs.vec(s, eps))
    return s.m, s.c, viol, decision


def correction_ref(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta, eps=1e-9):
    """Eq.-10 corrected out-messages on the violating set.

    Returns (out_m' (n,D,d), out_c' (n,D)) — meaningful on v_set slots.
    """
    calls["correction_ref"] += 1
    return corr_lib.corrected_messages(wvs.WV(s_m, s_c), wvs.WV(a_m, a_c),
                                       in_m, in_c, v_set, beta, eps)


def global_decision_ref(x_m, x_c, alive, region, eps=1e-9):
    """The observe pass's ground truth ``f(vec((+)_alive X))``.

    ``x_m`` (n, d), ``x_c`` (n,), ``alive`` (n,) with one family, or with a
    leading slot axis Q with Q families and ``eps`` one number or one per
    slot.  Returns ``(want, gx_m, gx_c)``: the decision (int32) and the
    global sums (:func:`..core.wvs.live_sum`, float64 rounded once).
    """
    gx = wvs.live_sum(wvs.WV(x_m, x_c), alive)
    want = region_decide_ref(wvs.vec(gx, eps)[..., None, :], region)[..., 0]
    return want, gx.m, gx.c
