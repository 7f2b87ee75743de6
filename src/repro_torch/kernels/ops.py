"""Public wrappers of the kernels (port of ``repro/kernels/ops.py``).

``lss_state`` and ``correction`` keep the JAX wrappers' signatures and
returns.  Where the tensors lie decides what runs: a CPU tensor takes the
plain PyTorch version (:mod:`.ref`), a CUDA tensor launches the CUDA kernel
(:mod:`.lss_state`, :mod:`.correction`) or the call raises.  Nothing falls
back from the kernel to the plain version.

Inputs are normalized as the JAX wrappers normalize them (float32 moments,
bool masks, contiguous), but not padded: the TPU's block and lane padding
has no use on the card.  Region families arrive as a
:class:`~repro_torch.core.regions.PackedSlot` (or anything
:func:`~repro_torch.core.regions.as_packed_slot` coerces) and are prepared
into the kernel table by :func:`prep_slot`.
"""

from __future__ import annotations

import torch

from ..core import regions as _regions
from . import correction as _corr
from . import lss_state as _state
from . import ref

__all__ = ["lss_state", "correction", "prep_slot"]


def prep_slot(region, eps=1e-9, beta=0.0):
    """Kernel table layout of one packed family: ``(cthw, cn, meta)``.

    ``cthw`` (d, k+1) float32 is ``[centers^T | w]``; ``cn`` (k,) holds the
    center norms with ``+inf`` on masked padding slots (so a padded family
    decides like the unpadded one); ``meta`` (4,) is ``[kind, b, eps,
    beta]``.  All on the slot's device.
    """
    slot = _regions.as_packed_slot(region)
    f32 = torch.float32
    centers = slot.centers.to(f32)
    cthw = torch.cat([centers.T, slot.w.to(f32)[:, None]], dim=1).contiguous()
    cn = torch.where(slot.cmask, torch.sum(centers * centers, dim=-1),
                     torch.inf)
    meta = torch.stack([
        slot.kind.to(f32), slot.b.to(f32),
        torch.full((), eps, dtype=f32, device=centers.device),
        torch.full((), beta, dtype=f32, device=centers.device)])
    return cthw, cn, meta


def _f32(t):
    return t.to(torch.float32).contiguous()


def _mask(t):
    return t.to(torch.bool).contiguous()


def lss_state(x_m, x_c, out_m, out_c, in_m, in_c, mask, region, eps=1e-9):
    """Fused S/A/violations/decision.  Unpadded moment-form inputs.

    Returns (s_m (n,d), s_c (n,), viol bool (n,D), decision (n,) int32).
    """
    args = (_f32(x_m), _f32(x_c), _f32(out_m), _f32(out_c), _f32(in_m),
            _f32(in_c), _mask(mask))
    if out_m.device.type == "cpu":
        return ref.lss_state_ref(*args, region, eps)
    return _state.launch(*args, *prep_slot(region, eps=eps), eps)


def correction(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta=1e-3, eps=1e-9):
    """Eq.-10 corrected messages: returns (out_m' (n,D,d), out_c' (n,D))."""
    args = (_f32(s_m), _f32(s_c), _f32(a_m), _f32(a_c), _f32(in_m),
            _f32(in_c), _mask(v_set))
    if a_m.device.type == "cpu":
        return ref.correction_ref(*args, beta, eps)
    return _corr.launch(*args, beta, eps)
