"""Public wrappers of the kernels (port of ``repro/kernels/ops.py``).

``region_decide``, ``lss_state`` and ``correction`` keep the JAX wrappers'
signatures and returns; ``global_decision`` is the observe pass's ground truth,
which the JAX package computes with jnp ops and one decision.  Where the
tensors lie decides what runs: a CPU tensor takes the plain PyTorch version
(:mod:`.ref`), a CUDA tensor launches the CUDA kernel (:mod:`.region_decide`,
:mod:`.lss_state`, :mod:`.correction`) or the call raises.  Nothing falls back
from the kernel to the plain version.

Every wrapper also takes a leading query-slot axis Q, which the JAX
package got from ``vmap`` over its wrappers: moment arrays ``(Q, n, ...)``,
the Q families as a :class:`~repro_torch.core.regions.PackedRegions` (or
the :class:`SlotTables` that :func:`prep_slots` built from one), and
``beta``/``eps`` one number or a (Q,) tensor.  All Q slots go through one
kernel launch; the unbatched call launches the same kernel with Q = 1.
A caller that calls the kernels many times with one family prepares its
tables once with :func:`prep_slots`, batched or not.

Inputs are normalized as the JAX wrappers normalize them (float32 moments,
bool masks, contiguous), but not padded: the TPU's block and lane padding
has no use on the card.  A single family arrives as a
:class:`~repro_torch.core.regions.PackedSlot` (or anything
:func:`~repro_torch.core.regions.as_packed_slot` coerces).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import regions as _regions
from . import correction as _corr
from . import lss_state as _state
from . import ref
from . import region_decide as _dec

__all__ = ["region_decide", "lss_state", "correction", "global_decision",
           "prep_slot", "prep_slots", "SlotTables", "packed", "is_batched"]


class SlotTables(NamedTuple):
    """Q packed families with their kernel tables, prepared once.

    ``cthw`` (Q, d, k+1) float32 is ``[centers^T | w]`` per slot; ``cn``
    (Q, k) the center norms with ``+inf`` on masked padding centers (so a
    padded family decides like the unpadded one and an all-masked padding
    slot decides 0); ``meta`` (Q, 4) is ``[kind, b, eps, beta]``.  The
    ``lss_state`` kernel reads ``eps`` from ``meta``; a caller passing
    tables and an ``eps`` passes the same values.  ``regions`` is a
    :class:`~repro_torch.core.regions.PackedRegions`, or for the tables of
    one family a :class:`~repro_torch.core.regions.PackedSlot` (the arrays
    then have Q = 1, and the wrappers treat the call as unbatched).
    """

    regions: object
    cthw: torch.Tensor
    cn: torch.Tensor
    meta: torch.Tensor


def _per_slot(x, q: int, device) -> torch.Tensor:
    """A knob as a contiguous float32 (q,) tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).expand(q).contiguous()
    return torch.full((q,), float(x), dtype=torch.float32, device=device)


def prep_slots(region, eps=1e-9, beta=0.0) -> SlotTables:
    """Kernel tables of Q packed families (a ``PackedRegions``), or of one
    family (a ``PackedSlot`` or anything
    :func:`~repro_torch.core.regions.as_packed_slot` coerces); see
    :class:`SlotTables`.

    ``eps``/``beta`` are numbers or (Q,) tensors; everything lands on the
    families' device.
    """
    if isinstance(region, _regions.PackedRegions):
        fams = region
    else:  # one family: Q = 1
        region = _regions.as_packed_slot(region)
        fams = _regions.PackedRegions(*(f[None] for f in region))
    f32 = torch.float32
    centers = fams.centers.to(f32)
    cthw = torch.cat([centers.transpose(1, 2), fams.w.to(f32)[:, :, None]],
                     dim=2).contiguous()
    cn = torch.where(fams.cmask, _regions.dot(centers, centers), torch.inf)
    dev, q = centers.device, fams.q
    meta = torch.stack([fams.kind.to(f32), fams.b.to(f32),
                        _per_slot(eps, q, dev), _per_slot(beta, q, dev)],
                       dim=-1)
    return SlotTables(region, cthw, cn, meta)


def prep_slot(region, eps=1e-9, beta=0.0):
    """Kernel table layout of one packed family: ``(cthw, cn, meta)``.

    ``cthw`` (d, k+1), ``cn`` (k,), ``meta`` (4,): :func:`prep_slots` of a
    single slot, without its slot axis.
    """
    tables = prep_slots(region, eps, beta)
    return tables.cthw[0], tables.cn[0], tables.meta[0]


def is_batched(region) -> bool:
    """True for Q families (a ``PackedRegions`` or its ``SlotTables``)."""
    return isinstance(packed(region), _regions.PackedRegions)


def packed(region):
    """The packed families behind ``region`` (``SlotTables`` unwrapped)."""
    return region.regions if isinstance(region, SlotTables) else region


def _tables(region, eps=1e-9) -> SlotTables:
    return region if isinstance(region, SlotTables) else \
        prep_slots(region, eps)


def _f32(t):
    return t.to(torch.float32).contiguous()


def _mask(t):
    return t.to(torch.bool).contiguous()


def region_decide(v, region):
    """Packed-family region ids, kernel-accelerated.

    ``v`` (n, d) with one family -> (n,) int32, or ``v`` (Q, n, d) with Q
    families -> (Q, n) int32.
    """
    v = _f32(v)
    if v.device.type == "cpu":
        return ref.region_decide_ref(v, packed(region))
    tables = _tables(region)
    if is_batched(region):
        return _dec.launch(v, tables.cthw, tables.cn, tables.meta)
    return _dec.launch(v[None], tables.cthw, tables.cn, tables.meta)[0]


def lss_state(x_m, x_c, out_m, out_c, in_m, in_c, mask, region, eps=1e-9):
    """Fused S/A/violations/decision.  Unpadded moment-form inputs.

    Returns (s_m (n,d), s_c (n,), viol bool (n,D), decision (n,) int32),
    each with a leading Q axis when the inputs have one.
    """
    args = (_f32(x_m), _f32(x_c), _f32(out_m), _f32(out_c), _f32(in_m),
            _f32(in_c), _mask(mask))
    if out_m.device.type == "cpu":
        return ref.lss_state_ref(*args, packed(region), eps)
    tables = _tables(region, eps)
    if out_m.ndim == 4:
        return _state.launch(*args, tables.cthw, tables.cn, tables.meta)
    out = _state.launch(*(a[None] for a in args), tables.cthw, tables.cn,
                        tables.meta)
    return tuple(o[0] for o in out)


def correction(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta=1e-3, eps=1e-9):
    """Eq.-10 corrected messages: returns (out_m' (n,D,d), out_c' (n,D)),
    each with a leading Q axis when the inputs have one."""
    args = (_f32(s_m), _f32(s_c), _f32(a_m), _f32(a_c), _f32(in_m),
            _f32(in_c), _mask(v_set))
    if a_m.device.type == "cpu":
        return ref.correction_ref(*args, beta, eps)
    batched = a_m.ndim == 4
    q = a_m.shape[0] if batched else 1
    knobs = (_per_slot(beta, q, a_m.device), _per_slot(eps, q, a_m.device))
    if batched:
        return _corr.launch(*args, *knobs)
    o_m, o_c = _corr.launch(*(a[None] for a in args), *knobs)
    return o_m[0], o_c[0]


def global_decision(x_m, x_c, alive, region, eps=1e-9):
    """The observe pass's ground truth ``f(vec((+)_alive X))``.

    ``x_m`` (n, d), ``x_c`` (n,) and ``alive`` (n,) with one family, or
    with a leading slot axis Q with Q families and ``eps`` one number or
    one per slot.  The sum over live peers is taken in float64 and rounded
    to float32 once.  Returns ``(want, gx_m, gx_c)``: the decision (int32)
    and the rounded sums, each per slot when the inputs have a slot axis.
    """
    x_m, x_c, alive = _f32(x_m), _f32(x_c), _mask(alive)
    if x_m.device.type == "cpu":
        return ref.global_decision_ref(x_m, x_c, alive, packed(region), eps)
    tables = _tables(region, eps)
    batched = x_m.ndim == 3
    q = x_m.shape[0] if batched else 1
    knob = _per_slot(eps, q, x_m.device) if isinstance(eps, torch.Tensor) \
        else eps
    if batched:
        return _dec.launch_global(x_m, x_c, alive, tables.cthw, tables.cn,
                                  tables.meta, knob)
    out = _dec.launch_global(x_m[None], x_c[None], alive[None], tables.cthw,
                             tables.cn, tables.meta, knob)
    return tuple(o[0] for o in out)
