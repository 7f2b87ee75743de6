"""Query model: user-facing specs and the padded device-side slot arrays.

Port of ``repro/service/query.py``.  A :class:`QuerySpec` is what a tenant
submits: a concrete region family
(:class:`~repro_torch.core.regions.VoronoiRegions` or
:class:`~repro_torch.core.regions.HalfspaceRegions`), the peers' initial
local inputs for this query's statistic, and optional per-query LSS knob
overrides (``beta``/``ell``/``eps`` — the knobs
:func:`repro_torch.core.lss.cycle_impl` takes per slot).

:class:`QueryParams` is the device-side form: every field is a fixed-shape
tensor over Q slots (region families padded via
:class:`~repro_torch.core.regions.PackedRegions`), so the whole batch
advances through one batched pass, and individual slots are rewritten
between dispatches without changing any shape.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import lss, regions, wvs
from .controlplane.slo import SLOSpec

__all__ = ["QuerySpec", "QueryParams", "decide_fn"]


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One tenant's monitoring query.

    ``region``: the convex region family whose containing-region index of
    the global average the tenant wants every peer to learn.
    ``inputs``: per-peer local data vectors, shape (n, d) (vector
    coordinates; weights default to 1 per peer, the paper's setup).
    ``beta``/``ell``/``eps``: optional per-query overrides of the service
    defaults.  ``seed`` seeds this query's message-loss stream.
    ``priority``: scheduling class under slot contention (higher wins;
    see :mod:`repro_torch.service.controlplane.scheduler`).  ``slo``:
    optional quality target the control plane tracks
    (:class:`~repro_torch.service.controlplane.slo.SLOSpec`).  Both are
    inert under the default FIFO control plane.
    """

    region: object  # VoronoiRegions | HalfspaceRegions
    inputs: np.ndarray  # (n, d) local vectors
    weights: Optional[np.ndarray] = None  # (n,), default ones
    beta: Optional[float] = None
    ell: Optional[int] = None
    eps: Optional[float] = None
    seed: int = 0
    priority: int = 0
    slo: Optional[SLOSpec] = None

    def input_wv(self, device=None) -> wvs.WV:
        f32 = torch.float32
        v = torch.as_tensor(np.asarray(self.inputs), dtype=f32, device=device)
        c = (torch.ones((v.shape[0],), dtype=f32, device=device)
             if self.weights is None
             else torch.as_tensor(np.asarray(self.weights), dtype=f32,
                                  device=device))
        return wvs.from_vector(v, c)


def _set_row(arr: torch.Tensor, slot: int, value) -> torch.Tensor:
    out = arr.clone()
    out[slot] = value
    return out


class QueryParams(NamedTuple):
    """Per-slot execution parameters, padded to Q fixed slots."""

    regions: regions.PackedRegions  # (Q, ...) tensors
    beta: torch.Tensor  # f32 (Q,)
    ell: torch.Tensor  # i32 (Q,)
    eps: torch.Tensor  # f32 (Q,)
    active: torch.Tensor  # bool (Q,) — False = masked no-op padding slot

    @classmethod
    def empty(cls, q: int, k_max: int, d: int, defaults: lss.LSSConfig,
              device=None) -> "QueryParams":
        return cls(
            regions=regions.PackedRegions.empty(q, k_max, d, device=device),
            beta=torch.full((q,), defaults.beta, dtype=torch.float32,
                            device=device),
            ell=torch.full((q,), defaults.ell, dtype=torch.int32,
                           device=device),
            eps=torch.full((q,), defaults.eps, dtype=torch.float32,
                           device=device),
            active=torch.zeros((q,), dtype=torch.bool, device=device),
        )

    def set_slot(self, slot: int, spec: QuerySpec,
                 defaults: lss.LSSConfig) -> "QueryParams":
        """Admit ``spec`` into ``slot`` (host-side, between dispatches)."""
        pick = lambda v, dv: dv if v is None else v  # noqa: E731
        return QueryParams(
            regions=self.regions.set(slot, spec.region),
            beta=_set_row(self.beta, slot, pick(spec.beta, defaults.beta)),
            ell=_set_row(self.ell, slot, pick(spec.ell, defaults.ell)),
            eps=_set_row(self.eps, slot, pick(spec.eps, defaults.eps)),
            active=_set_row(self.active, slot, True),
        )

    def clear_slot(self, slot: int,
                   defaults: lss.LSSConfig) -> "QueryParams":
        """Retire ``slot`` back to a masked padding query."""
        return QueryParams(
            regions=self.regions.clear(slot),
            beta=_set_row(self.beta, slot, defaults.beta),
            ell=_set_row(self.ell, slot, defaults.ell),
            eps=_set_row(self.eps, slot, defaults.eps),
            active=_set_row(self.active, slot, False),
        )


def decide_fn(pr: regions.PackedRegions):
    """Decision closure of the packed families: for Q slots' families,
    ``v`` (Q, ..., d) -> (Q, ...); for one slot's, ``v`` (..., d)."""
    return lambda v: regions.decide_packed(v, *pr)
