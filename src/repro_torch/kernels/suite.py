"""KernelSuite — the registry the hot loop plugs into (port of
``repro/kernels/suite.py``).

A :class:`KernelSuite` bundles the operations Alg. 1's per-cycle hot path needs
— ``decide``, ``status_viol`` and ``corrected`` — with region families in the
packed :class:`~repro_torch.core.regions.PackedSlot` form (or its prepared
:class:`~repro_torch.kernels.ops.SlotTables`) and ``beta``/``eps`` as runtime
values, and the observe pass's ``global_decision``, whose default is its plain
version.  Every hook also takes a leading query-slot axis: Q families (a
:class:`~repro_torch.core.regions.PackedRegions`, or the
:class:`~repro_torch.kernels.ops.SlotTables` prepared from one) with ``(Q, n,
...)`` arrays and one ``beta``/``eps`` per slot.

* ``reference`` — the plain PyTorch formulas (:mod:`..core.stopping`,
  :mod:`..core.correction`, :func:`..core.regions.decide_packed`).  This IS
  the algorithm.
* ``fused`` — :mod:`.ops`: the CUDA kernels on a CUDA tensor (one launch
  for all Q slots), their plain versions on a CPU tensor.

``resolve_suite(None, device)`` picks ``fused`` on ``cuda`` and
``reference`` on the CPU, as the JAX package picks the Pallas suite on the
TPU only.

Under :func:`repro_torch.launch.cost.analyze` every hook of both suites
counts as one kernel call of its model in :mod:`.cost`, by shape (every
slot live and in V, every family of ``k`` Voronoi centers), and its own
torch ops not at all: both suites then count the same work.
"""

from __future__ import annotations

import functools
from typing import Dict, Union

import torch

from ..core import correction as corr_lib
from ..core import regions, stopping, wvs
from ..launch import cost as counter
from . import cost, ops, ref

__all__ = ["KernelSuite", "ReferenceSuite", "FusedSuite", "register_suite",
           "get_suite", "resolve_suite", "suite_names"]


def _k(slot) -> int:
    """Centers a family (the padded count of a batched one)."""
    return int(ops.packed(slot).centers.shape[-2])


def _status_viol_cost(x_m, x_c, out_m, out_c, in_m, in_c, live, slot,
                      eps=None):
    n = x_c.numel()
    D, d = out_m.shape[-2:]
    return cost.lss_state_cost(n, D, d, _k(slot), n * D)


def _corrected_cost(old_s, a0, in_m, in_c, v_set, beta=None, eps=None):
    n = old_s.c.numel()
    D, d = in_m.shape[-2:]
    return cost.correction_cost(n, D, d, n * D)


def _decide_cost(v, slot, eps=None):
    q = v.shape[0] if ops.is_batched(slot) else 1
    k = _k(slot)
    return cost.region_decide_cost(q, v[..., 0].numel() // q, v.shape[-1],
                                   k, q * k, 0)


def _global_cost(x_m, x_c, alive, slot, eps=None):
    q = x_m.shape[0] if x_m.ndim == 3 else 1
    return cost.global_cost(q, x_c.shape[-1], x_m.shape[-1], _k(slot))


def _counted(model):
    """A hook that counts as one call of ``model``'s kernel while
    :func:`repro_torch.launch.cost.analyze` runs."""
    def wrap(fn):
        @functools.wraps(fn)
        def hook(self, *args, **kw):
            if not counter.counting():
                return fn(self, *args, **kw)
            with counter.kernel(*model(*args, **kw)):
                return fn(self, *args, **kw)
        return hook
    return wrap


class KernelSuite:
    """Fused decide/correction operations for one execution strategy."""

    name: str = "abstract"
    fused: bool = False

    def decide(self, v, slot: regions.PackedSlot, eps=1e-9):
        """Region ids of batched vectors ``v`` (..., d) -> int32 (...)."""
        raise NotImplementedError

    def status_viol(self, x_m, x_c, out_m, out_c, in_m, in_c, live,
                    slot: regions.PackedSlot, eps):
        """One pass: returns ``(S: WV, viol bool (n, D))`` (Alg. 1)."""
        raise NotImplementedError

    def corrected(self, old_s: wvs.WV, a0: wvs.WV, in_m, in_c, v_set,
                  beta, eps):
        """Eq.-10 corrected out-messages on the ``v_set`` slots."""
        raise NotImplementedError

    @_counted(_global_cost)
    def global_decision(self, x_m, x_c, alive, slot: regions.PackedSlot,
                        eps=1e-9):
        """The observe pass's ground truth ``f(vec((+)_alive X))``: int32,
        one per slot for Q families.  The default is the plain version."""
        return ref.global_decision_ref(x_m, x_c, alive, ops.packed(slot),
                                       eps)[0]

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<KernelSuite {self.name!r} fused={self.fused}>"


class ReferenceSuite(KernelSuite):
    """The plain PyTorch formulas — the semantics every suite must match."""

    name = "reference"
    fused = False

    @_counted(_decide_cost)
    def decide(self, v, slot, eps=1e-9):
        return regions.decide_packed(v, *ops.packed(slot))

    @_counted(_status_viol_cost)
    def status_viol(self, x_m, x_c, out_m, out_c, in_m, in_c, live, slot,
                    eps):
        s = stopping.status(x_m, x_c, out_m, out_c, in_m, in_c, live)
        a = stopping.agreements(out_m, out_c, in_m, in_c)
        fam = ops.packed(slot)
        decide = lambda u: regions.decide_packed(u, *fam)  # noqa: E731
        viol = stopping.violations_alg1(decide, s, a, live, eps)
        return s, viol

    @_counted(_corrected_cost)
    def corrected(self, old_s, a0, in_m, in_c, v_set, beta, eps):
        return corr_lib.corrected_messages(old_s, a0, in_m, in_c, v_set,
                                           beta, eps)


class FusedSuite(KernelSuite):
    """The hand-written CUDA kernels (plain versions on CPU tensors)."""

    name = "fused"
    fused = True

    @_counted(_decide_cost)
    def decide(self, v, slot, eps=1e-9):
        lead = (v.shape[0],) if ops.is_batched(slot) else ()
        flat = v.reshape(*lead, -1, v.shape[-1])
        return ops.region_decide(flat, slot).reshape(v.shape[:-1])

    @_counted(_status_viol_cost)
    def status_viol(self, x_m, x_c, out_m, out_c, in_m, in_c, live, slot,
                    eps):
        s_m, s_c, viol, _ = ops.lss_state(x_m, x_c, out_m, out_c, in_m,
                                          in_c, live, slot, eps=eps)
        return wvs.WV(s_m, s_c), viol

    @_counted(_corrected_cost)
    def corrected(self, old_s, a0, in_m, in_c, v_set, beta, eps):
        return ops.correction(old_s.m, old_s.c, a0.m, a0.c, in_m, in_c,
                              v_set, beta=beta, eps=eps)

    @_counted(_global_cost)
    def global_decision(self, x_m, x_c, alive, slot, eps=1e-9):
        return ops.global_decision(x_m, x_c, alive, slot, eps)[0]


_REGISTRY: Dict[str, KernelSuite] = {}


def register_suite(suite: KernelSuite) -> KernelSuite:
    """Add a suite to the registry (keyed by ``suite.name``)."""
    _REGISTRY[suite.name] = suite
    return suite


register_suite(ReferenceSuite())
register_suite(FusedSuite())


def suite_names():
    return tuple(_REGISTRY)


def get_suite(name: str) -> KernelSuite:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel suite {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def resolve_suite(use_kernels: Union[bool, str, None],
                  device=None) -> KernelSuite:
    """Map the public ``use_kernels`` knob to a suite.

    ``True`` -> ``fused``; ``False`` -> ``reference``; a string -> that
    registered suite; ``None`` (auto) -> ``fused`` when ``device`` is a
    CUDA device and ``reference`` otherwise.
    """
    if isinstance(use_kernels, str):
        return get_suite(use_kernels)
    if use_kernels is None:
        use_kernels = device is not None and torch.device(device).type == "cuda"
    return get_suite("fused" if use_kernels else "reference")
