"""Carry state across from the JAX package, as numpy arrays.

The port never imports JAX; a caller that holds a JAX ``LSSState``,
engine ``ShardedState`` or ``AsyncShardedState``, ``TopoArrays``,
``PackedSlot`` or service ``QuerySpec`` hands its fields
over as numpy arrays (``{f: np.asarray(getattr(s, f)) for f in
s._fields}``) and gets the port's twin back on ``device``; a model's
parameters, its AdamW state, its caches and a LocalSGD state go across as
``jax.tree.map(np.asarray, tree)``.
This is how the parity tests start both packages from the same state,
the same tenants and the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tree as tree_lib
from .core import lss, monitor, regions
from .engine import engine as engine_lib
from .models import attention, build, ssm
from .models.common import ParamTree, as_tree
from .models.encdec import EncDecCache
from .models.transformer import LMCache
from .optim import AdamWState
from .service.controlplane import SLOSpec
from .service.query import QuerySpec
from .training.localsgd import LocalSGDState

__all__ = ["state_from_jax_numpy", "states_from_jax_numpy", "state_to_numpy",
           "sharded_state_from_jax_numpy", "async_state_from_jax_numpy",
           "topo_from_numpy", "slot_from_numpy", "query_spec_from_numpy",
           "model_params_from_jax_numpy", "lm_cache_from_jax_numpy",
           "encdec_cache_from_jax_numpy", "localsgd_state_from_jax_numpy"]

_STATE_DTYPES = {
    "out_m": torch.float32, "out_c": torch.float32,
    "in_m": torch.float32, "in_c": torch.float32,
    "x_m": torch.float32, "x_c": torch.float32,
    "pending": torch.bool, "last_send": torch.int32, "alive": torch.bool,
    "t": torch.int32, "msgs": lss.counter_dtype(),
}
_ERR_DTYPES = {"wire_err_m": torch.float32, "wire_err_c": torch.float32}
_ASYNC_DTYPES = {
    "clock": torch.int32, "out_seq": torch.int32, "last_seq": torch.int32,
    "ring_m": torch.float32, "ring_c": torch.float32,
    "ring_flag": torch.bool, "ring_seq": torch.int32,
    "stale_drops": lss.counter_dtype(), "applied": lss.counter_dtype(),
    "delay_sum": lss.counter_dtype(),
}


def _tensors(fields, dtypes, device) -> dict:
    """The named numpy arrays present in ``fields`` as tensors on
    ``device``."""
    return {name: torch.tensor(np.asarray(fields[name]), dtype=dt,
                               device=device)
            for name, dt in dtypes.items()
            if fields.get(name) is not None}


def _numpy(state, names) -> dict:
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in names if getattr(state, name) is not None}


def state_from_jax_numpy(fields, device, seed: int = 0) -> lss.LSSState:
    """The port's :class:`~repro_torch.core.lss.LSSState` from a dict of
    numpy arrays named like the JAX ``LSSState`` fields.

    The JAX ``rng`` key (if present) is dropped: its threefry stream has no
    torch counterpart, so the state gets a generator seeded with ``seed``.
    """
    out = _tensors(fields, _STATE_DTYPES, device)
    out["rng"] = lss._generator(torch.device(device), seed)
    return lss.LSSState(**out)


def states_from_jax_numpy(fields, device, seeds) -> lss.LSSState:
    """Q slots' states stacked, from numpy arrays with a leading slot axis
    named like the JAX ``LSSState`` fields (a JAX service's ``states``).

    The JAX ``rng`` keys are dropped; slot q gets a generator seeded with
    ``seeds[q]``.
    """
    out = _tensors(fields, _STATE_DTYPES, device)
    dev = torch.device(device)
    out["rng"] = tuple(lss._generator(dev, s) for s in seeds)
    return lss.LSSState(**out)


def state_to_numpy(state) -> dict:
    """Every field but the generators of an ``LSSState``, an engine
    ``ShardedState`` (its ``wire_err_*`` where not None) or an
    ``AsyncShardedState`` (its books, and its sync state's fields as a
    dict under ``"sync"``) as numpy arrays (on the host)."""
    if isinstance(state, engine_lib.AsyncShardedState):
        return {**_numpy(state, _ASYNC_DTYPES),
                "sync": state_to_numpy(state.sync)}
    return _numpy(state, [*_STATE_DTYPES, *(
        _ERR_DTYPES if isinstance(state, engine_lib.ShardedState) else ())])


def sharded_state_from_jax_numpy(fields, device,
                                 seed: int = 0) -> engine_lib.ShardedState:
    """The port's engine :class:`~repro_torch.engine.ShardedState` from a
    dict of numpy arrays named like the JAX ``ShardedState`` fields (the
    ``(S, B, ...)`` layout of an engine with the same partition).

    The quantized wires' ``wire_err_*`` are carried when present.  The JAX
    per-shard ``rng`` keys are dropped: the state gets one drop generator
    per shard derived from ``seed``, as :meth:`~repro_torch.engine.
    ShardedLSS.init` derives them.  :func:`state_to_numpy` is the inverse.
    """
    out = _tensors(fields, {**_STATE_DTYPES, **_ERR_DTYPES}, device)
    out["rng"] = engine_lib._shard_generators(
        torch.device(device), seed, out["msgs"].shape[0])
    return engine_lib.ShardedState(**out)


def async_state_from_jax_numpy(fields, device,
                               seed: int = 0) -> engine_lib.AsyncShardedState:
    """The port's :class:`~repro_torch.engine.AsyncShardedState` from a
    dict of numpy arrays named like the JAX ``AsyncShardedState``'s book
    fields (``clock``, ``out_seq``, ``last_seq``, ``ring_*``,
    ``stale_drops``, ``applied``, ``delay_sum``), with the sync state's
    fields as a dict under ``"sync"``
    (:func:`sharded_state_from_jax_numpy`).  The delay generators are
    derived from the drop generators, as :meth:`~repro_torch.engine.
    ShardedLSS.wrap_async` derives them.
    """
    sync = sharded_state_from_jax_numpy(fields["sync"], device, seed)
    return engine_lib.AsyncShardedState(
        sync=sync, **_tensors(fields, _ASYNC_DTYPES, device),
        delay_rng=engine_lib._delay_generators(sync.rng))


def topo_from_numpy(nbr, mask, rev, device) -> lss.TopoArrays:
    """The port's ``TopoArrays`` from numpy ``nbr``/``mask``/``rev``."""
    return lss.TopoArrays(
        torch.tensor(np.asarray(nbr), dtype=torch.int32, device=device),
        torch.tensor(np.asarray(mask), dtype=torch.bool, device=device),
        torch.tensor(np.asarray(rev), dtype=torch.int32, device=device))


def slot_from_numpy(kind, centers, cmask, w, b, device) -> regions.PackedSlot:
    """The port's ``PackedSlot`` from the JAX slot's five fields."""
    return regions.PackedSlot(
        kind=torch.tensor(np.asarray(kind), dtype=torch.int32, device=device),
        centers=torch.tensor(np.asarray(centers), dtype=torch.float32,
                             device=device),
        cmask=torch.tensor(np.asarray(cmask), dtype=torch.bool,
                           device=device),
        w=torch.tensor(np.asarray(w), dtype=torch.float32, device=device),
        b=torch.tensor(np.asarray(b), dtype=torch.float32, device=device))


def query_spec_from_numpy(region, inputs, weights=None, beta=None, ell=None,
                          eps=None, seed=0, priority=0, slo=None) -> QuerySpec:
    """The port's :class:`~repro_torch.service.query.QuerySpec` from a JAX
    spec's fields.

    ``region`` is the JAX family's fields as numpy arrays
    (``{f: np.asarray(v) for f, v in spec.region._asdict().items()}``):
    ``centers`` for a Voronoi family, ``w`` and ``b`` for a halfspace.
    ``slo`` is None or the JAX ``SLOSpec``'s fields (a mapping or a tuple
    in field order).  The region's tensors stay on the CPU; the service
    copies them to its device at admission.
    """
    f32 = torch.float32
    if "centers" in region:
        fam = regions.VoronoiRegions(
            torch.tensor(np.asarray(region["centers"]), dtype=f32))
    else:
        fam = regions.HalfspaceRegions(
            w=torch.tensor(np.asarray(region["w"]), dtype=f32),
            b=torch.tensor(np.asarray(region["b"]), dtype=f32))
    if slo is not None:
        slo = SLOSpec(**slo) if isinstance(slo, dict) else SLOSpec(*slo)
    return QuerySpec(region=fam, inputs=np.asarray(inputs, np.float32),
                     weights=(None if weights is None
                              else np.asarray(weights, np.float32)),
                     beta=beta, ell=ell, eps=eps, seed=seed,
                     priority=priority, slo=slo)


def _array(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (bfloat16 ones included) as a tensor on ``device``,
    in its own dtype or ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # no numpy dtype torch reads
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def model_params_from_jax_numpy(cfg, tree, device) -> ParamTree:
    """The port's parameters for ``cfg`` from JAX's parameter tree as numpy
    (``jax.tree.map(np.asarray, params)``): a copy by path.  The tree must
    have the port's paths and shapes; each leaf takes the port's dtype."""
    def carry(want, got, path):
        if isinstance(want, dict):
            if set(want) != set(got):
                raise ValueError(f"{path or 'params'}: keys {sorted(got)} "
                                 f"!= {sorted(want)}")
            return {k: carry(want[k], got[k], f"{path}.{k}".lstrip("."))
                    for k in want}
        a = np.asarray(got)
        if a.shape != tuple(want.shape):
            raise ValueError(f"{path}: shape {a.shape} != {tuple(want.shape)}")
        return _array(a, device, want.dtype)

    return ParamTree(carry(build(cfg, "meta").init().tree(), tree, ""))


def adamw_state_from_jax_numpy(cfg_or_params, state, device) -> AdamWState:
    """The port's :class:`~repro_torch.optim.AdamWState` from JAX's as numpy
    (``jax.tree.map(np.asarray, opt)``): moments as float32 nested dicts
    of the parameters' paths, ``step`` a 0-d int32 tensor.
    ``cfg_or_params`` is a model config or the port's parameters, whose
    tree the moments must match leaf for leaf (JAX's order)."""
    like = as_tree(cfg_or_params if isinstance(cfg_or_params,
                                               (dict, ParamTree))
                   else build(cfg_or_params, "meta").init())

    def moments(tree, field):
        flat = tree_lib.leaves(tree)
        want = tree_lib.leaves(like)
        if len(flat) != len(want):
            raise ValueError(f"{field}: {len(flat)} leaves != {len(want)}")
        for a, w in zip(flat, want):
            if np.shape(a) != tuple(w.shape):
                raise ValueError(f"{field}: shape {np.shape(a)} != "
                                 f"{tuple(w.shape)}")
        return tree_lib.unflatten_like(
            like, [_array(a, device, torch.float32) for a in flat])

    return AdamWState(m=moments(state.m, "m"), v=moments(state.v, "v"),
                      step=_array(state.step, device, torch.int32))


def _kv_cache(kv, device):
    return attention.KVCache(*(_array(f, device) for f in kv))


def lm_cache_from_jax_numpy(cache, device) -> LMCache:
    """The port's :class:`~repro_torch.models.LMCache` from JAX's as numpy
    (``jax.tree.map(np.asarray, cache)``), each field in its own dtype."""
    return LMCache(
        kv=None if cache.kv is None else _kv_cache(cache.kv, device),
        ssm=None if cache.ssm is None else ssm.SSMState(
            *(_array(f, device) for f in cache.ssm)))


def encdec_cache_from_jax_numpy(cache, device) -> EncDecCache:
    """The port's :class:`~repro_torch.models.EncDecCache` from JAX's as
    numpy, as :func:`lm_cache_from_jax_numpy`."""
    return EncDecCache(kv=_kv_cache(cache.kv, device),
                       cross_k=_array(cache.cross_k, device),
                       cross_v=_array(cache.cross_v, device))


def localsgd_state_from_jax_numpy(state, peer: int, device) -> LocalSGDState:
    """This peer's :class:`~repro_torch.training.LocalSGDState` from JAX's
    as numpy (``(anchor, mon, syncs)``: the replica-stacked anchor tree,
    the ``MonitorState``, the sync count): row ``peer`` of every stacked
    array, kept ``(1, ...)``; the monitor's fields float32, ``syncs`` a
    0-d int32."""
    anchor, mon, syncs = state
    return LocalSGDState(
        anchor=tree_lib.map(
            lambda a: _array(np.asarray(a)[peer:peer + 1], device), anchor),
        mon=monitor.MonitorState(*(
            _array(np.asarray(getattr(mon, f))[peer:peer + 1], device,
                   torch.float32)
            for f in monitor.MonitorState._fields)),
        syncs=_array(np.asarray(syncs).reshape(()), device, torch.int32))
