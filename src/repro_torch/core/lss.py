"""LSS — Local Source Selection in general network graphs (Alg. 1).

Port of ``repro/core/lss.py``: the synchronous simulation of the paper's
algorithm, vectorized over all peers as torch tensors.

State layout (n peers, D = max degree slots, d dims; moment form):

    out_m/out_c   (n,D,d)/(n,D)  X_ij — latest message content per out-slot
    in_m/in_c     (n,D,d)/(n,D)  X_ji — latest message received per slot
    x_m/x_c       (n,d)/(n,)     X_ii — local input
    pending       (n,D) bool     out-slots changed and not yet delivered
    last_send     (n,) int32     cycle of the peer's last send (the ell timer)
    alive         (n,) bool      churn mask

One :func:`cycle` =
  1. deliver pending messages through the reverse-slot gather, dropping each
     independently with probability ``drop_rate``;
  2. recompute S_i / A_ij, evaluate Alg. 1's violation sets;
  3. peers with violations (and a cold ``ell`` timer) run the selective
     correction do-while (Sec. IV-C2, Eq. 10) — or the uniform policy
     (Eq. 5) — and post new messages on the violating slots.

**Query axis.**  Every function also takes Q slots' states stacked on a
leading axis (``out_m`` (Q,n,D,d), ``alive`` (Q,n), ``t``/``msgs`` (Q,),
``rng`` a tuple of Q generators; see :func:`init_state`), with
``beta``/``ell``/``eps`` one value or a (Q,) tensor and ``decide`` (or the
suite's packed families) batched over the slots.  This is what the JAX
service gets from ``vmap`` over these functions: all Q slots advance
through one batched pass, and the kernels launch once for all of them.

Differences from the JAX twin: the do-while is a Python loop that reads
``running.any()`` once per iteration over all slots (the JAX
``lax.while_loop`` has the same bound and reports the same ``iters``, per
slot under ``vmap``); ``host_syncs`` counts those reads.  ``rng`` is a
``torch.Generator`` on the state's device, so message-loss draws differ
from JAX's threefry stream and parity holds at ``drop_rate == 0`` only;
``msgs`` is int64.  Functions are pure: they return new states and never
write into the tensors they are given.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from . import correction, stopping, topology, wvs
from . import regions as regions_lib

__all__ = [
    "LSSConfig", "TopoArrays", "LSSState", "init_state", "cycle",
    "cycle_impl", "clear_slots", "pad_bucket", "metrics", "metrics_impl",
    "audit_impl", "counter_dtype", "suite_hooks", "correction_loop",
    "COLD_TIMER", "host_syncs",
]

# Send-timer value of a peer that has never sent: far enough in the past
# that the ell-cycle resend timer fires on the first eligible cycle.
COLD_TIMER = -(10 ** 6)

# Host reads of the do-while's ``running.any()`` (each one waits for the
# device), counted for the measurements of the loop; reset it at will.
host_syncs = 0


def pad_bucket(*arrays):
    """Pad same-length index arrays to the next power-of-two length by
    repeating their last entry (the edits they feed are idempotent)."""
    arrays = tuple(np.asarray(a) for a in arrays)
    m = max(1, int(arrays[0].shape[0]))
    size = 1 << (m - 1).bit_length()
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.repeat(a[-1:], size - a.shape[0], axis=0)], axis=0)
    return tuple(pad(a) for a in arrays)


def counter_dtype():
    """Exact dtype of the cumulative message counter: int64."""
    return torch.int64


class LSSConfig(NamedTuple):
    """Simulator knobs (the JAX twin's fields and defaults)."""

    beta: float = 1e-3  # minimum-weight floor on |S_i| (Sec. IV-C)
    ell: int = 1  # min cycles between a peer's sends (Alg. 1)
    drop_rate: float = 0.0  # i.i.d. message-loss probability
    policy: str = "selective"  # "selective" (Eq. 10) | "uniform" (Eq. 5)
    max_corr_iters: int = 0  # 0 = use max degree D
    eps: float = 1e-9


class TopoArrays(NamedTuple):
    nbr: torch.Tensor  # int32 (n, D)
    mask: torch.Tensor  # bool  (n, D) — static link validity
    rev: torch.Tensor  # int32 (n, D)

    @classmethod
    def from_topology(cls, t: topology.Topology, device) -> "TopoArrays":
        # torch.tensor always copies: a DynTopology mutates its numpy
        # buffers in place, and the device tables must not alias them.
        return cls(torch.tensor(t.nbr, dtype=torch.int32, device=device),
                   torch.tensor(t.mask, dtype=torch.bool, device=device),
                   torch.tensor(t.rev, dtype=torch.int32, device=device))


class LSSState(NamedTuple):
    out_m: torch.Tensor
    out_c: torch.Tensor
    in_m: torch.Tensor
    in_c: torch.Tensor
    x_m: torch.Tensor
    x_c: torch.Tensor
    pending: torch.Tensor
    last_send: torch.Tensor
    alive: torch.Tensor
    t: torch.Tensor  # current cycle (int32 scalar)
    msgs: torch.Tensor  # cumulative messages sent (int64 scalar)
    rng: object  # message-loss stream(s): a torch.Generator on the
    # state's device, or a tuple of Q of them for Q stacked slots


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def init_state(topo: TopoArrays, inputs: wvs.WV, seed=0,
               alive=None) -> LSSState:
    """Fresh all-quiescent state (S_i = X_ii, empty message slots).

    ``alive`` (optional bool (n,)) seeds the churn mask; default: every
    peer alive.  With ``inputs`` of Q slots (``m`` (Q, n, d)) the state is
    Q slots' states stacked: ``seed`` is one int or one per slot, ``rng``
    one generator per slot, and ``alive`` (n,) or (Q, n).
    """
    n, D = topo.nbr.shape
    d = inputs.m.shape[-1]
    dt = inputs.m.dtype
    dev = topo.nbr.device
    lead = tuple(inputs.m.shape[:-2])
    alive = (torch.ones(lead + (n,), dtype=torch.bool, device=dev)
             if alive is None
             else torch.tensor(np.asarray(alive), dtype=torch.bool,
                               device=dev).expand(lead + (n,)).contiguous())
    if lead:
        seeds = [seed] * lead[0] if np.ndim(seed) == 0 else list(seed)
        rng = tuple(_generator(dev, s) for s in seeds)
    else:
        rng = _generator(dev, seed)
    return LSSState(
        out_m=torch.zeros(lead + (n, D, d), dtype=dt, device=dev),
        out_c=torch.zeros(lead + (n, D), dtype=dt, device=dev),
        in_m=torch.zeros(lead + (n, D, d), dtype=dt, device=dev),
        in_c=torch.zeros(lead + (n, D), dtype=dt, device=dev),
        x_m=inputs.m,
        x_c=inputs.c,
        pending=torch.zeros(lead + (n, D), dtype=torch.bool, device=dev),
        last_send=torch.full(lead + (n,), COLD_TIMER, dtype=torch.int32,
                             device=dev),
        alive=alive,
        t=torch.zeros(lead, dtype=torch.int32, device=dev),
        msgs=torch.zeros(lead, dtype=counter_dtype(), device=dev),
        rng=rng,
    )


def clear_slots(state: LSSState, rows, slots) -> LSSState:
    """Scrub the messaging state of the given ``(peer, slot)`` coordinates.

    Dynamic membership reuses degree slots: when an edge is removed (and
    later a new one claims the freed slot) the out/in moments and pending
    flag go back to the empty-slot state.  Leading batch axes broadcast.
    """
    dev = state.out_m.device
    rows = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=dev)
    slots = torch.as_tensor(np.asarray(slots), dtype=torch.long, device=dev)

    def scrub(a, value, moment):
        a = a.clone()
        if moment:
            a[..., rows, slots, :] = value
        else:
            a[..., rows, slots] = value
        return a

    return state._replace(
        out_m=scrub(state.out_m, 0.0, True),
        out_c=scrub(state.out_c, 0.0, False),
        in_m=scrub(state.in_m, 0.0, True),
        in_c=scrub(state.in_c, 0.0, False),
        pending=scrub(state.pending, False, False),
    )


def _live_mask(topo: TopoArrays, alive: torch.Tensor) -> torch.Tensor:
    """Valid slots between two live peers (churn = failure of all links)."""
    return topo.mask & alive[..., :, None] & alive[..., topo.nbr]


def _uniform(rng, shape, device) -> torch.Tensor:
    """Uniform draws from one generator, or one (shape[1:]) per slot."""
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device)
    return torch.stack([torch.rand(shape[1:], generator=g, device=device)
                        for g in rng])


def _deliver(state: LSSState, topo: TopoArrays, drop_rate: float):
    """Move pending out-messages into the recipients' in-slots.

    Message (i,k) lands at (nbr[i,k], rev[i,k]).  ``rev`` makes the slot
    map an involution, so in-slot (j,r) *receives from* its unique source
    slot (nbr[j,r], rev[j,r]): delivery is one gather (on (Q, n*D) for Q
    stacked slots).
    """
    live = _live_mask(topo, state.alive)
    send = state.pending & live
    if drop_rate > 0.0:
        delivered = send & (_uniform(state.rng, send.shape, send.device)
                            >= drop_rate)
    else:
        delivered = send
    n, D = topo.nbr.shape
    lead = send.shape[:-2]
    src = topo.nbr.to(torch.int64) * D + topo.rev  # flat source slot
    # Did my source post a message that survived?  (Padding slots alias
    # arbitrary sources — mask them out on the receiver side.)
    got = delivered.reshape(*lead, n * D)[..., src] & topo.mask
    in_m = torch.where(got[..., None],
                       state.out_m.reshape(*lead, n * D, -1)[..., src, :],
                       state.in_m)
    in_c = torch.where(got, state.out_c.reshape(*lead, n * D)[..., src],
                       state.in_c)
    sent = torch.sum(send, dim=(-2, -1))
    return state._replace(
        in_m=in_m,
        in_c=in_c,
        pending=torch.zeros_like(state.pending),
        msgs=state.msgs + sent.to(state.msgs.dtype),
    ), sent


def _correction_loop(decide, state, topo, live, active, cfg: LSSConfig,
                     status_viol=None, corrected=None, entry=None):
    """Alg. 1's do-while, vectorized across peers.

    The corrected messages for a violating set V_i are a pure function of
    the *loop-entry* state (oldS_i, the entry agreements A0, the received
    X_ji); the do-while only *grows* V_i, recomputing the correction from
    scratch with the larger V_i until no new slot violates.

    ``status_viol(out_m, out_c) -> (S: WV, viol)`` and
    ``corrected(old_s, a0, in_m, in_c, v) -> (new_m, new_c)`` are pluggable
    (a :class:`~repro_torch.kernels.suite.KernelSuite` supplies them through
    :func:`suite_hooks`); the defaults are the reference formulas.
    ``entry=(old_s, a0, viol0)`` hands in the loop-entry values.

    The loop runs on the host: it reads ``running.any()`` once per
    iteration, over all slots of a batched state, and stops at
    ``cfg.max_corr_iters or D`` iterations.

    Returns ``(out_m, out_c, v, did_send, iters)`` with ``iters`` the
    do-while's iteration count: a Python int, or for Q stacked slots an
    int32 (Q,) tensor of each slot's own count (the iterations in which
    that slot was still running, as under the JAX ``vmap``).
    """
    n, D = topo.nbr.shape
    if status_viol is None:
        def status_viol(out_m, out_c):
            s = stopping.status(state.x_m, state.x_c, out_m, out_c,
                                state.in_m, state.in_c, live)
            a = stopping.agreements(out_m, out_c, state.in_m, state.in_c)
            return s, stopping.violations_alg1(decide, s, a, live, cfg.eps)
    if corrected is None:
        def corrected(old_s, a0, in_m, in_c, v):
            return correction.corrected_messages(
                old_s, a0, in_m, in_c, v, cfg.beta, cfg.eps)

    if entry is not None:
        old_s, a0, viol0 = entry
    else:
        old_s, viol0 = status_viol(state.out_m, state.out_c)
        a0 = stopping.agreements(state.out_m, state.out_c,
                                 state.in_m, state.in_c)
    v = viol0 & active[..., None]
    if cfg.policy == "uniform":
        # Eq. 5: a violating peer corrects *every* neighbor, not just V_i.
        any_viol = torch.any(v, dim=-1)
        v = live & (active & any_viol)[..., None]
    running = active & torch.any(v, dim=-1)
    max_iters = cfg.max_corr_iters or D
    lead = active.shape[:-1]
    slot_iters = (torch.zeros(lead, dtype=torch.int32, device=active.device)
                  if lead else None)

    def apply_v(v):
        """Corrected out-messages from the entry state, for slots in v."""
        new_m, new_c = corrected(old_s, a0, state.in_m, state.in_c, v)
        out_m = torch.where(v[..., None], new_m, state.out_m)
        out_c = torch.where(v, new_c, state.out_c)
        return out_m, out_c

    def still_running():
        global host_syncs
        host_syncs += 1
        return bool(torch.any(running))

    iters = 0
    while iters < max_iters and still_running():
        if slot_iters is not None:
            slot_iters += torch.any(running, dim=-1)
        out_m, out_c = apply_v(v)
        _, viol2 = status_viol(out_m, out_c)
        w = viol2 & running[..., None] & ~v
        running = running & torch.any(w, dim=-1)
        v = v | w
        iters += 1
    out_m, out_c = apply_v(v)
    did_send = active & torch.any(v, dim=-1)
    return out_m, out_c, v, did_send, (iters if slot_iters is None
                                       else slot_iters)


# Public alias, as in the JAX package.
correction_loop = _correction_loop


def suite_hooks(suite, state: LSSState, live, regions, cfg: LSSConfig):
    """Bind a :class:`repro_torch.kernels.suite.KernelSuite` to one state.

    Returns ``(status_viol, corrected, entry)`` in the shape
    :func:`correction_loop` consumes; ``regions`` is the packed
    :class:`~repro_torch.core.regions.PackedSlot` the suite decides with,
    or the :class:`~repro_torch.kernels.ops.SlotTables` prepared from it
    with ``cfg.eps``.
    """
    def status_viol(out_m, out_c):
        return suite.status_viol(state.x_m, state.x_c, out_m, out_c,
                                 state.in_m, state.in_c, live, regions,
                                 cfg.eps)

    def corrected(old_s, a0, in_m, in_c, v):
        return suite.corrected(old_s, a0, in_m, in_c, v, cfg.beta, cfg.eps)

    s, viol = status_viol(state.out_m, state.out_c)
    a0 = stopping.agreements(state.out_m, state.out_c,
                             state.in_m, state.in_c)
    return status_viol, corrected, (s, a0, viol)


def cycle_impl(state: LSSState, topo: TopoArrays, cfg: LSSConfig, decide,
               gate=None, suite=None, regions=None, with_stats=False):
    """One synchronous cycle with the decision function given explicitly.

    ``gate`` (optional bool, broadcastable to (n,), or one per slot of a
    batched state): where False the peer may not *initiate* sends this
    cycle.  ``suite`` + ``regions`` (a
    :class:`~repro_torch.kernels.suite.KernelSuite` and a packed
    :class:`~repro_torch.core.regions.PackedSlot`, or for Q stacked slots
    their :class:`~repro_torch.core.regions.PackedRegions`, or either's
    :class:`~repro_torch.kernels.ops.SlotTables`) route status/violations
    and the Eq.-10 correction through that suite; ``decide`` may then be
    None.  ``with_stats=True`` also returns the do-while's iteration count:
    ``(state', sent_now, corr_iters)``; ``sent_now`` and ``corr_iters`` are
    per slot for a batched state.
    """
    state, _ = _deliver(state, topo, cfg.drop_rate)

    live = _live_mask(topo, state.alive)
    status_viol = corrected = None
    if suite is not None:
        if regions is None:
            raise ValueError("cycle_impl(suite=...) needs packed `regions`")
        status_viol, corrected, entry = suite_hooks(
            suite, state, live, regions, cfg)
        viol = entry[2]
    else:
        s = stopping.status(state.x_m, state.x_c, state.out_m, state.out_c,
                            state.in_m, state.in_c, live)
        a = stopping.agreements(state.out_m, state.out_c, state.in_m,
                                state.in_c)
        viol = stopping.violations_alg1(decide, s, a, live, cfg.eps)
        entry = (s, a, viol)
    timer_ok = ((state.t[..., None] - state.last_send)
                >= wvs.lead(cfg.ell, state.last_send))
    active = state.alive & timer_ok & torch.any(viol, dim=-1)
    if gate is not None:
        if isinstance(gate, torch.Tensor) and gate.shape == state.t.shape:
            gate = gate[..., None]  # one gate per slot
        active = active & gate

    out_m, out_c, v, did_send, corr_iters = _correction_loop(
        decide, state, topo, live, active, cfg, status_viol=status_viol,
        corrected=corrected, entry=entry)
    sending = v & did_send[..., None]
    state = state._replace(
        out_m=out_m, out_c=out_c,
        pending=state.pending | sending,
        last_send=torch.where(did_send, state.t[..., None], state.last_send),
        t=state.t + 1,
    )
    sent_now = torch.sum(sending, dim=(-2, -1))
    if with_stats:
        return state, sent_now, corr_iters
    return state, sent_now


def cycle(state: LSSState, topo: TopoArrays, centers: torch.Tensor,
          cfg: LSSConfig, decide=None, suite=None, regions=None):
    """One synchronous simulator cycle.  Returns (state', sent_this_cycle).

    ``suite`` routes the hot loop through that suite with ``regions`` (by
    default ``centers`` packed as a Voronoi slot; a caller stepping many cycles
    passes the slot's tables, prepared once with ``cfg.eps``).  ``decide`` is
    the escape hatch for opaque decision functions (reference formulas only).
    """
    if suite is not None:
        if decide is not None:
            raise ValueError(
                "cycle() cannot honor both `decide` and `suite` — an "
                "opaque decide cannot feed the packed kernels; drop one "
                "(or pack the family and use cycle_impl(suite=, "
                "regions=))")
        if regions is None:
            regions = regions_lib.PackedSlot.voronoi(centers)
        return cycle_impl(state, topo, cfg, None, suite=suite,
                          regions=regions)
    if decide is None:
        decide = lambda v: regions_lib.decide_voronoi(v, centers)  # noqa: E731
    return cycle_impl(state, topo, cfg, decide)


def metrics_impl(state: LSSState, topo: TopoArrays, decide, eps=1e-9,
                 suite=None, regions=None):
    """Accuracy and quiescence.

    Returns ``(accuracy, quiescent, correct_mask, want)`` — ``want`` is the
    ground-truth region id ``f(vec((+)X))`` over live peers (the sum in
    float64, :func:`wvs.live_sum`); per slot for a batched state.  By
    default the reference formulas with ``decide``; with a fused ``suite``
    and its packed ``regions``, S, the violations and f(vec(S)) come from
    one ``lss_state`` launch and ``want`` from the suite's
    ``global_decision``, one launch of ``region_decide``'s second entry
    (``decide`` may then be None).  ``eps`` is one number or, for a
    batched state, one per slot.
    """
    live = _live_mask(topo, state.alive)
    if suite is not None and suite.fused:
        _, _, viol, got = kernel_ops.lss_state(
            state.x_m, state.x_c, state.out_m, state.out_c, state.in_m,
            state.in_c, live, regions, eps=eps)
        want = suite.global_decision(state.x_m, state.x_c, state.alive,
                                     regions, eps)
        return _accuracy(state, live, want, got, viol)
    s = stopping.status(state.x_m, state.x_c, state.out_m, state.out_c,
                        state.in_m, state.in_c, live)
    got = decide(wvs.vec(s, eps))
    a = stopping.agreements(state.out_m, state.out_c, state.in_m, state.in_c)
    viol = stopping.violations_alg1(decide, s, a, live, eps)
    gx = wvs.live_sum(wvs.WV(state.x_m, state.x_c), state.alive)
    want = decide(wvs.vec(gx, eps)[..., None, :])[..., 0]
    return _accuracy(state, live, want, got, viol)


def _accuracy(state, live, want, got, viol):
    correct = (got == want[..., None]) & state.alive
    acc = (torch.sum(correct, dim=-1)
           / torch.clamp(torch.sum(state.alive, dim=-1), min=1))
    quiescent = (~torch.any((state.pending & live).flatten(-2), dim=-1)
                 & ~torch.any(viol.flatten(-2), dim=-1))
    return acc, quiescent, correct, want


def metrics(state: LSSState, topo: TopoArrays, centers: torch.Tensor,
            eps: float = 1e-9, suite=None, regions=None):
    """(accuracy, quiescent, correct_mask): fraction of live peers whose
    f(vec(S_i)) equals f(vec((+)X over live peers)), and quiescence.

    With a fused ``suite``, S_i, the violations and f(vec(S_i)) come from
    one ``lss_state`` call and the global decision from one
    ``global_decision`` call (``regions``, a packed slot or its prepared
    :class:`~repro_torch.kernels.ops.SlotTables`, defaults to ``centers``
    packed as a Voronoi slot); otherwise from the reference formulas.
    """
    if suite is None or not suite.fused:
        decide = lambda v: regions_lib.decide_voronoi(v, centers)  # noqa: E731
        acc, quiescent, correct, _ = metrics_impl(state, topo, decide, eps)
        return acc, quiescent, correct
    slot = regions if regions is not None else \
        regions_lib.PackedSlot.voronoi(centers)
    acc, quiescent, correct, _ = metrics_impl(state, topo, None, eps,
                                              suite=suite, regions=slot)
    return acc, quiescent, correct


def audit_impl(state: LSSState, topo: TopoArrays, decide, eps=1e-9,
               sample_mod=1, sample_phase=0, settled_ok=None,
               tol_rel_extra=0.0):
    """Invariant reductions for the audit plane (see the JAX twin).

    **Conservation**: the residual ``(+)_alive S_i (-) (+)_alive X_ii (-)
    (+)_infl (in (-) out_rev)`` is rounding noise bounded by ``tol``.
    **Edge symmetry**: on settled slots ``A_ij`` and ``A_ji`` are bitwise
    equal (``edge_bad`` counts mismatches).  **Stopping soundness**:
    ``stop_bad`` counts alive peers whose Def.-4 balance fails, with the
    reference formulas and ``decide``, whatever suite the cycles ran.

    ``settled_ok`` (bool (n, D) or None) moves the slots it excludes to
    the in-flight side of the ledger and out of the edge check (the
    engine's halo slots on a lossy wire or in async mode);
    ``tol_rel_extra`` widens the rounding model by a wire's relative
    error bound.

    Returns a dict of scalar tensors: ``resid``/``tol``/``mag``,
    ``edge_bad``/``edge_checked``, ``stop_bad``/``quiescent``, and
    ``live_slots``/``msgs``/``t``.  For Q stacked slots (``decide``
    batched over them, ``eps`` one value or (Q,)) each is a (Q,) tensor
    of the slots' own reductions, what the JAX service gets from
    ``vmap``.
    """
    n, D = topo.nbr.shape
    lead = state.alive.shape[:-1]
    live = _live_mask(topo, state.alive)
    src = topo.nbr.to(torch.int64) * D + topo.rev
    out_rev_m = state.out_m.reshape(*lead, n * D, -1)[..., src, :]
    out_rev_c = state.out_c.reshape(*lead, n * D)[..., src]
    pend_rev = state.pending.reshape(*lead, n * D)[..., src]

    s = stopping.status(state.x_m, state.x_c, state.out_m, state.out_c,
                        state.in_m, state.in_c, live)
    alive_k = state.alive[..., None]
    gx_m = torch.sum(torch.where(alive_k, state.x_m, 0.0), dim=-2)
    gx_c = torch.sum(torch.where(state.alive, state.x_c, 0.0), dim=-1)

    infl = live & pend_rev
    if settled_ok is not None:
        infl = live & (pend_rev | ~settled_ok)
    sum_s_m = torch.sum(torch.where(alive_k, s.m, 0.0), dim=-2)
    sum_s_c = torch.sum(torch.where(state.alive, s.c, 0.0), dim=-1)
    flight_m = torch.sum(torch.where(infl[..., None], state.in_m - out_rev_m,
                                     0.0), dim=(-3, -2))
    flight_c = torch.sum(torch.where(infl, state.in_c - out_rev_c, 0.0),
                         dim=(-2, -1))
    resid = torch.maximum(
        torch.amax(torch.abs(sum_s_m - gx_m - flight_m), dim=-1),
        torch.abs(sum_s_c - gx_c - flight_c))
    mag = (
        torch.sum(torch.where(alive_k, torch.abs(state.x_m), 0.0),
                  dim=(-2, -1))
        + torch.sum(torch.where(state.alive, torch.abs(state.x_c), 0.0),
                    dim=-1)
        + torch.sum(torch.where(live[..., None],
                                torch.abs(state.in_m) + torch.abs(out_rev_m),
                                0.0), dim=(-3, -2, -1))
        + torch.sum(torch.where(live, torch.abs(state.in_c)
                                + torch.abs(out_rev_c), 0.0), dim=(-2, -1))
    )
    u = torch.finfo(state.x_m.dtype).eps
    tol = 1e-6 + (4.0 * u + tol_rel_extra) * (n * (D + 1)) * mag

    settled = live & ~state.pending & ~pend_rev
    if settled_ok is not None:
        settled = settled & settled_ok
    mod = max(int(sample_mod), 1)
    slot_id = torch.arange(n * D, dtype=torch.int32,
                           device=live.device).reshape(n, D)
    check = settled & (((slot_id + int(sample_phase)) % mod) == 0)
    a_m = state.out_m + state.in_m
    a_c = state.out_c + state.in_c
    mismatch = (torch.any(a_m != a_m.reshape(*lead, n * D, -1)[..., src, :],
                          dim=-1)
                | (a_c != a_c.reshape(*lead, n * D)[..., src]))
    edge_bad = torch.sum(check & mismatch, dim=(-2, -1))
    edge_checked = torch.sum(check, dim=(-2, -1))

    a = stopping.agreements(state.out_m, state.out_c, state.in_m, state.in_c)
    ok4 = stopping.def4_satisfied(decide, s, a, live, eps)
    stop_bad = torch.sum(state.alive & ~ok4, dim=-1)
    viol = stopping.violations_alg1(decide, s, a, live, eps)
    quiescent = (~torch.any((state.pending & live).flatten(-2), dim=-1)
                 & ~torch.any(viol.flatten(-2), dim=-1))

    return dict(
        resid=resid, tol=tol, mag=mag,
        edge_bad=edge_bad, edge_checked=edge_checked,
        stop_bad=stop_bad, quiescent=quiescent,
        live_slots=torch.sum(live, dim=(-2, -1)), msgs=state.msgs, t=state.t,
    )
