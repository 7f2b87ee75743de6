"""The port's Alg.-1 core loop (``repro_torch.core.lss``) against the JAX
package's, cycle by cycle, from the same state.

Both packages start from one JAX ``init_state`` carried across with
``repro_torch.convert``; the JAX side runs ``jax.jit(lss.cycle_impl)`` with
the reference formulas.  After every cycle every ``LSSState`` field but
``rng`` is compared — int and bool fields exactly, floats to rtol 1e-5 /
atol 1e-5 — as are the messages sent and the do-while's iteration count.
Grid, Barabási–Albert and Chord x the Voronoi, halfspace and padded-Voronoi
families x the port's three ways to run the loop (an explicit ``decide``,
the reference suite, the fused suite, which on the CPU runs the kernels'
plain versions).  ``drop_rate`` stays 0: the message-loss stream is JAX's
threefry and has no torch counterpart.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lss as j_lss
from repro.core import regions as j_regions
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro_torch import convert
from repro_torch.core import lss as t_lss
from repro_torch.core import regions as t_regions
from repro_torch.core import topology as t_top
from repro_torch.kernels import get_suite
from test_torch_formulas import FAMILIES, _family, assert_close, assert_exact

TOPOS = {"grid": lambda m: m.grid(64),
         "ba": lambda m: m.barabasi_albert(90, m=2, seed=1),
         "chord": lambda m: m.chord(64)}
CYCLES = 10
FLOATS = ("out_m", "out_c", "in_m", "in_c", "x_m", "x_c")
VARIANTS = {"default": j_lss.LSSConfig(),
            "uniform": j_lss.LSSConfig(policy="uniform"),
            "ell2": j_lss.LSSConfig(ell=2, beta=0.05),
            "iters1": j_lss.LSSConfig(max_corr_iters=1)}


def _fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if f != "rng"}


def _gate(n):
    return np.arange(n) % 3 != 0


@functools.lru_cache(maxsize=None)
def _jax_run(topo_name, fam, variant, gated=False):
    """Initial state, per-cycle (fields, sent, iters), and the metrics and
    audit reductions after cycle 3 and after the last cycle."""
    topo = TOPOS[topo_name](j_top)
    ta = j_lss.TopoArrays.from_topology(topo)
    jslot, _ = _family(fam, 2, 3, seed=0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((topo.n, 2)).astype(np.float32)
    state = j_lss.init_state(ta, j_wvs.from_vector(
        jnp.asarray(x), jnp.ones((topo.n,), jnp.float32)), seed=0)
    init = _fields(state)
    decide = lambda v: j_regions.decide_packed(v, *jslot)  # noqa: E731
    cfg = VARIANTS[variant]
    gate = jnp.asarray(_gate(topo.n)) if gated else None
    step = jax.jit(lambda s: j_lss.cycle_impl(s, ta, cfg, decide, gate=gate,
                                              with_stats=True))
    traj, observed = [], {}
    for c in range(CYCLES):
        state, sent, iters = step(state)
        traj.append((_fields(state), int(sent), int(iters)))
        if c in (3, CYCLES - 1):
            acc, q, correct, want = j_lss.metrics_impl(state, ta, decide)
            audit = j_lss.audit_impl(state, ta, decide)
            observed[c] = (float(acc), bool(q), np.asarray(correct),
                           int(want),
                           {k: np.asarray(v) for k, v in audit.items()})
    return init, traj, observed


def _port_setup(topo_name, fam, init):
    topo = TOPOS[topo_name](j_top)
    ta = convert.topo_from_numpy(topo.nbr, topo.mask, topo.rev, "cpu")
    _, tslot = _family(fam, 2, 3, seed=0)
    state = convert.state_from_jax_numpy(init, "cpu")
    return ta, tslot, state


def _assert_state(got, want, msg):
    got = convert.state_to_numpy(got)
    for name, w in want.items():
        if name in FLOATS:
            assert_close(got[name], w, f"{msg}: {name}")
        else:
            assert_exact(got[name], w, f"{msg}: {name}")


def _port_step(path, tslot, cfg, gate=None):
    decide = lambda v: t_regions.decide_packed(v, *tslot)  # noqa: E731
    if path == "decide":
        return lambda s, ta: t_lss.cycle_impl(s, ta, cfg, decide, gate=gate,
                                              with_stats=True)
    suite = get_suite(path)
    return lambda s, ta: t_lss.cycle_impl(s, ta, cfg, None, gate=gate,
                                          suite=suite, regions=tslot,
                                          with_stats=True)


def _check_observed(state, ta, tslot, observed, msg):
    decide = lambda v: t_regions.decide_packed(v, *tslot)  # noqa: E731
    acc, quiescent, correct, want = t_lss.metrics_impl(state, ta, decide)
    j_acc, j_q, j_correct, j_want, j_audit = observed
    assert float(acc) == j_acc and bool(quiescent) == j_q, msg
    assert_exact(correct, j_correct, msg)
    assert int(want) == j_want, msg
    audit = t_lss.audit_impl(state, ta, decide)
    for key in ("edge_bad", "edge_checked", "stop_bad", "quiescent",
                "live_slots", "msgs", "t"):
        assert int(audit[key]) == int(j_audit[key]), f"{msg}: audit {key}"
    assert_close(audit["mag"], j_audit["mag"], f"{msg}: audit mag")
    assert_close(audit["tol"], j_audit["tol"], f"{msg}: audit tol")
    assert float(audit["resid"]) <= float(audit["tol"]), msg
    assert float(j_audit["resid"]) <= float(j_audit["tol"]), msg


@pytest.mark.parametrize("path", ["decide", "reference", "fused"])
@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("topo_name", list(TOPOS))
def test_cycle_impl_matches_jax(topo_name, fam, path):
    init, traj, observed = _jax_run(topo_name, fam, "default")
    ta, tslot, state = _port_setup(topo_name, fam, init)
    step = _port_step(path, tslot, t_lss.LSSConfig())
    for c, (want, sent, iters) in enumerate(traj):
        state, t_sent, t_iters = step(state, ta)
        msg = f"{topo_name}/{fam}/{path} cycle {c}"
        _assert_state(state, want, msg)
        assert int(t_sent) == sent and t_iters == iters, msg
        if c in observed:
            _check_observed(state, ta, tslot, observed[c], msg)


@pytest.mark.parametrize("variant", ["uniform", "ell2", "iters1", "gate"])
def test_cycle_impl_knobs_match_jax(variant):
    gated = variant == "gate"
    cfg_key = "default" if gated else variant
    init, traj, _ = _jax_run("grid", "voronoi", cfg_key, gated)
    ta, tslot, state = _port_setup("grid", "voronoi", init)
    cfg = t_lss.LSSConfig(**VARIANTS[cfg_key]._asdict())
    gate = torch.tensor(_gate(ta.nbr.shape[0])) if gated else None
    step = _port_step("reference", tslot, cfg, gate)
    for c, (want, sent, iters) in enumerate(traj):
        state, t_sent, t_iters = step(state, ta)
        _assert_state(state, want, f"{variant} cycle {c}")
        assert int(t_sent) == sent and t_iters == iters


def test_state_round_trip():
    init, traj, _ = _jax_run("ba", "voronoi", "default")
    for fields in (init, traj[4][0]):
        state = convert.state_from_jax_numpy(fields, "cpu", seed=3)
        back = convert.state_to_numpy(state)
        assert back.keys() == fields.keys()
        for name in fields:
            assert_exact(back[name], fields[name], name)
        assert state.msgs.dtype == torch.int64
        assert state.t.dtype == torch.int32
        assert isinstance(state.rng, torch.Generator)


def test_init_state_matches_jax():
    topo_j, topo_t = j_top.grid(16), t_top.grid(16)
    x = np.random.default_rng(0).standard_normal((16, 2)).astype(np.float32)
    alive = np.arange(16) % 5 != 0
    js = j_lss.init_state(j_lss.TopoArrays.from_topology(topo_j),
                          j_wvs.from_vector(jnp.asarray(x),
                                            jnp.ones((16,), jnp.float32)),
                          alive=alive)
    ts = t_lss.init_state(t_lss.TopoArrays.from_topology(topo_t, "cpu"),
                          t_lss.wvs.from_vector(torch.tensor(x),
                                                torch.ones(16)),
                          alive=alive)
    _assert_state(ts, _fields(js), "init")
    assert int(ts.last_send[0]) == t_lss.COLD_TIMER == j_lss.COLD_TIMER


def test_clear_slots_and_pad_bucket_match_jax():
    init, traj, _ = _jax_run("grid", "voronoi", "default")
    rows, slots = np.array([0, 5, 9], np.int32), np.array([1, 0, 2], np.int32)
    for a, b in zip(t_lss.pad_bucket(rows, slots),
                    j_lss.pad_bucket(rows, slots)):
        assert_exact(a, b)
    fields = traj[2][0]
    want = j_lss.clear_slots(
        j_lss.LSSState(**{k: jnp.asarray(v) for k, v in fields.items()},
                       rng=jax.random.PRNGKey(0)), rows, slots)
    got = t_lss.clear_slots(convert.state_from_jax_numpy(fields, "cpu"),
                            rows, slots)
    _assert_state(got, _fields(want), "clear_slots")


def test_fused_metrics_match_reference():
    """``metrics`` with the fused suite (S, viol, f(S) from ops.lss_state)
    equals the reference formulas."""
    init, traj, _ = _jax_run("chord", "voronoi", "default")
    ta, tslot, _ = _port_setup("chord", "voronoi", init)
    for fields, _, _ in traj[::3]:
        state = convert.state_from_jax_numpy(fields, "cpu")
        ref = t_lss.metrics(state, ta, tslot.centers)
        fused = t_lss.metrics(state, ta, tslot.centers,
                              suite=get_suite("fused"))
        assert float(ref[0]) == float(fused[0])
        assert bool(ref[1]) == bool(fused[1])
        assert_exact(fused[2], ref[2])


def test_drop_rate_is_seeded_and_counts_losses():
    """At drop_rate > 0 the torch generator in the state drives the loss:
    the same seed gives the same run, and lost messages are still counted
    as sent."""
    ta = t_lss.TopoArrays.from_topology(t_top.grid(64), "cpu")
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (64, 2)).astype(np.float32))
    centers = torch.tensor([[0.0, 0.0], [1.0, 1.0], [-1.0, 0.5]])
    cfg = t_lss.LSSConfig(drop_rate=0.3)
    runs = []
    for _ in range(2):
        st = t_lss.init_state(ta, t_lss.wvs.from_vector(x, torch.ones(64)),
                              seed=5)
        for _ in range(6):
            st, _ = t_lss.cycle(st, ta, centers, cfg)
        runs.append(convert.state_to_numpy(st))
    for name in runs[0]:
        assert_exact(runs[0][name], runs[1][name], name)
    assert runs[0]["msgs"] > 0


def test_cycle_argument_errors():
    ta = t_lss.TopoArrays.from_topology(t_top.grid(16), "cpu")
    st = t_lss.init_state(ta, t_lss.wvs.from_vector(torch.zeros(16, 2),
                                                    torch.ones(16)))
    centers = torch.zeros((2, 2))
    custom = lambda v: (v[..., 0] > 0).to(torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="decide"):
        t_lss.cycle(st, ta, centers, t_lss.LSSConfig(), decide=custom,
                    suite=get_suite("fused"))
    with pytest.raises(ValueError, match="regions"):
        t_lss.cycle_impl(st, ta, t_lss.LSSConfig(), None,
                         suite=get_suite("reference"))


@pytest.mark.parametrize("path", ["decide", "reference", "fused"])
def test_batched_cycle_matches_per_slot_runs(path):
    """Q stacked slots (mixed families, per-slot beta/ell/eps tensors, a
    per-slot gate, message loss from one generator per slot) advance
    exactly as Q unbatched runs of the same cycle, state, sends and
    do-while iterations alike, and metrics_impl agrees slot by slot."""
    topo = t_top.chord(48)
    ta = t_lss.TopoArrays.from_topology(topo, "cpu")
    rng = np.random.default_rng(7)
    kinds = FAMILIES + ["voronoi"]
    slots = [_family(kind, 2, 3, seed=i)[1] for i, kind in enumerate(kinds)]
    q = len(slots)
    k_max = max(s.centers.shape[0] for s in slots)
    packed = t_regions.PackedRegions.empty(q, k_max, 2)
    for i, s in enumerate(slots):
        fam = (t_regions.HalfspaceRegions(s.w, s.b)
               if int(s.kind) == t_regions.KIND_HALFSPACE
               else t_regions.VoronoiRegions(s.centers[s.cmask]))
        packed = packed.set(i, fam)
    x = torch.tensor(rng.standard_normal((q, 48, 2)).astype(np.float32))
    beta = torch.tensor([1e-3, 0.05, 2e-3, 1e-3])
    ell = torch.tensor([1, 2, 1, 3], dtype=torch.int32)
    eps = torch.tensor([1e-9, 1e-6, 1e-9, 1e-3])
    gate = torch.tensor([True, True, False, True])
    base = t_lss.LSSConfig(drop_rate=0.2)
    cfg = base._replace(beta=beta, ell=ell, eps=eps)
    seeds = [3, 4, 5, 6]
    batched = t_lss.init_state(ta, t_lss.wvs.from_vector(x, torch.ones(q,
                                                                     48)),
                               seed=seeds)
    singles = [t_lss.init_state(ta, t_lss.wvs.from_vector(x[i],
                                                          torch.ones(48)),
                                seed=seeds[i]) for i in range(q)]
    suite = None if path == "decide" else get_suite(path)
    for c in range(8):
        batched, sent, iters = t_lss.cycle_impl(
            batched, ta, cfg, packed.decide, gate=gate, suite=suite,
            regions=packed, with_stats=True)
        for i in range(q):
            one = base._replace(beta=float(beta[i]), ell=int(ell[i]),
                                eps=float(eps[i]))
            singles[i], s_sent, s_iters = t_lss.cycle_impl(
                singles[i], ta, one, slots[i].decide, gate=gate[i],
                suite=suite, regions=slots[i], with_stats=True)
            msg = f"{path} cycle {c} slot {i}"
            got = convert.state_to_numpy(batched)
            for name, want in convert.state_to_numpy(singles[i]).items():
                assert_exact(got[name][i], want, f"{msg}: {name}")
            assert int(sent[i]) == int(s_sent) and int(iters[i]) == s_iters
    acc, quiescent, correct, want = t_lss.metrics_impl(
        batched, ta, packed.decide, eps, suite=suite, regions=packed)
    for i in range(q):
        a, qu, co, wa = t_lss.metrics_impl(singles[i], ta, slots[i].decide,
                                           float(eps[i]), suite=suite,
                                           regions=slots[i])
        assert (float(acc[i]), bool(quiescent[i]), int(want[i])) == (
            float(a), bool(qu), int(wa))
        assert_exact(correct[i], co)
    assert not bool(batched.pending[2].any())  # the gated slot never sent
