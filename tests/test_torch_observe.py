"""The observe pass's global decision and the driver's prepared tables.

``want = f(vec((+)_alive X))`` is ``region_decide``'s second entry on the
card; on the CPU ``ops.global_decision`` and ``KernelSuite.global_decision``
run its plain version (``kernels/ref.py::global_decision_ref``).  Here:

* the plain version equals the composition ``lss.metrics_impl`` ran before
  it existed (float64 sums of the live inputs rounded once, ``wvs.vec``, the
  fused suite's ``decide``): ``want`` exactly and ``gx`` bitwise
  (rtol = atol = 0), for Q = 1 and Q = 5, d = 2 and 6, k = 3 and 243,
  Voronoi, padded, halfspace and padding families, dead peers, an all-dead
  slot and a per-slot eps;
* it equals the JAX package's ``want`` (``repro.core.lss.metrics_impl`` with
  ``repro.kernels.ref`` decisions) on the same numpy inputs, exactly on ids,
  except at slots whose decision is a near tie: JAX sums the inputs in
  float32 in XLA's order, which is off from the float64 sum rounded once by
  up to about n 2^-24 of the sum of magnitudes (2e-5 relative at n = 300),
  and JAX's decision takes its dot products as a matrix product, so a slot
  whose float64 decision margin is under 1e-3 relative may decide
  otherwise there;
* ``sim.run_static``, which now prepares its kernel tables once, gives the
  JAX driver's records through the fused suite's plain versions on every
  topology of ``test_torch_sim.py``, and with a cycle eps other than the
  observe's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lss as j_lss
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro.kernels import ref as j_ref
from repro_torch import kernels
from repro_torch.core import lss as t_lss
from repro_torch.core import regions as t_regions
from repro_torch.core import sim as t_sim
from repro_torch.core import topology as t_top
from repro_torch.core import wvs as t_wvs
from repro_torch.kernels import get_suite, ops, ref
from test_torch_formulas import assert_exact
from test_torch_kernels import _slot_family, regions_of

N = 300
TIE = 1e-3
# Slot kinds of the Q = 5 cases; slot 3 is a padding slot, slot 2 has
# every peer dead.
KINDS = ["voronoi", "halfspace", "padded-voronoi", "padding", "voronoi"]
EPS_Q = np.array([1e-9, 1e-3, 1e-9, 0.5, 1e6], np.float32)  # 1e6: guard


def _case(q, d, k, fam, seed):
    """Numpy inputs (q, n, ...) that are not dyadic, one fifth of the peers
    dead (every peer of slot 2 when q = 5), and the (JAX, port) families."""
    rng = np.random.default_rng(seed)
    x_m = rng.standard_normal((q, N, d)).astype(np.float32)
    x_c = rng.uniform(0.5, 2.0, (q, N)).astype(np.float32)
    alive = rng.random((q, N)) >= 0.2
    if q == 5:
        alive[2] = False
    kinds = [fam] if q == 1 else KINDS
    pairs = [_slot_family(kind, d, k, seed=seed + i)
             for i, kind in enumerate(kinds)]
    return x_m, x_c, alive, pairs


def _before(x_m, x_c, alive, region, eps):
    """What ``metrics_impl``'s fused branch computed before the global
    decision had an entry of its own: (want, gx)."""
    f64 = torch.float64
    gx = t_wvs.WV(
        torch.sum(torch.where(alive[..., None], x_m, 0.0),
                  dim=-2, dtype=f64).to(x_m.dtype),
        torch.sum(torch.where(alive, x_c, 0.0), dim=-1,
                  dtype=f64).to(x_c.dtype),
    )
    decide = lambda u: get_suite("fused").decide(u, region, eps)  # noqa: E731
    return decide(t_wvs.vec(gx, eps)[..., None, :])[..., 0], gx


def _port_args(q, x_m, x_c, alive, pairs):
    t = [torch.tensor(a) for a in (x_m, x_c, alive)]
    if q == 1:
        return [a[0] for a in t], pairs[0][1], 1e-3
    return t, regions_of([p for _, p in pairs]), torch.tensor(EPS_Q)


@pytest.mark.parametrize("q,d,k,fam", [
    (1, 2, 3, "voronoi"), (1, 2, 3, "halfspace"), (1, 6, 243, "voronoi"),
    (1, 2, 243, "padded-voronoi"), (1, 6, 3, "padding"),
    (5, 2, 3, "mixed"), (5, 6, 3, "mixed"), (5, 2, 243, "mixed"),
    (5, 6, 243, "mixed")])
def test_plain_global_decision_equals_before(q, d, k, fam):
    """want equal, gx bitwise (rtol = atol = 0), through the wrapper, the
    fused and reference suites, and prepared tables."""
    x_m, x_c, alive, pairs = _case(q, d, k, fam, seed=q * 100 + d * 10 + k)
    (tx_m, tx_c, talive), region, eps = _port_args(q, x_m, x_c, alive,
                                                   pairs)
    want, gx = _before(tx_m, tx_c, talive, region, eps)
    tables = ops.prep_slots(region, eps)
    for reg in (region, tables):
        got, gx_m, gx_c = ops.global_decision(tx_m, tx_c, talive, reg, eps)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want)
        torch.testing.assert_close(gx_m, gx.m, rtol=0, atol=0)
        torch.testing.assert_close(gx_c, gx.c, rtol=0, atol=0)
        for suite in ("fused", "reference"):
            assert torch.equal(get_suite(suite).global_decision(
                tx_m, tx_c, talive, reg, eps), want)
    if q == 5:
        assert float(gx.c[2]) == 0.0  # the all-dead slot sums to zero
        assert int(want[3]) == 0  # the padding slot decides 0


@pytest.mark.parametrize("q,d,k,fam", [
    (1, 2, 3, "voronoi"), (1, 2, 3, "halfspace"), (1, 6, 243, "voronoi"),
    (1, 2, 243, "padded-voronoi"), (5, 2, 3, "mixed"), (5, 6, 243, "mixed")])
def test_global_decision_matches_jax_metrics(q, d, k, fam):
    """``want`` equals the JAX ``metrics_impl``'s slot by slot, exactly,
    except at near-tie slots (see the module docstring)."""
    x_m, x_c, alive, pairs = _case(q, d, k, fam, seed=q * 7 + d + k)
    (tx_m, tx_c, talive), region, eps = _port_args(q, x_m, x_c, alive,
                                                   pairs)
    got = ops.global_decision(tx_m, tx_c, talive, region, eps)[0]
    got = got.reshape(q)
    ta = j_lss.TopoArrays.from_topology(j_top.chord(N))
    compared = 0
    for s, (jslot, tslot) in enumerate(pairs):
        e = float(eps) if q == 1 else float(EPS_Q[s])
        state = j_lss.init_state(ta, j_wvs.WV(jnp.asarray(x_m[s]),
                                              jnp.asarray(x_c[s])),
                                 alive=alive[s])
        decide = lambda v, j=jslot: j_ref.region_decide_ref(v, j)  # noqa: E731
        want = int(j_lss.metrics_impl(state, ta, decide, e)[3])
        if _margin(x_m[s], x_c[s], alive[s], tslot, e) < TIE:
            continue
        assert int(got[s]) == want, s
        compared += 1
    assert compared >= q - 1 and compared >= 1


def _margin(x_m, x_c, alive, slot, eps):
    """Relative margin of the slot's global decision, in float64."""
    m = x_m[alive].astype(np.float64).sum(0)
    c = x_c[alive].astype(np.float64).sum()
    v = m / c if abs(c) > eps else np.zeros_like(m)
    if int(slot.kind) == t_regions.KIND_VORONOI:
        cmask = slot.cmask.numpy()
        if cmask.sum() < 2:
            return np.inf
        cent = slot.centers.numpy().astype(np.float64)[cmask]
        scores = np.sort(-2.0 * cent @ v + (cent * cent).sum(-1))
        a, b = scores[0], scores[1]
    else:
        a = float(v @ slot.w.numpy().astype(np.float64))
        b = float(slot.b)
    return abs(b - a) / max(abs(a), abs(b), 1.0)


def test_unbatched_tables_stay_unbatched():
    """Tables prepared from one family are read as one family by every
    wrapper and suite (the kernels get them with a slot axis of 1)."""
    rng = np.random.default_rng(5)
    _, slot = _slot_family("voronoi", 2, 3, seed=5)
    tables = ops.prep_slots(slot, 1e-3)
    assert tables.cthw.shape == (1, 2, 4) and tables.meta.shape == (1, 4)
    assert not ops.is_batched(tables)
    assert isinstance(ops.packed(tables), t_regions.PackedSlot)
    assert ops.is_batched(ops.prep_slots(regions_of([slot, slot])))
    assert_exact(tables.meta[0], ops.prep_slot(slot, 1e-3)[2])
    v = torch.tensor(rng.standard_normal((4, 7, 2)).astype(np.float32))
    for suite in ("fused", "reference"):
        assert torch.equal(get_suite(suite).decide(v, tables),
                           get_suite(suite).decide(v, slot))
    assert torch.equal(ops.region_decide(v[0], tables),
                       ops.region_decide(v[0], slot))


def test_observe_counts_one_plain_decision():
    """On the CPU one fused observe runs the plain lss_state and one plain
    decision (``kernels.counts()`` keeps its keys)."""
    topo = t_top.chord(64)
    ta = t_lss.TopoArrays.from_topology(topo, "cpu")
    x = np.random.default_rng(1).standard_normal((64, 2)).astype(np.float32)
    state = t_lss.init_state(ta, t_wvs.from_vector(torch.tensor(x),
                                                   torch.ones(64)))
    _, slot = _slot_family("halfspace", 2, 3, seed=1)
    kernels.reset_counts()
    t_lss.metrics_impl(state, ta, None, 1e-9, suite=get_suite("fused"),
                       regions=ops.prep_slots(slot))
    assert kernels.counts() == {"region_decide": 0, "lss_state": 0,
                                "correction": 0, "region_decide_ref": 1,
                                "lss_state_ref": 1, "correction_ref": 0}


@pytest.mark.parametrize("eps", [1e-9, 1e-3])
def test_driver_prepares_tables_once(monkeypatch, eps):
    """The driver's tables are prepared at set-up, with cfg.eps for the
    cycles and the observe's eps for metrics; stepping and observing
    prepare none."""
    topo = t_top.grid(64)
    cfg = t_lss.LSSConfig(eps=eps)
    drv, _, _ = t_sim._driver(topo, t_sim.ProblemSpec(n=64), cfg, None,
                              "cpu", True)
    assert not ops.is_batched(drv._tables)
    assert float(drv._tables.meta[0, 2]) == float(np.float32(eps))
    assert float(drv._observe_tables.meta[0, 2]) == float(
        np.float32(t_sim.OBSERVE_EPS))
    assert (drv._observe_tables is drv._tables) == (eps == t_sim.OBSERVE_EPS)

    def refuse(*args, **kwargs):
        raise AssertionError("prep_slots ran after the driver's set-up")

    monkeypatch.setattr(ops, "prep_slots", refuse)
    drv.advance(3)
    acc, _ = drv.observe()
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("make", [
    lambda m: m.grid(256),
    lambda m: m.barabasi_albert(256, m=2, seed=1),
    lambda m: m.chord(256),
], ids=["grid", "ba", "chord"])
def test_run_static_fused_with_tables_matches_jax(make):
    """Through the fused suite's plain versions with the prepared tables,
    ``run_static`` gives the JAX driver's records."""
    spec = j_sim.ProblemSpec(n=256)
    want = j_sim.run_static(make(j_top), spec, max_cycles=300)
    got = t_sim.run_static(make(t_top), t_sim.ProblemSpec(n=256),
                           max_cycles=300, device="cpu", use_kernels=True)
    assert got["quiesced_at"] is not None
    for key in want:
        assert got[key] == want[key], key


def test_run_static_cycle_eps_matches_jax():
    """A cycle eps other than the observe's: the two tables differ and the
    records still equal the JAX driver's."""
    spec = j_sim.ProblemSpec(n=144, seed=2)
    want = j_sim.run_static(j_top.grid(144), spec,
                            j_lss.LSSConfig(eps=1e-3), max_cycles=300)
    got = t_sim.run_static(t_top.grid(144), t_sim.ProblemSpec(n=144, seed=2),
                           t_lss.LSSConfig(eps=1e-3), max_cycles=300,
                           device="cpu", use_kernels=True)
    for key in want:
        assert got[key] == want[key], key


def test_global_decision_ref_is_the_plain_version():
    """The suite default and the wrapper's CPU path are the same function
    (its decision counted as one ``region_decide_ref`` call)."""
    x_m, x_c, alive, pairs = _case(1, 2, 3, "voronoi", seed=11)
    t = [torch.tensor(a[0]) for a in (x_m, x_c, alive)]
    kernels.reset_counts()
    a = ref.global_decision_ref(*t, pairs[0][1], 1e-9)
    b = ops.global_decision(*t, pairs[0][1], 1e-9)
    assert kernels.counts()["region_decide_ref"] == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
