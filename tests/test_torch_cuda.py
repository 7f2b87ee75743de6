"""The CUDA kernels on the card (``cuda`` marker; they skip without CUDA).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs,
unbatched (Q = 1) and with a leading query-slot axis of mixed families and
per-slot knobs.  The inputs are multiples of 1/64, so every sum is exact in
float32 in any order: float outputs must agree to rtol 1e-5 / atol 1e-5,
and ``viol`` / ``dec`` exactly, except where the plain version's decision
is a near tie (best and second-best score, or v.w and b, within 1e-5
relative), where a sum taken in another order may round differently.
``region_decide`` must agree exactly: the plain decision does the kernel's
arithmetic (``regions.dot``).  ``lss_state`` and ``correction`` must also
agree bitwise on inputs that are not dyadic (``test_lss_state_bitwise``,
``test_correction_bitwise``): each sums a row's live or violating slots in
the plain version's order, so no sum may round otherwise, and ``viol`` /
``dec`` must then be equal everywhere, near ties included.  The observe
pass's global decision (``region_decide``'s second entry) must give the
plain version's ``want`` and, bitwise, its rounded global sums
(``test_global_decision_bitwise``).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import lss, regions, sim, topology, wvs
from repro_torch.kernels import correction as k_corr
from repro_torch.kernels import get_suite
from repro_torch.kernels import lss_state as k_state
from repro_torch.kernels import ops, ref
from repro_torch.kernels import region_decide as k_dec
from repro_torch.service import (ControlPlaneConfig, QuerySpec, Service,
                                  ServiceConfig)

pytestmark = pytest.mark.cuda
TIE = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _inputs(n, D, d, seed, dev):
    rng = np.random.default_rng(seed)
    q = lambda a: torch.tensor(np.round(a * 64) / 64, dtype=torch.float32,  # noqa: E731
                               device=dev)
    zero = rng.random((n, D)) < 0.25
    keep = (~zero).astype(np.float32)
    x_m = q(rng.standard_normal((n, d)))
    x_c = torch.ones((n,), device=dev)
    out_m = q(rng.standard_normal((n, D, d)) * 0.3 * keep[..., None])
    out_c = q(rng.uniform(0.05, 2.0, (n, D)) * keep)
    in_m = q(rng.standard_normal((n, D, d)) * 0.3 * keep[..., None])
    in_c = q(rng.uniform(0.05, 2.0, (n, D)) * keep)
    mask = torch.tensor(rng.random((n, D)) > 0.2, device=dev)
    return [x_m, x_c, out_m, out_c, in_m, in_c, mask]


def _slot(fam, d, k, seed, dev):
    rng = np.random.default_rng(seed)
    cent = torch.tensor(rng.standard_normal((k, d)), dtype=torch.float32,
                        device=dev)
    if fam == "halfspace":
        w = torch.tensor(rng.standard_normal(d), dtype=torch.float32,
                         device=dev)
        return regions.PackedSlot.halfspace(w, 0.1)
    if fam == "padded-voronoi":
        return regions.PackedRegions.pack([regions.VoronoiRegions(cent)],
                                          k_max=k + 3).slot(0)
    return regions.PackedSlot.voronoi(cent)


def _margin(v, slot):
    """Relative gap of each decision of ``v`` (..., d), in float64."""
    v = v.double()
    if int(slot.kind) == regions.KIND_VORONOI:
        c = slot.centers.double()
        s = torch.where(slot.cmask, -2.0 * v @ c.T + (c * c).sum(-1),
                        torch.inf)
        if s.shape[-1] < 2:
            return torch.full(v.shape[:-1], torch.inf, device=v.device)
        a, b = torch.topk(s, 2, dim=-1, largest=False).values.unbind(-1)
    else:
        a, b = v @ slot.w.double(), slot.b.double().expand(v.shape[:-1])
    return (b - a).abs() / torch.clamp(torch.maximum(a.abs(), b.abs()),
                                       min=1.0)


def _row_margin(args, s_m, s_c, slot, eps):
    """The smallest decision margin each peer's Alg.-1 test involves."""
    _, _, out_m, out_c, in_m, in_c, mask = args
    a = wvs.WV(out_m + in_m, out_c + in_c)
    sa = wvs.WV(s_m[:, None] - a.m, s_c[:, None] - a.c)
    slot_m = torch.minimum(_margin(wvs.vec(a, eps), slot),
                           _margin(wvs.vec(sa, eps), slot))
    slot_m = torch.where(mask, slot_m, torch.inf)
    return torch.minimum(_margin(wvs.vec(wvs.WV(s_m, s_c), eps), slot),
                         slot_m.min(dim=1).values)


@pytest.mark.parametrize("fam", ["voronoi", "halfspace", "padded-voronoi"])
@pytest.mark.parametrize("n,D,d,k", [(1000, 6, 2, 3), (130, 8, 6, 7),
                                     (33, 3, 2, 243), (5000, 40, 2, 3)])
def test_kernels_match_plain(dev, n, D, d, k, fam):
    args = _inputs(n, D, d, seed=n + D, dev=dev)
    slot = _slot(fam, d, k, seed=k, dev=dev)
    eps = 1e-9
    kernels.reset_counts()
    got = ops.lss_state(*args, slot, eps=eps)
    want = ref.lss_state_ref(*args, slot, eps)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    differs = (got[3] != want[3]) | (got[2] != want[2]).any(dim=1)
    margin = _row_margin(args, want[0], want[1], slot, eps)
    assert bool((margin[differs] <= TIE).all()), "differs off a near tie"
    s_m, s_c, viol, _ = want
    cargs = (s_m, s_c, args[2] + args[4], args[3] + args[5], args[4],
             args[5], viol)
    for beta in (1e-3, 0.1):
        for g, w in zip(ops.correction(*cargs, beta=beta, eps=eps),
                        ref.correction_ref(*cargs, beta, eps)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    v = args[0] / 3.0
    torch.testing.assert_close(ops.region_decide(v, slot),
                               ref.region_decide_ref(v, slot), rtol=0, atol=0)
    assert kernels.counts()["lss_state"] == 1
    assert kernels.counts()["correction"] == 2
    assert kernels.counts()["region_decide"] == 1


def _slots(d, k, dev):
    """Q = 8 slots: Voronoi, halfspace, padded Voronoi and padding (every
    center masked), twice, as one PackedRegions on the card."""
    fams = []
    for i in range(8):
        kind = ("voronoi", "halfspace", "padded-voronoi", "padding")[i % 4]
        if kind == "padding":
            fams.append(None)
            continue
        slot = _slot(kind, d, k, seed=k + i, dev=dev)
        fams.append(regions.VoronoiRegions(slot.centers[slot.cmask])
                    if kind != "halfspace"
                    else regions.HalfspaceRegions(slot.w, slot.b))
    packed = regions.PackedRegions.empty(8, k + 3, d, device=dev)
    for i, fam in enumerate(fams):
        if fam is not None:
            packed = packed.set(i, fam)
    return packed


@pytest.mark.parametrize("n,D,d,k", [(1000, 6, 2, 3), (130, 8, 6, 7),
                                     (33, 3, 2, 243)])
def test_batched_kernels_match_plain(dev, n, D, d, k):
    """One launch for Q slots with per-slot families and knobs equals the
    batched plain versions; padding slots decide 0."""
    per_slot = [_inputs(n, D, d, seed=n + q, dev=dev) for q in range(8)]
    args = [torch.stack(a) for a in zip(*per_slot)]
    packed = _slots(d, k, dev)
    eps = torch.tensor([1e-9, 1e-3] * 4, device=dev)
    beta = torch.tensor([1e-3, 1e-3, 0.1, 0.05] * 2, device=dev)
    tables = ops.prep_slots(packed, eps, beta)
    kernels.reset_counts()
    got = ops.lss_state(*args, tables, eps=eps)
    want = ref.lss_state_ref(*args, packed, eps)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    differs = (got[3] != want[3]) | (got[2] != want[2]).any(dim=-1)
    for q in range(8):
        slot = packed.slot(q)
        if int(slot.kind) == regions.KIND_VORONOI and not slot.cmask.any():
            assert not bool(got[3][q].any()), "padding slot decided != 0"
            continue
        one = [a[q] for a in args]
        margin = _row_margin(one, want[0][q], want[1][q], slot,
                             float(eps[q]))
        assert bool((margin[differs[q]] <= TIE).all()), q
    s_m, s_c, viol, _ = want
    cargs = (s_m, s_c, args[2] + args[4], args[3] + args[5], args[4],
             args[5], viol)
    for g, w in zip(ops.correction(*cargs, beta=beta, eps=eps),
                    ref.correction_ref(*cargs, beta, eps)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    v = args[0] / 3.0
    torch.testing.assert_close(ops.region_decide(v, tables),
                               ref.region_decide_ref(v, packed), rtol=0,
                               atol=0)
    assert {k: kernels.counts()[k] for k in
            ("region_decide", "lss_state", "correction")} == {
        "region_decide": 1, "lss_state": 1, "correction": 1}


def _correction_inputs(q, n, D, d, seed, dev, offset=0):
    """Non-dyadic (q, n, D, d) inputs of the correction on a Barabási–Albert
    like row mix: full hub rows among degree-2 rows padded to D; rows with
    empty V (S_c = 0 there, so |T_c| <= eps), with V on every live slot and
    with V on every slot; with q > 1 the last slot is a padding slot (all
    zero, V empty).  ``offset`` > 0 puts the d-vector arrays that many
    floats into their buffers, off 8- and 16-byte alignment."""
    rng = np.random.default_rng(seed)
    hub = np.zeros(n, bool)
    hub[[0, n // 2, n - 1]] = True
    deg = np.where(hub, D, min(2, D))
    live = np.arange(D)[None, :] < deg[:, None]
    kind = np.arange(n) % 7
    v = np.where(kind[:, None] == 1, False,
                 np.where(kind[:, None] == 2, live,
                          np.where(kind[:, None] == 3, True,
                                   live & (rng.random((q, n, D)) < 0.6))))
    v = np.broadcast_to(v, (q, n, D)).copy()
    keep = live[..., None].astype(np.float32)
    s_m = rng.standard_normal((q, n, d)).astype(np.float32)
    s_c = (3.0 * rng.standard_normal((q, n))).astype(np.float32)
    s_c[:, kind == 1] = 0.0
    s_c[:, kind == 5] = 1e-12
    a_m = (0.3 * rng.standard_normal((q, n, D, d)) * keep).astype(np.float32)
    a_c = (rng.uniform(0.05, 2.0, (q, n, D)) * live).astype(np.float32)
    in_m = (0.3 * rng.standard_normal((q, n, D, d)) * keep).astype(np.float32)
    in_c = (rng.uniform(0.05, 2.0, (q, n, D)) * live).astype(np.float32)
    if q > 1:
        for arr in (s_m, s_c, a_m, a_c, in_m, in_c):
            arr[-1] = 0.0
        v[-1] = False

    def put(a, off=0):
        buf = torch.empty(a.size + off, dtype=torch.float32, device=dev)
        out = buf[off:].view(a.shape)
        out.copy_(torch.from_numpy(a))
        return out

    return (put(s_m), put(s_c), put(a_m, offset), put(a_c), put(in_m, offset),
            put(in_c), torch.tensor(v, device=dev))


@pytest.mark.parametrize("q,n,D,d,offset", [
    (1, 1000, 3, 2, 0), (5, 257, 4, 2, 0), (1, 301, 34, 2, 0),
    (5, 131, 37, 2, 0), (1, 200, 780, 2, 0), (5, 67, 780, 2, 0),
    (1, 8, 5000, 2, 0), (5, 8, 5000, 2, 0), (5, 97, 37, 3, 0),
    (1, 150, 34, 4, 0), (5, 131, 34, 4, 1), (1, 301, 34, 2, 1),
    (5, 40, 6, 16, 0), (1, 8, 1500, 6, 0)])
def test_correction_bitwise(dev, q, n, D, d, offset):
    """The kernel equals its plain version bitwise on non-dyadic inputs, at
    tile edges (n not a multiple of a tile), on hub rows, on rows longer
    than a tile (D = 1,500 and 5,000) and with unaligned d-vectors; q = 5
    takes per-slot beta / eps and a padding slot, q = 1 the unbatched
    call."""
    args = _correction_inputs(q, n, D, d, seed=n * 31 + D, dev=dev,
                              offset=offset)
    if q == 1:
        args = tuple(a[0] for a in args)
        beta, eps = 1e-3, 1e-9
    else:
        beta = torch.tensor([1e-3, 0.1, 0.05, 1e-3, 0.2][:q], device=dev)
        eps = torch.tensor([1e-9, 1e-3, 0.5, 1e-9, 1e-9][:q], device=dev)
    kernels.reset_counts()
    got = ops.correction(*args, beta=beta, eps=eps)
    want = ref.correction_ref(*args, beta, eps)
    assert kernels.counts()["correction"] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _state_inputs(q, n, D, d, seed, dev, offset=0):
    """Non-dyadic (q, n, D, d) inputs of ``lss_state`` on a Barabási–Albert
    like row mix: full hub rows among degree-2 rows padded to D, all-dead
    rows, rows with dead slots scattered anywhere (as churn leaves them),
    and rows whose one live slot has in == out (a zero difference).  Dead
    slots hold values too, which the kernel must not read into S.
    ``offset`` > 0 puts out_m / in_m that many floats into their buffers,
    off 8- and 16-byte alignment."""
    rng = np.random.default_rng(seed)
    hub = np.zeros(n, bool)
    hub[[0, n // 2, n - 1]] = True
    deg = np.where(hub, D, min(2, D))
    live = np.arange(D)[None, :] < deg[:, None]
    kind = np.arange(n) % 7
    mask = np.broadcast_to(live, (q, n, D)).copy()
    mask[:, kind == 1] = False
    mask[:, kind == 3] = rng.random((q, int((kind == 3).sum()), D)) < 0.6
    mask[:, kind == 5] = np.arange(D) == 0
    x_m = rng.standard_normal((q, n, d)).astype(np.float32)
    x_c = rng.uniform(0.5, 2.0, (q, n)).astype(np.float32)
    out_m = (0.3 * rng.standard_normal((q, n, D, d))).astype(np.float32)
    out_c = rng.uniform(-0.5, 2.0, (q, n, D)).astype(np.float32)
    in_m = (0.3 * rng.standard_normal((q, n, D, d))).astype(np.float32)
    in_c = rng.uniform(-0.5, 2.0, (q, n, D)).astype(np.float32)
    in_m[:, kind == 5, 0] = out_m[:, kind == 5, 0]
    in_c[:, kind == 5, 0] = out_c[:, kind == 5, 0]

    def put(a, off=0):
        buf = torch.empty(a.size + off, dtype=torch.float32, device=dev)
        out = buf[off:].view(a.shape)
        out.copy_(torch.from_numpy(a))
        return out

    return (put(x_m), put(x_c), put(out_m, offset), put(out_c),
            put(in_m, offset), put(in_c), torch.tensor(mask, device=dev))


def _mixed_slots(q, d, k, dev):
    """q slots cycling Voronoi, halfspace, padded Voronoi (k - 1 centers),
    Voronoi and padding (every center masked), from numpy draws."""
    rng = np.random.default_rng(k * 13 + d)
    packed = regions.PackedRegions.empty(q, k + 3, d, device=dev)
    for i in range(q):
        kind = i % 5
        if kind == 4:
            continue
        arr = lambda *s: torch.tensor(  # noqa: E731
            rng.standard_normal(s).astype(np.float32), device=dev)
        fam = (regions.HalfspaceRegions(arr(d), arr()) if kind == 1 else
               regions.VoronoiRegions(arr(k - (kind == 2), d)))
        packed = packed.set(i, fam)
    return packed


@pytest.mark.parametrize("q,n,D,d,k,fam,offset", [
    (1, 1000, 3, 2, 3, "voronoi", 0), (5, 257, 4, 2, 3, "mixed", 0),
    (1, 301, 34, 2, 3, "halfspace", 0), (5, 131, 37, 2, 3, "mixed", 0),
    (1, 200, 780, 2, 3, "voronoi", 0), (5, 67, 780, 2, 3, "mixed", 0),
    (1, 8, 5000, 2, 3, "padded-voronoi", 0), (5, 8, 5000, 2, 3, "mixed", 0),
    (5, 97, 37, 3, 243, "mixed", 0), (1, 150, 34, 4, 243, "voronoi", 0),
    (5, 131, 34, 4, 3, "mixed", 1), (1, 301, 34, 2, 3, "padded-voronoi", 1),
    (1, 64, 780, 4, 3, "halfspace", 1), (5, 40, 6, 16, 7, "mixed", 0),
    (1, 100, 34, 16, 243, "voronoi", 0),
    (1, 33, 3, 2, 243, "padded-voronoi", 0), (1, 300, 1, 2, 3, "voronoi", 0),
    (1, 31, 513, 3, 3, "padded-voronoi", 0),
    (1, 50, 300, 6, 3, "halfspace", 0), (5, 9, 1025, 2, 3, "mixed", 0)])
def test_lss_state_bitwise(dev, q, n, D, d, k, fam, offset):
    """The kernel equals its plain version bitwise on non-dyadic inputs:
    ``s_m`` / ``s_c`` with rtol = atol = 0, ``viol`` / ``dec`` everywhere,
    near ties included; on each of the kernel's paths and at their edges
    (rows of 1 to 4 slots, tiles with n not a multiple of a tile, rows of
    513 to 1,024 slots such as hubs of 780, rows of 1,025 and 5,000), with
    unaligned d-vectors, k = 243, d = 16; q = 5 takes mixed families,
    per-slot eps and a padding slot, q = 1 the unbatched call."""
    args = _state_inputs(q, n, D, d, seed=n * 31 + D + k, dev=dev,
                         offset=offset)
    if q == 1:
        args = tuple(a[0] for a in args)
        region = plain = _slot(fam, d, k, seed=k, dev=dev)
        eps = 1e-3
    else:
        plain = _mixed_slots(q, d, k, dev)
        eps = torch.tensor([1e-9, 1e-3, 0.5, 1e-9, 1e-9][:q], device=dev)
        region = ops.prep_slots(plain, eps)
    kernels.reset_counts()
    got = ops.lss_state(*args, region, eps=eps)
    want = ref.lss_state_ref(*args, plain, eps)
    assert kernels.counts()["lss_state"] == 1
    for name, g, w in zip(("s_m", "s_c", "viol", "dec"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))


def test_cuda_tensors_launch_kernels_only(dev):
    args = _inputs(300, 5, 2, seed=1, dev=dev)
    slot = _slot("voronoi", 2, 3, seed=1, dev=dev)
    kernels.reset_counts()
    s_m, s_c, viol, _ = ops.lss_state(*args, slot)
    ops.correction(s_m, s_c, args[2] + args[4], args[3] + args[5], args[4],
                   args[5], viol)
    get_suite("fused").decide(s_m, slot)
    assert kernels.counts() == {"region_decide": 1, "lss_state": 1,
                                "correction": 1, "region_decide_ref": 0,
                                "lss_state_ref": 0, "correction_ref": 0}


def test_launchers_check_their_inputs(dev):
    args = [a[None] for a in _inputs(64, 3, 2, seed=2, dev=dev)]
    table = [t[None] for t in ops.prep_slot(_slot("voronoi", 2, 3, seed=2,
                                                  dev=dev))]
    with pytest.raises(TypeError):
        k_state.launch(args[0].double(), *args[1:], *table)
    with pytest.raises(ValueError, match="contiguous"):
        k_state.launch(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                       *args[1:], *table)
    with pytest.raises(ValueError, match="on"):
        k_state.launch(args[0].cpu(), *args[1:], *table)
    with pytest.raises(ValueError, match="shape"):
        k_dec.launch(args[0], table[0], table[1], table[2][:, :3])
    big = [a[None] for a in _inputs(8, 2, k_state.MAX_D + 1, seed=3,
                                    dev=dev)]
    knob = torch.full((1,), 1e-3, device=dev)
    with pytest.raises(ValueError, match="d <="):
        k_corr.launch(big[0], big[1], big[2], big[3], big[4], big[5],
                      big[6], knob, knob)


@pytest.mark.parametrize("make", [lambda: topology.grid(256),
                                  lambda: topology.barabasi_albert(256, 2, 1),
                                  lambda: topology.chord(256)],
                         ids=["grid", "ba", "chord"])
@pytest.mark.parametrize("eps", [1e-9, 1e-3])
def test_run_static_on_card_matches_cpu(dev, make, eps):
    """The driver's prepared tables (cfg.eps for the cycles, the observe's
    own eps for metrics) give the CPU's records."""
    spec = sim.ProblemSpec(n=256)
    cfg = lss.LSSConfig(eps=eps)
    on_card = sim.run_static(make(), spec, cfg, max_cycles=300, device=dev)
    on_cpu = sim.run_static(make(), spec, cfg, max_cycles=300, device="cpu")
    for key in ("cycles_95", "cycles_100", "quiesced_at", "final_accuracy",
                "quiescent", "msgs_per_link"):
        assert on_card[key] == on_cpu[key], key


def _global_inputs(q, n, d, seed, dev, offset=0):
    """Non-dyadic (q, n, ...) inputs of the global decision: x_m normal,
    x_c in [0.5, 2), one peer in five dead; with q > 2 every peer of slot 2
    dead; slot 1 (a halfspace slot of ``_mixed_slots``, or the only slot)
    with unit weights and every peer alive, so that a threshold at the
    float32 mean of its inputs is a rounding tie.  ``offset`` > 0 puts x_m
    that many floats into its buffer, off 8- and 16-byte alignment."""
    rng = np.random.default_rng(seed)
    x_m = rng.standard_normal((q, n, d)).astype(np.float32)
    x_c = rng.uniform(0.5, 2.0, (q, n)).astype(np.float32)
    alive = rng.random((q, n)) >= 0.2
    tie = min(1, q - 1)
    x_c[tie] = 1.0
    alive[tie] = True
    if q > 2:
        alive[2] = False
    buf = torch.empty(x_m.size + offset, dtype=torch.float32, device=dev)
    t_m = buf[offset:].view(x_m.shape)
    t_m.copy_(torch.from_numpy(x_m))
    mean = x_m[tie].mean(0)  # numpy float32, as heterogeneous_tenants
    return (t_m, torch.tensor(x_c, device=dev), torch.tensor(alive,
                                                             device=dev),
            mean, tie)


@pytest.mark.parametrize("q,n,d,k,fam,offset", [
    (1, 80_000, 2, 3, "voronoi", 0), (64, 80_000, 2, 3, "mixed", 0),
    (1, 80_000, 2, 3, "mean-halfspace", 0), (1, 1000, 2, 3, "voronoi", 1),
    (5, 4097, 2, 3, "mixed", 0), (5, 4096, 3, 243, "mixed", 0),
    (5, 300, 16, 7, "mixed", 0), (1, 700, 6, 243, "padded-voronoi", 1),
    (5, 2049, 4, 3, "mixed", 1), (1, 1, 2, 3, "voronoi", 0)])
def test_global_decision_bitwise(dev, q, n, d, k, fam, offset):
    """The global decision equals its plain version: ``want`` equal and the
    rounded sums ``gx`` bitwise (rtol = atol = 0), on non-dyadic inputs;
    n off and on a multiple of a block's run, dead peers, an all-dead slot,
    a padding slot, per-slot eps (one large enough to take the guard),
    d = 16, k = 243, unaligned x_m, and a halfspace threshold at the float32
    mean of the inputs (the tie ``service.heterogeneous_tenants`` builds);
    q = 1 takes the unbatched call with one eps for the slot.  Two launches
    give the same bits."""
    x_m, x_c, alive, mean, tie = _global_inputs(q, n, d, seed=n + q + d,
                                                dev=dev, offset=offset)
    if q == 1:
        x_m, x_c, alive = x_m[0], x_c[0], alive[0]
        region = plain = _slot(fam if fam != "mean-halfspace" else "voronoi",
                               d, k, seed=k, dev=dev)
        eps = 1e-3
    else:
        plain = _mixed_slots(q, d, k, dev)
        eps = torch.tensor([1e-9, 1e-3, 0.5, 1e-9, 1e6] * (q // 5 + 1),
                           device=dev)[:q]
        region = ops.prep_slots(plain, eps)
    if fam != "voronoi" and fam != "padded-voronoi":  # a threshold at the mean
        w = np.random.default_rng(k).standard_normal(d).astype(np.float32)
        fam_t = regions.HalfspaceRegions(
            torch.tensor(w, device=dev),
            torch.tensor(np.float32(mean @ w), device=dev))
        if q == 1:
            region = plain = regions.as_packed_slot(fam_t)
        else:
            plain = plain.set(tie, fam_t)
            region = ops.prep_slots(plain, eps)
    kernels.reset_counts()
    got = ops.global_decision(x_m, x_c, alive, region, eps)
    again = ops.global_decision(x_m, x_c, alive, region, eps)
    assert kernels.counts()["region_decide"] == 2
    assert kernels.counts()["region_decide_ref"] == 0
    want = ref.global_decision_ref(x_m, x_c, alive, plain, eps)
    for name, g, a, w in zip(("want", "gx_m", "gx_c"), got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
        assert torch.equal(g, a), name


def test_observe_launches_global_decision_once(dev, monkeypatch):
    """A ``run_static`` cycle prepares no slot tables; one observe launches
    ``lss_state`` once and the global decision once (the second entry of
    ``region_decide``), and no plain version."""
    drv, _, _ = sim._driver(topology.grid(256), sim.ProblemSpec(n=256),
                            lss.LSSConfig(eps=1e-3), None, dev, None)

    def refuse(*args, **kwargs):
        raise AssertionError("prep_slots ran after the driver's set-up")

    monkeypatch.setattr(ops, "prep_slots", refuse)
    kernels.reset_counts()
    drv.advance(2)
    before = kernels.counts()
    assert before["region_decide"] == 0 and before["lss_state"] >= 2
    drv.observe()
    after = kernels.counts()
    assert after["region_decide"] == 1
    assert after["lss_state"] == before["lss_state"] + 1
    assert after["correction"] == before["correction"]
    assert not any(after[f"{k}_ref"] for k in
                   ("region_decide", "lss_state", "correction"))


def test_service_on_card_matches_cpu(dev):
    """The port's service through the kernels on the card gives the records
    of the same service on the CPU (plain versions of the same kernels)."""
    topo = topology.grid(64)
    rng = np.random.default_rng(4)
    specs = []
    for i in range(4):
        centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=64,
                                                                 seed=i))
        x = sample(rng, 64)
        region = (regions.VoronoiRegions(centers) if i % 2 == 0 else
                  regions.HalfspaceRegions(torch.tensor([1.0, -0.5]),
                                           torch.tensor(0.1)))
        specs.append(QuerySpec(region=region, inputs=x, seed=i,
                               beta=1e-3 * (1 + i), ell=1 + i % 2))
    runs = []
    for device in (dev, "cpu"):
        svc = Service(topo, ServiceConfig(capacity=6, k_max=3, d=2,
                                          cycles_per_dispatch=5,
                                          use_kernels=True), device=device)
        for spec in specs:
            svc.admit(spec)
        kernels.reset_counts()
        runs.append([svc.tick() for _ in range(4)])
        if device == dev:
            counts = kernels.counts()
            assert counts["lss_state"] > 0 and counts["correction"] > 0
            assert counts["region_decide"] == 4  # one per observe
            assert counts["lss_state_ref"] == counts["correction_ref"] == 0
    assert runs[0] == runs[1]


def _churn_records(device, use_kernels, specs, dispatches=8):
    """A service on a DynTopology (grid 1,024, 8 spare rows, auto-regrow)
    under six seeded events a dispatch (joins with a link, leaves, unlinks
    of live edges, links) and a ``grow_capacity`` of the degree slots at
    dispatch 4.  Returns (records, epochs, launch counts)."""
    dyn = topology.DynTopology.from_topology(topology.grid(1024),
                                             n_cap=1032, deg_cap=6)
    cfg = ServiceConfig(capacity=4, k_max=3, d=2, cycles_per_dispatch=4,
                        use_kernels=use_kernels,
                        control=ControlPlaneConfig(auto_regrow=True))
    with Service(dyn, cfg, device=device) as svc:
        for spec in specs:
            svc.admit(spec)
        rng = np.random.default_rng(7)
        kernels.reset_counts()
        records = []
        for i in range(dispatches):
            if i == 4:
                svc.grow_capacity(deg_cap=svc.topo.deg_cap + 3)
            for _ in range(6):
                op = rng.choice([0, 0, 0, 1, 2, 3])
                topo = svc.topo
                a, b = (int(p) for p in rng.choice(
                    np.flatnonzero(topo.present), 2, replace=False))
                try:
                    if op == 0:
                        p = svc.join_peer(value=rng.normal(size=2))
                        svc.link_peers(p, a)
                    elif op == 1:
                        svc.leave_peer(a)
                    elif op == 2:
                        live = topo.nbr[a][topo.mask[a]]
                        if live.size:
                            svc.unlink_peers(a, int(live[0]))
                    else:
                        svc.link_peers(a, b)
                except ValueError:
                    pass
            records.append(svc.tick())
        return (records, [e["kind"] for e in svc.capman.epochs],
                kernels.counts())


def test_service_churn_fused_matches_reference(dev):
    """Membership churn with a regrow of the rows and of the degree slots:
    the kernels on the card give the reference suite's records on the
    card, and the CPU's plain versions of the kernels give them too."""
    centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=1032, seed=0))
    rng = np.random.default_rng(1)
    specs = [QuerySpec(region=regions.VoronoiRegions(centers),
                       inputs=sample(rng, 1032), seed=i) for i in range(4)]
    fused, epochs, counts = _churn_records(dev, True, specs)
    assert epochs.count("regrow") >= 2  # the rows' wall and the slots'
    assert counts["lss_state"] > 0 and counts["correction"] > 0
    assert counts["region_decide"] == len(fused)  # one per observe
    assert counts["lss_state_ref"] == counts["correction_ref"] == 0
    plain = _churn_records(dev, False, specs)
    assert plain[0] == fused and plain[1] == epochs
    assert _churn_records("cpu", True, specs)[0] == fused


def _engine_service_records(device, use_kernels, specs, backend="engine",
                            dispatches=8):
    """A service on a DynTopology (grid 3,025, 8 spare rows, auto-regrow;
    on the engine backend S = 4) under six seeded events a dispatch (joins
    with a link, leaves, unlinks of live edges, links), a
    ``grow_capacity`` of the degree slots at dispatch 3 and a forced
    rebalance at dispatch 5.  Returns (records, epochs, launch counts)."""
    dyn = topology.DynTopology.from_topology(topology.grid(3025),
                                             n_cap=3033, deg_cap=6)
    cfg = ServiceConfig(capacity=4, k_max=3, d=2, cycles_per_dispatch=4,
                        use_kernels=use_kernels, backend=backend,
                        engine_shards=4,
                        control=ControlPlaneConfig(auto_regrow=True))
    with Service(dyn, cfg, device=device) as svc:
        for spec in specs:
            svc.admit(spec)
        rng = np.random.default_rng(11)
        kernels.reset_counts()
        records = []
        for i in range(dispatches):
            if i == 3:
                svc.grow_capacity(deg_cap=svc.topo.deg_cap + 2)
            if i == 5:
                svc.rebalance_now()
            _six_events(svc, rng)
            records.append(svc.tick())
        return (records, [e["kind"] for e in svc.capman.epochs],
                kernels.counts())


def _six_events(svc, rng):
    """Six seeded membership events: joins with a link, leaves, unlinks of
    live edges, links."""
    for _ in range(6):
        op = rng.choice([0, 0, 0, 1, 2, 3])
        topo = svc.topo
        a, b = (int(p) for p in rng.choice(
            np.flatnonzero(topo.present), 2, replace=False))
        try:
            if op == 0:
                p = svc.join_peer(value=rng.normal(size=2))
                svc.link_peers(p, a)
            elif op == 1:
                svc.leave_peer(a)
            elif op == 2:
                live = topo.nbr[a][topo.mask[a]]
                if live.size:
                    svc.unlink_peers(a, int(live[0]))
            else:
                svc.link_peers(a, b)
        except ValueError:
            pass


def test_engine_service_churn_fused_matches_reference(dev):
    """The engine-backed service (Q = 4 tenants stacked on the sharded
    state, S = 4) under churn through a regrow of the rows and of the
    degree slots and a rebalance: the kernels on the card give the
    reference suite's records on the card, the CPU's plain versions give
    them too, and so does the core backend on the card; each kernel
    launches as often as on the core backend (once a step for all
    tenants)."""
    centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=3033, seed=0))
    rng = np.random.default_rng(1)
    specs = [QuerySpec(region=regions.VoronoiRegions(centers),
                       inputs=sample(rng, 3033), seed=i) for i in range(4)]
    fused, epochs, counts = _engine_service_records(dev, True, specs)
    assert epochs.count("regrow") >= 2 and "rebalance" in epochs
    assert counts["region_decide"] == len(fused)  # one per observe
    assert counts["lss_state"] > 0 and counts["correction"] > 0
    assert counts["lss_state_ref"] == counts["correction_ref"] == 0
    plain = _engine_service_records(dev, False, specs)
    assert plain[0] == fused and plain[1] == epochs
    assert _engine_service_records("cpu", True, specs)[0] == fused
    core, _, core_counts = _engine_service_records(dev, True, specs,
                                                   backend="core")
    assert core == fused
    assert all(core_counts[k] == counts[k]
               for k in ("lss_state", "correction", "region_decide"))


def _overlap_service_records(device, use_kernels, specs, overlap,
                             dispatches=8):
    """The engine-backed service (S = 4, grid 4,096 with 8 spare rows,
    auto-regrow) under six seeded events a dispatch and a forced
    rebalance after dispatch 5, with or without the overlapped boundary;
    overlapped, the regrow adopts the build that ``_maybe_stage_growth``
    staged (waited for after each tick).  Returns (the records in
    dispatch order, the epochs as (kind, staged), launch counts)."""
    dyn = topology.DynTopology.from_topology(topology.grid(4096),
                                             n_cap=4104, deg_cap=6)
    cfg = ServiceConfig(capacity=4, k_max=3, d=2, cycles_per_dispatch=4,
                        use_kernels=use_kernels, backend="engine",
                        engine_shards=4, overlap=overlap,
                        control=ControlPlaneConfig(auto_regrow=True))
    with Service(dyn, cfg, device=device) as svc:
        for spec in specs:
            svc.admit(spec)
        rng = np.random.default_rng(5)
        kernels.reset_counts()
        records = []
        for i in range(dispatches):
            if i == 5:
                svc.rebalance_now()
            _six_events(svc, rng)
            records += svc.tick()
            for entry in svc._staged.values():
                entry[0].take()
        records += svc.flush()
        return (records, [(e["kind"], e.get("staged"))
                          for e in svc.capman.epochs], kernels.counts())


def test_overlapped_engine_service_fused_matches_reference(dev):
    """The overlapped engine-backed service (Q = 4, S = 4, grid 4,096)
    under churn through a staged regrow and a rebalance: the kernels on
    the card give the reference suite's records on the card, the same
    records when the service is driven from a side stream, the
    synchronous service's records on the card (with the same launches)
    and the CPU's."""
    centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=4104, seed=0))
    rng = np.random.default_rng(2)
    specs = [QuerySpec(region=regions.VoronoiRegions(centers),
                       inputs=sample(rng, 4104), seed=i) for i in range(4)]
    fused, epochs, counts = _overlap_service_records(dev, True, specs, True)
    assert len(fused) == 32 and ("regrow", True) in epochs
    assert ("rebalance", False) in epochs
    assert counts["region_decide"] == 8  # one per observe
    assert counts["lss_state_ref"] == counts["correction_ref"] == 0
    plain = _overlap_service_records(dev, False, specs, True)
    assert plain[0] == fused and plain[1] == epochs
    # The worker runs on the launching thread's stream, not its own
    # thread's default one.
    with torch.cuda.stream(torch.cuda.Stream()):
        side = _overlap_service_records(dev, True, specs, True)
    assert side[0] == fused and side[1] == epochs
    sync, sync_epochs, sync_counts = _overlap_service_records(
        dev, True, specs, False)
    assert sync == fused and [k for k, _ in sync_epochs] == \
        [k for k, _ in epochs]
    assert all(sync_counts[k] == counts[k]
               for k in ("lss_state", "correction", "region_decide"))
    assert _overlap_service_records("cpu", True, specs, True)[0] == fused


def _engine_runs(dev, topo, use_kernels, cycles=30):
    """(engine, per-dispatch states) of a 3-shard engine on the card,
    K = 5, from ``run_static``'s problem."""
    from repro_torch.engine import EngineConfig, ShardedLSS

    centers, _, _, inputs = sim._setup(topo, sim.ProblemSpec(n=topo.n), dev)
    eng = ShardedLSS(topo, centers, lss.LSSConfig(),
                     EngineConfig(num_shards=3, cycles_per_dispatch=5,
                                  use_kernels=use_kernels), device=dev)
    st = eng.init(inputs, seed=0)
    states = []
    for _ in range(cycles // 5):
        st = eng.run(st, 5)
        states.append((eng.to_lss_state(st), eng.metrics(st)))
    return eng, states


def _assert_states_equal(got, want, msg):
    for name in lss.LSSState._fields:
        if name != "rng":
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                f"{msg}: {name}"


@pytest.mark.parametrize("make", [lambda: topology.grid(3025),
                                  lambda: topology.chord(3000),
                                  lambda: topology.barabasi_albert(
                                      3000, m=2, seed=1)],
                         ids=["grid", "chord", "ba"])
def test_engine_fused_matches_reference_and_core(dev, make):
    """The engine through the kernels equals the engine through the
    reference formulas and the core loop through the kernels, on every
    state field and the metrics, dispatch by dispatch (S = 3)."""
    topo = make()
    kernels.reset_counts()
    eng, fused = _engine_runs(dev, topo, None)
    counts = kernels.counts()
    assert eng.suite.name == "fused"
    assert min(counts[k] for k in ("lss_state", "correction",
                                   "region_decide")) > 0
    assert not any(counts[f"{k}_ref"] for k in ("lss_state", "correction",
                                                "region_decide"))
    _, plain = _engine_runs(dev, topo, False)
    centers, _, _, inputs = sim._setup(topo, sim.ProblemSpec(n=topo.n), dev)
    ta = lss.TopoArrays.from_topology(topo, dev)
    core = lss.init_state(ta, inputs, seed=0)
    suite = get_suite("fused")
    for i, ((f_st, f_m), (p_st, p_m)) in enumerate(zip(fused, plain)):
        for _ in range(5):
            core, _ = lss.cycle(core, ta, centers, lss.LSSConfig(),
                                suite=suite)
        _assert_states_equal(f_st, p_st, f"dispatch {i} fused/reference")
        _assert_states_equal(f_st, core, f"dispatch {i} engine/core")
        c_m = lss.metrics(core, ta, centers, suite=suite)
        for a, b, c in zip(f_m, p_m, c_m):
            assert torch.equal(a, b) and torch.equal(a, c), f"dispatch {i}"


def test_engine_opaque_decide_on_the_card_needs_the_plain_suite(dev):
    """On a CUDA device the auto suite is the fused one, which cannot honor
    an opaque ``decide``: the engine raises rather than run the plain
    formulas on the card, and runs them only when asked to."""
    from repro_torch.engine import EngineConfig, ShardedLSS

    topo = topology.grid(144)
    centers, _, _, inputs = sim._setup(topo, sim.ProblemSpec(n=topo.n), dev)
    custom = lambda v: (v[..., 0] > 0).to(torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="opaque"):
        ShardedLSS(topo, centers, decide=custom, device=dev)
    eng = ShardedLSS(topo, centers, ecfg=EngineConfig(use_kernels=False),
                     decide=custom, device=dev)
    assert eng.suite.name == "reference" and not eng.use_kernels
    st = eng.run(eng.init(inputs), 8)
    assert int(eng.total_msgs(st)) > 0


@pytest.mark.parametrize("kw", [dict(async_mode=True, staleness=2),
                                dict(wire="int8")], ids=["async2", "int8"])
@pytest.mark.parametrize("make", [lambda: topology.grid(4096),
                                  lambda: topology.barabasi_albert(
                                      4096, m=2, seed=1)],
                         ids=["grid", "ba"])
def test_async_and_int8_engines_fused_match_reference(dev, make, kw):
    """The bounded-staleness (staleness 2) and int8 engines through the
    kernels equal the same engines through the reference formulas on
    every field (books, ring and error feedback included) and the
    metrics, dispatch by dispatch: the delay draws come from the same
    seeded generators in both."""
    from repro_torch import convert
    from repro_torch.engine import EngineConfig, ShardedLSS

    topo = make()
    centers, _, _, inputs = sim._setup(topo, sim.ProblemSpec(n=topo.n), dev)
    runs = {}
    for use_kernels in (None, False):
        kernels.reset_counts()
        eng = ShardedLSS(topo, centers, lss.LSSConfig(),
                         EngineConfig(num_shards=4, cycles_per_dispatch=5,
                                      use_kernels=use_kernels, **kw),
                         device=dev)
        st = eng.init(inputs, seed=0)
        runs[use_kernels] = []
        for _ in range(6):
            st = eng.run(st, 5)
            runs[use_kernels].append((convert.state_to_numpy(st),
                                      eng.metrics(st)))
        counts = kernels.counts()
        keys = ("lss_state", "correction", "region_decide")
        if use_kernels is None:
            assert eng.suite.name == "fused"
            assert min(counts[k] for k in keys) > 0
            assert not any(counts[f"{k}_ref"] for k in keys)
        else:
            assert not any(counts[k] for k in keys)
    for i, ((f_st, f_m), (p_st, p_m)) in enumerate(zip(runs[None],
                                                       runs[False])):
        f_st, p_st = ({**f.pop("sync", {}), **f} for f in (f_st, p_st))
        assert f_st.keys() == p_st.keys()
        for name, a in f_st.items():
            assert np.array_equal(a, p_st[name]), f"dispatch {i}: {name}"
        for a, b in zip(f_m, p_m):
            assert torch.equal(a, b), f"dispatch {i}"


VERDICT = ("dispatch", "t", "query", "slot", "ok", "violations", "monitors",
           "quiescent", "claimed_quiescent", "edge_bad", "edge_checked",
           "stop_bad", "msgs", "live_slots")


def _audited_service_records(device, use_kernels, specs, backend,
                             overlap=False, profile=False, audit_every=1,
                             dispatches=8):
    """The churned service of ``_overlap_service_records`` (grid 4,096
    with 8 spare rows, auto-regrow, six seeded events a dispatch, a
    ``grow_capacity`` of the degree slots at dispatch 3 and, on the engine
    backend, a forced rebalance at dispatch 5) with the audit plane on
    every ``audit_every``-th window.  Returns (records, audit records'
    verdicts and integer reductions, launch counts, the tracker)."""
    from repro_torch.obs import InMemoryTracker

    dyn = topology.DynTopology.from_topology(topology.grid(4096),
                                             n_cap=4104, deg_cap=6)
    cfg = ServiceConfig(capacity=4, k_max=3, d=2, cycles_per_dispatch=4,
                        use_kernels=use_kernels, backend=backend,
                        engine_shards=4, overlap=overlap,
                        profile_dispatch=profile, audit_every=audit_every,
                        control=ControlPlaneConfig(auto_regrow=True))
    tr = InMemoryTracker()
    with Service(dyn, cfg, tracker=tr, device=device) as svc:
        for spec in specs:
            svc.admit(spec)
        rng = np.random.default_rng(5)
        kernels.reset_counts()
        records = []
        for i in range(dispatches):
            if i == 3:
                svc.grow_capacity(deg_cap=svc.topo.deg_cap + 2)
            if i == 5 and backend == "engine":
                svc.rebalance_now()
            _six_events(svc, rng)
            records += svc.tick()
            for entry in svc._staged.values():
                entry[0].take()
        records += svc.flush()
        counts = kernels.counts()
    audits = [{k: r.get(k) for k in VERDICT} for r in tr.records
              if r.get("kind") == "audit"]
    return records, audits, counts, tr


@pytest.mark.parametrize("backend,overlap", [("core", False),
                                             ("engine", False),
                                             ("engine", True)],
                         ids=["core", "engine", "engine-overlap-profiled"])
def test_audited_service_churn_fused_matches_reference(dev, backend,
                                                       overlap):
    """The audit plane on the churned service (grid 4,096, Q = 4, a regrow
    of the degree slots, on the engine a rebalance; overlapped and
    profiled once): the kernels on the card give the reference suite's
    records and audit verdicts on the card and the CPU's; every clean
    audit holds; the audit launches no kernel (the counts of the
    unaudited service)."""
    centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=4104, seed=0))
    rng = np.random.default_rng(2)
    specs = [QuerySpec(region=regions.VoronoiRegions(centers),
                       inputs=sample(rng, 4104), seed=i) for i in range(4)]
    kw = dict(backend=backend, overlap=overlap, profile=overlap)
    fused, audits, counts, tr = _audited_service_records(dev, True, specs,
                                                         **kw)
    assert len(fused) == 32 and len(audits) == 32
    assert all(a["ok"] for a in audits), [a for a in audits if not a["ok"]]
    assert counts["region_decide"] == 8  # one per observe
    assert counts["lss_state_ref"] == counts["correction_ref"] == 0
    plain = _audited_service_records(dev, False, specs, **kw)
    assert plain[0] == fused and plain[1] == audits
    off = _audited_service_records(dev, True, specs, audit_every=0, **kw)
    assert off[0] == fused and off[1] == []
    assert all(off[2][k] == counts[k]
               for k in ("lss_state", "correction", "region_decide"))
    cpu = _audited_service_records("cpu", True, specs, **kw)
    assert cpu[0] == fused and cpu[1] == audits
    if overlap:
        frac = tr.registry.gauge("host_overhead_frac").value(
            backend=backend)
        assert frac is not None and 0.0 <= frac <= 1.0
