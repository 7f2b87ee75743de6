"""The port's halo wires (``repro_torch.engine.exchange`` and
``repro_torch.distributed.compression``) against the JAX package's.

The quantizers are held BITWISE to JAX on the same numpy buffers: the
int8 codes, per-link scales, error buffers and both decodes, and the bf16
encode and decode (``torch.round`` and ``jnp.round`` both round half to
even; the casts round to nearest even).  The engine on a quantized wire
is held to JAX cycle by cycle, each cycle stepped from JAX's own state:
ints and bools exactly, floats at rtol = atol = 1e-5, and the received
halo values and error buffers within one quantum where an int8 code
flipped (the halo values themselves are only ``allclose`` across the two
frameworks, and one ulp at a rounding boundary moves a code by one).
Free-running quantized trajectories are compared by their ``run_static``
results, not field by field.  The mesh, audit, autotune and
service-engine cases of ``tests/test_wire.py`` belong to ROADMAP A.5,
A.7, A.8 and A.6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lss as j_lss
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro.distributed import compression as j_comp
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import ShardedLSS as JShardedLSS
from repro.engine import exchange as j_ex
from repro.engine import partition as j_part
from repro_torch import convert
from repro_torch.core import lss as t_lss
from repro_torch.core import sim as t_sim
from repro_torch.core import topology as t_top
from repro_torch.distributed import compression as t_comp
from repro_torch.engine import EngineConfig, ShardedLSS
from repro_torch.engine import exchange as t_ex
from repro_torch.obs import InMemoryTracker
from test_torch_formulas import TOL, assert_close, assert_exact

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hermetic container: seeded fallback shim
    from _hypothesis_fallback import given, settings, strategies as st

TOPOS = {"grid": lambda m: m.grid(100),
         "ba": lambda m: m.barabasi_albert(100, m=2, seed=0)}
STATIC_KEYS = ("n", "cycles_95", "cycles_100", "quiesced_at",
               "final_accuracy", "quiescent", "msgs_per_link", "total_msgs",
               "engine_shards", "cut_edges")
FLOATS = ("out_m", "out_c", "in_m", "in_c", "x_m", "x_c")


def _rand_halo(seed, S=3, H=11, d=2, ragged=True, err=True):
    """Random (S, S, H[, d]) halo buffers, flags and error buffers as numpy;
    ``ragged`` zeroes each pair's flags past its own random width."""
    rng = np.random.default_rng(seed)
    buf_m = rng.normal(size=(S, S, H, d)).astype(np.float32) * 10
    buf_c = rng.normal(size=(S, S, H)).astype(np.float32)
    flag = rng.random((S, S, H)) < 0.6
    if ragged:
        widths = rng.integers(0, H + 1, size=(S, S))
        flag &= np.arange(H)[None, None, :] < widths[:, :, None]
    errs = ((rng.normal(size=buf_m.shape).astype(np.float32),
             rng.normal(size=buf_c.shape).astype(np.float32)) if err
            else (None, None))
    return buf_m, buf_c, flag, errs


def _both(arrays):
    """(JAX arrays, torch tensors) of numpy arrays (None stays None)."""
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.tensor(a) for a in arrays])


def _assert_bitwise(got, want, what=""):
    """Equal values (signed zeros aside) and equal dtypes."""
    want = np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16
                      else want)
    got = (got.to(torch.float32) if got.dtype == torch.bfloat16
           else got).numpy()
    assert got.dtype == want.dtype, what
    assert_exact(got, want, what)


# ---------------------------------------------------------------------------
# the quantizers, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("err", [False, True], ids=["no-err", "err"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("S,H,d", [(3, 11, 2), (2, 1, 1), (4, 17, 5)])
def test_quantize_halo_bitwise(S, H, d, ragged, err):
    bufs = _rand_halo(S * 100 + H + d, S, H, d, ragged, err)
    (jm, jc, jf, jem, jec), (tm, tc, tf, tem, tec) = _both(
        [*bufs[:3], *bufs[3]])
    jpack, j_em, j_ec = j_comp.quantize_halo(jm, jc, jf, jem, jec)
    tpack, t_em, t_ec = t_comp.quantize_halo(tm, tc, tf, tem, tec)
    assert tpack.q_m.dtype == torch.int8 and tpack.scale_m.shape == (S, S)
    for name, g, w in zip((*t_comp.HaloQuantPack._fields, "err_m", "err_c"),
                          (*tpack, t_em, t_ec), (*jpack, j_em, j_ec)):
        _assert_bitwise(g, w, name)
    for g, w in zip(t_comp.dequantize_halo(*tpack),
                    j_comp.dequantize_halo(*jpack)):
        _assert_bitwise(g, w, "dequantize")


@pytest.mark.parametrize("wire", ["exact", "compact", "int8", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_encode_decode_bitwise(wire, seed):
    """Every wire's payload, error buffers and decode equal JAX's."""
    bufs = _rand_halo(seed, err=seed > 0)
    (jm, jc, jf, jem, jec), (tm, tc, tf, tem, tec) = _both(
        [*bufs[:3], *bufs[3]])
    jw, tw = j_ex.get_wire(wire), t_ex.get_wire(wire)
    jpay, j_em, j_ec = jw.encode(jm, jc, jf, jem, jec)
    tpay, t_em, t_ec = tw.encode(tm, tc, tf, tem, tec)
    assert len(tpay) == len(jpay)
    for g, w in zip(tpay, jpay):
        _assert_bitwise(g, w, f"{wire} payload")
    for g, w in ((t_em, j_em), (t_ec, j_ec)):
        assert (g is None) == (w is None)
        if g is not None:
            _assert_bitwise(g, w, f"{wire} error")
    for g, w in zip(tw.decode(tpay), jw.decode(jpay)):
        _assert_bitwise(g, w, f"{wire} decode")
    assert (tw.lossy, tw.stateful, tw.trims, tw.quant_eps) == \
        (jw.lossy, jw.stateful, jw.trims, jw.quant_eps)


@pytest.mark.parametrize("seed", [0, 3])
def test_int8_and_topk_compress_bitwise(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(7, 13)).astype(np.float32) * 3
    err = rng.normal(size=x.shape).astype(np.float32) * 0.1
    for e in (None, err):
        (jx, je), (tx, te) = _both([x, e])
        jpack, jerr = j_comp.int8_compress(jx, je)
        tpack, terr = t_comp.int8_compress(tx, te)
        for g, w in ((tpack.q, jpack.q), (tpack.scale, jpack.scale),
                     (terr, jerr)):
            _assert_bitwise(g, w, "int8_compress")
        _assert_bitwise(t_comp.int8_decompress(tpack),
                        j_comp.int8_decompress(jpack), "int8_decompress")
        for frac in (0.01, 0.2):
            for g, w in zip(t_comp.topk_compress(tx, te, frac),
                            j_comp.topk_compress(jx, je, frac)):
                _assert_bitwise(g, w, f"topk {frac}")


def _check_int8_roundtrip_error_bound(seed):
    """|dequantize(q) - (x + err)| <= scale/2 per component, and its
    relative form ``quant_eps * max|x|`` per link, each up to one float32
    rounding of the value (``np.spacing``): the decode rounds ``q *
    scale`` once, which can miss by up to an ulp of x where a component
    sits on a quantum's half-way point."""
    buf_m, buf_c, flag, (err_m, err_c) = _rand_halo(seed)
    pack, _, _ = t_comp.quantize_halo(*map(torch.tensor, (
        buf_m, buf_c, flag, err_m, err_c)))
    deq_m, deq_c = (a.numpy() for a in t_comp.dequantize_halo(*pack))
    xm = np.where(flag[..., None], buf_m + err_m, 0.0)
    xc = np.where(flag, buf_c + err_c, 0.0)
    half_m = pack.scale_m.numpy()[..., None, None] / 2
    half_c = pack.scale_c.numpy()[..., None] / 2
    assert (np.abs(deq_m - xm) <= half_m + np.spacing(np.abs(xm))).all()
    assert (np.abs(deq_c - xc) <= half_c + np.spacing(np.abs(xc))).all()
    eps = t_ex.get_wire("int8").quant_eps
    big = np.abs(xm).max(axis=(-2, -1))
    assert (np.abs(deq_m - xm).max(axis=(-2, -1))
            <= eps * big + np.spacing(big)).all()


@settings(max_examples=15, deadline=None, database=None)
@given(st.integers(0, 2**16))
def test_int8_roundtrip_error_bound(seed):
    _check_int8_roundtrip_error_bound(seed)


@pytest.mark.parametrize("seed", [326, 5829, 7992, 15562, 18275])
def test_int8_roundtrip_error_bound_at_rounding_boundary(seed):
    """Seeds whose dequantized component misses x by more than scale/2
    (by under one ulp of x): the bound's rounding allowance, every run."""
    _check_int8_roundtrip_error_bound(seed)


@settings(max_examples=15, deadline=None, database=None)
@given(st.integers(0, 2**16))
def test_bf16_roundtrip_error_bound(seed):
    """Flagged components obey the 2^-8 relative bound; unflagged entries
    are never scattered, so they are exempt."""
    buf_m, buf_c, flag, _ = _rand_halo(seed, err=False)
    wire = t_ex.get_wire("bf16")
    payload, _, _ = wire.encode(*map(torch.tensor, (buf_m, buf_c, flag)))
    out_m, out_c, out_f = (a.numpy() for a in wire.decode(payload))
    fm = np.broadcast_to(flag[..., None], buf_m.shape)
    assert (np.abs(out_m[fm] - buf_m[fm])
            <= wire.quant_eps * np.abs(buf_m[fm]) + 1e-7).all()
    assert (np.abs(out_c[flag] - buf_c[flag])
            <= wire.quant_eps * np.abs(buf_c[flag]) + 1e-7).all()
    assert np.array_equal(out_f, flag)


def test_wire_registry():
    assert set(t_ex.WIRE_FORMATS) == set(j_ex.WIRE_FORMATS) == \
        {"exact", "compact", "int8", "bf16"}
    with pytest.raises(ValueError, match="zstd"):
        t_ex.get_wire("zstd")


@pytest.mark.parametrize("wire", ["exact", "compact", "int8", "bf16"])
def test_pair_bytes_on_engine_tables_match_jax(wire):
    """Each wire's byte model on a real partition's occupancy tables (BA,
    4 shards, slack 1.5) equals JAX's; compact < exact and int8 < bf16 <
    compact on every active pair."""
    jt = j_top.barabasi_albert(300, m=2, seed=2)
    st_ = j_part.shard_topology(jt, j_part.make_partition(jt, 4),
                                halo_slack=1.5)
    counts = np.asarray(st_.halo.send_ok).sum(axis=-1)
    width = st_.halo_width
    got = {w: t_ex.get_wire(w).pair_bytes(counts, width, 2)
           for w in t_ex.WIRE_FORMATS}
    assert_exact(got[wire], j_ex.get_wire(wire).pair_bytes(counts, width, 2))
    active = counts > 0
    np.fill_diagonal(active, False)
    assert (got["int8"][active] < got["bf16"][active]).all()
    assert (got["bf16"][active] < got["compact"][active]).all()
    assert (got["compact"][active] < got["exact"][active]).all()


# ---------------------------------------------------------------------------
# the engine on a quantized wire
# ---------------------------------------------------------------------------


def _problem(topo, seed):
    spec = t_sim.ProblemSpec(n=topo.n, seed=seed)
    centers, _, _, inputs = t_sim._setup(topo, spec, "cpu")
    return centers, inputs


def _engine(topo, wire, seed=0, drop=0.0, **ecfg_kw):
    centers, inputs = _problem(topo, seed)
    eng = ShardedLSS(topo, centers, t_lss.LSSConfig(drop_rate=drop),
                     EngineConfig(num_shards=4, cycles_per_dispatch=4,
                                  halo_slack=1.5, wire=wire, **ecfg_kw),
                     device="cpu")
    return eng, eng.init(inputs, seed=seed)


def _jax_engine(topo, wire, seed=0, **ecfg_kw):
    spec = j_sim.ProblemSpec(n=topo.n, seed=seed)
    centers, sample, _, _ = j_sim.make_problem(spec)
    x = sample(np.random.default_rng(seed + 1), topo.n)
    inputs = j_wvs.from_vector(jnp.asarray(x),
                               jnp.ones((topo.n,), jnp.float32))
    eng = JShardedLSS(topo, centers, j_lss.LSSConfig(),
                      JEngineConfig(num_shards=4, cycles_per_dispatch=4,
                                    halo_slack=1.5, wire=wire, **ecfg_kw))
    return eng, eng.init(inputs, seed=seed)


def _jax_fields(state):
    """A JAX engine state's fields as numpy, generators and ``None``s
    dropped (an async state's sync fields under ``"sync"``)."""
    return {f: (_jax_fields(v) if f == "sync" else np.asarray(v))
            for f, v in state._asdict().items()
            if f != "rng" and v is not None}


def _quantum(fields):
    """An upper bound on every link's int8 scale in the next cycle's
    encode: ``(max|out| + max|err|) / 127`` over moments and weights."""
    mx = max(np.abs(fields["out_m"]).max(), np.abs(fields["out_c"]).max())
    er = max(np.abs(fields["wire_err_m"]).max(),
             np.abs(fields["wire_err_c"]).max())
    return (mx + er) / 127.0


QUANTIZED = ("in_m", "in_c", "wire_err_m", "wire_err_c", "ring_m", "ring_c")


def _compare_quantized(got, want, quantum, msg):
    """Floats close, ints exact; received halo values, the ring and the
    error feedback within one quantum where they are not close.  Returns
    the number of such flips."""
    flips = 0
    for name, w in want.items():
        g = got[name]
        if name == "sync":
            flips += _compare_quantized(g, w, quantum, msg)
        elif name in QUANTIZED:
            off = ~np.isclose(g, w, **TOL)
            flips += int(off.sum())
            assert (np.abs(g - w)[off] <= quantum * 1.001).all(), \
                f"{msg}: {name} beyond one quantum"
        elif name in FLOATS:
            assert_close(g, w, f"{msg}: {name}")
        else:
            assert_exact(g, w, f"{msg}: {name}")
    return flips


@pytest.mark.parametrize("wire,mode", [("int8", "sync"), ("bf16", "sync"),
                                       ("int8", "async")])
def test_quantized_cycles_from_jax_state(wire, mode, capsys):
    """Load JAX's state after each cycle, step the port one cycle, compare
    (async: staleness 0, the ring's books too)."""
    kw = dict(async_mode=True, staleness=0) if mode == "async" else {}
    jt, tt = j_top.grid(100), t_top.grid(100)
    jeng, jst = _jax_engine(jt, wire, seed=1, **kw)
    teng, _ = _engine(tt, wire, seed=1, **kw)
    if mode == "async":
        j_cycle, t_cycle = jax.jit(jeng._cycle_async), teng._cycle_async
        load = convert.async_state_from_jax_numpy
    else:
        j_cycle, t_cycle = jax.jit(jeng._cycle_full), teng._cycle_full
        load = convert.sharded_state_from_jax_numpy
    flips = 0
    for c in range(40):
        fields = _jax_fields(jst)
        sync = fields.get("sync", fields)
        quantum = (_quantum(sync) if wire == "int8"
                   else 2.0 ** -8 * max(np.abs(sync["out_m"]).max(), 1.0))
        tst = t_cycle(load(fields, "cpu"), teng._tables)
        jst = j_cycle(jst, jeng._tables)
        flips += _compare_quantized(convert.state_to_numpy(tst),
                                    _jax_fields(jst), quantum, f"cycle {c}")
    err = np.asarray((jst.sync if mode == "async" else jst).wire_err_m)
    assert np.abs(err).max() > 0  # the debt is real
    with capsys.disabled():
        print(f"\n[{wire} {mode}] quantum flips over 40 cycles: {flips}")


@pytest.mark.parametrize("wire", ["int8", "bf16"])
@pytest.mark.parametrize("topo_name", list(TOPOS))
def test_quantized_run_static_matches_jax(topo_name, wire):
    """fig3-style workloads: the quantized wire reaches the exact wire's
    decisions (accuracy 1.0, quiescent) with JAX's results."""
    import repro.engine as j_engine
    import repro_torch.engine as t_engine

    jt, tt = TOPOS[topo_name](j_top), TOPOS[topo_name](t_top)
    res = {}
    for name, mod, sim_mod, top, extra in (
            ("jax", j_engine, j_sim, jt, {}),
            ("port", t_engine, t_sim, tt, {"device": "cpu"})):
        for w in ("exact", wire):
            res[name, w] = sim_mod.run_static(
                top, sim_mod.ProblemSpec(n=top.n, seed=3), max_cycles=400,
                engine=mod.EngineConfig(num_shards=4, cycles_per_dispatch=4,
                                        wire=w), **extra)
    got = res["port", wire]
    assert got["final_accuracy"] == res["port", "exact"]["final_accuracy"] \
        == 1.0
    assert got["quiescent"]
    for key in STATIC_KEYS:
        assert got[key] == res["jax", wire][key], key


def test_int8_converges_under_message_loss():
    """Quantization composes with message drops (fig4-style)."""
    topo = t_top.grid(100)
    spec = t_sim.ProblemSpec(n=topo.n, seed=4)
    r = t_sim.run_static(topo, spec, cfg=t_lss.LSSConfig(drop_rate=0.2),
                         max_cycles=600, device="cpu",
                         engine=EngineConfig(num_shards=4,
                                             cycles_per_dispatch=4,
                                             wire="int8"))
    assert r["final_accuracy"] == 1.0


def test_int8_with_async_staleness():
    """Error feedback updates at the sender's publish, so it survives
    bounded-staleness delivery under loss."""
    eng, st_ = _engine(t_top.grid(100), "int8", seed=2, drop=0.1,
                       async_mode=True, staleness=2)
    st_ = eng.run(st_, 120)
    assert float(eng.metrics(st_)[0]) == 1.0
    assert st_.sync.wire_err_m is not None
    assert float(st_.sync.wire_err_m.abs().max()) > 0


def test_int8_error_feedback_survives_migration():
    """migrate_from carries per-slot quantization debt row for row into
    the new layout; the run continues and converges."""
    topo = t_top.grid(100)
    e1, s = _engine(topo, "int8")
    s = e1.run(s, 12)
    assert float(s.wire_err_m.abs().max()) > 0  # debt actually accrued
    centers, _ = _problem(topo, 0)
    e2 = ShardedLSS(topo, centers, t_lss.LSSConfig(),
                    EngineConfig(num_shards=4, cycles_per_dispatch=4,
                                 halo_slack=1.5, wire="int8",
                                 method="stride"), device="cpu")
    s2 = e2.migrate_from(e1, s)
    old = s.wire_err_m.reshape(e1.S * e1.B, e1.D, -1)[e1._pos]
    new = s2.wire_err_m.reshape(e2.S * e2.B, e2.D, -1)[e2._pos]
    assert torch.equal(new, old)
    oldc = s.wire_err_c.reshape(e1.S * e1.B, e1.D)[e1._pos]
    assert torch.equal(s2.wire_err_c.reshape(e2.S * e2.B, e2.D)[e2._pos],
                       oldc)
    # place_lss_state alone restarts the debt at zero.
    placed = e2.place_lss_state(e1.to_lss_state(s))
    assert float(placed.wire_err_m.abs().max()) == 0.0
    s2 = e2.run(s2, 100)
    assert float(e2.metrics(s2)[0]) == 1.0


def test_clear_slots_scrubs_the_debt():
    topo = t_top.grid(100)
    eng, s = _engine(topo, "int8")
    s = eng.run(s, 12)
    flat = s.wire_err_m.reshape(eng.S * eng.B, eng.D, -1)[eng._pos]
    rows, slots = np.nonzero(flat.abs().sum(-1).numpy())
    assert rows.size > 0
    cleared = eng.clear_slots(s, rows[:5], slots[:5])
    after = cleared.wire_err_m.reshape(eng.S * eng.B, eng.D, -1)[eng._pos]
    afterc = cleared.wire_err_c.reshape(eng.S * eng.B, eng.D)[eng._pos]
    assert float(after[rows[:5], slots[:5]].abs().max()) == 0.0
    assert float(afterc[rows[:5], slots[:5]].abs().max()) == 0.0
    assert float(after.abs().sum()) < float(flat.abs().sum())
    assert float(s.wire_err_m.reshape(eng.S * eng.B, eng.D, -1)[eng._pos][
        rows[0], slots[0]].abs().max()) > 0  # the input state is untouched


def test_compact_async_bitwise_equals_exact():
    """The bounded-staleness ring under loss: compact stays bitwise (it is
    value-lossless; only the byte accounting changes)."""
    topo = t_top.grid(100)
    e0, s0 = _engine(topo, "exact", drop=0.1, async_mode=True, staleness=2)
    e1, s1 = _engine(topo, "compact", drop=0.1, async_mode=True,
                     staleness=2)
    s0, s1 = e0.run(s0, 24), e1.run(s1, 24)
    assert e1._wire_w < e0.stopo.halo_width  # the trim engaged
    a, b = convert.state_to_numpy(s0), convert.state_to_numpy(s1)
    for name in a["sync"]:
        assert_exact(b["sync"][name], a["sync"][name], name)
    for name in ("clock", "out_seq", "last_seq", "stale_drops", "applied",
                 "delay_sum"):
        assert_exact(b[name], a[name], name)


def test_wire_err_state_round_trips_through_convert():
    topo = t_top.grid(100)
    eng, s = _engine(topo, "bf16")
    s = eng.run(s, 8)
    fields = convert.state_to_numpy(s)
    assert "wire_err_m" in fields and "wire_err_c" in fields
    back = convert.sharded_state_from_jax_numpy(fields, "cpu")
    for name, a in convert.state_to_numpy(back).items():
        assert_exact(a, fields[name], name)
    exact = convert.state_to_numpy(_engine(topo, "exact")[1])
    assert "wire_err_m" not in exact


def test_halo_bytes_span_attr_reports_wire_bytes():
    topo = t_top.grid(100)
    vals = {}
    for wire in ("exact", "compact", "bf16", "int8"):
        centers, inputs = _problem(topo, 0)
        tr = InMemoryTracker()
        eng = ShardedLSS(topo, centers, t_lss.LSSConfig(),
                         EngineConfig(num_shards=4, cycles_per_dispatch=4,
                                      halo_slack=1.5, wire=wire),
                         tracker=tr, device="cpu")
        eng.run(eng.init(inputs, seed=0), 4)
        spans = tr.spans_named("engine.dispatch")
        assert spans and spans[0].attrs["wire"] == wire
        vals[wire] = spans[0].attrs["halo_bytes"]
        c = tr.registry.get("engine_shard_halo_bytes_total")
        assert sum(v for _, v in c.series()) == \
            sum(sp.attrs["halo_bytes"] for sp in spans)
        assert vals[wire] == 4 * int(eng.wire_pair_bytes(2).sum())
        pad = tr.registry.get("engine_halo_padding_frac")
        assert all(0.0 <= v <= 1.0 for _, v in pad.series())
    assert vals["int8"] < vals["bf16"] < vals["compact"] < vals["exact"]
