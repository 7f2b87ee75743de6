"""The port's kernel wrappers (``repro_torch.kernels``) against the JAX
package's kernel oracles.

On the CPU ``ops.region_decide`` / ``ops.lss_state`` / ``ops.correction``
run the plain PyTorch versions; they are held against ``repro.kernels.ref``
on ``tests/test_kernels.py::SHAPES`` x the three region families x beta,
with a leading query-slot axis against a per-slot loop over the JAX oracles,
and against the Pallas kernels in interpret mode on one shape.  Bool and int
outputs are exact, floats agree to rtol 1e-5 / atol 1e-5.  The CUDA
kernels themselves run only on the card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold them against the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regions as j_regions
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch import kernels
from repro_torch.core import regions as t_regions
from repro_torch.kernels import _build
from repro_torch.kernels import correction as k_corr
from repro_torch.kernels import lss_state as k_state
from repro_torch.kernels import ops
from repro_torch.kernels import region_decide as k_dec
from repro_torch.kernels.suite import get_suite, resolve_suite
from test_torch_formulas import (FAMILIES, SHAPES, _family, _mk, _t,
                                 assert_close, assert_exact, to_port_slot)

# Slot kinds of the query-batched cases: the three families, plus a
# padding slot (every center masked: decides region 0 everywhere).
SLOT_KINDS = FAMILIES + ["padding"]


def regions_of(slots):
    """Port PackedSlots stacked into one PackedRegions, centers padded to
    the largest k with masked rows (which decide like the unpadded ones)."""
    k = max(s.centers.shape[0] for s in slots)
    d = slots[0].centers.shape[1]
    centers = torch.zeros((len(slots), k, d))
    cmask = torch.zeros((len(slots), k), dtype=torch.bool)
    for i, s in enumerate(slots):
        centers[i, :s.centers.shape[0]] = s.centers
        cmask[i, :s.centers.shape[0]] = s.cmask
    return t_regions.PackedRegions(
        kind=torch.stack([s.kind for s in slots]), centers=centers,
        cmask=cmask, w=torch.stack([s.w for s in slots]),
        b=torch.stack([s.b for s in slots]))


def _slot_family(kind, d, k, seed):
    """(JAX PackedSlot, port PackedSlot) of one slot kind."""
    if kind == "padding":
        jslot = j_regions.PackedRegions.empty(1, k, d).slot(0)
        return jslot, to_port_slot(jslot)
    return _family(kind, d, k, seed)


def _state_case(n, D, d, k, fam, seed):
    rng = np.random.default_rng(seed)
    arrs = _mk(rng, n, D, d)
    jslot, tslot = _family(fam, d, k, seed=seed + 1)
    return arrs, jslot, tslot


def _assert_state(got, want):
    for g, w, name in zip(got, want, ("s_m", "s_c", "viol", "dec")):
        if name in ("viol", "dec"):
            assert_exact(g, w, name)
        else:
            assert_close(g, w, name)


@pytest.mark.parametrize("n,D,d,k", SHAPES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_lss_state_plain_vs_jax_ref(n, D, d, k, fam):
    arrs, jslot, tslot = _state_case(n, D, d, k, fam, seed=n * 7 + D)
    got = ops.lss_state(*(_t(a) for a in arrs), tslot)
    want = j_ref.lss_state_ref(*(jnp.asarray(a) for a in arrs), jslot)
    _assert_state(got, want)
    assert got[2].dtype == torch.bool and got[3].dtype == torch.int32


@pytest.mark.parametrize("n,D,d,k", SHAPES)
@pytest.mark.parametrize("beta", [1e-3, 0.1])
@pytest.mark.parametrize("fam", FAMILIES)
def test_correction_plain_vs_jax_ref(n, D, d, k, beta, fam):
    arrs, jslot, _ = _state_case(n, D, d, k, fam, seed=n * 13 + D)
    x_m, x_c, out_m, out_c, in_m, in_c, mask = (jnp.asarray(a) for a in arrs)
    s_m, s_c, viol, _ = j_ref.lss_state_ref(x_m, x_c, out_m, out_c, in_m,
                                            in_c, mask, jslot)
    cargs = [np.asarray(a) for a in (s_m, s_c, out_m + in_m, out_c + in_c,
                                     in_m, in_c, viol & mask)]
    got = ops.correction(*(_t(a) for a in cargs), beta=beta)
    want = j_ref.correction_ref(*(jnp.asarray(a) for a in cargs), beta)
    assert_close(got[0], want[0], "out_m'")
    assert_close(got[1], want[1], "out_c'")


def test_plain_vs_pallas_interpret():
    """One shape against the JAX kernels themselves (interpret mode)."""
    n, D, d, k = 130, 5, 2, 3
    for fam in FAMILIES:
        arrs, jslot, tslot = _state_case(n, D, d, k, fam, seed=3)
        got = ops.lss_state(*(_t(a) for a in arrs), tslot)
        want = j_ops.lss_state(*(jnp.asarray(a) for a in arrs), jslot)
        _assert_state(got, want)
        s_m, s_c, viol, _ = (np.asarray(w) for w in want)
        x_m, x_c, out_m, out_c, in_m, in_c, mask = arrs
        cargs = (s_m, s_c, out_m + in_m, out_c + in_c, in_m, in_c,
                 viol & mask)
        got_c = ops.correction(*(_t(a) for a in cargs), beta=0.05)
        want_c = j_ops.correction(*(jnp.asarray(a) for a in cargs),
                                  beta=0.05)
        assert_close(got_c[0], want_c[0], "out_m'")
        assert_close(got_c[1], want_c[1], "out_c'")


@pytest.mark.parametrize("fam", FAMILIES)
def test_prep_slot_matches_jax_table(fam):
    """The kernel table is the JAX one without the TPU's lane padding."""
    d, k = 3, 4
    jslot, tslot = _family(fam, d, k, seed=9)
    jt = j_ops.prep_slot(jslot, eps=1e-8, beta=0.25)
    tt = ops.prep_slot(tslot, eps=1e-8, beta=0.25)
    assert_exact(tt[0], np.asarray(jt[0])[:d])  # (d, k+1) of (128, k+1)
    assert_exact(tt[1], np.asarray(jt[1])[0])
    assert_exact(tt[2], np.asarray(jt[2])[0])


def test_cpu_takes_plain_version_and_counts():
    kernels.reset_counts()
    arrs, _, tslot = _state_case(64, 3, 2, 3, "voronoi", seed=1)
    t = [_t(a) for a in arrs]
    s_m, s_c, viol, _ = ops.lss_state(*t, tslot)
    a_m, a_c = t[2] + t[4], t[3] + t[5]
    ops.correction(s_m, s_c, a_m, a_c, t[4], t[5], viol)
    get_suite("fused").decide(s_m, tslot)
    assert kernels.counts() == {"region_decide": 0, "lss_state": 0,
                                "correction": 0, "region_decide_ref": 1,
                                "lss_state_ref": 1, "correction_ref": 1}
    kernels.reset_counts()
    assert set(kernels.counts().values()) == {0}


def test_bf16_inputs_upcast():
    """The wrappers normalize dtypes, as the JAX wrappers do."""
    arrs, _, tslot = _state_case(64, 4, 2, 3, "voronoi", seed=3)
    t = [_t(a).to(torch.bfloat16) if a.dtype == np.float32 else _t(a)
         for a in arrs]
    s_m, s_c, viol, dec = ops.lss_state(*t, tslot)
    assert s_m.dtype == torch.float32 and torch.isfinite(s_m).all()


def test_launchers_refuse_cpu_tensors():
    """A launcher never runs a CPU tensor (and never builds for one)."""
    arrs, _, tslot = _state_case(16, 2, 2, 3, "voronoi", seed=4)
    t = [_t(a) for a in arrs]
    q = [a[None] for a in t]  # the launchers take a leading slot axis
    tables = ops.prep_slots(regions_of([tslot]))
    knob = torch.full((1,), 1e-3)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        k_state.launch(*q, *tables[1:])
    with pytest.raises(ValueError, match="CUDA"):
        k_corr.launch(q[0], q[1], q[2], q[3], q[4], q[5], q[6], knob, knob)
    with pytest.raises(ValueError, match="CUDA"):
        k_dec.launch(q[0], *tables[1:])
    assert kernels.counts() == before


def test_suites():
    assert resolve_suite(None, "cpu").name == "reference"
    assert resolve_suite(None, "cuda").name == "fused"
    assert resolve_suite(None).name == "reference"
    assert resolve_suite(True).fused and not resolve_suite(False).fused
    assert resolve_suite("fused") is get_suite("fused")
    with pytest.raises(KeyError):
        resolve_suite("no-such-suite")
    # The fused decide runs (its plain version on the CPU) and agrees with
    # the reference suite, on one family and on Q of them.
    v = torch.tensor(np.random.default_rng(0).standard_normal(
        (3, 5, 2)).astype(np.float32))
    for fam in FAMILIES:
        _, tslot = _family(fam, 2, 3, seed=2)
        assert_exact(get_suite("fused").decide(v, tslot),
                     get_suite("reference").decide(v, tslot))
    packed = regions_of([_family(f, 2, 3, seed=2)[1] for f in FAMILIES])
    assert_exact(get_suite("fused").decide(v, packed),
                 get_suite("reference").decide(v, packed))


def test_build_recipe(monkeypatch, tmp_path):
    """Sources, flags and the cache key of the nvcc build."""
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build._lib_path(name).parent == _build.BUILD_DIR
        assert _build._lib_path(name) == _build._lib_path(name)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "fast_math" not in flags
    if _build.shutil.which("nvcc") is None:
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()


@pytest.mark.parametrize("n,D,d,k", SHAPES)
@pytest.mark.parametrize("fam", SLOT_KINDS)
def test_region_decide_plain_vs_jax_ref(n, D, d, k, fam):
    v = np.random.default_rng(n + k).standard_normal((n, d)).astype(
        np.float32)
    jslot, tslot = _slot_family(fam, d, k, seed=n)
    got = ops.region_decide(_t(v), tslot)
    assert got.dtype == torch.int32
    assert_exact(got, j_ref.region_decide_ref(jnp.asarray(v), jslot))
    if fam == "padding":
        assert not got.any()  # argmin over all-+inf scores picks 0


def _batched_case(n, D, d, k, seed):
    """Q = 8 slots of mixed kinds with per-slot eps/beta: numpy inputs
    (Q, n, ...), the JAX slots, and the port's PackedRegions."""
    rng = np.random.default_rng(seed)
    kinds = [SLOT_KINDS[i % len(SLOT_KINDS)] for i in range(8)]
    pairs = [_slot_family(kind, d, k, seed=seed + i)
             for i, kind in enumerate(kinds)]
    per_slot = [_mk(rng, n, D, d) for _ in kinds]
    arrs = [np.stack(a) for a in zip(*per_slot)]
    eps = np.array([1e-9, 1e-3] * 4, np.float32)
    beta = np.array([1e-3, 1e-3, 0.1, 0.05] * 2, np.float32)
    return (arrs, [j for j, _ in pairs], regions_of([t for _, t in pairs]),
            eps, beta)


@pytest.mark.parametrize("n,D,d,k", SHAPES[:4])
def test_batched_plain_vs_per_slot_jax_ref(n, D, d, k):
    """The query-batched plain versions (one call for all Q slots, per-slot
    families and knobs) equal a per-slot loop over the JAX oracles."""
    arrs, jslots, packed, eps, beta = _batched_case(n, D, d, k, seed=n + D)
    t_arrs = [_t(a) for a in arrs]
    for tables in (packed, ops.prep_slots(packed, _t(eps), _t(beta))):
        got = ops.lss_state(*t_arrs, tables, eps=_t(eps))
        s_m, s_c, viol, _ = got
        x_m, x_c, out_m, out_c, in_m, in_c, mask = t_arrs
        cgot = ops.correction(s_m, s_c, out_m + in_m, out_c + in_c, in_m,
                              in_c, viol & mask, beta=_t(beta), eps=_t(eps))
        vgot = ops.region_decide(x_m, tables)
        for q, jslot in enumerate(jslots):
            one = [jnp.asarray(a[q]) for a in arrs]
            want = j_ref.lss_state_ref(*one, jslot, eps=float(eps[q]))
            _assert_state([g[q] for g in got], want)
            w_m, w_c = j_ref.correction_ref(
                want[0], want[1], one[2] + one[4], one[3] + one[5], one[4],
                one[5], want[2] & one[6], float(beta[q]), float(eps[q]))
            assert_close(cgot[0][q], w_m, "out_m'")
            assert_close(cgot[1][q], w_c, "out_c'")
            assert_exact(vgot[q], j_ref.region_decide_ref(one[0], jslot))


def test_prep_slots_matches_per_slot_tables():
    """The (Q, ...) tables are the single-slot tables stacked."""
    _, jslots, packed, eps, beta = _batched_case(16, 2, 3, 4, seed=5)
    tables = ops.prep_slots(packed, _t(eps), _t(beta))
    for q, jslot in enumerate(jslots):
        jt = j_ops.prep_slot(jslot, eps=float(eps[q]), beta=float(beta[q]))
        k = np.asarray(jt[1]).shape[1]
        assert_exact(tables.cthw[q][:, list(range(k)) + [-1]],
                     np.asarray(jt[0])[:3])
        assert_exact(tables.cn[q][:k], np.asarray(jt[1])[0])
        assert_exact(tables.meta[q], np.asarray(jt[2])[0])
        assert bool(torch.isinf(tables.cn[q][k:]).all())
