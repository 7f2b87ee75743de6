"""The port's kernel wrappers (``repro_torch.kernels``) against the JAX
package's kernel oracles.

On the CPU ``ops.lss_state`` / ``ops.correction`` run the plain PyTorch
versions; they are held against ``repro.kernels.ref`` on
``tests/test_kernels.py::SHAPES`` x the three region families x beta, and
against the Pallas kernels in interpret mode on one shape.  Bool and int
outputs are exact, floats agree to rtol 1e-5 / atol 1e-5.  The CUDA
kernels themselves run only on the card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold them against the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels import correction as k_corr
from repro_torch.kernels import lss_state as k_state
from repro_torch.kernels import ops
from repro_torch.kernels.suite import get_suite, resolve_suite
from test_torch_formulas import (FAMILIES, SHAPES, _family, _mk, _t,
                                 assert_close, assert_exact)


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
    assert kernels.counts() == {"lss_state": 0, "correction": 0,
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
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        k_state.launch(*t, *ops.prep_slot(tslot), 1e-9)
    with pytest.raises(ValueError, match="CUDA"):
        k_corr.launch(t[0], t[1], t[2], t[3], t[4], t[5], t[6], 1e-3, 1e-9)
    assert kernels.counts() == before


def test_suites():
    assert resolve_suite(None, "cpu").name == "reference"
    assert resolve_suite(None, "cuda").name == "fused"
    assert resolve_suite(None).name == "reference"
    assert resolve_suite(True).fused and not resolve_suite(False).fused
    assert resolve_suite("fused") is get_suite("fused")
    with pytest.raises(KeyError):
        resolve_suite("no-such-suite")
    with pytest.raises(NotImplementedError, match="B.3"):
        get_suite("fused").decide(torch.zeros(4, 2), None)


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
