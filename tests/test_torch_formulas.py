"""The port's formulas (wvs, regions) against the JAX package's, on the
same numpy inputs (stopping and correction: ``test_torch_stopping.py``).

Shapes are ``tests/test_kernels.py::SHAPES``; the region families are the
three of ``tests/test_kernel_suite.py::_families`` (Voronoi, halfspace,
padded Voronoi) at each shape's d and k.  Bool and int outputs must be
exact; floats agree to rtol 1e-5 / atol 1e-5 (the two frameworks sum and
contract in different orders, so bitwise equality is not promised).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regions as j_regions
from repro.core import wvs as j_wvs
from repro_torch import convert
from repro_torch.core import regions as t_regions
from repro_torch.core import wvs as t_wvs

SHAPES = [(64, 2, 2, 3), (200, 5, 3, 4), (130, 8, 6, 7), (1024, 4, 1, 2),
          (33, 3, 2, 243)]
FAMILIES = ["voronoi", "halfspace", "padded-voronoi"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _mk(rng, n, D, d, zero_frac=0.25):
    """tests/test_kernels.py::_mk in numpy: moment-form inputs with a
    quarter of the slots empty and a fifth of them masked."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = lambda *s: rng.uniform(0.05, 2.0, s).astype(np.float32)  # noqa: E731
    x_m, x_c = f(n, d), np.ones((n,), np.float32)
    out_m, out_c = f(n, D, d) * 0.3, pos(n, D)
    in_m, in_c = f(n, D, d) * 0.3, pos(n, D)
    zero = rng.random((n, D)) < zero_frac
    out_c = np.where(zero, 0.0, out_c).astype(np.float32)
    out_m = np.where(zero[..., None], 0.0, out_m).astype(np.float32)
    in_c = np.where(zero, 0.0, in_c).astype(np.float32)
    in_m = np.where(zero[..., None], 0.0, in_m).astype(np.float32)
    mask = rng.random((n, D)) > 0.2
    return x_m, x_c, out_m, out_c, in_m, in_c, mask


def _family(name, d, k, seed):
    """(JAX PackedSlot, port PackedSlot) of one family kind."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32)
    w = rng.standard_normal((d,)).astype(np.float32)
    if name == "halfspace":
        jslot = j_regions.as_packed_slot(j_regions.HalfspaceRegions(
            w=jnp.asarray(w), b=jnp.asarray(np.float32(0.1))))
    elif name == "padded-voronoi":
        jslot = j_regions.PackedRegions.pack(
            [j_regions.VoronoiRegions(jnp.asarray(centers))],
            k_max=k + 3).slot(0)
    else:
        jslot = j_regions.PackedSlot.voronoi(jnp.asarray(centers))
    return jslot, to_port_slot(jslot)


def to_port_slot(jslot, device="cpu"):
    return convert.slot_from_numpy(*(np.asarray(f) for f in jslot),
                                   device=device)


def _t(a):
    return torch.tensor(np.asarray(a))  # a copy: JAX's buffers are read-only


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **TOL)


def assert_exact(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.array_equal(got, want), what


@pytest.mark.parametrize("n,D,d,k", SHAPES)
def test_wvs_ops(n, D, d, k):
    rng = np.random.default_rng(n + d)
    m1, m2 = (rng.standard_normal((n, d)).astype(np.float32) for _ in "ab")
    c1 = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    c2 = np.where(rng.random(n) < 0.3, 0.0, c1 * 0.7).astype(np.float32)
    s = rng.uniform(0.1, 3.0, (n,)).astype(np.float32)
    jx, jy = j_wvs.WV(jnp.asarray(m1), jnp.asarray(c1)), \
        j_wvs.WV(jnp.asarray(m2), jnp.asarray(c2))
    tx, ty = t_wvs.WV(_t(m1), _t(c1)), t_wvs.WV(_t(m2), _t(c2))
    for name, j, t in (
            ("add", j_wvs.add(jx, jy), t_wvs.add(tx, ty)),
            ("sub", jx - jy, tx - ty),
            ("smul", j_wvs.smul(jnp.asarray(s), jx), t_wvs.smul(_t(s), tx)),
            ("from_vector", j_wvs.from_vector(jnp.asarray(m1),
                                              jnp.asarray(c2)),
             t_wvs.from_vector(_t(m1), _t(c2))),
            ("wsum", j_wvs.wsum(jx), t_wvs.wsum(tx))):
        assert_close(t.m, j.m, name)
        assert_close(t.c, j.c, name)
    for eps in (0.0, 1e-9, 0.5):
        assert_close(t_wvs.vec(ty, eps), j_wvs.vec(jy, eps), f"vec {eps}")
    assert t_wvs.allclose(tx, tx) and not t_wvs.allclose(tx, ty)


@pytest.mark.parametrize("n,D,d,k", SHAPES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_decide(n, D, d, k, fam):
    rng = np.random.default_rng(n * 3 + k)
    jslot, tslot = _family(fam, d, k, seed=n + k)
    v = rng.standard_normal((n, D, d)).astype(np.float32)
    want = j_regions.decide_packed(jnp.asarray(v), *jslot)
    assert_exact(t_regions.decide_packed(_t(v), *tslot), want, "packed")
    assert_exact(tslot.decide(_t(v[:, 0])), jslot.decide(jnp.asarray(v[:, 0])))
    if fam == "voronoi":
        assert_exact(t_regions.decide_voronoi(_t(v), tslot.centers),
                     j_regions.decide_voronoi(jnp.asarray(v), jslot.centers))
    if fam == "halfspace":
        fam_t = t_regions.HalfspaceRegions(tslot.w, tslot.b)
        fam_j = j_regions.HalfspaceRegions(jslot.w, jslot.b)
        assert_exact(fam_t.decide(_t(v)), fam_j.decide(jnp.asarray(v)))


def test_packed_regions_layout():
    """pack / set / clear / slot build the same tables in both packages."""
    rng = np.random.default_rng(5)
    d = 3
    cents = [rng.standard_normal((k, d)).astype(np.float32) for k in (2, 4)]
    w = rng.standard_normal((d,)).astype(np.float32)
    jfams = [j_regions.VoronoiRegions(jnp.asarray(cents[0])),
             j_regions.HalfspaceRegions(jnp.asarray(w),
                                        jnp.asarray(np.float32(0.2))),
             j_regions.VoronoiRegions(jnp.asarray(cents[1]))]
    tfams = [t_regions.VoronoiRegions(_t(cents[0])),
             t_regions.HalfspaceRegions(_t(w), torch.tensor(0.2)),
             t_regions.VoronoiRegions(_t(cents[1]))]
    jp = j_regions.PackedRegions.pack(jfams)
    tp = t_regions.PackedRegions.pack(tfams)
    for f, g in zip(tp, jp):
        assert_exact(f, g)
    jp, tp = jp.clear(1), tp.clear(1)
    for f, g in zip(tp, jp):
        assert_exact(f, g)
    v = rng.standard_normal((50, d)).astype(np.float32)
    for i in range(3):
        assert_exact(tp.decide_slot(i)(_t(v)),
                     jp.decide_slot(i)(jnp.asarray(v)))
    with pytest.raises(ValueError):
        tp.set(0, t_regions.VoronoiRegions(torch.zeros((9, d))))
    assert t_regions.as_packed_slot(_t(cents[0])).k_max == 2
    with pytest.raises(TypeError):
        t_regions.as_packed_slot(torch.zeros(3))
