"""The port's stopping rule (Def. 4, Alg.-1 violations) and correction
formulas (Eqs. 8 and 10) against the JAX package's, on the same numpy
inputs: ``tests/test_kernels.py::SHAPES`` x the three region families.
Bool outputs must be exact; floats agree to rtol 1e-5 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import correction as j_corr
from repro.core import regions as j_regions
from repro.core import stopping as j_stop
from repro.core import wvs as j_wvs
from repro_torch.core import correction as t_corr
from repro_torch.core import regions as t_regions
from repro_torch.core import stopping as t_stop
from repro_torch.core import wvs as t_wvs
from test_torch_formulas import (FAMILIES, SHAPES, _family, _mk, _t,
                                 assert_close, assert_exact)


@pytest.mark.parametrize("n,D,d,k", SHAPES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_stopping(n, D, d, k, fam):
    rng = np.random.default_rng(n * 7 + D)
    arrs = _mk(rng, n, D, d)
    jslot, tslot = _family(fam, d, k, seed=n)
    j_args = [jnp.asarray(a) for a in arrs]
    t_args = [_t(a) for a in arrs]
    js = j_stop.status(*j_args)
    ts = t_stop.status(*t_args)
    assert_close(ts.m, js.m, "status m")
    assert_close(ts.c, js.c, "status c")
    ja = j_stop.agreements(*j_args[2:6])
    ta = t_stop.agreements(*t_args[2:6])
    assert_close(ta.m, ja.m, "agreements m")
    assert_close(ta.c, ja.c, "agreements c")
    jdec = lambda u: j_regions.decide_packed(u, *jslot)  # noqa: E731
    tdec = lambda u: t_regions.decide_packed(u, *tslot)  # noqa: E731
    mask_j, mask_t = j_args[6], t_args[6]
    for eps in (1e-9, 1e-3):
        assert_exact(t_stop.violations_alg1(tdec, ts, ta, mask_t, eps),
                     j_stop.violations_alg1(jdec, js, ja, mask_j, eps),
                     f"violations eps={eps}")
        assert_exact(t_stop.def4_satisfied(tdec, ts, ta, mask_t, eps),
                     j_stop.def4_satisfied(jdec, js, ja, mask_j, eps),
                     f"def4 eps={eps}")


@pytest.mark.parametrize("n,D,d,k", SHAPES)
@pytest.mark.parametrize("beta", [1e-3, 0.1])
def test_correction(n, D, d, k, beta):
    rng = np.random.default_rng(n * 13 + D)
    x_m, x_c, out_m, out_c, in_m, in_c, mask = _mk(rng, n, D, d,
                                                    zero_frac=0.0)
    v = mask & (rng.random((n, D)) < 0.5)
    js = j_wvs.WV(jnp.asarray(x_m), jnp.asarray(x_c))
    ts = t_wvs.WV(_t(x_m), _t(x_c))
    ja = j_wvs.WV(jnp.asarray(out_m + in_m), jnp.asarray(out_c + in_c))
    ta = t_wvs.WV(_t(out_m + in_m), _t(out_c + in_c))
    jt = j_corr.selective_target(js, ja, jnp.asarray(v))
    tt = t_corr.selective_target(ts, ta, _t(v))
    assert_close(tt.m, jt.m, "T m")
    assert_close(tt.c, jt.c, "T c")
    assert_close(t_corr.new_agreement_weights(ts.c, ta.c, _t(v), beta),
                 j_corr.new_agreement_weights(js.c, ja.c, jnp.asarray(v),
                                              beta), "weights")
    got = t_corr.corrected_messages(ts, ta, _t(in_m), _t(in_c), _t(v), beta)
    want = j_corr.corrected_messages(js, ja, jnp.asarray(in_m),
                                     jnp.asarray(in_c), jnp.asarray(v), beta)
    assert_close(got[0], want[0], "out_m'")
    assert_close(got[1], want[1], "out_c'")
