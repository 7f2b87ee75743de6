"""The port's optimizer and token stream (``repro_torch.optim``,
``repro_torch.data``) against the JAX package's, on the same numpy inputs.

* ``adamw_update``, ``clip_by_global_norm`` and ``cosine_schedule`` over
  several steps from the same float32 or bf16 parameters, grads and
  moments: parameters, moments, the clipped grads, the norm and the LR
  ``allclose`` at rtol 1e-6 (atol 1e-12 for values near zero), ``step``
  exactly.  Each update takes JAX's clipped grads, so that the norm's
  rounding is held once, by the clip's own check.
* ``TokenSource.shard_at``: tokens, labels and frames bitwise JAX's for
  every ``(seed, step, shard, num_shards)`` tried.
* The twins of ``tests/test_substrate.py``'s data and optimizer tests, on
  the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.data import TokenSource as JTokenSource
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_schedule as j_cosine
from repro_torch import tree
from repro_torch.data import Batch, TokenSource, make_batch_fn
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, clip_by_global_norm,
                               cosine_schedule)

RTOL, ATOL = 1e-6, 1e-12
SHAPES = {"w": (16, 8), "blocks": {"b": (8,), "a": (3, 4, 5)}, "z": ()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _random_tree(rng, scale=1.0):
    def make(shape):
        if isinstance(shape, dict):
            return {k: make(v) for k, v in shape.items()}
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return make(SHAPES)


def _to_torch(t, dtype):
    return tree.map(lambda a: torch.tensor(a, dtype=dtype), t)


def _to_jax(t, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


def _close(got, want, what):
    names, g = tree.leaves_with_names(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for name, a, b in zip(names, g, w):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(dtype):
    """Five steps from the same parameters with nonzero moments: clip
    (the norm above the limit on some steps), the cosine LR (warm-up 2),
    AdamW with weight decay; every leaf and scalar compared each step."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    p0 = _random_tree(rng)
    m0, v0 = _random_tree(rng, 0.1), jax.tree.map(
        np.abs, _random_tree(rng, 0.01))
    cfg_t, cfg_j = AdamWConfig(clip_norm=4.0), JAdamWConfig(clip_norm=4.0)
    p_t, p_j = _to_torch(p0, tdt), _to_jax(p0, jdt)
    o_t = AdamWState(m=_to_torch(m0, torch.float32),
                     v=_to_torch(v0, torch.float32),
                     step=torch.tensor(3, dtype=torch.int32))
    o_j = j_adamw_init(p_j)._replace(m=_to_jax(m0, jnp.float32),
                                     v=_to_jax(v0, jnp.float32),
                                     step=jnp.asarray(3, jnp.int32))
    for k in range(5):
        g = _random_tree(rng, 0.5 + k)
        n_t, gc_t = clip_by_global_norm(_to_torch(g, tdt), cfg_t.clip_norm)
        n_j, gc_j = j_clip(_to_jax(g, jdt), cfg_j.clip_norm)
        np.testing.assert_allclose(float(n_t), float(n_j), rtol=RTOL)
        _close(gc_t, gc_j, "clipped ")
        lr_t = cosine_schedule(o_t.step, 1e-2, 2, 10)
        lr_j = j_cosine(o_j.step, 1e-2, 2, 10)
        assert lr_t.dtype == torch.float32
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=RTOL)
        # The update from the same grads (JAX's clipped ones): a one-ulp
        # difference of the norm would otherwise reach m where b1 m and
        # (1 - b1) g cancel.
        gc_t = _to_torch(jax.tree.map(np.asarray, gc_j), torch.float32)
        p_t, o_t = adamw_update(p_t, gc_t, o_t, lr_t, cfg_t)
        p_j, o_j = j_adamw_update(p_j, gc_j, o_j, lr_j, cfg_j)
        _close(p_t, p_j, f"step {k} params ")
        _close(o_t.m, o_j.m, f"step {k} m ")
        _close(o_t.v, o_j.v, f"step {k} v ")
        assert int(o_t.step) == int(o_j.step) == 4 + k
        assert o_t.step.dtype == torch.int32
        for leaf in tree.leaves(p_t):
            assert leaf.dtype == tdt
        for leaf in tree.leaves((o_t.m, o_t.v)):
            assert leaf.dtype == torch.float32


def test_adamw_init_matches_jax():
    rng = np.random.default_rng(1)
    p0 = _random_tree(rng)
    o_t = adamw_init(_to_torch(p0, torch.bfloat16))
    o_j = j_adamw_init(_to_jax(p0, jnp.bfloat16))
    assert (tree.leaves_with_names(o_t)[0]
            == [jax.tree_util.keystr(k) for k, _ in
                jax.tree_util.tree_flatten_with_path(o_j)[0]])
    for a, b in zip(tree.leaves(o_t), jax.tree.leaves(o_j)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert not a.any()


def test_adamw_update_writes_in_place():
    p = {"w": torch.ones(4)}
    o = adamw_init(p)
    w, m = p["w"], o.m["w"]
    p2, o2 = adamw_update(p, {"w": torch.full((4,), 0.5)}, o, 0.1,
                          AdamWConfig())
    assert p2["w"] is w and o2.m["w"] is m
    assert int(o.step) == 0 and int(o2.step) == 1
    assert not torch.equal(w, torch.ones(4))


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_matches_jax(max_norm):
    rng = np.random.default_rng(2)
    g = _random_tree(rng, 3.0)
    n_t, g_t = clip_by_global_norm(_to_torch(g, torch.float32), max_norm)
    n_j, g_j = j_clip(_to_jax(g, jnp.float32), max_norm)
    np.testing.assert_allclose(float(n_t), float(n_j), rtol=RTOL)
    _close(g_t, g_j, "clipped ")


def test_cosine_schedule_matches_jax():
    for warmup, total in ((10, 100), (0, 50), (1, 1), (5, 3)):
        for s in range(0, 130, 3):
            got = cosine_schedule(torch.tensor(s, dtype=torch.int32), 3e-4,
                                  warmup, total)
            want = j_cosine(jnp.asarray(s, jnp.int32), 3e-4, warmup, total)
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{warmup} {s}")


# ---------------------------------------------------------------------------
# The token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=16, global_batch=8, seed=3),
    dict(vocab=50, seq_len=64, global_batch=4),
    dict(vocab=151_936, seq_len=33, global_batch=6, seed=9),
    dict(vocab=512, seq_len=24, global_batch=4, seed=1, frames_dim=12,
         enc_len=7),
])
def test_shard_at_bitwise_jax(kw):
    src, jsrc = TokenSource(**kw), JTokenSource(**kw)
    for step in (0, 1, 17, 1000):
        for n in (1, 2, kw["global_batch"]):
            for shard in range(n):
                got, want = src.shard_at(step, shard, n), jsrc.shard_at(
                    step, shard, n)
                for field in Batch._fields:
                    g, w = getattr(got, field), getattr(want, field)
                    if w is None:
                        assert g is None
                        continue
                    assert g.device.type == "cpu"
                    assert str(g.dtype).removeprefix("torch.") == str(
                        w.dtype)
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_batch_fn_places_and_refuses_a_mesh():
    """Places the batch on the device, and on a one-rank mesh (the name is
    from before ``mesh=`` was ported): DTensors holding every row."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    src = TokenSource(vocab=100, seq_len=8, global_batch=2, seed=4,
                      frames_dim=3, enc_len=5)
    b = make_batch_fn(src, device="cpu")(6)
    want = src.global_batch_at(6)
    for got, ref in zip(b, want):
        assert got.device.type == "cpu"
        assert torch.equal(got, ref)
    with torch_ranks.one_rank_group():
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        bm = make_batch_fn(src, mesh=mesh, device="cpu")(6)
        for got, ref in zip(bm, want):
            assert isinstance(got, DTensor)
            assert tuple(got.placements) == (Shard(0), Replicate())
            assert torch.equal(got.to_local(), ref)


def test_make_batch_fn_defaults_to_cuda():
    if torch.cuda.is_available():
        assert make_batch_fn(TokenSource(10, 4, 1))(0).tokens.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_batch_fn(TokenSource(10, 4, 1))


# ---------------------------------------------------------------------------
# Twins of tests/test_substrate.py (the port alone)
# ---------------------------------------------------------------------------


def test_data_deterministic_and_sharded():
    src = TokenSource(vocab=1000, seq_len=16, global_batch=8, seed=3)
    b1 = src.global_batch_at(5)
    b2 = src.global_batch_at(5)
    np.testing.assert_array_equal(b1.tokens.numpy(), b2.tokens.numpy())
    # labels are next-token shifted
    np.testing.assert_array_equal(b1.tokens[:, 1:].numpy(),
                                  b1.labels[:, :-1].numpy())
    # different steps differ
    b3 = src.global_batch_at(6)
    assert not np.array_equal(b1.tokens.numpy(), b3.tokens.numpy())


def test_data_vocab_range():
    src = TokenSource(vocab=50, seq_len=64, global_batch=4)
    b = src.global_batch_at(0)
    assert int(b.tokens.min()) >= 0 and int(b.tokens.max()) < 50


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.0)
    target = torch.tensor([1.0, 2.0, 3.0])
    for _ in range(300):
        g = {"w": 2.0 * (params["w"] - target)}
        _, g = clip_by_global_norm(g, 10.0)
        params, opt = adamw_update(params, g, opt, 0.05, cfg)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 2.0, 3.0],
                               atol=0.05)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    norm, g2 = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in tree.leaves(g2)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape():
    lrs = [float(cosine_schedule(torch.tensor(s), 1e-3, 10, 100))
           for s in range(0, 100, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1e-3, rel=0.1)
    assert lrs[-1] < lrs[4]
