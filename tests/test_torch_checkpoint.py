"""The port's checkpoint store (``repro_torch.checkpoint``) against the JAX
package's: one layout, so a checkpoint written by one package loads into
the other bitwise.

* The twins of ``tests/test_substrate.py``'s checkpoint tests: round trip,
  async saves with GC, no partial checkpoint visible, the elastic
  reshard (``load(..., shardings=)`` onto a one-rank mesh).
* bf16 leaves round-trip bitwise (stored as their uint16 bits).
* Across packages: an f32 tree and a ``(params, AdamWState)`` smoke pair
  written by JAX load into the port's trees bitwise, and the reverse;
  the manifests' leaf names, shapes and dtypes are equal, leaf for leaf
  in the same order.  A bf16 leaf JAX wrote loads here bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_cfgs
import repro_torch.configs as cfgs
from repro import checkpoint as j_checkpoint
from repro.models import build as j_build
from repro.optim import adamw_init as j_adamw_init
import torch_ranks
from repro_torch import checkpoint, convert, tree
from repro_torch.models import ParamTree, build
from repro_torch.optim import AdamWState, adamw_init

ARCH = "qwen3-14b"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32)}}


def _bits(x):
    """A leaf's bytes as an integer array (bitwise comparisons)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    a = np.atleast_1d(np.asarray(x))
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8)


def _same(got, want_leaves):
    got = tree.leaves(got)
    assert len(got) == len(want_leaves)
    for a, b in zip(got, want_leaves):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _manifest(path, step):
    return json.loads((path / f"step_{step:08d}" / "manifest.json")
                      .read_text())


# ---------------------------------------------------------------------------
# Twins of tests/test_substrate.py (the port alone)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    checkpoint.save(tmp_path, 7, t)
    assert checkpoint.latest_step(tmp_path) == 7
    t2 = checkpoint.load(tmp_path, 7, t)
    _same(t2, tree.leaves(t))
    assert t2["nested"]["b"].dtype == torch.int32


def test_checkpoint_async_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        checkpoint.save_async(tmp_path, s, t, max_keep=2)
    checkpoint.wait_pending()
    assert checkpoint.latest_step(tmp_path) == 5
    kept = sorted(p.name for p in tmp_path.glob("step_*") if p.is_dir())
    assert len(kept) <= 2
    t2 = checkpoint.load(tmp_path, 5, t)
    np.testing.assert_array_equal(t2["a"].numpy(), t["a"].numpy())


def test_checkpoint_atomic_no_partial(tmp_path):
    """A tmp dir left behind must never be visible as a checkpoint."""
    t = _tree()
    checkpoint.save(tmp_path, 1, t)
    (tmp_path / "step_00000002.tmp").mkdir()
    assert checkpoint.latest_step(tmp_path) == 1


def test_checkpoint_reshard_waits_for_a10c(tmp_path):
    """The twin of ``test_checkpoint_elastic_reshard`` (the name is from
    before ``load(shardings=)`` was ported): restore with explicit
    shardings onto a one-rank mesh; each leaf comes back a DTensor on
    that mesh, bitwise."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import NamedSharding

    t = _tree()
    checkpoint.save(tmp_path, 3, t)
    with torch_ranks.one_rank_group():
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        sh = tree.map(lambda _: NamedSharding(mesh, ()), t)
        t2 = checkpoint.load(tmp_path, 3, t, shardings=sh)
        a = t2["a"]
        assert isinstance(a, DTensor)
        assert dict(zip(a.device_mesh.mesh_dim_names,
                        a.device_mesh.shape)) == {"data": 1}
        for got, want in zip(tree.leaves(t2), tree.leaves(t)):
            assert got.dtype == want.dtype
            assert torch.equal(got.to_local(), want)


# ---------------------------------------------------------------------------
# The port's own guarantees
# ---------------------------------------------------------------------------


def test_bf16_roundtrip_bitwise(tmp_path):
    g = torch.Generator().manual_seed(1)
    t = ParamTree({"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
                   "blk": {"b": torch.randn((3,), generator=g)}})
    checkpoint.save(tmp_path, 2, t)
    leaves = _manifest(tmp_path, 2)["leaves"]
    assert [(x["name"], x["dtype"]) for x in leaves] == [
        ("['blk']['b']", "float32"), ("['w']", "bfloat16")]
    t2 = checkpoint.load(tmp_path, 2, t)
    assert isinstance(t2, ParamTree)
    assert t2.tree()["w"].dtype == torch.bfloat16
    _same(t2, tree.leaves(t))


def test_save_async_snapshots_before_returning(tmp_path):
    """The train step updates its tensors in place: the async writer must
    hold a copy made before ``save_async`` returned."""
    t = {"w": torch.ones(1000)}
    checkpoint.save_async(tmp_path, 1, t)
    t["w"].mul_(3.0)
    checkpoint.wait_pending()
    t2 = checkpoint.load(tmp_path, 1, t)
    assert torch.equal(t2["w"], torch.ones(1000))


def test_load_takes_the_dtype_and_device_of_like(tmp_path):
    t = {"a": torch.randn(4, 3), "s": torch.tensor(5, dtype=torch.int32)}
    checkpoint.save(tmp_path, 4, t)
    like = {"a": torch.zeros(4, 3, dtype=torch.float64),
            "s": torch.zeros((), dtype=torch.int64)}
    t2 = checkpoint.load(tmp_path, 4, like)
    assert t2["a"].dtype == torch.float64 and t2["s"].dtype == torch.int64
    assert t2["s"].shape == () and int(t2["s"]) == 5
    np.testing.assert_array_equal(t2["a"].numpy(),
                                  t["a"].double().numpy())
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(tmp_path, 4, {"a": like["a"]})


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------


def _jax_pair():
    """JAX's smoke params and an AdamW state with nonzero moments."""
    cfg = j_cfgs.get_smoke(ARCH)
    params = j_build(cfg).init(jax.random.PRNGKey(0))
    opt = j_adamw_init(params)
    opt = opt._replace(
        m=jax.tree.map(lambda p: 0.5 * p, params),
        v=jax.tree.map(lambda p: jnp.square(p), params),
        step=jnp.asarray(11, jnp.int32))
    return params, opt


def _port_like():
    cfg = cfgs.get_smoke(ARCH)
    params = build(cfg, "cpu").init()
    return params, adamw_init(params)


def _jax_names(t):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(t)[0]]


def test_jax_checkpoint_loads_into_port(tmp_path):
    j_tree = {"a": jax.random.normal(jax.random.PRNGKey(0), (8, 4)),
              "nested": {"b": jnp.arange(6, dtype=jnp.int32)}}
    j_checkpoint.save(tmp_path / "tree", 7, j_tree)
    got = checkpoint.load(tmp_path / "tree", 7, _tree(3))
    _same(got, jax.tree.leaves(j_tree))

    pair = _jax_pair()
    j_checkpoint.save(tmp_path / "pair", 11, pair)
    like = _port_like()
    assert tree.leaves_with_names(like)[0] == _jax_names(pair)
    params, opt = checkpoint.load(tmp_path / "pair", 11, like)
    assert isinstance(params, ParamTree) and isinstance(opt, AdamWState)
    _same((params, opt), jax.tree.leaves(pair))
    assert opt.step.dtype == torch.int32 and int(opt.step) == 11


def test_port_checkpoint_loads_into_jax(tmp_path):
    params = convert.model_params_from_jax_numpy(
        cfgs.get_smoke(ARCH), jax.tree.map(np.asarray, _jax_pair()[0]), "cpu")
    opt = adamw_init(params)
    for leaf in tree.leaves((opt.m, opt.v)):
        leaf.normal_(generator=torch.Generator().manual_seed(leaf.numel()))
    opt = opt._replace(step=torch.tensor(4, dtype=torch.int32))
    checkpoint.save(tmp_path / "port", 4, (params, opt))
    j_like = _jax_pair()
    got = j_checkpoint.load(tmp_path / "port", 4, j_like)
    _same((params, opt), jax.tree.leaves(got))

    # The manifests of one pair written by each package are equal.
    j_checkpoint.save(tmp_path / "jax", 4, got)
    assert _manifest(tmp_path / "port", 4) == _manifest(tmp_path / "jax", 4)


def test_jax_bf16_leaf_loads_bitwise(tmp_path):
    w = jax.random.normal(jax.random.PRNGKey(2), (6, 5)).astype(jnp.bfloat16)
    j_checkpoint.save(tmp_path, 1, {"w": w, "x": jnp.ones(3)})
    got = checkpoint.load(tmp_path, 1, {"w": torch.zeros(6, 5,
                                                         dtype=torch.bfloat16),
                                        "x": torch.zeros(3)})
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["w"]), _bits(np.asarray(w)))


def test_adamw_state_from_jax_numpy():
    pair = jax.tree.map(np.asarray, _jax_pair())
    opt = convert.adamw_state_from_jax_numpy(cfgs.get_smoke(ARCH), pair[1],
                                             "cpu")
    assert isinstance(opt, AdamWState) and opt.step.dtype == torch.int32
    assert (tree.leaves_with_names(opt)[0]
            == _jax_names(pair[1]))
    _same(opt, jax.tree.leaves(pair[1]))
    with pytest.raises(ValueError, match="leaves"):
        convert.adamw_state_from_jax_numpy(
            cfgs.get_smoke("yi-9b"), pair[1], "cpu")
