"""The port's meshes, placements and elastic restore
(``repro_torch.launch.mesh``, ``distributed.sharding`` / ``elastic``, the
checkpoint's ``load(shardings=)``, ``make_batch_fn(mesh=)``) against the
JAX package's, with one process a rank over gloo.

* ``remesh``'s info equals JAX's for n in {1, 3, 4, 5, 8} x ``model_axis``
  in {1, 2, 4} (the pure ``remesh_plan``); the twin of
  ``test_distributed.py::test_elastic_remesh`` at world 1; a mesh over
  ranks [0, 1] of a world of 3 leaves rank 2 outside (coordinate None,
  an empty local shard; it still joins the gather of the whole value).
* The twin of ``test_elastic_remesh_checkpoint_roundtrip``: 8 ranks save
  ``P('data', 'model')`` DTensor leaves; a second launch of 4 ranks
  remeshes and loads with ``shardings``.  Each rank's local shard is
  bitwise JAX's shard at the same mesh coordinate, the whole value the
  original.
* ``reshard`` of a spec tree with ``None``, ``"model"`` and
  ``("pod", "data")`` entries on a (2, 2, 2) mesh equals JAX's shard for
  shard by coordinate; a dim its axes do not divide raises in both.
* ``make_batch_fn(mesh=...)``'s rows by coordinate are bitwise JAX's.
* ``make_host_mesh`` shapes and axes equal JAX's at worlds 1 and 4;
  ``make_production_mesh`` raises on a small world in both packages.
* A checkpoint the port saves from DTensor leaves on 4 ranks loads into
  JAX's ``checkpoint.load`` bitwise, with the manifest names equal.

JAX runs in one subprocess with 8 host devices (and its 1-device main
process for world 1); the port's launches: 8 ranks beside it, then 4, 3
and 1 ranks side by side.
"""

import functools
import json
import pathlib
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch.distributed as dist

import torch_ranks
from repro_torch.distributed import elastic, launch

SPAWN_TIMEOUT_S = 150
NS, MODEL_AXES = (1, 3, 4, 5, 8), (1, 2, 4)
_TMP = tempfile.TemporaryDirectory(prefix="repro_torch_elastic_")

_JAX_ELASTIC = """
import json, tempfile, types, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import checkpoint
from repro.data.pipeline import TokenSource, make_batch_fn
from repro.distributed.elastic import remesh, reshard
from repro.launch import mesh as mesh_mod
SPEC = json.loads(SPEC)
devs = jax.devices()
auto = jax.sharding.AxisType.Auto
def shards(arr, mesh):
    out = {}
    for sh in arr.addressable_shards:
        c = np.argwhere(mesh.devices == sh.device)[0]
        out[",".join(str(int(i)) for i in c)] = np.asarray(sh.data).tolist()
    return out
out = {"remesh": {f"{n},{m}": remesh(devs[:n], model_axis=m)[1]
                  for n in SPEC["ns"] for m in SPEC["models"]}}
# tests/test_distributed.py::test_elastic_remesh_checkpoint_roundtrip
mesh8, _ = remesh(devs, model_axis=2)
t = {'w': jnp.asarray(np.asarray(SPEC["w"], np.float32))}
t8 = jax.device_put(t['w'], NamedSharding(mesh8, P('data', 'model')))
tmp = tempfile.mkdtemp()
checkpoint.save(tmp, 1, {'w': t8})
mesh4, info4 = remesh(devs[:4], model_axis=2)
t4 = checkpoint.load(tmp, 1, t, shardings={'w': NamedSharding(mesh4, P('data', 'model'))})
out["shards8"] = shards(t8, mesh8)
out["shards4"] = shards(t4['w'], mesh4)
out["mesh4"] = dict(t4['w'].sharding.mesh.shape)
cube = jax.make_mesh((2, 2, 2), ('pod', 'data', 'model'), axis_types=(auto,) * 3)
tree = {'a': jnp.asarray(np.asarray(SPEC["tree"]["a"], np.float32)),
        'blk': {'b': jnp.asarray(np.asarray(SPEC["tree"]["b"], np.float32)),
                'c': jnp.asarray(np.asarray(SPEC["tree"]["c"], np.int32))}}
specs = {'a': P(('pod', 'data'), None), 'blk': {'b': P(None, 'model'), 'c': P(None)}}
placed = reshard(tree, specs, cube)
out["reshard"] = {"a": shards(placed['a'], cube), "b": shards(placed['blk']['b'], cube),
                  "c": shards(placed['blk']['c'], cube)}
try:
    jax.device_put(jnp.zeros((3, 4)), NamedSharding(cube, P('data')))
    out["indivisible"] = "no error"
except Exception as e:
    out["indivisible"] = type(e).__name__
b = make_batch_fn(TokenSource(**SPEC["batch"]), cube)(7)
out["batch"] = {f: shards(getattr(b, f), cube) for f in ("tokens", "labels", "frames")}
# JAX's make_host_mesh over 4 of the devices (its own body, the device set cut).
real = mesh_mod.jax
mesh_mod.jax = types.SimpleNamespace(
    devices=lambda: devs[:4], sharding=jax.sharding,
    make_mesh=lambda s, a, axis_types: jax.make_mesh(s, a, axis_types=axis_types,
                                                     devices=devs[:4]))
host4 = [mesh_mod.make_host_mesh(), mesh_mod.make_host_mesh(axes=("data",))]
try:
    mesh_mod.make_host_mesh((5, 1))
    bad4 = "no error"
except Exception as e:
    bad4 = type(e).__name__
mesh_mod.jax = real
out["host4"] = [[list(m.axis_names), list(m.devices.shape)] for m in host4]
out["bad4"] = bad4
prod = []
for mp in (False, True):
    try:
        mesh_mod.make_production_mesh(multi_pod=mp)
        prod.append("no error")
    except Exception as e:
        prod.append(type(e).__name__)
out["production"] = prod
print("RESULT" + json.dumps(out))
"""


def _spec() -> dict:
    tree = torch_ranks.reshard_tree()
    return {"ns": NS, "models": MODEL_AXES,
            "w": torch_ranks.ELASTIC_W.tolist(),
            "tree": {"a": tree["a"].tolist(), "b": tree["blk"]["b"].tolist(),
                     "c": tree["blk"]["c"].tolist()},
            "batch": torch_ranks.BATCH_SOURCE}


@functools.lru_cache(maxsize=None)
def _jax_future():
    from conftest import run_with_devices

    code = f"SPEC = {json.dumps(json.dumps(_spec()))}\n" + _JAX_ELASTIC
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run_with_devices, code, 8, 600)
    pool.shutdown(wait=False)
    return future


@functools.lru_cache(maxsize=None)
def _jax_runs() -> dict:
    out = _jax_future().result(timeout=660)
    return json.loads(out.split("RESULT", 1)[1])


def _spawn(world):
    return launch.spawn(torch_ranks.elastic_body, world,
                        timeout_s=SPAWN_TIMEOUT_S, args=(_TMP.name,))


@functools.lru_cache(maxsize=None)
def _port_runs() -> dict:
    """Every launch's ranks: 8 (the save) beside JAX's subprocess, then 4
    (the restore), 3 and 1 side by side."""
    _jax_future()
    runs = {8: _spawn(8)}
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = {w: pool.submit(_spawn, w) for w in (4, 3, 1)}
        runs.update({w: f.result() for w, f in futures.items()})
    return runs


def _key(coord) -> str:
    return ",".join(str(i) for i in coord)


# -- remesh --------------------------------------------------------------------

@pytest.mark.parametrize("model_axis", MODEL_AXES)
@pytest.mark.parametrize("n", NS)
def test_remesh_plan_matches_jax(n, model_axis):
    assert elastic.remesh_plan(n, model_axis) == \
        _jax_runs()["remesh"][f"{n},{model_axis}"]


def test_elastic_remesh_world1():
    """``test_elastic_remesh``'s twin: the mesh over the world of one."""
    (r,) = _port_runs()[1]
    assert r["remesh"]["devices_used"] >= 1
    assert "data" in r["remesh_mesh"][0]
    assert r["remesh"] == _jax_runs()["remesh"]["1,1"]
    assert r["remesh_mesh"] == (("data", "model"), (1, 1))


def test_remesh_leaves_a_rank_outside_the_mesh():
    ranks = _port_runs()[3]
    assert [r["coord"] for r in ranks] == [(0, 0), (0, 1), None]
    assert [r["local_numel"] for r in ranks] == [16, 16, 0]
    assert ranks[0]["remesh"] == {"devices_used": 2, "spares": 0,
                                  "shape": {"data": 1, "model": 2}}
    for r in ranks:  # the rank outside joins the gather and gets it all
        assert np.array_equal(r["full"], torch_ranks.ELASTIC_W[:4])


# -- the elastic checkpoint round trip -----------------------------------------

def test_elastic_checkpoint_roundtrip_8_to_4():
    want = _jax_runs()
    for r in _port_runs()[8]:
        assert np.array_equal(r["local8"],
                              np.asarray(want["shards8"][_key(r["coord8"])],
                                         np.float32))
    ranks4 = _port_runs()[4]
    assert sorted(r["coord4"] for r in ranks4) == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    for r in ranks4:
        got = r["local4"]
        assert got.dtype == np.float32 and got.shape == (4, 4)
        assert np.array_equal(got, np.asarray(want["shards4"][_key(
            r["coord4"])], np.float32))
        assert np.array_equal(r["full4"], torch_ranks.ELASTIC_W)
        assert dict(zip(*r["mesh4"])) == want["mesh4"] == {"data": 2,
                                                           "model": 2}


# -- reshard and the batch's placement -----------------------------------------

@pytest.mark.parametrize("leaf", ["a", "b", "c"])
def test_reshard_matches_jax_by_coordinate(leaf):
    want = _jax_runs()["reshard"][leaf]
    for r in _port_runs()[8]:
        got = r["reshard"][leaf]
        assert np.array_equal(got, np.asarray(want[_key(r["cube_coord"])],
                                              got.dtype))
    r0 = _port_runs()[8][0]
    assert r0["placements"] == {"a": ["S(0)", "S(0)", "R"],
                                "b": ["R", "R", "S(1)"]}


def test_reshard_refuses_an_indivisible_dim_as_jax():
    assert _jax_runs()["indivisible"] == "ValueError"
    for r in _port_runs()[8]:
        assert r["indivisible"].startswith("ValueError: spec ('data',) "
                                           "splits dim 0")


@pytest.mark.parametrize("field", ["tokens", "labels", "frames"])
def test_make_batch_fn_mesh_rows_match_jax(field):
    from repro_torch.data import TokenSource

    want = _jax_runs()["batch"][field]
    for r in _port_runs()[8]:
        got = r["batch"][field]
        assert np.array_equal(got, np.asarray(want[_key(r["cube_coord"])],
                                              got.dtype))
        assert got.shape[0] == 2  # 8 rows over pod x data
    full = TokenSource(**torch_ranks.BATCH_SOURCE).global_batch_at(7)
    assert np.array_equal(_port_runs()[8][5]["batch_full"],
                          full.tokens.numpy())


# -- the meshes -----------------------------------------------------------------

def test_make_host_mesh_matches_jax_world1():
    from repro.launch.mesh import make_host_mesh

    (r,) = _port_runs()[1]
    for got, m in ((r["host_mesh"], make_host_mesh()),
                   (r["host_mesh_1axis"], make_host_mesh(axes=("data",)))):
        assert got == (tuple(m.axis_names), tuple(m.devices.shape))
    with pytest.raises(ValueError):
        make_host_mesh((2, 1))
    assert r["bad_shape"] == "ValueError: mesh shape (2, 1) != 1 devices"


def test_make_host_mesh_matches_jax_world4():
    want = _jax_runs()
    for r in _port_runs()[4]:
        assert [list(r["host_mesh"][0]), list(r["host_mesh"][1])] == \
            want["host4"][0]
        assert [list(r["host_mesh_1axis"][0]),
                list(r["host_mesh_1axis"][1])] == want["host4"][1]
        assert r["bad_shape"].startswith("ValueError")
    assert want["bad4"] == "ValueError"


def test_make_production_mesh_raises_on_a_small_world():
    assert all(e != "no error" for e in _jax_runs()["production"])
    for world, ranks in _port_runs().items():
        for r in ranks:
            assert r["production"] == [
                f"ValueError: production mesh (16, 16) needs 256 ranks, the "
                f"world has {world}",
                f"ValueError: production mesh (2, 16, 16) needs 512 ranks, "
                f"the world has {world}"]


def test_mesh_module_needs_a_process_group():
    """Importing the module touches no process group; a mesh without one
    raises, naming the launcher."""
    from repro_torch.launch import mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="launch.spawn"):
        mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="launch.spawn"):
        mesh.make_production_mesh()


# -- across packages -------------------------------------------------------------

def test_port_checkpoint_from_dtensors_loads_into_jax():
    import jax

    from repro import checkpoint as j_checkpoint

    ranks = _port_runs()[4]
    assert [r["latest"] for r in ranks] == [2] * 4  # true on every rank
    want = torch_ranks.cross_tree()
    got = j_checkpoint.load(pathlib.Path(_TMP.name) / "cross", 2, want)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        assert np.asarray(b).dtype == a.dtype, path
        assert np.array_equal(np.asarray(b), a), path
    manifest = json.loads((pathlib.Path(_TMP.name) / "cross" / "step_00000002"
                           / "manifest.json").read_text())
    assert [leaf["name"] for leaf in manifest["leaves"]] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
