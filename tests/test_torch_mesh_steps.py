"""The port's train, prefill and decode steps across a multi-device
``DeviceMesh`` (``repro_torch.training.steps`` on four gloo ranks of a
(2, 2) ("data", "model") mesh, ``repro_torch.distributed.spmd``) against
the JAX package's steps and the port's one-process steps.

Twins of ``tests/test_distributed.py::test_train_step_sharded_2x2`` and
``::test_grad_accum_equivalence`` (yi-9b smoke; cells (64, 4) at accum 2
for two steps, and (32, 8) at accum 1 and 4), with more held than JAX's
finite losses and 5e-3 / 5e-2 bounds:

* against JAX's step on the same global batch and parameters, with
  ``tests/torch_train_parity.py``'s tolerances and its noise gate on the
  parameters (accum 1 and 2 from ``jax_side``; accum 1 and 4 on 8 rows
  from JAX's step here);
* against the port's one-process step on the same inputs at float32
  round-off (gloo's ring sums in another order than one process):
  metrics rtol 1e-6, ``m`` / ``v`` rtol 1e-5 with atol 1e-5 of the leaf's
  largest value, parameters rtol 1e-5 with atol 1e-4 of the leaf's
  largest value (AdamW's first steps are about ±lr wherever |g| ≫ ε);
* a MoE arch (qwen3-moe smoke with FSDP and remat, accum 2): the loss
  and the router grads equal the one-process step's (rtol 1e-6, atol
  1e-6 of the largest |g|): the load-balancing statistics are means over
  the data axes, so a per-rank aux loss fails it;
* a prefill and three greedy decode steps of yi-9b and zamba2 smoke at
  batch 4 and at batch 1 (``long_ctx``: the KV sequence on ``"data"``):
  tokens equal to the one-process steps';
* ranks that differ only on "model" keep bitwise equal replicas of the
  parameters and moments even where their grads differ (a loss scaled
  apart on each "model" rank);
* after each train step every local shard is bitwise its slice of the
  regathered value, every output sits at its ``out_specs`` placement, and
  ``in_specs`` / ``out_specs`` of every kind of cell of the ten archs
  equal JAX's on a (2, 2) mesh (``kv_div`` follows the model axis).

One ``launch.spawn`` of four ranks runs every case (bodies in
``tests/torch_ranks.py``), on a thread beside the JAX work; JAX's (2, 2)
specs come from one subprocess with 4 host devices.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_ranks
import torch_train_parity as parity
from repro_torch import configs, tree
from repro_torch.distributed import launch

ARCH = "yi-9b"
SPAWN_TIMEOUT_S = 240
ROUND_METRIC_RTOL = 1e-6
ROUND_MOM_RTOL, ROUND_MOM_LEAF_ATOL = 1e-5, 1e-5
ROUND_PARAM_RTOL, ROUND_PARAM_LEAF_ATOL = 1e-5, 1e-4
MOE_RTOL, MOE_LEAF_ATOL = 1e-6, 1e-6
JAX_ACCUM_BOUNDS = (5e-3, 5e-2)  # test_grad_accum_equivalence's
REPLICA_SKEW = 1e-3  # the loss scale's step from one "model" rank to the next

_JAX_SPECS = """
import json, jax
import repro
import repro.configs as cfgs
from jax.sharding import NamedSharding
from repro.models import build
from repro.training.steps import build_for_cell
CELLS = json.loads(CELLS)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
def flat(sh):
    f = jax.tree_util.tree_flatten_with_path(
        sh, is_leaf=lambda s: isinstance(s, NamedSharding))[0]
    return [[jax.tree_util.keystr(p), list(s.spec)] for p, s in f]
out = {}
with mesh:
    for arch in cfgs.ARCH_IDS:
        model = build(cfgs.get_smoke(arch))
        for cell in CELLS:
            _, i, o, _ = build_for_cell(model, mesh, cfgs.ShapeCell(*cell))
            out[arch + "/" + cell[0]] = [flat(i), flat(o)]
print("RESULT" + json.dumps(out))
"""


def _cells():
    return [("t", "train", torch_ranks.STEP_L, 2),
            ("p", "prefill", torch_ranks.SERVE_PROMPT, 2),
            ("l", "prefill", torch_ranks.SERVE_PROMPT, 1),
            ("d", "decode", torch_ranks.SERVE_LEN, 2),
            ("dl", "decode", torch_ranks.SERVE_LEN, 1)]


def _background(fn, *args):
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future


@functools.lru_cache(maxsize=None)
def _jax_specs_future():
    from conftest import run_with_devices

    code = f"CELLS = {json.dumps(json.dumps(_cells()))}\n" + _JAX_SPECS
    return _background(run_with_devices, code, 4, 300)


def _cfg():
    return configs.get_smoke(ARCH)


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    want = parity.jax_side(ARCH)
    params, batch = want["params"], want["batch"]
    cfg = _cfg()

    def case(b, accum, steps=1, variant="smoke", p=params):
        return dict(arch=ARCH, variant=variant, params=p, batch=b,
                    accum=accum, steps=steps)

    moe_cfg = configs.get_smoke(torch_ranks.MOE_ARCH)
    return {
        "train": {
            "accum1": case(parity._rows(batch, parity.B), 1),
            "accum2": case(parity._rows(batch, 2 * parity.B), 2),
            "rows8_accum1": case(torch_ranks.step_batch(
                cfg, 8, torch_ranks.STEP_L, 1), 1),
            "rows8_accum4": case(torch_ranks.step_batch(
                cfg, 8, torch_ranks.STEP_L, 1), 4),
            "sharded_2x2": case(torch_ranks.step_batch(
                cfg, 4, torch_ranks.STEP_2X2_L, 2), 2, steps=2),
            "fsdp_remat": case(parity._rows(batch, 2 * parity.B), 2,
                               steps=2, variant="fsdp_remat", p=None),
            "skewed": dict(case(parity._rows(batch, 2 * parity.B), 1,
                                steps=2, variant="fsdp_remat", p=None),
                           skew=REPLICA_SKEW)},
        "moe": dict(arch=torch_ranks.MOE_ARCH, variant="fsdp_remat",
                    batch=torch_ranks.step_batch(moe_cfg, 4,
                                                 torch_ranks.STEP_L, 3),
                    accum=2),
        "spec_archs": configs.ARCH_IDS}


@functools.lru_cache(maxsize=None)
def _ranks() -> list:
    _jax_specs_future()
    return launch.spawn(torch_ranks.mesh_steps_body, 4,
                        timeout_s=SPAWN_TIMEOUT_S, args=(_cases(),))


@functools.lru_cache(maxsize=None)
def _jax_rows8() -> dict:
    """JAX's train step on the 8-row batch at accum 1 and 4 from
    ``jax_side``'s parameters, and the grad of the whole batch (the
    parameters' noise gate)."""
    import jax
    import jax.numpy as jnp

    import repro.configs as j_cfgs
    from repro.models import build as j_build
    from repro.optim import adamw_init as j_adamw_init
    from repro.training.steps import TrainHParams as JTrainHParams
    from repro.training.steps import build_for_cell as j_build_for_cell

    batch = _cases()["train"]["rows8_accum1"]["batch"]
    params = parity.jax_side(ARCH)["params"]
    model = j_build(j_cfgs.get_smoke(ARCH))
    out = {}
    with parity._mesh() as mesh:
        grad = jax.jit(jax.grad(lambda p, b: model.loss(
            p, b["tokens"], b["labels"])[0]))
        out["grads"] = parity._np_tree(grad(params, batch))
        for accum in (1, 4):
            cell = j_cfgs.ShapeCell("t", "train", torch_ranks.STEP_L, 8)
            step = j_build_for_cell(model, mesh, cell,
                                    JTrainHParams(**parity._hp(accum)))[0]
            p = jax.tree.map(jnp.asarray, params)
            p2, o2, metrics = step(p, j_adamw_init(p), batch)
            out[accum] = dict(
                params=parity._np_tree(p2), m=parity._np_tree(o2.m),
                v=parity._np_tree(o2.v), step=int(o2.step),
                metrics={k: float(v) for k, v in metrics.items()})
    return out


@functools.lru_cache(maxsize=None)
def _one_process(name: str) -> dict:
    return torch_ranks.train_case(_cases()["train"][name])


def _t(t):
    return tree.map(torch.as_tensor, t)


def _hold_to_jax(got, want, g_want):
    """A rank's step against JAX's, at torch_train_parity's tolerances."""
    m = got["metrics"][0]
    for key, rtol in (("loss", parity.LOSS_RTOL), ("nll", parity.LOSS_RTOL),
                      ("gnorm", parity.GNORM_RTOL), ("lr", parity.LR_RTOL)):
        np.testing.assert_allclose(m[key], want["metrics"][key], rtol=rtol,
                                   err_msg=key)
    assert got["step"] == want["step"] == 1
    parity._leafwise(_t(got["m"]), want["m"], "m ", parity.MOM_RTOL,
                     parity.MOM_LEAF_ATOL, parity.MOM_ATOL)
    parity._leafwise(_t(got["v"]), want["v"], "v ", parity.MOM_RTOL,
                     parity.MOM_LEAF_ATOL, parity.MOM_ATOL)
    names, flat = tree.leaves_with_names(got["params"])
    kept = total = 0
    for name, p, p_want, g in zip(names, flat, tree.leaves(want["params"]),
                                  tree.leaves(g_want)):
        g = np.abs(np.asarray(g, np.float32))
        noise = max(parity.GRAD_ATOL,
                    parity.GRAD_LEAF_ATOL * float(g.max(initial=0.0)))
        sure = g > parity.NOISE_FACTOR * noise
        np.testing.assert_allclose(np.asarray(p)[sure],
                                   np.asarray(p_want)[sure],
                                   rtol=parity.PARAM_RTOL,
                                   atol=parity.PARAM_ATOL,
                                   err_msg=f"params {name}")
        kept += int(sure.sum())
        total += g.size
    assert kept >= total // 2


def _round_off(a, b, rtol, leaf_atol, what):
    names, fa = tree.leaves_with_names(a)
    for name, x, y in zip(names, fa, tree.leaves(b), strict=True):
        y = np.asarray(y, np.float32)
        np.testing.assert_allclose(
            np.asarray(x, np.float32), y, rtol=rtol,
            atol=leaf_atol * float(np.abs(y).max(initial=0.0)),
            err_msg=f"{what}{name}")


def _hold_to_one_process(got, one):
    assert len(got["metrics"]) == len(one["metrics"])
    for m_got, m_one in zip(got["metrics"], one["metrics"]):
        for key in m_one:
            np.testing.assert_allclose(m_got[key], m_one[key],
                                       rtol=ROUND_METRIC_RTOL, err_msg=key)
    assert got["step"] == one["step"] == len(one["metrics"])
    for key, rtol, atol in (("m", ROUND_MOM_RTOL, ROUND_MOM_LEAF_ATOL),
                            ("v", ROUND_MOM_RTOL, ROUND_MOM_LEAF_ATOL),
                            ("params", ROUND_PARAM_RTOL,
                             ROUND_PARAM_LEAF_ATOL)):
        _round_off(got[key], tree.map(lambda t: t.numpy(), one[key]), rtol,
                   atol, f"{key} ")


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_train_step_matches_jax(accum):
    """The (2, 2) step at accum 1 (2 rows) and 2 (4 rows) against JAX's
    (``jax_side``) and the port's one process."""
    name = f"accum{accum}"
    want = parity.jax_side(ARCH)
    for r in _ranks():
        _hold_to_jax(r["train"][name], want["train"][accum],
                     want["grads"][accum])
    _hold_to_one_process(_ranks()[0]["train"][name], _one_process(name))


def test_mesh_grad_accum_equivalence():
    """Twin of ``test_grad_accum_equivalence``: accum 4 and accum 1 on 8
    rows agree within JAX's bounds, each is JAX's step at the parity
    tolerances and the one-process step at round-off."""
    got = {a: _ranks()[0]["train"][f"rows8_accum{a}"] for a in (1, 4)}
    loss_bound, param_bound = JAX_ACCUM_BOUNDS
    assert abs(got[1]["metrics"][0]["loss"]
               - got[4]["metrics"][0]["loss"]) < loss_bound
    for a, b in zip(tree.leaves(got[1]["params"]),
                    tree.leaves(got[4]["params"])):
        assert np.abs(a - b).max() < param_bound
    jax_runs = _jax_rows8()
    for a in (1, 4):
        _hold_to_jax(got[a], jax_runs[a], jax_runs["grads"])
        _hold_to_one_process(got[a], _one_process(f"rows8_accum{a}"))


@pytest.mark.parametrize("name", ["sharded_2x2", "fsdp_remat"])
def test_mesh_train_steps_match_one_process(name):
    """Twin of ``test_train_step_sharded_2x2`` (two steps of (64, 4) at
    accum 2: finite), and two steps with FSDP on the data axes and remat
    (the leaves gathered again in the checkpointed backward): every rank
    the one-process steps at round-off."""
    one = _one_process(name)
    for r in _ranks():
        got = r["train"][name]
        assert all(np.isfinite(m["loss"]) for m in got["metrics"])
        _hold_to_one_process(got, one)


def test_mesh_moe_aux_loss_is_global():
    """qwen3-moe smoke (FSDP, remat, experts on "model") at accum 2: the
    loss and the router grads of every rank equal the one-process
    step's."""
    one = torch_ranks.moe_grads(_cases()["moe"])
    router = one["router"].numpy()
    for r in _ranks():
        np.testing.assert_allclose(float(r["moe"]["loss"]),
                                   float(one["loss"]), rtol=MOE_RTOL)
        np.testing.assert_allclose(
            r["moe"]["router"], router, rtol=MOE_RTOL,
            atol=MOE_LEAF_ATOL * float(np.abs(router).max()))


@pytest.mark.parametrize("arch", torch_ranks.SERVE_ARCHS)
@pytest.mark.parametrize("rows", [4, 1])
def test_mesh_serve_tokens(arch, rows):
    """A prefill and three greedy decode steps on the (2, 2) mesh (rows
    1: ``long_ctx``, the KV sequence stored on "data"): every rank's tokens
    equal the one-process steps'."""
    want = torch_ranks.serve_case(arch, rows).numpy()
    assert want.shape == (rows, 1 + torch_ranks.SERVE_DECODE)
    for r in _ranks():
        np.testing.assert_array_equal(r["serve"][(arch, rows)], want)


def test_mesh_shards_bitwise_and_placements():
    """After the train steps every local shard of the parameters and
    moments is bitwise its slice of the regathered value, and each sits
    at its ``out_specs`` placement."""
    for r in _ranks():
        for name, got in r["train"].items():
            assert all(got["bitwise"].values()), (name, got["bitwise"])
            bad = [(a, b) for a, b in got["placements"] if a != b]
            assert not bad, (name, bad[:3])


@pytest.mark.parametrize("part", ["params", "m", "v"])
def test_mesh_replicas_stay_equal(part):
    """Ranks that differ only on "model" compute different grads (their
    loss scaled apart by ``REPLICA_SKEW``, as the CUDA backward's atomics
    part them at round-off); after two steps every rank's regathered
    parameters and moments are still bitwise the same, and every local
    shard, each replica's own, bitwise its slice of them."""
    ranks = _ranks()
    want = tree.leaves(ranks[0]["train"]["skewed"][part])
    for r in ranks:
        assert r["train"]["skewed"]["bitwise"][part]
        got = tree.leaves(r["train"]["skewed"][part])
        for a, b in zip(got, want, strict=True):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_mesh_specs_equal_jax():
    """``in_specs`` and ``out_specs`` of every kind of cell of the ten
    archs on the (2, 2) mesh equal JAX's entry for entry."""
    out = _jax_specs_future().result(timeout=300)
    want = json.loads(out.split("RESULT", 1)[1])
    got = _ranks()[0]["specs"]
    for arch in configs.ARCH_IDS:
        for cell, specs in got[arch].items():
            mine = [parity._port_specs(s) for s in specs]
            assert json.loads(json.dumps(mine)) == want[f"{arch}/{cell}"], (
                arch, cell)
