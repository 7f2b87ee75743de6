"""Experts on "model" and the KV sequence on "data" (A.10d part 2): the
port's steps on four gloo ranks of (2, 2), (1, 4) and (4, 1) ("data",
"model") meshes, against the JAX package's steps and the port's
one-process steps.

* The qwen3-moe smoke (8 experts, 2 or 4 a "model" rank) and mixtral
  smoke (4 experts, each expert's d_ff on "model") train steps, accum 1
  and 2, float32, from JAX's parameters and batches: against JAX's at
  ``tests/torch_train_parity.py``'s tolerances and its noise gate, and
  against the one-process step at ``tests/test_torch_tensor_parallel.py``'s
  round-off tolerances; every local shard bitwise its slice, every output
  at its ``out_specs`` placement, every replica the same bits, and no
  ``moe.*`` leaf gathered over "model".
* The router grads (FSDP, remat, accum 2): the loss and the router's grad
  equal the one-process step's as in
  ``test_mesh_moe_aux_loss_is_global``: the router, its top-k and the
  load-balancing loss run outside the expert-parallel region, alike on
  every "model" rank, and the two tensors entering it sum their grads
  over "model" (a router inside it would get its grad m times).
* A 6-expert qwen3-moe smoke on (1, 4), whose experts 4 ranks do not
  divide: computed whole, its expert leaves named in ``model_gathered``,
  held to one process.
* The compute is split: a (1, 4) MoE train step's matrix-product flops a
  rank are at most 0.30 of the one-process step's.
* A prefill and three greedy decode steps at batch 4 and at batch 1
  (``long_ctx``) of both MoE archs: tokens equal to JAX's and the
  one-process steps'.
* ``long_ctx`` on (2, 2) and (4, 1), the KV caches split on their
  sequence over "data", started as noise (``torch_ranks.fill_cache``):
  yi-9b, zamba2 and mixtral smoke (its 46-token prompt wraps the 32-slot
  ring across slice boundaries), a yi-9b cache of 32 whose upper slices
  stay all masked, and a one-kv-head yi-9b whose ``d_head`` "model"
  splits while "data" splits the sequence.  The tokens equal the
  one-process steps'; after the prefill and each step every rank's cache
  shard equals its slice of the one-process cache (rtol 1e-6, atol 1e-5
  of the leaf's largest value: the written slots come from split
  products and a log-sum-exp combine, round-off apart, which zamba2's
  SSD carries to 1.4e-6 of its largest k on (2, 2)), its unwritten
  slots bitwise the noise they started as; a decode step gathers no KV
  cache (``plan.sent["kv"]`` 0) and combines over "data" (``"seq"``).

One ``launch.spawn`` of four ranks runs every case (bodies in
``tests/torch_ranks.py``), on a thread beside the JAX side.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_ranks
import torch_train_parity as parity
from repro_torch import tree
from repro_torch.distributed import sharding
from test_torch_mesh_steps import MOE_LEAF_ATOL, MOE_RTOL, _hold_to_jax
from test_torch_tensor_parallel import _hold_to_one_process

SPAWN_TIMEOUT_S = 400
FLOPS_SHARE = 0.30  # (1, 4): attention, experts and vocab split 4 ways
CACHE_RTOL, CACHE_LEAF_ATOL = 1e-6, 1e-5
MESHES = torch_ranks.EP_MESHES
ARCHS = torch_ranks.EP_ARCHS
TRAIN = [(a, accum) for a in ARCHS for accum in (1, 2)]
MOE_SERVE = [(a, rows) for a in ARCHS for rows in (4, 1)]
LONG = [(m, name) for name, c in torch_ranks.LONG_CASES.items()
        for m in c["meshes"]]


def _moe_serve_case(arch, rows):
    params, batch = parity.jax_inputs(arch)
    return dict(arch=arch, params=params, meshes=MESHES,
                tokens=batch["tokens"][:rows, :torch_ranks.EP_PROMPT],
                length=torch_ranks.EP_LEN, decode=torch_ranks.EP_DECODE)


def _long_case(name):
    c = dict(torch_ranks.LONG_CASES[name])
    cfg = torch_ranks.case_cfg(c)
    c.update(tokens=torch_ranks.step_batch(cfg, 1, c["prompt"], 13)["tokens"],
             decode=torch_ranks.EP_DECODE, fill=True, params=None)
    return c


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    train = {}
    for arch, accum in TRAIN:
        params, batch = parity.jax_inputs(arch)
        train[arch, accum] = dict(arch=arch, params=params, accum=accum,
                                  batch=parity._rows(batch, accum * parity.B),
                                  steps=1)
    router = {arch: dict(arch=arch, variant="fsdp_remat", accum=2,
                         batch=torch_ranks.step_batch(
                             torch_ranks.step_variant(arch, "smoke"), 4,
                             torch_ranks.STEP_L, 3))
              for arch in ARCHS}
    serve = {f"{a}/{rows}": _moe_serve_case(a, rows) for a, rows in MOE_SERVE}
    serve.update({name: _long_case(name) for name in torch_ranks.LONG_CASES})
    whole_arch = ARCHS[0]
    whole = dict(arch=whole_arch, n_experts=torch_ranks.EP_WHOLE_EXPERTS,
                 accum=1, steps=1, batch=torch_ranks.step_batch(
                     torch_ranks.step_variant(whole_arch, "smoke"),
                     parity.B, torch_ranks.STEP_L, 4))
    flops = {arch: train[arch, 1] for arch in ARCHS}
    return {"train": train, "router": router, "serve": serve,
            "whole": whole, "flops": flops}


@functools.lru_cache(maxsize=None)
def _spawned():
    from repro_torch.distributed import launch

    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(launch.spawn, torch_ranks.ep_body, 4,
                         timeout_s=SPAWN_TIMEOUT_S, args=(_cases(),))
    pool.shutdown(wait=False)
    return future


def _ranks() -> list:
    return _spawned().result()


@functools.lru_cache(maxsize=None)
def _one_train(key) -> dict:
    cases = _cases()
    return torch_ranks.train_case(cases["whole"] if key == "whole"
                                  else cases["train"][key])


@functools.lru_cache(maxsize=None)
def _one_serve(name) -> dict:
    return torch_ranks.seq_serve(_cases()["serve"][name])


@functools.lru_cache(maxsize=None)
def _jax_served(arch, rows) -> np.ndarray:
    """JAX's prefill and greedy decode steps of ``_moe_serve_case``."""
    import repro.configs as j_cfgs
    from repro.models import build as j_build
    from repro.training.steps import build_for_cell as j_build_for_cell

    case = _moe_serve_case(arch, rows)
    model = j_build(j_cfgs.get_smoke(arch))
    length = case["length"]
    with parity._mesh() as mesh:
        prefill = j_build_for_cell(model, mesh, j_cfgs.ShapeCell(
            "p", "prefill", torch_ranks.EP_PROMPT, rows))[0]
        decode = j_build_for_cell(model, mesh, j_cfgs.ShapeCell(
            "d", "decode", length, rows))[0]
        tok, cache = prefill(case["params"], case["tokens"],
                             model.init_cache(rows, length))
        served = [np.asarray(tok)]
        for _ in range(case["decode"]):
            tok, cache = decode(case["params"], tok, cache)
            served.append(np.asarray(tok))
    return np.stack(served, 1)


def test_ep_jax_inputs_are_jax_sides():
    """The ranks start from ``parity.jax_side``'s parameters and batch
    (made here without its steps, so that the spawn runs beside them)."""
    _spawned()
    for arch in ARCHS:
        params, batch = parity.jax_inputs(arch)
        want = parity.jax_side(arch)
        for a, b in zip(tree.leaves(params), tree.leaves(want["params"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        for key in batch:
            np.testing.assert_array_equal(batch[key], want["batch"][key])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch,accum", TRAIN)
def test_ep_train_step_matches_jax_and_one_process(mesh, arch, accum):
    """Every rank's step against JAX's and the one-process step's."""
    _spawned()
    want = parity.jax_side(arch)
    one = _one_train((arch, accum))
    for r in _ranks():
        got = r[mesh]["train"][arch, accum]
        _hold_to_jax(got, want["train"][accum], want["grads"][accum])
        _hold_to_one_process(got, one, want["grads"][accum])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_ep_shards_bitwise_replicas_equal_no_expert_gathered(mesh):
    """After each MoE train step every local shard is bitwise its slice,
    at its ``out_specs`` placement, every rank's regathered parameters
    and moments are the same bits, and no ``moe.*`` leaf is gathered
    over "model"."""
    ranks = _ranks()
    for key in _cases()["train"]:
        first = ranks[0][mesh]["train"][key]
        for r in ranks:
            got = r[mesh]["train"][key]
            assert all(got["bitwise"].values()), (key, got["bitwise"])
            bad = [(a, b) for a, b in got["placements"] if a != b]
            assert not bad, (key, bad[:3])
            for part in ("params", "m", "v"):
                for a, b in zip(tree.leaves(got[part]),
                                tree.leaves(first[part]), strict=True):
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
            assert not [n for n in got["model_gathered"] if "moe" in n], (
                key, got["model_gathered"])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_router_grads_equal_one_process(mesh, arch):
    """FSDP, remat, accum 2: the loss and the router grads of every rank
    equal the one-process step's."""
    one = torch_ranks.moe_grads(_cases()["router"][arch])
    router = one["router"].numpy()
    for r in _ranks():
        got = r[mesh]["router"][arch]
        np.testing.assert_allclose(float(got["loss"]), float(one["loss"]),
                                   rtol=MOE_RTOL)
        np.testing.assert_allclose(
            got["router"], router, rtol=MOE_RTOL,
            atol=MOE_LEAF_ATOL * float(np.abs(router).max()))


def _one_grads(case) -> dict:
    """The one-process grads of a case's step (numpy, by path)."""
    import torch

    from repro_torch.models import build
    from repro_torch.training import loss_and_grads

    cfg = torch_ranks.case_cfg(case)
    grads = loss_and_grads(
        build(cfg, "cpu"), torch_ranks.step_params(cfg),
        {k: torch.tensor(v) for k, v in case["batch"].items()},
        case["accum"])[2]
    return tree.map(lambda g: g.numpy(), grads)


def test_ep_undivided_experts_computed_whole():
    """6 experts on 4 "model" ranks: the layer is computed whole, its
    expert leaves named in ``model_gathered``, the step held to one
    process (the noise gate on the one-process grads)."""
    one = _one_train("whole")
    grads = _one_grads(_cases()["whole"])
    for r in _ranks():
        got = r[(1, 4)]["whole"]
        assert {"['blocks']['moe']['wg']", "['blocks']['moe']['wu']",
                "['blocks']['moe']['wd']"} <= set(got["model_gathered"]), (
            got["model_gathered"])
        assert all(got["bitwise"].values()), got["bitwise"]
        _hold_to_one_process(got, one, grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_compute_is_split(arch):
    """A (1, 4) MoE smoke train step's matrix-product flops a rank are at
    most 0.30 of the one-process step's."""
    one = torch_ranks.tp_matmul_flops(_cases()["flops"][arch])
    for r in _ranks():
        share = r[(1, 4)]["flops"][arch] / one
        print(f"{arch}: matrix-product flops a rank on (1, 4): {share:.4f} "
              f"of the one-process step's")
        assert share <= FLOPS_SHARE, share


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch,rows", MOE_SERVE)
def test_ep_serve_tokens(mesh, arch, rows):
    """A prefill and three greedy decode steps at batch 4 and at batch 1:
    every rank's tokens equal JAX's and the one-process steps'."""
    _spawned()
    want = _jax_served(arch, rows)
    np.testing.assert_array_equal(_one_serve(f"{arch}/{rows}")["tokens"],
                                  want)
    for r in _ranks():
        np.testing.assert_array_equal(
            r[mesh]["serve"][f"{arch}/{rows}"]["tokens"], want)


def _unwritten(case, step, shape, sl):
    """The mask of a local shard's slots (its slice ``sl`` of a cache of
    ``shape``) that no step has written by ``step`` (0: the prefill):
    positions at or past the length, where the ring has not wrapped."""
    seq = np.arange(shape[2])[sl[2]]
    written = case["prompt"] + step
    if case["prompt"] >= shape[2]:  # the ring wrapped: every slot written
        written = shape[2]
    mask = np.zeros([s.stop - s.start for s in sl], dtype=bool)
    mask[:, :, seq >= written] = True
    return mask


@pytest.mark.parametrize("mesh,name", LONG, ids=str)
def test_long_ctx_sequence_split(mesh, name):
    """long_ctx with the KV sequence on "data": tokens equal to the
    one-process steps'; every cache shard its slice of the one-process
    cache after the prefill and each step, its unwritten slots the noise
    they started as; no KV cache gathered in a decode step."""
    case = _cases()["serve"][name]
    one = _one_serve(name)
    fill = torch_ranks.initial_cache(case).kv
    noise = {"k": fill.k.numpy(), "v": fill.v.numpy()}
    for r in _ranks():
        got = r[mesh]["serve"][name]
        np.testing.assert_array_equal(got["tokens"], one["tokens"])
        assert got["sent_decode"]["kv"] == 0, got["sent_decode"]
        assert got["sent_prefill"]["kv"] == 0, got["sent_prefill"]
        assert (got["sent_decode"]["seq"] > 0) == (mesh[0] > 1), (
            got["sent_decode"])
        for step, (kv_got, kv_one) in enumerate(zip(got["kv"], one["kv"],
                                                     strict=True)):
            for f in ("k", "v"):
                spec, local = kv_got[f]
                whole = kv_one[f]
                assert spec[2] == ("data" if mesh[0] > 1 else None), spec
                sl = sharding.local_slices(whole.shape, got["sizes"], spec,
                                           got["coord"])
                np.testing.assert_allclose(
                    local, whole[sl], rtol=CACHE_RTOL,
                    atol=CACHE_LEAF_ATOL * float(np.abs(whole).max()),
                    err_msg=f"{f} after step {step}")
                mask = _unwritten(case, step, whole.shape, sl)
                assert np.array_equal(local[mask], noise[f][sl][mask]), (
                    f, step)
