"""Tensor-parallel compute on "model" for the dense layers
(``repro_torch.distributed.spmd``, the hooks of
``repro_torch.models.common``): the port's steps on four gloo ranks of a
(2, 2) and a (1, 4) ("data", "model") mesh, against the JAX package's
steps and the port's one-process steps.

* The yi-9b and whisper smoke train steps (accum 1 and 2, float32), from
  JAX's parameters and batches: against JAX's at
  ``tests/torch_train_parity.py``'s tolerances and its noise gate on the
  parameters, and against the one-process step at
  ``test_mesh_train_steps_match_one_process``'s round-off tolerances
  (``tests/test_torch_mesh_steps.py``); every local shard bitwise its
  slice, every output at its ``out_specs`` placement, every replica the
  same bits.  The split layers add in another order than one process
  (the row-parallel partials, a column shard's products), so the
  parameters after AdamW's first step are held to the one-process ones
  behind the parity module's noise gate, as to JAX's: where a grad is
  cancellation noise (yi-9b ``wd[0, 119, 7]`` at accum 2: JAX's grad
  3.8e-8, the one-process 5.6e-9 and the (1, 4) mesh's 4.7e-9, of a leaf
  whose largest is 0.11), m̂ / (√v̂ + ε) moves by up to 2 lr either way.
* A prefill and three greedy decode steps: tokens equal to JAX's and the
  one-process steps'.  On (1, 4) yi-9b smoke has 2 kv heads over 4 ranks
  (the cache split on ``d_head``, decode contracting QK^T on a slice)
  and command-r smoke 6 heads over 4 (train and prefill compute a
  balanced 1 or 2 heads a rank: ``tests/test_torch_ssd_parallel.py``);
  whisper's cross-attention caches follow its heads, and a 6-head whisper
  smoke (the port's parameters, held to one process) splits its self and
  cross caches on ``d_head``.
* The vocab-parallel helpers: the NLL and its grad equal
  ``models.transformer._nll``'s on the gathered logits within 1e-6, the
  argmax ``torch.argmax``'s with ties across a shard boundary.
* The compute is split: a (1, 4) yi-9b smoke train step's matrix-product
  flops a rank are at most 0.30 of the one-process step's.
* A row-parallel partial and its hand-written backward, bf16 and
  float32, against autograd of the float64 product (no ranks).

One ``launch.spawn`` of four ranks runs every case on both meshes (bodies
in ``tests/torch_ranks.py``), after JAX's sides.
"""

import functools

import numpy as np
import pytest

import torch_ranks
import torch_train_parity as parity
from repro_torch import tree
from test_torch_mesh_steps import (ROUND_METRIC_RTOL, ROUND_MOM_LEAF_ATOL,
                                   ROUND_MOM_RTOL, ROUND_PARAM_LEAF_ATOL,
                                   ROUND_PARAM_RTOL, _hold_to_jax)

SPAWN_TIMEOUT_S = 300
NLL_TOL = 1e-6
FLOPS_SHARE = 0.30  # (1, 4): the q, o, ffn and vocab products split 4 ways
MESHES = torch_ranks.TP_MESHES
TRAIN = [(a, accum) for a in torch_ranks.TP_TRAIN_ARCHS for accum in (1, 2)]
SERVE = [(m, a) for m in MESHES for a in torch_ranks.TP_SERVE_ARCHS[m]]


def _serve_case(arch):
    want = parity.jax_side(arch)
    b = want["batch"]
    return dict(arch=arch, params=want["params"],
                tokens=b["tokens"][:parity.B, :parity.PROMPT],
                frames=b["frames"][:parity.B] if "frames" in b else None,
                decode=parity.DECODE)


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    train = {}
    for arch, accum in TRAIN:
        want = parity.jax_side(arch)
        train[arch, accum] = dict(
            arch=arch, variant="smoke", params=want["params"],
            batch=parity._rows(want["batch"], accum * parity.B),
            accum=accum, steps=1)
    serve = {a: _serve_case(a) for a in sorted(
        {a for archs in torch_ranks.TP_SERVE_ARCHS.values() for a in archs}
        - {torch_ranks.WHISPER_6H})}
    serve[torch_ranks.WHISPER_6H] = dict(serve["whisper-large-v3"],
                                         params=None, n_heads=6)
    flops = dict(train[torch_ranks.TP_FLOPS_ARCH, 1])
    return {"train": train, "serve": serve, "flops": flops}


@functools.lru_cache(maxsize=None)
def _ranks() -> list:
    from repro_torch.distributed import launch

    return launch.spawn(torch_ranks.tp_body, 4, timeout_s=SPAWN_TIMEOUT_S,
                        args=(_cases(),))


@functools.lru_cache(maxsize=None)
def _one_process(arch: str, accum: int) -> dict:
    return torch_ranks.train_case(_cases()["train"][arch, accum])


def _hold_to_one_process(got, one, g_want):
    """A rank's step against the one-process step's: metrics, ``m`` and
    ``v`` at round-off (with ``parity.MOM_ATOL`` as the floor); the
    parameters at round-off where JAX's |g| is above the parity noise
    gate (module docstring)."""
    for m_got, m_one in zip(got["metrics"], one["metrics"], strict=True):
        for key in m_one:
            np.testing.assert_allclose(m_got[key], m_one[key],
                                       rtol=ROUND_METRIC_RTOL, err_msg=key)
    assert got["step"] == one["step"] == len(one["metrics"])
    for key in ("m", "v"):  # with the parity module's floor: the key
        # biases' grads are 0 but for round-off (whisper's cross bk)
        names, flat = tree.leaves_with_names(got[key])
        for name, x, y in zip(names, flat, tree.leaves(one[key]),
                              strict=True):
            y = y.numpy()
            np.testing.assert_allclose(
                np.asarray(x), y, rtol=ROUND_MOM_RTOL, atol=max(
                    parity.MOM_ATOL,
                    ROUND_MOM_LEAF_ATOL * float(np.abs(y).max())),
                err_msg=f"{key} {name}")
    names, flat = tree.leaves_with_names(got["params"])
    kept = total = 0
    for name, p, p_one, g in zip(names, flat, tree.leaves(one["params"]),
                                 tree.leaves(g_want), strict=True):
        p_one = p_one.numpy()
        g = np.abs(np.asarray(g, np.float32))
        noise = max(parity.GRAD_ATOL,
                    parity.GRAD_LEAF_ATOL * float(g.max(initial=0.0)))
        sure = g > parity.NOISE_FACTOR * noise
        np.testing.assert_allclose(
            np.asarray(p)[sure], p_one[sure], rtol=ROUND_PARAM_RTOL,
            atol=ROUND_PARAM_LEAF_ATOL * float(np.abs(p_one).max()),
            err_msg=f"params {name}")
        kept += int(sure.sum())
        total += g.size
    assert kept >= total // 2


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch,accum", TRAIN)
def test_tp_train_step_matches_jax_and_one_process(mesh, arch, accum):
    """Every rank's step against JAX's and the one-process step's."""
    want = parity.jax_side(arch)
    one = _one_process(arch, accum)
    for r in _ranks():
        got = r[mesh]["train"][arch, accum]
        _hold_to_jax(got, want["train"][accum], want["grads"][accum])
        _hold_to_one_process(got, one, want["grads"][accum])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_tp_shards_bitwise_and_replicas_equal(mesh):
    """After each train step every local shard is bitwise its slice of
    the regathered value, at its ``out_specs`` placement, and every
    rank's regathered parameters and moments are the same bits."""
    ranks = _ranks()
    for key in _cases()["train"]:
        for r in ranks:
            got = r[mesh]["train"][key]
            assert all(got["bitwise"].values()), (key, got["bitwise"])
            bad = [(a, b) for a, b in got["placements"] if a != b]
            assert not bad, (key, bad[:3])
            first = ranks[0][mesh]["train"][key]
            for part in ("params", "m", "v"):
                for a, b in zip(tree.leaves(got[part]),
                                tree.leaves(first[part]), strict=True):
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("mesh,arch", SERVE, ids=str)
def test_tp_serve_tokens(mesh, arch):
    """A prefill and three greedy decode steps: every rank's tokens equal
    JAX's (but for the 6-head whisper, which JAX's configs lack) and the
    one-process steps'."""
    want = torch_ranks.tp_serve(_cases()["serve"][arch])
    if arch != torch_ranks.WHISPER_6H:
        np.testing.assert_array_equal(want, parity.jax_side(arch)["served"])
    for r in _ranks():
        np.testing.assert_array_equal(r[mesh]["serve"][arch], want)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_tp_vocab_helpers(mesh):
    """The vocab-parallel NLL (and its grad) equal ``_nll`` on the
    gathered logits within 1e-6; the argmax is ``torch.argmax``'s, ties
    across a shard boundary and inside one taken at the lowest index."""
    for r in _ranks():
        v = r[mesh]["vocab"]
        assert v["nll_err"] <= NLL_TOL * abs(v["nll"]), v
        assert v["grad_err"] <= NLL_TOL, v
        np.testing.assert_array_equal(v["argmax"], v["argmax_want"])


def test_tp_compute_is_split():
    """A (1, 4) yi-9b smoke train step's matrix-product flops a rank are at
    most 0.30 of the one-process step's."""
    one = torch_ranks.tp_matmul_flops(_cases()["flops"])
    for r in _ranks():
        share = r[(1, 4)]["flops"] / one
        print(f"matrix-product flops a rank on (1, 4): {share:.4f} of the "
              f"one-process step's")
        assert share <= FLOPS_SHARE, share


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_product_and_grads_match_einsum(dtype):
    """The row-parallel partial of ``dtype`` operands, one precision up,
    and its hand-written backward (the bf16 path of every published
    config's train step) against autograd of the float64 ``einsum``."""
    import torch

    dt = getattr(torch, dtype)
    got = torch_ranks.row_product_errors(dt, "cpu")
    out_tol, grad_tol = torch_ranks.ROW_PRODUCT_TOL[dt]
    assert got["dtype"] == {torch.bfloat16: torch.float32,
                            torch.float32: torch.float64}[dt], got
    assert got["grad_dtypes"] == (dt, dt), got
    assert got["out"] <= out_tol, got
    assert got["h"] <= grad_tol and got["w"] <= grad_tol, got


def test_remat_recompute_keeps_the_hooks():
    """The checkpointed recompute of a ``remat`` body runs under the
    forward's tensor-parallel and data-parallel hooks, also when the
    backward runs on another thread (as autograd runs it for CUDA
    tensors): the hooks are thread-local."""
    import threading
    import types

    import torch

    from repro_torch.models import common

    seen = []

    def body(x):
        seen.append((common.model_size(),
                     float(common.data_mean(x.detach()).sum())))
        return x * x

    cfg = types.SimpleNamespace(remat=True, remat_policy=None)
    hook = types.SimpleNamespace(tp_size=4, tp_rank=1)
    x = torch.ones(3, requires_grad=True)
    with common.tensor_parallel(hook), common.data_parallel(
            lambda t: t / 2):
        y = common.remat(body, cfg)(x).sum()
    grads = []
    worker = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join()
    assert seen == [(4, 1.5), (4, 1.5)], seen  # forward, then recompute
    assert torch.equal(grads[0], torch.full((3,), 2.0))
    assert common.model_size() == 1
