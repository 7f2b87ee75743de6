"""The SSD's heads and uneven attention heads on "model"
(``repro_torch.models.ssm``, ``attention``'s balanced head ranges, the
hooks of ``repro_torch.models.common``): the port's steps on four gloo
ranks of a (2, 2) and a (1, 4) ("data", "model") mesh, against the JAX
package's steps and the port's one-process steps.

* The mamba2 and zamba2 smoke train steps (accum 1 and 2, float32; the
  SSD's 8 heads, ``in_proj``'s 296 columns split z | x B C | dt), from
  JAX's parameters and batches: against JAX's at
  ``tests/torch_train_parity.py``'s tolerances and against the
  one-process step at ``test_torch_tensor_parallel.py``'s round-off
  tolerances (zamba2 at the parity module's, as against JAX: its grads
  are ill conditioned in float32, and any other order of its sums moves
  them by up to 4.4e-5 of a leaf's largest moment and its gnorm by up
  to 1.9e-6; its attention and MLP split over "model" with the SSD
  whole on every rank move the gnorm by 1.19e-6 alone); every local
  shard bitwise its slice, every replica the same bits.
* The SSD's grads of an accum-2 step, gathered whole, against the
  one-process ones leaf by leaf at the parity module's grad tolerances:
  ``norm_w``, ``A_log``, ``D``, ``dt_bias``, ``in_proj`` (its B / C
  columns on their own too: each rank projects a share, gathered, whose
  grads every rank's heads add to), the conv and ``out_proj``.  The
  gated norm's sum of squares is totalled over "model" with its grad
  summed too: a copy whose backward passes the grad through instead
  (``reduce_from_model``'s) fails this test.
* ``common.gather_from_model`` (B and C's shares): the value is every
  rank's share in rank order, and its backward sums bf16 partial grads
  in float32 before one cast (4 bytes an element sent).
* Serving: a prefill and three greedy decode steps, tokens equal to
  JAX's and the one-process steps'; after each step every rank's local
  SSM state is its heads' slice of the one-process state (rtol 1e-5 and
  1e-5 of the state's largest value) and a decode step gathers no leaf
  over "model".
* The compute is split: on (1, 4) the SSD of one layer, forward and
  backward, counts at most its arithmetic share of the one-process
  matrix-product flops plus 0.05.  The arithmetic share is what a rank
  of two of the 8 heads must compute, the C·B product of its one group
  whole: ``_ssd_share``'s count of the forward's products.
* Uneven heads: qwen3 smoke with 6 heads (2 kv heads), which 4 ranks on
  "model" divide neither (qwen3-14b's 40 heads over 16), trains (accum 1
  and 2) and serves as one process does (JAX's configs have no such
  variant; the port's seed-0 parameters); a (1, 4) command-r smoke train
  step (6 heads over 4, as it is) counts at most 0.30 of the
  one-process matrix-product flops a rank (every head on every rank:
  about 0.37).
* The dry-run: mamba2-370m decode_32k on the 256-rank production mesh,
  JAX's ``useful_flops_ratio`` (pinned, from ``repro.launch.dryrun``)
  at most 1.5 times the port's.

One ``launch.spawn`` of four ranks runs every case on both meshes (bodies
in ``tests/torch_ranks.py``), after JAX's sides; the dry-run's child
process runs beside it.
"""

import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_ranks
import torch_train_parity as parity
from test_torch_mesh_steps import _hold_to_jax
from test_torch_tensor_parallel import FLOPS_SHARE, _hold_to_one_process

SPAWN_TIMEOUT_S = 300
MESHES = torch_ranks.SSD_MESHES
ARCHS = torch_ranks.SSD_ARCHS
TRAIN = [(a, accum) for a in ARCHS for accum in (1, 2)]
UNEVEN = torch_ranks.UNEVEN
STATE_RTOL, STATE_LEAF_ATOL = 1e-5, 1e-5
SSD_SHARE_SLACK = 0.05
# JAX's useful_flops_ratio of mamba2-370m decode_32k on the single-pod
# mesh (python -m repro.launch.dryrun --arch mamba2-370m --shape
# decode_32k --mesh single), and the most it may be of the port's.
DRYRUN_CELL = ("mamba2-370m", "decode_32k")
JAX_RATIO = 0.9672
RATIO_MAX = 1.5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _serve_case(arch):
    params, b = parity.jax_inputs(arch)
    return dict(arch=arch, params=params,
                tokens=b["tokens"][:parity.B, :parity.PROMPT],
                decode=parity.DECODE)


def _train_case(arch, accum):
    params, batch = parity.jax_inputs(arch)
    return dict(arch=arch, params=params,
                batch=parity._rows(batch, accum * parity.B),
                accum=accum, steps=1)


def _uneven_case(accum):
    cfg = torch_ranks.case_cfg(torch_ranks.UNEVEN_CASE)
    return dict(torch_ranks.UNEVEN_CASE, params=None, accum=accum, steps=1,
                batch=torch_ranks.step_batch(cfg, accum * parity.B,
                                             parity.L, 7))


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    train = {(a, accum): _train_case(a, accum) for a, accum in TRAIN}
    train.update({(UNEVEN, accum): _uneven_case(accum) for accum in (1, 2)})
    serve = {a: _serve_case(a) for a in ARCHS}
    cfg = torch_ranks.case_cfg(torch_ranks.UNEVEN_CASE)
    serve[UNEVEN] = dict(torch_ranks.UNEVEN_CASE, params=None,
                         decode=parity.DECODE,
                         tokens=torch_ranks.step_batch(
                             cfg, parity.B, parity.PROMPT, 11)["tokens"])
    flops_cfg = torch_ranks.case_cfg(
        dict(arch=torch_ranks.UNEVEN_FLOPS_ARCH))
    return {"train": train,
            "grads": {a: train[a, 2] for a in ARCHS},
            "serve": serve,
            "flops": {"ssd": dict(arch="mamba2-370m"),
                      "uneven": dict(
                          arch=torch_ranks.UNEVEN_FLOPS_ARCH, accum=1,
                          batch=torch_ranks.step_batch(
                              flops_cfg, parity.B, parity.L, 9))}}


@functools.lru_cache(maxsize=None)
def _dryrun_child():
    """The dry-run CLI on ``DRYRUN_CELL`` (single pod) in a child process,
    started once (beside the ranks): (the process, its output dir)."""
    arch, shape = DRYRUN_CELL
    out = pathlib.Path(tempfile.mkdtemp(prefix="ssd_dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out


@functools.lru_cache(maxsize=None)
def _spawned():
    """The dry-run child and the 4-rank spawn, started once on a thread
    (beside JAX's steps): the future of the ranks' results."""
    from repro_torch.distributed import launch

    _dryrun_child()
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(launch.spawn, torch_ranks.ssd_body, 4,
                         timeout_s=SPAWN_TIMEOUT_S, args=(_cases(),))
    pool.shutdown(wait=False)
    return future


def _ranks() -> list:
    future = _spawned()
    for arch in ARCHS:  # JAX's steps while the ranks run
        parity.jax_side(arch)
    return future.result()


@functools.lru_cache(maxsize=None)
def _one_process(kind: str, key) -> dict:
    fn = {"train": torch_ranks.train_case, "grads": torch_ranks.ssd_grads,
          "serve": torch_ranks.ssd_serve}[kind]
    return fn(_cases()[kind][key])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch,accum", TRAIN)
def test_ssd_train_step_matches_jax_and_one_process(mesh, arch, accum):
    """Every rank's step against JAX's and the one-process step's."""
    ranks = _ranks()
    want = parity.jax_side(arch)
    one = _one_process("train", (arch, accum))
    for r in ranks:
        got = r[mesh]["train"][arch, accum]
        _hold_to_jax(got, want["train"][accum], want["grads"][accum])
        if arch == "zamba2-2.7b":  # the parity tolerances (docstring)
            _hold_to_jax(got, dict(one, metrics=one["metrics"][0]),
                         want["grads"][accum])
        else:
            _hold_to_one_process(got, one, want["grads"][accum])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_ssd_shards_bitwise_and_replicas_equal(mesh):
    """After each train step (the SSD archs' and the uneven heads') every
    local shard is bitwise its slice at its ``out_specs`` placement, and
    every rank's regathered parameters and moments are the same bits."""
    from repro_torch import tree

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


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_grads_match_one_process(mesh, arch):
    """The SSD's grads of an accum-2 step, gathered whole, against the
    one-process grads leaf by leaf; ``in_proj``'s B / C columns
    (projected by shares, gathered; their grads from every rank's heads)
    on their own."""
    from repro_torch import configs

    one = _one_process("grads", arch)
    s = configs.get_smoke(arch).ssm
    bc = slice(2 * s.d_inner, s.d_inner + s.conv_dim)
    for r in _ranks():
        got = r[mesh]["grads"][arch]
        assert set(got) == set(one)
        leaves = [(k, got[k], one[k]) for k in sorted(one)]
        leaves.append(("in_proj B/C", got["in_proj"][..., bc],
                       one["in_proj"][..., bc]))
        for name, g, w in leaves:
            np.testing.assert_allclose(
                g, w, rtol=parity.GRAD_RTOL, atol=max(
                    parity.GRAD_ATOL,
                    parity.GRAD_LEAF_ATOL * float(np.abs(w).max())),
                err_msg=f"{arch} {mesh} {name}")


def _local_slice(whole, spec, sizes, coord):
    from repro_torch.distributed import sharding

    return whole[sharding.local_slices(whole.shape, sizes, spec, coord)]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_serve_tokens_and_states(mesh, arch):
    """A prefill and three greedy decode steps: tokens equal to JAX's and
    the one-process steps'; after each step every rank's SSM state is
    its heads' slice (H / m of them) of the one-process state, its conv
    tail its channels'; a decode step gathers no leaf over "model"."""
    from repro_torch import configs

    one = _one_process("serve", arch)
    np.testing.assert_array_equal(one["tokens"],
                                  parity.jax_side(arch)["served"])
    cfg = configs.get_smoke(arch)
    head_dim = 2 if cfg.block == "ssm" else 3  # after the layer dims
    for r in _ranks():
        got = r[mesh]["serve"][arch]
        np.testing.assert_array_equal(got["tokens"], one["tokens"])
        assert got["decode_gathered"] == [], got["decode_gathered"]
        for step, (st, st1) in enumerate(zip(got["states"], one["states"],
                                             strict=True)):
            spec, ssm = st["ssm"]
            assert ssm.shape[head_dim] == (cfg.ssm.n_heads
                                           // got["sizes"]["model"])
            for field in ("ssm", "conv"):
                spec, local = st[field]
                want = _local_slice(st1[field], spec, got["sizes"],
                                    got["coord"])
                np.testing.assert_allclose(
                    local, want, rtol=STATE_RTOL,
                    atol=STATE_LEAF_ATOL * float(np.abs(st1[field]).max()),
                    err_msg=f"{arch} {mesh} step {step} {field}")


def _ssd_share(cfg, m: int, L: int = torch_ranks.STEP_L) -> float:
    """The share of the SSD's forward matrix-product flops on a (·, L)
    input that a rank of H / m heads computes: ``in_proj``'s columns of
    its heads and of its share of B / C's channels, the C·B product of
    the G groups (every rank computes it whole), the per-head
    intra-chunk, state and inter-chunk products, its rows of
    ``out_proj``."""
    s = cfg.ssm
    Q = min(s.chunk, L)
    while L % Q:
        Q -= 1
    GN, P, N = s.n_groups * s.d_state, s.headdim, s.d_state

    def flops(h):
        bc = 2 * GN * h // s.n_heads  # the rank's share of B / C
        return (L * cfg.d_model * (2 * h * P + bc + h)  # in_proj
                + L * Q * s.n_groups * N  # C.B
                + L * Q * h * P + 2 * L * h * P * N  # intra, states, inter
                + L * h * P * cfg.d_model)  # out_proj

    return flops(s.n_heads // m) / flops(s.n_heads)


def test_ssd_compute_is_split():
    """On (1, 4) the SSD of one mamba2 smoke layer, forward and backward,
    counts at most its arithmetic share of the one-process flops plus
    0.05."""
    from repro_torch import configs

    case = _cases()["flops"]["ssd"]
    one = torch_ranks.ssd_flops(case)
    share = _ssd_share(configs.get_smoke(case["arch"]), 4)
    for r in _ranks():
        got = r[(1, 4)]["flops"]["ssd"] / one
        print(f"SSD matrix-product flops a rank on (1, 4): {got:.4f} of the "
              f"one-process SSD's (arithmetic share {share:.4f})")
        assert got <= share + SSD_SHARE_SLACK, (got, share)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_gather_from_model_sums_grads_one_precision_up(mesh):
    """``common.gather_from_model`` (B and C's shares) gathers every
    rank's share, and its backward sums bf16 partial grads in float32
    before one cast, as every other sum of per-rank partials does: the
    grad is the float32 sum cast to bf16, and the reduce-scatter sends
    4 bytes an element."""
    for r in _ranks():
        got = r[mesh]["gather"]
        assert got["value"] and got["grad"], got
        assert got["grad_dtype"] == "torch.bfloat16", got
        assert got["sent"] == got["want_sent"], got


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("accum", (1, 2))
def test_uneven_heads_train_step_matches_one_process(mesh, accum):
    """qwen3 smoke with 6 heads: every rank's step against the one-process
    step's (at round-off; the noise gate on the parameters from the
    one-process grads)."""
    one = _one_process("train", (UNEVEN, accum))
    case = _cases()["train"][UNEVEN, accum]
    g_one = _grads_one(case)
    for r in _ranks():
        _hold_to_one_process(r[mesh]["train"][UNEVEN, accum], one, g_one)


def _grads_one(case):
    """The one-process grads of a case's step (the noise gate's)."""
    import torch

    from repro_torch import tree
    from repro_torch.models import build
    from repro_torch.training import steps

    cfg = torch_ranks.case_cfg(case)
    grads = steps.loss_and_grads(
        build(cfg, "cpu"), torch_ranks.step_params(cfg),
        {k: torch.tensor(v) for k, v in case["batch"].items()},
        case["accum"])[2]
    return tree.map(lambda g: g.numpy(), grads)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_uneven_heads_serve_tokens(mesh):
    """qwen3 smoke with 6 heads: a prefill and three greedy steps, tokens
    equal to the one-process steps' (the cache split on ``d_head`` on (1,
    4))."""
    one = _one_process("serve", UNEVEN)
    for r in _ranks():
        np.testing.assert_array_equal(r[mesh]["serve"][UNEVEN]["tokens"],
                                      one["tokens"])


def test_uneven_heads_compute_is_split():
    """A (1, 4) command-r smoke train step (6 heads over 4) counts at most
    0.30 of the one-process matrix-product flops a rank."""
    one = torch_ranks.tp_matmul_flops(_cases()["flops"]["uneven"])
    for r in _ranks():
        share = r[(1, 4)]["flops"]["uneven"] / one
        print(f"command-r smoke matrix-product flops a rank on (1, 4): "
              f"{share:.4f} of the one-process step's")
        assert share <= FLOPS_SHARE, share


def test_head_range_is_balanced():
    """Rank r of m takes heads [floor(r H / m), floor((r + 1) H / m)): the
    ranges tile the heads, differ in size by at most one, and are the
    even split where m divides H."""
    import types

    from repro_torch.models import common

    for H, m in ((6, 4), (40, 16), (20, 8), (8, 4), (3, 4)):
        got = []
        for r in range(m):
            with common.tensor_parallel(types.SimpleNamespace(
                    tp_size=m, tp_rank=r)):
                got.append(common.head_range(H))
        assert got[0][0] == 0 and got[-1][1] == H
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
        sizes = {hi - lo for lo, hi in got}
        assert max(sizes) - min(sizes) <= 1
        if H % m == 0:
            assert sizes == {H // m}
    assert common.head_range(40) == (0, 40)


def test_cache_model_split_names_sub_fields():
    """``LMCache.MODEL_SPLIT`` keeps the KV caches and the SSM state's
    heads at their "model" split; the conv tail and ``pos`` are whole."""
    from repro_torch import configs, tree
    from repro_torch.models import build
    from repro_torch.training import steps

    model = build(configs.get_smoke("zamba2-2.7b"), "meta")
    cache = model.init_cache(2, 16)
    names = tree.leaves_with_names(cache)[0]
    split = dict(zip(names, steps._model_split(cache), strict=True))
    assert split == {".kv.k": True, ".kv.v": True, ".kv.length": True,
                     ".ssm.ssm": True, ".ssm.conv": False, ".ssm.pos": False}


def test_ssd_dryrun_cell_ratio():
    """mamba2-370m decode_32k single through the dry-run CLI: ``ok``, and
    JAX's ``useful_flops_ratio`` (pinned) at most 1.5 times the port's."""
    arch, shape = DRYRUN_CELL
    proc, out = _dryrun_child()
    try:
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        rec = json.loads((out / f"{arch}__{shape}__single.json")
                         .read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    assert rec["status"] == "ok", rec
    ratio = JAX_RATIO / rec["useful_flops_ratio"]
    print(f"{arch} {shape} single: useful_flops_ratio "
          f"{rec['useful_flops_ratio']}, JAX's {JAX_RATIO}: {ratio:.3f}")
    assert ratio <= RATIO_MAX, ratio
