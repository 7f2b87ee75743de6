"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on rank 0 of a
production mesh, without a device.

Port of ``repro/launch/dryrun.py``.  JAX's lowers and compiles each cell's
jitted step on 512 placeholder host devices; here each cell starts a world
of 256 (single pod, (16, 16) over ("data", "model")) or 512 ranks
(multi-pod, (2, 16, 16) over ("pod", "data", "model")) on torch's fake
process group (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``: every collective returns at once), builds the mesh with
:func:`repro_torch.launch.mesh.make_production_mesh` and runs rank 0's step
from :func:`repro_torch.training.steps.build_for_cell` on ``meta`` tensors
(``input_specs()`` cut to rank 0's local shards) under
:func:`repro_torch.launch.cost.analyze`, at 1 to 3 depth units and 2 to 3
microbatches, each count carried to the full depth and ``accum_steps``
(:func:`count`: JAX's scans are counted as a body times its trip count).
It is a device-free tool by nature, as JAX's is, not a fallback of a
device path.  The fake group owns
its process: each cell runs in a fresh interpreter (a spawned child of the
CLI).  ``accum_steps`` is JAX's rule: a live microbatch of 2 rows a data
replica for a train cell.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
Results are JSON per cell, ``<arch>__<shape>__<mesh>.json`` (resumable:
existing files are skipped); ``configs.skip_reason`` cells are written as
``"skipped"``, a cell that raises as ``"error"`` with its traceback.

An ``"ok"`` record has JAX's keys where the meaning carries: ``arch``,
``shape``, ``mesh``, ``status``, ``n_chips``,
``collective_bytes_per_device`` (by op: ``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``total``), ``model_flops_global`` /
``model_flops_per_device`` (:func:`model_flops`, JAX's formula),
``useful_flops_ratio``, ``roofline`` (``compute_s``, ``memory_s``,
``collective_s``), ``dominant``, ``step_time_bound_s`` and
``bytes_per_device``.  Changed:

* ``counted_flops_per_device`` / ``counted_bytes_per_device`` (what
  :func:`~repro_torch.launch.cost.analyze` counts on the traced step)
  replace ``hlo_flops_per_device`` / ``hlo_bytes_per_device``; there is no
  ``xla_cost_analysis_flops``;
* ``trace_s`` (building the steps and tracing them) replaces ``lower_s``
  / ``compile_s``;
* ``memory_analysis`` holds ``argument_size_in_bytes`` (exact: the local
  shards' bytes) and ``temp_size_in_bytes`` (the peak of the bytes of the
  ``meta`` storages the trace made and still held, a tally carried to the
  full depth by :func:`count`); JAX's
  ``output_size_in_bytes`` and ``generated_code_size_in_bytes`` have no
  counterpart (the step updates its arguments in place);
* ``accum_steps`` is recorded, and so is ``model_gathered``: the paths of
  the parameters rank 0's step gathers whole over ``"model"``: the
  leaves a split layer reads whole, whose stored shards are not its
  columns (the SSD's ``in_proj`` / ``conv_w`` / ``conv_b``, ``wq`` /
  ``wo`` where ``"model"`` does not divide the heads, ``wk`` / ``wv``
  where it does not divide the kv heads), and a MoE's where ``"model"``
  divides neither its experts nor their ffn (computed whole).

The roofline's constants are an H100 SXM's, not JAX's v5e ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import pathlib
import queue
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from .. import configs
from .. import tree as tree_lib
from ..distributed import sharding
from ..models import EncDecConfig, build
from ..training.steps import TrainHParams, build_for_cell
from . import cost
from .mesh import make_production_mesh

__all__ = ["PEAK_FLOPS", "HBM_BW", "NET_BW", "model_flops", "trace",
           "count", "run_cell", "run_cell_in_child", "main"]

# NVIDIA H100 SXM5 datasheet (per GPU): dense BF16 tensor-core peak and
# HBM3 bandwidth.
PEAK_FLOPS = 989e12  # FLOP/s, bf16 dense
HBM_BW = 3.35e12  # bytes/s
# The production groups span nodes of 8 GPUs, so a collective runs at the
# inter-node rate: one 400 Gb/s InfiniBand NDR port a GPU.  Inside a node
# NVLink 4 moves 450e9 bytes/s each way, which the bound does not use.
NET_BW = 50e9  # bytes/s


def model_flops(cfg, cell) -> float:
    """6*N*D for train (N = active params), 2*N*D for inference."""
    try:
        n_active = cfg.active_param_count()
    except AttributeError:
        n_active = cfg.param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * cell.global_batch  # decode: one token per seq


class _LiveBytes(TorchDispatchMode):
    """The peak over a call of the bytes of the storages its ops made that
    are still held (each storage counted once, dropped when freed)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def _freed(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, n)
        return out


def trace(fn, args) -> dict:
    """``fn(*args)`` once under :func:`cost.analyze`: its counts (flops,
    HBM bytes, collective bytes by op) and the peak of its temporaries."""
    live = _LiveBytes()

    def run():
        with live:
            fn(*args)

    counted = cost.analyze(run)
    return {"flops": counted["flops"], "hbm_bytes": counted["hbm_bytes"],
            **{f"collective:{k}": v
               for k, v in counted["collective_bytes"].items()},
            "temp_size_in_bytes": live.peak}


def _depth(cfg) -> int:
    """The model's depth in repeated units: layers, a hybrid's groups, an
    enc-dec's (encoder, decoder) layer blocks."""
    if isinstance(cfg, EncDecConfig):
        return math.gcd(cfg.n_enc, cfg.n_dec)
    return cfg.n_groups if cfg.block == "hybrid" else cfg.n_layers


def _cut(cfg, d: int):
    """``cfg`` at ``d`` of its :func:`_depth` units."""
    D = _depth(cfg)
    if isinstance(cfg, EncDecConfig):
        return dataclasses.replace(cfg, n_enc=cfg.n_enc // D * d,
                                   n_dec=cfg.n_dec // D * d)
    unit = cfg.attn_every if cfg.block == "hybrid" else 1
    return dataclasses.replace(cfg, n_layers=d * unit)


def _extend(vals: dict, at: int) -> int:
    """The value at ``at`` of the polynomial through ``vals`` (x -> int at
    x = 1, 2, 3; or one point, ``at`` itself)."""
    if at in vals:
        return vals[at]
    v1, v2, v3 = vals[1], vals[2], vals[3]
    k = at - 1
    return v1 + k * (v2 - v1) + k * (k - 1) // 2 * (v3 - 2 * v2 + v1)


def count(cfg, cell, mesh, hp: TrainHParams) -> dict:
    """The counts of this rank's step of ``cell`` for the model ``cfg`` on
    ``mesh`` (a process group up), as :func:`trace` gives them for the
    whole step, and its argument bytes.

    The layers of a model are alike and so are the microbatches, as JAX's
    scans make them and ``repro.launch.hlo_cost`` counts them (a loop body
    times its trip count): the step is traced at 1, 2 and 3 depth units
    (:func:`_depth`) and, under accumulation, at 2 and 3 microbatches of
    the cell's size, and each count is carried to the full depth along
    the quadratic through the three depths (a stacked leaf's grad is
    written whole for each of its layers) and to ``accum_steps`` along the
    line through the two microbatch counts.  The peak of the temporaries
    (one microbatch live at a time: taken at the fewer microbatches) is
    not a polynomial in the depth: it is carried along the line through
    depths 2 and 3 (what each layer leaves held), never downwards."""
    D, A = _depth(cfg), hp.accum_steps
    rows = cell.global_batch // A
    depths = (1, 2, 3) if D > 3 else (D,)
    accums = (2, 3) if A > 2 else (A,)  # the step accumulates from A = 2
    samples, gathered = {}, set()
    for d in depths:
        model = build(_cut(cfg, d), "meta")
        for a in accums:
            fn, in_specs, _, input_specs = build_for_cell(
                model, mesh, dataclasses.replace(cell,
                                                 global_batch=rows * a),
                dataclasses.replace(hp, accum_steps=a))
            got = trace(fn, tuple(
                sharding.put_tree(t, s, mesh, "meta")
                for t, s in zip(input_specs(), in_specs)))
            samples[d, a] = {k: int(round(v)) for k, v in got.items()}
            plan = getattr(fn, "plan", None)
            gathered |= plan.model_gathered if plan is not None else set()
    out = {}
    a0, a1 = accums[0], accums[-1]
    for key in samples[depths[0], a0]:
        if key == "temp_size_in_bytes":  # one microbatch live at a time
            peak = {d: samples[d, a0][key] for d in depths}
            out[key] = peak[D] if D in peak else peak[3] + (D - 3) * max(
                0, peak[3] - peak[2])
        else:
            out[key] = _extend({d: samples[d, a0][key] + (A - a0) * (
                samples[d, a1][key] - samples[d, a0][key]) for d in depths},
                D)
    _, in_specs, _, input_specs = build_for_cell(build(cfg, "meta"), mesh,
                                                 cell, hp)
    with torch.no_grad():
        shards = [x.to_local() for t, s in zip(input_specs(), in_specs)
                  for x in tree_lib.leaves(
                      sharding.put_tree(t, s, mesh, "meta"))]
    colls = {k.split(":", 1)[1]: v for k, v in out.items()
             if k.startswith("collective:")}
    return {"flops": out["flops"], "hbm_bytes": out["hbm_bytes"],
            "collective_bytes": colls,
            "argument_size_in_bytes": sum(x.numel() * x.element_size()
                                          for x in shards),
            "temp_size_in_bytes": out["temp_size_in_bytes"],
            "model_gathered": sorted(gathered)}


def _accum(mesh, cell) -> int:
    """JAX's rule: a live microbatch of 2 rows a data replica."""
    names = tuple(mesh.mesh_dim_names)
    dp = math.prod(int(mesh.shape[names.index(a)]) for a in ("pod", "data")
                   if a in names)
    return max(1, (cell.global_batch // dp) // 2) if cell.kind == "train" \
        else 1


def _fake_world(n: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell's record, in this process: it starts and ends the fake
    world (so no process group may be up)."""
    cell = next(s for s in configs.SHAPES if s.name == shape_name)
    mesh_name = "multi" if multi_pod else "single"
    skip = configs.skip_reason(arch_id, shape_name)
    if skip:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}

    cfg = configs.get(arch_id)
    n_chips = 512 if multi_pod else 256
    _fake_world(n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        hp = TrainHParams(accum_steps=_accum(mesh, cell))
        t0 = time.perf_counter()
        res = count(cfg, cell, mesh, hp)
        trace_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()

    flops, bytes_acc = res["flops"], res["hbm_bytes"]
    colls = res["collective_bytes"]
    mflops = model_flops(cfg, cell)
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": bytes_acc / HBM_BW,
             "collective_s": colls["total"] / NET_BW}
    dominant = max(terms, key=terms.get)
    mem = {k: res[k] for k in ("argument_size_in_bytes",
                               "temp_size_in_bytes")}
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_chips": n_chips,
        "accum_steps": hp.accum_steps,
        "trace_s": round(trace_s, 1),
        "counted_flops_per_device": flops,
        "counted_bytes_per_device": bytes_acc,
        "collective_bytes_per_device": colls,
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / n_chips,
        "useful_flops_ratio": (mflops / n_chips) / flops if flops else None,
        "roofline": terms,
        "dominant": dominant,
        "step_time_bound_s": max(terms.values()),
        "memory_analysis": mem,
        "bytes_per_device": sum(mem.values()),
        "model_gathered": res["model_gathered"],
    }


def _child(results, arch, shape, multi_pod):
    try:
        results.put(run_cell(arch, shape, multi_pod))
    except Exception as e:  # noqa: BLE001 — reported in the record
        results.put({"arch": arch, "shape": shape,
                   "mesh": "multi" if multi_pod else "single",
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()})


def run_cell_in_child(arch: str, shape: str, multi_pod: bool) -> dict:
    """:func:`run_cell` in a fresh interpreter (the fake group owns its
    process); a child that dies without a record gives an ``"error"``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_child, args=(results, arch, shape, multi_pod))
    proc.start()
    try:
        while True:
            try:
                return results.get(timeout=1.0)
            except queue.Empty:
                if proc.exitcode is not None and results.empty():
                    return {"arch": arch, "shape": shape,
                            "mesh": "multi" if multi_pod else "single",
                            "status": "error",
                            "error": f"exit code {proc.exitcode}"}
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in configs.SHAPES]
              if (args.all or not args.shape) else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = outdir / f"{tag}.json"
                if path.exists():
                    print(f"[skip existing] {tag}", flush=True)
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                rec = (run_cell(arch, shape, mp)  # a skip starts nothing
                       if configs.skip_reason(arch, shape)
                       else run_cell_in_child(arch, shape, mp))
                failures += rec["status"] == "error"
                path.write_text(json.dumps(rec, indent=2, default=str))
                extra = ""
                if rec["status"] == "ok":
                    extra = (f" dominant={rec['dominant']}"
                             f" bound={rec['step_time_bound_s']:.4f}s"
                             f" trace={rec['trace_s']}s")
                print(f"[done] {tag}: {rec['status']}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
