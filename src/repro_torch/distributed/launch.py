"""Run one function on ``world`` ranks, one process each, over
``torch.distributed`` (the port's multi-process paths: the engine's
collective transport and the mesh monitor).

    from repro_torch.distributed import launch

    def body(rank, world, n):          # a module-level function
        ...                            # the default group is initialised
        return {"x": some_tensor}      # tensors come back as numpy

    results = launch.spawn(body, world=4, args=(64,))  # rank order

Each rank is a fresh interpreter (``torch.multiprocessing`` with the
``spawn`` start method), so ``fn`` and ``args`` must pickle: ``fn`` is a
module-level function.  The ranks meet at a ``FileStore`` in a temporary
directory, never at a TCP port, so several launches may run side by side
on one host.  Every rank's ``init_process_group`` gets ``timeout_s``,
which bounds each collective too.

The parent waits for all results until ``timeout_s`` has passed.  If a
rank raises, the parent kills the other ranks (they may be blocked in a
collective with it) and raises :class:`RankError` with the tracebacks of
the ranks that failed; if a rank dies without a result, or the deadline passes, it
kills them all and raises :class:`RankError` or ``TimeoutError``.  No
rank outlives :func:`spawn`.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["RankError", "spawn", "to_numpy"]

_POLL_S = 0.1  # how often the parent looks at dead ranks while waiting


class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback or exit
    code."""


def to_numpy(obj):
    """Tensors anywhere in nested tuples / lists / dicts -> numpy (a
    tensor sent through the queue would be shared memory that dies with
    its rank)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(to_numpy(v) for v in obj)
    if isinstance(obj, tuple):  # a NamedTuple keeps its type
        return type(obj)(*(to_numpy(v) for v in obj))
    return obj


def _rank_main(fn, rank, world, backend, store_path, timeout_s, results,
               args):
    """One rank: join the group, run ``fn``, report, leave the group."""
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = to_numpy(fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises RankError
        results.put((rank, False, traceback.format_exc()))


def _failures(results, rank, trace, world, grace_s: float = 1.0) -> str:
    """The first failure's report and any other rank's that arrives
    within ``grace_s`` (a rank blocked in a collective with the failed
    one fails too, and may report first), in rank order."""
    failed = {rank: trace}
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            r, ok, out = results.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            failed[r] = out
    return "\n".join(f"rank {r} of {world} raised:\n{failed[r]}"
                     for r in sorted(failed))


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def spawn(fn, world: int, backend: str = "gloo", timeout_s: float = 120.0,
          args: tuple = ()) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks in a process
    group of ``backend``; return the ranks' results in rank order.

    Raises :class:`RankError` when a rank raises or dies, and
    ``TimeoutError`` when the ranks have not all returned within
    ``timeout_s`` seconds; every rank is stopped first.
    """
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        results = ctx.Queue()
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, store, timeout_s,
                                   results, tuple(args)),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=_POLL_S)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        # Its result may still be in the pipe: look once.
                        try:
                            rank, ok, out = results.get(timeout=1.0)
                        except queue.Empty:
                            raise RankError(
                                f"rank {dead[0]} of {world} died with exit "
                                f"code {procs[dead[0]].exitcode} and no "
                                "result") from None
                    elif time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{len(got)} of {world} ranks returned within "
                            f"{timeout_s} s") from None
                    else:
                        continue
                if not ok:
                    raise RankError(_failures(results, rank, out, world))
                got[rank] = out
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            _kill(procs)
            results.close()
    return [got[r] for r in range(world)]
