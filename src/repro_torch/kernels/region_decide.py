"""Launchers of the ``region_decide`` CUDA kernel (``csrc/region_decide.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/region_decide.py::
region_decide_kernel`` (launched by ``region_decide_call``) and its
query-batched form: the packed region decision of Q batches of vectors,
one slot table per batch, in one launch (:func:`launch`).  Its second
entry (:func:`launch_global`) is the observe pass's global decision: the
float64 sum of each slot's live inputs, its vector part and its decision,
in one launch for all Q slots.

What bounds it on the H100: bytes at the paper's k (it reads d floats and
writes one int32 per vector, about 3 k d flops between), float32
operations once k reaches the hundreds.  Its design: one thread per vector
on a 2-D grid (``blockIdx.y`` = query slot), the slot's table in shared
memory, and the ``decide`` device function of ``lss_state``
(``csrc/packed_decide.cuh``), so both kernels decide alike.  The second
entry reads 4 d + 5 bytes a peer and is bound by bytes; its blocks each
reduce a contiguous run of peers, and the last block of a slot to finish
adds the blocks' float64 partials in index order and decides
(``csrc/region_decide.cu`` says why).

``launches`` counts the kernel launches made by :func:`launch` and
:func:`launch_global` (one per call, whatever Q).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .lss_state import MAX_D, SHARED_LIMIT

__all__ = ["launch", "launch_global", "launches"]

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_tickets: dict = {}  # device -> int32 zeros, one per slot, kept at zero


@functools.cache
def _fn():
    fn = _build.library("region_decide").repro_region_decide
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P] * 2
    fn.restype = _I
    return fn


@functools.cache
def _global_fn():
    lib = _build.library("region_decide")
    fn = lib.repro_global_decide
    fn.argtypes = [_P] * 7 + [_F] + [_I] * 4 + [_P] * 6
    fn.restype = _I
    return fn, lib.repro_global_decide_run()


def _slot_tickets(dev, q: int) -> torch.Tensor:
    """The kernel's per-slot tickets on ``dev``, allocated zeroed once (and
    again, larger, when Q grows); every launch leaves them at zero."""
    t = _tickets.get(dev)
    if t is None or t.numel() < q:
        t = _tickets[dev] = torch.zeros((q,), dtype=torch.int32, device=dev)
    return t


def launch(v, cthw, cn, meta):
    """Run the kernel on CUDA tensors; returns the decisions (Q, m) int32.

    ``v`` is float32 (Q, m, d), contiguous, on one CUDA device; the tables
    ``(cthw, cn, meta)`` come from
    :func:`repro_torch.kernels.ops.prep_slots`.
    """
    global launches
    Q, m, d = v.shape
    k = cn.shape[-1]
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"region_decide kernel needs CUDA tensors, got {dev}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"region_decide kernel supports 1 <= d <= {MAX_D}, "
                         f"got d={d}")
    if 4 * (k * d + k + d) > SHARED_LIMIT:
        raise ValueError(f"region_decide kernel: region table of k={k}, "
                         f"d={d} exceeds the block's shared memory")
    f32 = torch.float32
    for name, t, shape in (("v", v, (Q, m, d)), ("cthw", cthw, (Q, d, k + 1)),
                           ("cn", cn, (Q, k)), ("meta", meta, (Q, 4))):
        _build.check_arg("region_decide", name, t, shape, f32, dev)
    out = torch.empty((Q, m), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(v.data_ptr(), cthw.data_ptr(), cn.data_ptr(), meta.data_ptr(),
                Q, m, d, k, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"region_decide kernel launch failed: cudaError {err}")
    if Q > 0 and m > 0:
        launches += 1
    return out


def launch_global(x_m, x_c, alive, cthw, cn, meta, eps):
    """Run the global decision on CUDA tensors; returns ``(want, gx_m,
    gx_c)``: (Q,) int32, (Q, d) and (Q,) float32.

    ``x_m`` (Q, n, d) and ``x_c`` (Q, n) float32 and ``alive`` (Q, n) bool,
    contiguous, on one CUDA device; the tables ``(cthw, cn, meta)`` come
    from :func:`repro_torch.kernels.ops.prep_slots`; ``eps`` is a float32
    (Q,) tensor on the same device, or one number for every slot.
    """
    global launches
    Q, n, d = x_m.shape
    k = cn.shape[-1]
    dev = x_m.device
    if dev.type != "cuda":
        raise ValueError(f"region_decide kernel needs CUDA tensors, got {dev}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"region_decide kernel supports 1 <= d <= {MAX_D}, "
                         f"got d={d}")
    if 4 * (k * d + k + d) > SHARED_LIMIT:
        raise ValueError(f"region_decide kernel: region table of k={k}, "
                         f"d={d} exceeds the block's shared memory")
    f32 = torch.float32
    args = [("x_m", x_m, (Q, n, d), f32), ("x_c", x_c, (Q, n), f32),
            ("alive", alive, (Q, n), torch.bool),
            ("cthw", cthw, (Q, d, k + 1), f32), ("cn", cn, (Q, k), f32),
            ("meta", meta, (Q, 4), f32)]
    if isinstance(eps, torch.Tensor):
        args.append(("eps", eps, (Q,), f32))
        eps_ptr, eps0 = eps.data_ptr(), 0.0
    else:
        eps_ptr, eps0 = None, float(eps)
    for name, t, shape, dtype in args:
        _build.check_arg("region_decide", name, t, shape, dtype, dev)
    fn, run = _global_fn()
    part = torch.empty((Q, max(1, -(-n // run)), d + 1), dtype=torch.float64,
                       device=dev)
    want = torch.empty((Q,), dtype=torch.int32, device=dev)
    gx_m = torch.empty((Q, d), dtype=f32, device=dev)
    gx_c = torch.empty((Q,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x_m.data_ptr(), x_c.data_ptr(), alive.data_ptr(),
             cthw.data_ptr(), cn.data_ptr(), meta.data_ptr(), eps_ptr, eps0,
             Q, n, d, k, part.data_ptr(), _slot_tickets(dev, Q).data_ptr(),
             want.data_ptr(), gx_m.data_ptr(), gx_c.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"region_decide global decision launch failed: cudaError {err}")
    if Q > 0:
        launches += 1
    return want, gx_m, gx_c
