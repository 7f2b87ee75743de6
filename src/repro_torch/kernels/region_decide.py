"""Launcher of the ``region_decide`` CUDA kernel (``csrc/region_decide.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/region_decide.py::
region_decide_kernel`` (launched by ``region_decide_call``) and its
query-batched form: the packed region decision of Q batches of vectors,
one slot table per batch, in one launch.

What bounds it on the H100: bytes at the paper's k (it reads d floats and
writes one int32 per vector, about 3 k d flops between), float32
operations once k reaches the hundreds.  Its design: one thread per vector
on a 2-D grid (``blockIdx.y`` = query slot), the slot's table in shared
memory, and the ``decide`` device function of ``lss_state``
(``csrc/packed_decide.cuh``), so both kernels decide alike.

``launches`` counts the kernel launches made by :func:`launch` (one per
call, whatever Q).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .lss_state import MAX_D, SHARED_LIMIT

__all__ = ["launch", "launches"]

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("region_decide").repro_region_decide
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P] * 2
    fn.restype = _I
    return fn


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
