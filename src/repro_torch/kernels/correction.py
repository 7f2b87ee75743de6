"""Launcher of the ``correction`` CUDA kernel (``csrc/correction.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/correction.py::
correction_kernel`` (launched by ``correction_call``) and its
query-batched form: the Eq.-10 corrected out-messages on the violating
set, for Q query slots in one launch.

What bounds it on the H100: bytes.  It reads the in-messages and agreement
weights of every slot and writes a message for every slot, with a handful
of flops each.  Its design: the (Q, n, D) arrays are Q*n contiguous rows,
so a block of 128 threads takes a tile of whole consecutive rows (at
most 512 elements) and each thread owns elements a block-width apart, which makes every
warp-wide access contiguous whatever D is (d-vectors as 8- or 16-byte
accesses where the pointers allow).  The block keeps its a_c, in_c and
in_m in registers, stages a_m and a_c of the violating set V in shared
memory with V as a ballot bitmask, and one thread per (row, component)
sums its row's set bits in slot order from +0, then adds S: the order of
the plain version, so T_i rounds bitwise like it.  The write pass is then
elementwise.  A row longer than a tile gets a block of its own that walks
it in chunks.  beta and eps are (Q,) device tensors.

``launches`` counts the kernel launches made by :func:`launch` (one per
call, whatever Q; none for an empty input).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["launch", "launches", "MAX_D"]

MAX_D = 16  # largest d the kernel is instantiated for (kMaxD in csrc)

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("correction").repro_correction
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 3
    fn.restype = _I
    return fn


def launch(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta, eps):
    """Run the kernel on CUDA tensors; returns ``(out_m', out_c')``.

    Inputs carry a leading slot axis Q: float32 (``v_set`` bool),
    contiguous, on one CUDA device, in the layouts of
    ``csrc/correction.cu``; ``beta`` and ``eps`` are float32 (Q,).
    """
    global launches
    Q, n, D, d = a_m.shape
    dev = a_m.device
    if dev.type != "cuda":
        raise ValueError(f"correction kernel needs CUDA tensors, got {dev}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"correction kernel supports 1 <= d <= {MAX_D}, "
                         f"got d={d}")
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("s_m", s_m, (Q, n, d), f32), ("s_c", s_c, (Q, n), f32),
            ("a_m", a_m, (Q, n, D, d), f32), ("a_c", a_c, (Q, n, D), f32),
            ("in_m", in_m, (Q, n, D, d), f32),
            ("in_c", in_c, (Q, n, D), f32),
            ("v_set", v_set, (Q, n, D), torch.bool),
            ("beta", beta, (Q,), f32), ("eps", eps, (Q,), f32)):
        _build.check_arg("correction", name, t, shape, dtype, dev)
    o_m = torch.empty((Q, n, D, d), dtype=f32, device=dev)
    o_c = torch.empty((Q, n, D), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(s_m.data_ptr(), s_c.data_ptr(), a_m.data_ptr(),
                a_c.data_ptr(), in_m.data_ptr(), in_c.data_ptr(),
                v_set.data_ptr(), beta.data_ptr(), eps.data_ptr(), Q, n, D,
                d, o_m.data_ptr(), o_c.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"correction kernel launch failed: cudaError {err}")
    if Q > 0 and n > 0 and D > 0:
        launches += 1
    return o_m, o_c
