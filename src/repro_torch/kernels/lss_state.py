"""Launcher of the ``lss_state`` CUDA kernel (``csrc/lss_state.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/lss_state.py::
lss_state_kernel`` (launched by ``lss_state_call``) and its query-batched
form: the fused status S_i, agreements, three packed region decisions and
Alg.-1 violation set, for Q query slots in one launch.

What bounds it on the H100: bytes at the paper's k = 3 (each slot's mask
and viol byte, out/in moments and weights of the live slots), operations at
k = 243 (each live slot's two decisions scan every center); at k = 3 the
instruction rate is close too (up to four IEEE divisions and two decisions
a live slot).  Its design: the (Q, n, D) arrays are Q*n contiguous rows, so
a block of 128 threads takes a tile of whole consecutive rows of one query
slot (at most 512 slots; 256 for d > 4), with that slot's packed table and
``eps`` in shared memory, and each thread owns elements a block-width
apart, which makes every warp-wide access contiguous whatever D is
(d-vectors as 8- or 16-byte accesses where the pointers allow).  Out/in
are read on live slots only.  The block puts in - out of its live slots
into shared memory with the live set as a ballot bitmask, and one thread
per (row, component) sums its row's live slots in slot order from +0 (over
nonzero words, in groups of 8 loaded together), then adds X_ii: the order
of the plain version, so S rounds bitwise like it.  One thread per row
decides f(vec S); the violation pass is then elementwise.  Rows of up to 4
slots take a thread per row for the sum and decision.  Rows longer than a
tile (Barabási–Albert graphs pad every row to the hub degree) get a warp
each, in segments of 1,024 slots, summing S with shuffles in the same
order.

``launches`` counts the kernel launches made by :func:`launch` (one per
call, whatever Q).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["launch", "launches", "MAX_D"]

MAX_D = 16  # largest d the kernel is instantiated for (kMaxD in csrc)
SHARED_LIMIT = 227 * 1024  # dynamic shared memory a Hopper block may use

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("lss_state").repro_lss_state
    fn.argtypes = [_P] * 10 + [_I] * 5 + [_P] * 5
    fn.restype = _I
    return fn


def launch(x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw, cn, meta):
    """Run the kernel on CUDA tensors; returns ``(s_m, s_c, viol, dec)``.

    Inputs carry a leading slot axis Q: float32 (``mask`` bool),
    contiguous, on one CUDA device, in the layouts of
    ``csrc/lss_state.cu``; the tables ``(cthw, cn, meta)`` come from
    :func:`repro_torch.kernels.ops.prep_slots` and ``eps`` is ``meta[:, 2]``.
    """
    global launches
    Q, n, D, d = out_m.shape
    k = cn.shape[-1]
    dev = out_m.device
    if dev.type != "cuda":
        raise ValueError(f"lss_state kernel needs CUDA tensors, got {dev}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"lss_state kernel supports 1 <= d <= {MAX_D}, "
                         f"got d={d}")
    if 4 * (k * d + k + d) > SHARED_LIMIT:
        raise ValueError(f"lss_state kernel: region table of k={k}, d={d} "
                         "exceeds the block's shared memory")
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("x_m", x_m, (Q, n, d), f32), ("x_c", x_c, (Q, n), f32),
            ("out_m", out_m, (Q, n, D, d), f32),
            ("out_c", out_c, (Q, n, D), f32),
            ("in_m", in_m, (Q, n, D, d), f32),
            ("in_c", in_c, (Q, n, D), f32),
            ("mask", mask, (Q, n, D), torch.bool),
            ("cthw", cthw, (Q, d, k + 1), f32), ("cn", cn, (Q, k), f32),
            ("meta", meta, (Q, 4), f32)):
        _build.check_arg("lss_state", name, t, shape, dtype, dev)
    s_m = torch.empty((Q, n, d), dtype=f32, device=dev)
    s_c = torch.empty((Q, n), dtype=f32, device=dev)
    viol = torch.empty((Q, n, D), dtype=torch.bool, device=dev)
    dec = torch.empty((Q, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(x_m.data_ptr(), x_c.data_ptr(), out_m.data_ptr(),
                out_c.data_ptr(), in_m.data_ptr(), in_c.data_ptr(),
                mask.data_ptr(), cthw.data_ptr(), cn.data_ptr(),
                meta.data_ptr(), Q, n, D, d, k, s_m.data_ptr(),
                s_c.data_ptr(), viol.data_ptr(), dec.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lss_state kernel launch failed: cudaError {err}")
    if Q > 0 and n > 0:
        launches += 1
    return s_m, s_c, viol, dec
