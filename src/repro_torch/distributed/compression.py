"""Lossy wire compression with error feedback (port of
``repro/distributed/compression.py``).

Every scheme carries its compression error forward instead of dropping it:

* :func:`int8_compress` — per-tensor symmetric int8 quantization;
* :func:`topk_compress` — keep the top ``frac`` of entries by magnitude
  (realized as a masked dense tensor);
* :func:`quantize_halo` / :func:`dequantize_halo` — the engine's halo
  buffers quantized per link: one scale pair per ``(src, dst)`` link over
  the ``(..., W, d)`` moment buffers and their ``(..., W)`` weight row,
  masked by the delivered flags, with the error feedback updated only
  where a message shipped.  ``EngineConfig(wire="int8")`` runs it
  (:mod:`repro_torch.engine.exchange`).

The arithmetic is the JAX twin's, operation for operation, in float32:
``torch.round`` and ``jnp.round`` both round half to even, so on the same
buffers the codes, scales and error buffers are bitwise equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Int8Pack", "int8_compress", "int8_decompress", "topk_compress",
           "HaloQuantPack", "quantize_halo", "dequantize_halo"]


class Int8Pack(NamedTuple):
    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # float32 per-tensor scale


def _plus_err(x, err):
    xf = x.to(torch.float32)
    return xf if err is None else xf + err


def _quantize(xf, scale):
    """int8 codes of ``xf / scale`` (half to even, clipped to +-127)."""
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def int8_compress(x, err=None):
    """Returns ``(pack, new_err)``; ``err`` is the running error-feedback
    buffer."""
    xf = _plus_err(x, err)
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    q = _quantize(xf, scale)
    return Int8Pack(q=q, scale=scale), xf - q.to(torch.float32) * scale


def int8_decompress(pack: Int8Pack):
    return pack.q.to(torch.float32) * pack.scale


class HaloQuantPack(NamedTuple):
    """Per-link quantized halo payload (one scale pair per link)."""

    q_m: torch.Tensor  # int8 (..., W, d) moment buffers
    q_c: torch.Tensor  # int8 (..., W) weight row
    scale_m: torch.Tensor  # float32 (...,) per-link moment scale
    scale_c: torch.Tensor  # float32 (...,) per-link weight scale


def quantize_halo(buf_m, buf_c, flag, err_m=None, err_c=None):
    """Symmetric int8 quantization of halo send buffers, per link.

    ``buf_m (..., W, d)`` / ``buf_c (..., W)`` are one link's gathered send
    buffers per leading index; ``flag (..., W)`` masks real messages.
    Masked entries quantize as zero and never touch the error feedback.

    With ``xf = buf + err`` (masked) the scale is ``max|xf| / 127`` per
    link, so clipping is never active and each component's round-trip
    error is at most ``scale / 2 = max|xf| / 254`` (``quant_eps``).  The
    returned error buffers hold ``xf - deq`` where ``flag`` and the old
    error elsewhere: a pending-but-unsent slot keeps carrying its debt.
    """
    fm = flag[..., None]
    xm = torch.where(fm, _plus_err(buf_m, err_m), 0.0)
    xc = torch.where(flag, _plus_err(buf_c, err_c), 0.0)
    scale_m = torch.clamp_min(torch.amax(torch.abs(xm), dim=(-2, -1)),
                              1e-12) / 127.0
    scale_c = torch.clamp_min(torch.amax(torch.abs(xc), dim=-1),
                              1e-12) / 127.0
    q_m = _quantize(xm, scale_m[..., None, None])
    q_c = _quantize(xc, scale_c[..., None])
    deq_m, deq_c = dequantize_halo(q_m, q_c, scale_m, scale_c)
    new_err_m = torch.where(fm, xm - deq_m, 0.0 if err_m is None else err_m)
    new_err_c = torch.where(flag, xc - deq_c,
                            0.0 if err_c is None else err_c)
    pack = HaloQuantPack(q_m=q_m, q_c=q_c, scale_m=scale_m, scale_c=scale_c)
    return pack, new_err_m, new_err_c


def dequantize_halo(q_m, q_c, scale_m, scale_c):
    """Inverse of :func:`quantize_halo`'s value mapping."""
    f32 = torch.float32
    return (q_m.to(f32) * scale_m[..., None, None],
            q_c.to(f32) * scale_c[..., None])


def topk_compress(x, err=None, frac: float = 0.01):
    """Top-``frac`` magnitude sparsification with error feedback.

    Returns ``(sparse_dense, new_err)``: ``sparse_dense`` equals ``x + err``
    on the kept coordinates (every entry at least the k-th largest
    magnitude) and 0 elsewhere.
    """
    xf = _plus_err(x, err)
    flat = xf.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    kept = torch.where(torch.abs(xf) >= thresh, xf, 0.0)
    return kept, xf - kept
