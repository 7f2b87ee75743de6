"""Covariance-weighted vector space — the paper's §II-A generalization
(port of ``repro/core/wvs_cov.py``).

Def. 1 allows the scalar field C to be "the space of covariance matrices":
elements are <v, W> with W a PSD matrix, and

    W1 (.) <v, W2>   = <v, W1 W2>
    <v1,W1> (+) <v2,W2> = <(W1+W2)^-1 (W1 v1 + W2 v2), W1 + W2>

— inverse-covariance (precision) weighting, i.e. the information-filter
fusion rule.  In moment form m = W v the space is again linear
(m1+m2, W1+W2), so the *same* mass-conservation / stopping-rule /
correction machinery applies verbatim with scalar ops replaced by matrix
ops.  Each peer holds a local estimate with its own uncertainty, and the
network agrees on a thresholded function of the precision-weighted global
mean.

API mirrors :mod:`repro_torch.core.wvs` with (m: (..., d), W: (..., d, d)),
on tensors; results stay on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CWV", "from_estimate", "add", "sub", "smul", "vec", "zero",
           "mahalanobis"]


class CWV(NamedTuple):
    m: torch.Tensor  # (..., d)    moment = W @ v
    W: torch.Tensor  # (..., d, d) matrix weight (precision)


def from_estimate(v, W) -> CWV:
    """<v, W> from an estimate v with precision (inverse covariance) W."""
    v = torch.as_tensor(v)
    W = torch.as_tensor(W)
    return CWV(torch.einsum("...ij,...j->...i", W, v), W)


def zero(d: int, batch=(), dtype=torch.float32, device=None) -> CWV:
    return CWV(torch.zeros((*batch, d), dtype=dtype, device=device),
               torch.zeros((*batch, d, d), dtype=dtype, device=device))


def add(x: CWV, y: CWV) -> CWV:
    return CWV(x.m + y.m, x.W + y.W)


def sub(x: CWV, y: CWV) -> CWV:
    return CWV(x.m - y.m, x.W - y.W)


def smul(s, x: CWV) -> CWV:
    """Scalar (or matrix) multiple of the weight; vector part unchanged.

    Scalar s: <v, sW> — moment scales to s*m.
    """
    s = torch.as_tensor(s, device=x.m.device)
    if s.ndim <= x.m.ndim - 1:  # scalar(s): broadcast over batch
        return CWV(s[..., None] * x.m if s.ndim else s * x.m,
                   s[..., None, None] * x.W if s.ndim else s * x.W)
    raise NotImplementedError("matrix scalars: multiply W directly")


def vec(x: CWV, eps: float = 1e-9) -> torch.Tensor:
    """v = W^-1 m (the precision-weighted mean), guarded by ridge eps."""
    d = x.m.shape[-1]
    Wr = x.W + eps * torch.eye(d, dtype=x.W.dtype, device=x.W.device)
    return torch.linalg.solve(Wr, x.m[..., None])[..., 0]


def mahalanobis(x: CWV, c) -> torch.Tensor:
    """(v - c)^T W (v - c) — the natural 'distance' for region tests:
    Voronoi cells under this metric stay convex (W is PSD)."""
    v = vec(x)
    diff = v - torch.as_tensor(c, dtype=v.dtype, device=v.device)
    return torch.einsum("...i,...ij,...j->...", diff, x.W, diff)
