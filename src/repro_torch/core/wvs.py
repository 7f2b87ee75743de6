"""Weighted vector space (Def. 1 of the paper), in moment form.

Port of ``repro/core/wvs.py``.  A pair ``<v, c>`` (vector, weight) is
stored as its *moment* ``m = c * v`` and weight ``c``; the paper's
operations become plain linear algebra:

    (+)  ->  elementwise +        (-)  ->  elementwise -
    c (.) <m, c2>  ->  <c*m, c*c2>

and the "vector part" is ``m / c`` (defined only when ``c != 0``).

A ``WV`` holds arbitrarily-batched weighted vectors: ``m`` has shape
``(*batch, d)`` and ``c`` has shape ``(*batch,)``.  A guard such as ``eps``
may be one value or one per query slot (a tensor over the leading axes,
see :func:`lead`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["WV", "add", "sub", "smul", "vec", "wsum", "live_sum",
           "from_vector", "allclose", "lead"]


class WV(NamedTuple):
    """A (batch of) weighted vector(s) in moment form."""

    m: torch.Tensor  # (*batch, d) moment = weight * vector
    c: torch.Tensor  # (*batch,)   weight

    @property
    def d(self) -> int:
        return self.m.shape[-1]

    def __add__(self, other: "WV") -> "WV":  # X (+) Y
        return add(self, other)

    def __sub__(self, other: "WV") -> "WV":  # X (-) Y
        return sub(self, other)

    def __rmul__(self, s) -> "WV":  # s (.) X
        return smul(s, self)


def lead(x, like: torch.Tensor):
    """Broadcast a per-slot value against ``like``.

    A Python number or a 0-d tensor is returned as is; a tensor over the
    leading (query-slot) axes of ``like`` gets trailing unit axes, so a
    (Q,) knob meets a (Q, n) or (Q, n, D) array slot by slot.
    """
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def from_vector(v, c) -> WV:
    """Build ``<v, c>`` from the paper's (vector, weight) coordinates."""
    v = torch.as_tensor(v)
    c = torch.as_tensor(c)
    return WV(v * c[..., None], c)


def add(x: WV, y: WV) -> WV:
    """The paper's (+): weighted average.  Moment form: elementwise sum."""
    return WV(x.m + y.m, x.c + y.c)


def sub(x: WV, y: WV) -> WV:
    """The paper's (-): X (-) Y = Z iff X = Y (+) Z."""
    return WV(x.m - y.m, x.c - y.c)


def smul(s, x: WV) -> WV:
    """The paper's (.): scales the weight, keeps the vector part."""
    s = torch.as_tensor(s, dtype=x.c.dtype, device=x.c.device)
    return WV(s[..., None] * x.m, s * x.c)


def vec(x: WV, eps: float = 0.0) -> torch.Tensor:
    """Vector part ``m / c``.  Where ``|c| <= eps`` returns 0 (guarded)."""
    ok = torch.abs(x.c) > lead(eps, x.c)
    safe = torch.where(ok, x.c, 1.0)
    v = x.m / safe[..., None]
    return torch.where(ok[..., None], v, 0.0)


def wsum(x: WV, axis=0) -> WV:
    """(+)-fold over an axis of a batched WV: the paper's big-oplus."""
    return WV(torch.sum(x.m, dim=axis), torch.sum(x.c, dim=axis))


def live_sum(x: WV, alive: torch.Tensor) -> WV:
    """(+)-fold of ``x`` (``m`` (..., n, d), ``c`` (..., n)) over the peers
    where ``alive`` (..., n): the observe pass's global sum.

    The global sum is taken in float64 and rounded to float32 once, so it
    does not depend on the reduction's order: a batched and an unbatched
    state (or another device) give the same ``want`` even where it is a
    near tie (a halfspace threshold at the data mean).
    """
    f64 = torch.float64
    return WV(
        torch.sum(torch.where(alive[..., None], x.m, 0.0),
                  dim=-2, dtype=f64).to(x.m.dtype),
        torch.sum(torch.where(alive, x.c, 0.0), dim=-1,
                  dtype=f64).to(x.c.dtype),
    )


def allclose(x: WV, y: WV, rtol=1e-5, atol=1e-6) -> bool:
    return (torch.allclose(x.m, y.m, rtol=rtol, atol=atol)
            and torch.allclose(x.c, y.c, rtol=rtol, atol=atol))
