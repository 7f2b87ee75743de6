"""Convex region families for the thresholding problem (Problem 2).

Port of ``repro/core/regions.py``.  A region family maps a vector in R^d to
the index of the (convex, non-overlapping) region containing it:

* ``VoronoiRegions`` — the source-selection problem (Sec. V): Voronoi cells
  of k option points, ``f(v) = argmin_c ||c - v||``.
* ``HalfspaceRegions`` — one hyperplane ``w . v >= b`` (two regions).

Decision functions are vectorized: input (..., d) -> int32 (...).
``decide_voronoi`` uses ``||v - c||^2 = ||v||^2 - 2 v.c + ||c||^2`` and
drops the constant ``||v||^2``.  ``torch.argmin`` returns the first of
equal minima, as ``jnp.argmin`` does, so ties resolve identically.

The dot products are taken as the CUDA kernels take them (:func:`dot`):
in coordinate order, each product rounded on its own, no fused
multiply-add.  So the plain versions decide bitwise like the kernels; the
JAX package contracts with a matrix product instead, which can differ from
this in the last bit and so only at a near tie.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["VoronoiRegions", "HalfspaceRegions", "PackedRegions",
           "PackedSlot", "decide_voronoi", "decide_packed", "as_packed_slot",
           "dot", "KIND_VORONOI", "KIND_HALFSPACE"]

KIND_VORONOI = 0
KIND_HALFSPACE = 1


def dot(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sum_j u[..., j] * c[..., j]`` (broadcast), in the order j = 0, 1,
    ..., each product and sum rounded on its own — the arithmetic of the
    kernels (built with ``--fmad=false``)."""
    out = u[..., 0] * c[..., 0]
    for j in range(1, u.shape[-1]):
        out = out + u[..., j] * c[..., j]
    return out


def _scores(v, centers):
    """-2 v.c + ||c||^2 for every center: (..., d) x (K, d) -> (..., K)."""
    return -2.0 * dot(v[..., None, :], centers) + dot(centers, centers)


def decide_voronoi(v: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """argmin_k ||v - centers[k]||^2 for batched v: (..., d) -> int32 (...)."""
    return torch.argmin(_scores(v, centers), dim=-1).to(torch.int32)


class VoronoiRegions(NamedTuple):
    """Voronoi cells of k centers — the source-selection region family."""

    centers: torch.Tensor  # (k, d)

    @property
    def k(self) -> int:
        return self.centers.shape[0]

    @property
    def d(self) -> int:
        return self.centers.shape[1]

    def decide(self, v: torch.Tensor) -> torch.Tensor:
        return decide_voronoi(v, self.centers)


class HalfspaceRegions(NamedTuple):
    """Two regions split by ``w . v >= b`` (region 1 = above threshold)."""

    w: torch.Tensor  # (d,)
    b: torch.Tensor  # ()

    @property
    def k(self) -> int:
        return 2

    @property
    def d(self) -> int:
        return self.w.shape[0]

    def decide(self, v: torch.Tensor) -> torch.Tensor:
        return (dot(v, self.w) >= self.b).to(torch.int32)


RegionFamily = Callable[[torch.Tensor], torch.Tensor]


def decide_packed(v: torch.Tensor, kind, centers, cmask, w, b) -> torch.Tensor:
    """Decision function of ONE packed family on batched ``v`` (..., d).

    ``kind`` scalar int32, ``centers`` (Kmax, d) with validity ``cmask``
    (Kmax,), ``w`` (d,) / ``b`` () for the halfspace.  Padding center slots
    score ``+inf``, so a k-center Voronoi family padded to Kmax decides
    exactly like :func:`decide_voronoi` on the unpadded centers.

    With a leading query-slot axis on the family (``kind`` (Q,),
    ``centers`` (Q, Kmax, d), ...: a :class:`PackedRegions`) ``v`` is
    (Q, ..., d) and slot q's vectors meet slot q's family.
    """
    if kind.ndim == 1:
        return _decide_packed_slots(v, kind, centers, cmask, w, b)
    scores = torch.where(cmask, _scores(v, centers), torch.inf)
    vor = torch.argmin(scores, dim=-1).to(torch.int32)
    half = (dot(v, w) >= b).to(torch.int32)
    return torch.where(kind == KIND_VORONOI, vor, half)


def _decide_packed_slots(v, kind, centers, cmask, w, b):
    """:func:`decide_packed` of Q families on ``v`` (Q, ..., d)."""
    q, d = v.shape[0], v.shape[-1]
    flat = v.reshape(q, -1, d)
    scores = (-2.0 * dot(flat[:, :, None, :], centers[:, None])
              + dot(centers, centers)[:, None, :])
    scores = torch.where(cmask[:, None, :], scores, torch.inf)
    vor = torch.argmin(scores, dim=-1).to(torch.int32)
    half = (dot(flat, w[:, None, :]) >= b[:, None]).to(torch.int32)
    out = torch.where(kind[:, None] == KIND_VORONOI, vor, half)
    return out.reshape(v.shape[:-1])


class PackedSlot(NamedTuple):
    """ONE family in the packed ``(kind, centers, cmask, w, b)`` form.

    The currency every layer passes around: what :class:`PackedRegions`
    holds per query slot and what the kernels of :mod:`repro_torch.kernels`
    take as their region table.  Field order matches
    :class:`PackedRegions` so ``PackedSlot(*packed_slice)`` works.
    """

    kind: torch.Tensor  # int32 ()  KIND_VORONOI | KIND_HALFSPACE
    centers: torch.Tensor  # (Kmax, d)
    cmask: torch.Tensor  # bool (Kmax,)
    w: torch.Tensor  # (d,)
    b: torch.Tensor  # ()

    @property
    def k_max(self) -> int:
        return self.centers.shape[0]

    @property
    def d(self) -> int:
        return self.centers.shape[1]

    @classmethod
    def voronoi(cls, centers) -> "PackedSlot":
        """Pack unpadded Voronoi centers (all-valid ``cmask``)."""
        centers = torch.as_tensor(centers)
        k, d = centers.shape
        dev = centers.device
        return cls(
            kind=torch.tensor(KIND_VORONOI, dtype=torch.int32, device=dev),
            centers=centers,
            cmask=torch.ones((k,), dtype=torch.bool, device=dev),
            w=torch.zeros((d,), dtype=centers.dtype, device=dev),
            b=torch.zeros((), dtype=centers.dtype, device=dev),
        )

    @classmethod
    def halfspace(cls, w, b, k_max: int = 1) -> "PackedSlot":
        w = torch.as_tensor(w)
        dev = w.device
        return cls(
            kind=torch.tensor(KIND_HALFSPACE, dtype=torch.int32, device=dev),
            centers=torch.zeros((k_max, w.shape[0]), dtype=w.dtype,
                                device=dev),
            cmask=torch.zeros((k_max,), dtype=torch.bool, device=dev),
            w=w,
            b=torch.as_tensor(b, dtype=w.dtype, device=dev),
        )

    def decide(self, v: torch.Tensor) -> torch.Tensor:
        return decide_packed(v, *self)


def as_packed_slot(region) -> PackedSlot:
    """Coerce a region family (or bare Voronoi centers) to a PackedSlot."""
    if isinstance(region, PackedSlot):
        return region
    if isinstance(region, VoronoiRegions):
        return PackedSlot.voronoi(region.centers)
    if isinstance(region, HalfspaceRegions):
        return PackedSlot.halfspace(region.w, region.b)
    arr = torch.as_tensor(region)
    if arr.ndim == 2:  # bare (k, d) Voronoi centers
        return PackedSlot.voronoi(arr)
    raise TypeError(f"cannot pack region family {type(region)!r}")


def _set_row(arr: torch.Tensor, slot: int, value) -> torch.Tensor:
    out = arr.clone()
    out[slot] = value
    return out


class PackedRegions(NamedTuple):
    """A stackable, padded batch of Q region families (one per query slot).

    Fixed shapes — (Q, Kmax, d) centers etc. — so families can be written
    into / cleared from individual slots without changing any shape.
    Unused parameter blocks (e.g. ``w``/``b`` of a Voronoi slot) are zeros.
    Updates are functional: :meth:`set` and :meth:`clear` return copies.
    """

    kind: torch.Tensor  # int32 (Q,)  KIND_VORONOI | KIND_HALFSPACE
    centers: torch.Tensor  # (Q, Kmax, d)
    cmask: torch.Tensor  # bool (Q, Kmax)
    w: torch.Tensor  # (Q, d)
    b: torch.Tensor  # (Q,)

    @property
    def q(self) -> int:
        return self.kind.shape[0]

    @property
    def k_max(self) -> int:
        return self.centers.shape[1]

    @property
    def d(self) -> int:
        return self.centers.shape[2]

    @classmethod
    def empty(cls, q: int, k_max: int, d: int, dtype=torch.float32,
              device=None) -> "PackedRegions":
        """Q all-padding slots (every slot decides region 0 everywhere)."""
        return cls(
            kind=torch.zeros((q,), dtype=torch.int32, device=device),
            centers=torch.zeros((q, k_max, d), dtype=dtype, device=device),
            cmask=torch.zeros((q, k_max), dtype=torch.bool, device=device),
            w=torch.zeros((q, d), dtype=dtype, device=device),
            b=torch.zeros((q,), dtype=dtype, device=device),
        )

    @classmethod
    def pack(cls, families, k_max: int | None = None) -> "PackedRegions":
        """Stack concrete families (Voronoi/Halfspace) into padded slots."""
        if not families:
            raise ValueError("pack() needs at least one family")
        d = families[0].d
        if k_max is None:
            k_max = max([f.k for f in families
                         if isinstance(f, VoronoiRegions)] or [1])
        first = families[0]
        dev = (first.centers if isinstance(first, VoronoiRegions)
               else first.w).device
        out = cls.empty(len(families), k_max, d, device=dev)
        for i, fam in enumerate(families):
            out = out.set(i, fam)
        return out

    def set(self, slot: int, family) -> "PackedRegions":
        """Write one family into ``slot`` (host-side, between dispatches)."""
        if isinstance(family, VoronoiRegions):
            k = family.k
            if k > self.k_max:
                raise ValueError(
                    f"family has {k} centers, slot capacity is {self.k_max}")
            if family.d != self.d:
                raise ValueError(f"family d={family.d} != packed d={self.d}")
            cent = torch.zeros((self.k_max, self.d), dtype=self.centers.dtype,
                               device=self.centers.device)
            cent[:k] = family.centers
            return self._replace(
                kind=_set_row(self.kind, slot, KIND_VORONOI),
                centers=_set_row(self.centers, slot, cent),
                cmask=_set_row(self.cmask, slot,
                               torch.arange(self.k_max,
                                            device=self.cmask.device) < k),
                w=_set_row(self.w, slot, 0.0),
                b=_set_row(self.b, slot, 0.0),
            )
        if isinstance(family, HalfspaceRegions):
            if family.d != self.d:
                raise ValueError(f"family d={family.d} != packed d={self.d}")
            return self._replace(
                kind=_set_row(self.kind, slot, KIND_HALFSPACE),
                centers=_set_row(self.centers, slot, 0.0),
                cmask=_set_row(self.cmask, slot, False),
                w=_set_row(self.w, slot, family.w),
                b=_set_row(self.b, slot, family.b),
            )
        raise TypeError(f"unsupported region family: {type(family)!r}")

    def clear(self, slot: int) -> "PackedRegions":
        """Reset ``slot`` to padding."""
        return PackedRegions(
            kind=_set_row(self.kind, slot, KIND_VORONOI),
            centers=_set_row(self.centers, slot, 0.0),
            cmask=_set_row(self.cmask, slot, False),
            w=_set_row(self.w, slot, 0.0),
            b=_set_row(self.b, slot, 0.0),
        )

    def slot(self, i: int) -> PackedSlot:
        """One slot's packed parameters."""
        return PackedSlot(self.kind[i], self.centers[i], self.cmask[i],
                          self.w[i], self.b[i])

    def decide_slot(self, slot: int) -> RegionFamily:
        """The decision function of one slot."""
        return self.slot(slot).decide

    def decide(self, v: torch.Tensor) -> torch.Tensor:
        """Every slot's decisions at once: ``v`` (Q, ..., d) -> (Q, ...)."""
        return decide_packed(v, *self)
