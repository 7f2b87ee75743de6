"""Counter-indexed synthetic LM token stream + host-sharded batch assembly.

Port of ``repro/data/pipeline.py``.  The stream is numpy, as JAX's: the
tokens, labels and frames of every ``(seed, step, shard, num_shards)`` are
bitwise JAX's, and become tensors only at the end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device

__all__ = ["Batch", "TokenSource", "make_batch_fn"]


class Batch(NamedTuple):
    tokens: torch.Tensor  # (B, L) int32
    labels: torch.Tensor  # (B, L) int32
    frames: Optional[torch.Tensor] = None  # enc-dec stub frontend embeddings


@dataclasses.dataclass(frozen=True)
class TokenSource:
    """Deterministic pseudo-corpus: batch i is a pure function of (seed, i).

    Sequences follow a Zipf-ish unigram draw with Markov smoothing so the
    loss curve is non-trivial (a uniform stream gives a flat loss).  The
    batches are built on the host: their tensors are on the CPU
    (:func:`make_batch_fn` places them).
    """

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frames_dim: int = 0  # >0 for enc-dec: emit stub frame embeddings
    enc_len: int = 0

    def global_batch_at(self, step: int) -> Batch:
        return self.shard_at(step, 0, 1)

    def shard_at(self, step: int, shard: int, num_shards: int) -> Batch:
        """The rows [shard::num_shards] of global batch ``step``."""
        assert self.global_batch % num_shards == 0
        rows = self.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # Zipf unigram via inverse-CDF on a power law, then a Markov blend.
        u = rng.random((rows, self.seq_len + 1))
        ranks = np.floor((self.vocab ** u - 1.0) / (self.vocab - 1.0)
                         * self.vocab).astype(np.int64)
        ranks = np.clip(ranks, 0, self.vocab - 1)
        # Markov smoothing: with prob .5 repeat-shift the previous token.
        rep = rng.random((rows, self.seq_len + 1)) < 0.5
        seq = ranks.copy()
        seq[:, 1:] = np.where(rep[:, 1:],
                              (seq[:, :-1] * 31 + 7) % self.vocab,
                              seq[:, 1:])
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        frames = None
        if self.frames_dim:
            frames = rng.standard_normal(
                (rows, self.enc_len, self.frames_dim)).astype(np.float32)
        return Batch(tokens=torch.from_numpy(tokens),
                     labels=torch.from_numpy(labels),
                     frames=None if frames is None
                     else torch.from_numpy(frames))


def make_batch_fn(source: TokenSource, mesh=None, device=None):
    """Returns step -> Batch on ``device`` (``cuda`` unless the caller
    passes one; without a card and without a device it raises).

    With a ``DeviceMesh`` the batch rows are split over the data axes it
    has (``("pod", "data")``) and replicated over the others, JAX's
    ``P(data_axes, None)`` / ``P(data_axes, None, None)``: ``tokens``,
    ``labels`` and ``frames`` are DTensors whose local shard, on
    ``device``, is this rank's rows (every rank builds the global batch;
    nothing moves between ranks).
    """
    dev = resolve_device(device)
    if mesh is None:
        def fn(step: int) -> Batch:
            b = source.global_batch_at(step)
            return Batch(*(None if x is None else x.to(dev) for x in b))

        return fn

    from ..distributed.sharding import NamedSharding, device_put

    data_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    sh2 = NamedSharding(mesh, (data_axes or None, None))
    sh3 = NamedSharding(mesh, (data_axes or None, None, None))

    def fn_mesh(step: int) -> Batch:
        b = source.global_batch_at(step)
        return Batch(
            tokens=device_put(b.tokens, sh2, dev),
            labels=device_put(b.labels, sh2, dev),
            frames=None if b.frames is None
            else device_put(b.frames, sh3, dev))

    return fn_mesh
