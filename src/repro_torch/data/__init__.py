"""Deterministic, shardable data pipeline (port of ``repro.data``).

Every host builds only its local shard of each global batch from a
counter-indexed PRNG, so the step index fully determines the batch: resume
is exact with no reader state to checkpoint, and a host with another
data-shard id regenerates its slice of the same global batch.
"""

from .pipeline import Batch, TokenSource, make_batch_fn

__all__ = ["Batch", "TokenSource", "make_batch_fn"]
