"""Fault-tolerant checkpointing: atomic, async, in JAX's layout (port of
``repro.checkpoint``).

Layout:  <dir>/step_<N>/
             manifest.json        — leaf names (JAX's keystr), shapes,
                                    dtypes, step
             shard_0.npz          — the flat leaf arrays ``leaf_<i>``
         <dir>/LATEST             — atomically-updated pointer file

Guarantees:
  * atomicity — writes go to ``step_<N>.tmp`` and are renamed only after
    a sync; a crash mid-save never corrupts the latest checkpoint;
  * async — ``save_async`` copies to host RAM synchronously and writes in
    a daemon thread, overlapping the next train steps (which update the
    parameters in place);
  * elastic — ``load(..., shardings=)`` places each leaf on a
    ``NamedSharding`` of another mesh; across ranks a save gathers DTensor
    leaves and rank 0 writes.
"""

from .store import latest_step, load, save, save_async, wait_pending

__all__ = ["save", "save_async", "load", "latest_step", "wait_pending"]
