"""Push-style tracker: wandb-shaped ``step``/``log`` buffering.

Copy of ``src/repro/obs/push.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

Hosted experiment trackers (wandb, mlflow, neptune) want batched
*pushes* of step-stamped payloads rather than a pull/scrape surface.
:class:`PushTracker` adapts the repo's :class:`~repro_torch.obs.Tracker`
protocol to that shape without taking any network dependency: payloads
are buffered and periodically flushed to a user callback, which can POST
them, queue them, or hand them to a real client library.

Every payload is ``{"step": int, ...}``; the step auto-increments per
record (wandb semantics: monotone, never reused) unless the caller
stamps one explicitly via :meth:`log`.  Buffering is bounded by
``flush_every``; ``flush()``/``close()`` drain the remainder, so no
payload is ever dropped by the tracker itself.

The registry behaves exactly like every other backend (gauges from
``log_metrics``, span histograms), so dashboards and policies read the
same surface regardless of where the push stream goes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .metrics import MetricsRegistry
from .tracker import Tracker

__all__ = ["PushTracker"]


class PushTracker(Tracker):
    """Buffer step-stamped payloads; flush batches to ``emit``.

    Args:
      emit: ``f(batch: list[dict])`` called with each drained batch
        (ordered, step-stamped).  Defaults to collecting into
        :attr:`pushed` (useful in tests and as an outbox).
      flush_every: buffer size that triggers an automatic flush.
    """

    def __init__(self, emit: Optional[Callable[[List[dict]], None]] = None,
                 flush_every: int = 32,
                 registry: Optional[MetricsRegistry] = None):
        super().__init__(registry)
        self.pushed: List[List[dict]] = []
        self._emit = emit if emit is not None else self.pushed.append
        self.flush_every = max(1, int(flush_every))
        self._buf: List[dict] = []
        self._step = 0

    # -- wandb-style entry point --------------------------------------
    def log(self, data: Dict[str, object], step: Optional[int] = None
            ) -> int:
        """Push one payload; returns the step it was stamped with.

        ``step`` may be supplied to group several payloads under one
        step; it must be >= the current step (monotone)."""
        if step is None:
            step = self._step
            self._step += 1
        else:
            step = int(step)
            if step < self._step - 1:
                raise ValueError(
                    f"step {step} is behind the stream (at {self._step})")
            self._step = max(self._step, step + 1)
        payload = {"step": step}
        payload.update(data)
        self._buf.append(payload)
        if len(self._buf) >= self.flush_every:
            self.flush()
        return step

    # -- Tracker protocol ---------------------------------------------
    def log_record(self, record: dict) -> None:
        self.log({"record": record})

    def log_metrics(self, metrics, **labels) -> None:
        super().log_metrics(metrics, **labels)  # keep registry gauges
        payload: Dict[str, object] = {"metrics": dict(metrics)}
        if labels:
            payload["labels"] = dict(labels)
        self.log(payload)

    # -- lifecycle -----------------------------------------------------
    def flush(self) -> None:
        if self._buf:
            batch, self._buf = self._buf, []
            self._emit(batch)

    def close(self) -> None:
        if not self._closed:
            self.flush()
        super().close()
