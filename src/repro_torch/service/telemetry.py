"""Per-tenant telemetry: one record per (dispatch, active query), JSONL.

Copy of ``src/repro/service/telemetry.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

:class:`TelemetrySink` is the legacy name for what is now a thin shim
over :class:`repro_torch.obs.JsonlTracker` — same constructor, same byte-level
JSONL output, same convenience accessors — kept so existing callers
(`TelemetrySink(path)`, ``sink.emit(rec)``, ``sink.records``) keep
working unchanged.  New code should construct a tracker from
:mod:`repro_torch.obs` directly and pass it to the service as ``tracker=``;
the record schema both speak is documented in :mod:`repro_torch.obs.schema`.

The sink stays deliberately dumb — the :class:`~repro_torch.service.service.
Service` computes the numbers (batched, one device round-trip per
dispatch) and hands plain dicts here; the sink timestamps nothing and
never touches device arrays, so it can be swapped for a real exporter.
"""

from __future__ import annotations

from typing import IO, Optional, Union

from ..obs import JsonlTracker, MetricsRegistry

__all__ = ["TelemetrySink"]


class TelemetrySink(JsonlTracker):
    """Collects per-query records; optionally streams them as JSONL.

    Record schema: see :mod:`repro_torch.obs.schema` (per-query records plus
    ``kind="control"`` control-plane records).

    ``max_records`` bounds the in-memory copy with a ring buffer (the
    JSONL file still receives every record); the default ``None`` keeps
    everything, matching the historical behavior — the service's *own*
    default sink is bounded.  A str ``path`` is opened in append mode
    (and owned: closed by :meth:`close` / the context manager); a
    file-like object is borrowed.
    """

    def __init__(self, path: Optional[Union[str, IO[str]]] = None,
                 keep: bool = True, max_records: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        super().__init__(path, keep=keep, max_records=max_records,
                         mode="a", registry=registry)

    # Legacy spelling of log_record.
    def emit(self, record: dict) -> None:
        self.log_record(record)
