"""Golden schema for the service's telemetry records.

Copy of ``src/repro/obs/schema.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

Five record kinds flow through a tracker's ``log_record`` stream:

**Per-query** (one per dispatch per active slot; no ``kind`` key)::

    dispatch       int    dispatch ordinal
    t              int    global cycle count after the dispatch
    query          str    tenant's query id
    slot           int    slot index
    accuracy       float  fraction of live peers deciding correctly
    quiescent      bool   no pending messages / violations for this query
    region         int    ground-truth region of the global average
    msgs           int    sends by this query in this dispatch window
    msgs_per_link  float  ditto, normalized per link (current edge count)
    topo_version   int    topology version the dispatch executed under
    trace_id       str    the tenant's causal trace id (minted at admit)

    (SLO tenants only)
    slo_ok         bool   every declared check passed this window
    slo_violations int    cumulative violation count
    accuracy_ok    bool   accuracy target met (when declared)
    msgs_ok        bool   msgs/link bound met (when declared)

**Control** (``kind: "control"``; at most one per dispatch, emitted only
when the boundary did something)::

    kind            "control"
    dispatch        int   dispatch ordinal
    t               int   global cycle count
    queue_depth     int   admission queue occupancy after the boundary
    preempted_depth int   suspended queries waiting to resume

    (only when non-empty / present)
    activated  [str]             queries activated at this boundary
    resumed    [str]             preempted queries resumed
    preempted  [str]             queries suspended
    evicted    [{query, reason}] queue evictions with reasons
    epochs     [dict]            regrow / rebalance epoch records
    spans      {name: float}     host-boundary span wall times (seconds)
    boundary   {name: int}       boundary work counts (events drained,
                                 batches applied, activations, recompiles)

**Span** (``kind: "span"``; one per finished tracker span, emitted by
every backend except Noop)::

    kind      "span"
    name      str    span site (tick, dispatch, admission, ...)
    span_id   int    process-unique id, minted at span entry
    seconds   float  wall time of the scope

    (when present)
    parent_id int    span_id of the enclosing scope (absent = root)
    trace     [str]  tenant trace_ids this scope did work for
    attrs     dict   caller context (backend, k, recompile delta, ...)

**Alert** (``kind: "alert"``; one per alert-rule state *transition*,
see :mod:`repro_torch.obs.alerts`)::

    kind     "alert"
    rule     str    rule name
    metric   str    registry metric the rule watches
    value    float  the series value at the transition
    state    str    "firing" | "resolved"
    dispatch int    dispatch ordinal of the evaluation
    t        int    global cycle count

    (when present)
    labels   dict   the matching series' label set
    sustain  int    consecutive windows required to fire

**Flight** (``kind: "flight"``; the header line of a flight-recorder
dump, see :mod:`repro_torch.obs.flight`)::

    kind     "flight"
    reason   str    trigger (slo_violation, eviction, epoch, alert,
                    audit_violation, crash, manual)
    records  int    ring records that follow

    (when present)
    dispatch int    dispatch ordinal at dump time
    t        int    global cycle count at dump time
    error    str    exception repr (crash dumps)

**Audit** (``kind: "audit"``; one per audited dispatch per active slot,
see :mod:`repro_torch.obs.audit` — the evaluated invariant monitors)::

    kind       "audit"
    dispatch   int    dispatch ordinal the audit window covers
    t          int    global cycle count after the dispatch
    query      str    tenant's query id
    slot       int    slot index
    ok         bool   every monitor held
    violations int    number of monitors that fired
    residual   float  conservation residual (max-abs over components)
    tol        float  the residual's rounding-model tolerance
    trace_id   str    the tenant's causal trace id

    (when present)
    monitors   {name: bool}  per-monitor verdict (True = held)
    edge_bad / edge_checked / stop_bad / seq_bad / ring_bad /
    stale_drops / msgs / live_slots      int    raw reduction counters
    quiescent / claimed_quiescent        bool   recomputed vs claimed
    mag                                  float  conservation L1 mass

:func:`validate_record` checks one dict against this schema and returns
a list of problem strings (empty = valid); :func:`validate_stream` maps
it over an iterable of records (e.g. parsed JSONL lines).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

__all__ = ["PER_QUERY_REQUIRED", "PER_QUERY_OPTIONAL", "CONTROL_REQUIRED",
           "CONTROL_OPTIONAL", "SPAN_REQUIRED", "SPAN_OPTIONAL",
           "ALERT_REQUIRED", "ALERT_OPTIONAL", "FLIGHT_REQUIRED",
           "FLIGHT_OPTIONAL", "AUDIT_REQUIRED", "AUDIT_OPTIONAL",
           "validate_record", "validate_stream"]

_BOOL = (bool,)
_INT = (int,)          # bool is excluded explicitly below
_NUM = (int, float)
_STR = (str,)
_LIST = (list,)
_DICT = (dict,)

PER_QUERY_REQUIRED = {
    "dispatch": _INT,
    "t": _INT,
    "query": _STR,
    "slot": _INT,
    "accuracy": _NUM,
    "quiescent": _BOOL,
    "region": _INT,
    "msgs": _INT,
    "msgs_per_link": _NUM,
    "topo_version": _INT,
    "trace_id": _STR,
}

PER_QUERY_OPTIONAL = {
    "slo_ok": _BOOL,
    "slo_violations": _INT,
    "accuracy_ok": _BOOL,
    "msgs_ok": _BOOL,
}

CONTROL_REQUIRED = {
    "kind": _STR,
    "dispatch": _INT,
    "t": _INT,
    "queue_depth": _INT,
    "preempted_depth": _INT,
}

CONTROL_OPTIONAL = {
    "activated": _LIST,
    "resumed": _LIST,
    "preempted": _LIST,
    "evicted": _LIST,
    "epochs": _LIST,
    "spans": _DICT,
    "boundary": _DICT,
}

SPAN_REQUIRED = {
    "kind": _STR,
    "name": _STR,
    "span_id": _INT,
    "seconds": _NUM,
}

SPAN_OPTIONAL = {
    "parent_id": _INT,
    "trace": _LIST,
    "attrs": _DICT,
}

ALERT_REQUIRED = {
    "kind": _STR,
    "rule": _STR,
    "metric": _STR,
    "value": _NUM,
    "state": _STR,
    "dispatch": _INT,
    "t": _INT,
}

ALERT_OPTIONAL = {
    "labels": _DICT,
    "sustain": _INT,
    "percentile": _NUM,  # histogram rules watching a tail quantile
}

FLIGHT_REQUIRED = {
    "kind": _STR,
    "reason": _STR,
    "records": _INT,
}

FLIGHT_OPTIONAL = {
    "dispatch": _INT,
    "t": _INT,
    "error": _STR,
}

AUDIT_REQUIRED = {
    "kind": _STR,
    "dispatch": _INT,
    "t": _INT,
    "query": _STR,
    "slot": _INT,
    "ok": _BOOL,
    "violations": _INT,
    "residual": _NUM,
    "tol": _NUM,
    "trace_id": _STR,
}

AUDIT_OPTIONAL = {
    "monitors": _DICT,
    "edge_bad": _INT,
    "edge_checked": _INT,
    "stop_bad": _INT,
    "seq_bad": _INT,
    "ring_bad": _INT,
    "stale_drops": _INT,
    "msgs": _INT,
    "live_slots": _INT,
    "quiescent": _BOOL,
    "claimed_quiescent": _BOOL,
    "mag": _NUM,
}

_KINDS = {
    "control": (CONTROL_REQUIRED, CONTROL_OPTIONAL),
    "span": (SPAN_REQUIRED, SPAN_OPTIONAL),
    "alert": (ALERT_REQUIRED, ALERT_OPTIONAL),
    "flight": (FLIGHT_REQUIRED, FLIGHT_OPTIONAL),
    "audit": (AUDIT_REQUIRED, AUDIT_OPTIONAL),
}


def _check_type(key: str, value, types: tuple, errs: List[str]) -> None:
    # bool is an int subclass: reject it for int/float-typed keys, and
    # require it for bool-typed keys.
    if bool in types:
        if not isinstance(value, bool):
            errs.append(f"{key}: expected bool, got {type(value).__name__}")
        return
    if isinstance(value, bool) or not isinstance(value, types):
        names = "/".join(t.__name__ for t in types)
        errs.append(f"{key}: expected {names}, got {type(value).__name__}")


def validate_record(record: dict) -> List[str]:
    """Problems with one record against the golden schema ([] = valid)."""
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, not dict"]
    kind = record.get("kind")
    if kind is None:
        required, optional = PER_QUERY_REQUIRED, PER_QUERY_OPTIONAL
    elif kind in _KINDS:
        required, optional = _KINDS[kind]
    else:
        return [f"unknown record kind {kind!r}"]
    errs: List[str] = []
    for key, types in required.items():
        if key not in record:
            errs.append(f"missing required key {key!r}")
        else:
            _check_type(key, record[key], types, errs)
    for key, value in record.items():
        if key in required:
            continue
        if key not in optional:
            errs.append(f"unknown key {key!r}")
        else:
            _check_type(key, value, optional[key], errs)
    return errs


def validate_stream(records: Iterable[dict]) -> List[Tuple[int, str]]:
    """(index, problem) pairs over a record stream ([] = all valid)."""
    out: List[Tuple[int, str]] = []
    for i, rec in enumerate(records):
        for err in validate_record(rec):
            out.append((i, err))
    return out
