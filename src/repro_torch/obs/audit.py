"""Online invariant monitors for the audit plane.

Port of ``src/repro/obs/audit.py``: :func:`evaluate`, :func:`record`,
:data:`MONITORS` and :class:`AuditReport` are its host code, copied;
:func:`audit_core` reads the port's :func:`repro_torch.core.lss.
audit_impl`, and :class:`AuditFaults` edits torch tensors (a clone, then
an indexed add, where JAX uses ``.at[].add``).

The paper's guarantees are *algebraic*: the repositioning arithmetic
conserves the weighted vector sum under any messaging schedule, settled
link endpoints agree bitwise on their shared agreement vector, and the
local stopping rule (Def. 4) is sound exactly because those identities
hold.  This module turns each of them into a runtime monitor over the
raw device reductions produced by :func:`repro_torch.core.lss.audit_impl` /
``ShardedLSS.audit``:

===============  ===========================================================
monitor          invariant
===============  ===========================================================
``conservation`` ``(+)_alive S_i == (+)_alive X_ii (+) (+)_inflight
                 (in (-) out_rev)`` — residual within a rounding-model
                 tolerance (``u * N_terms * L1-mass``); any real break
                 (corrupted knowledge, double-applied halo repair) lands
                 orders of magnitude above it.
``counter``      the exact integer send counter: non-negative and bounded
                 by the window's maximum possible sends (``k * n * D``).
``edge``         settled endpoints of every (sampled) shared edge hold the
                 *bitwise identical* agreement vector ``A_ij = A_ji``
                 (IEEE addition is commutative — zero tolerance).
``stopping``     a quiescence claim implies every alive peer's Def.-4
                 balance condition holds (``stop_bad == 0``).  The serving
                 path's claim is cross-checked against the reference
                 formulas; Alg. 1's violating set is strictly stronger
                 than Def. 4, so a *consistent* state can never trip this
                 — only a stale or miscomputed claim does.
``seq``          (async engines) per-link sequence numbers never regress
                 — the receiver's last applied seq and every live ring
                 publication stay bounded by the sender's counter — and
                 the device stale-drop total reconciles with the
                 ``engine_async_stale_drops_total`` gauge.
===============  ===========================================================

:func:`evaluate` folds a raw reduction dict into an :class:`AuditReport`;
:func:`record` renders a report as a schema'd ``kind="audit"`` record for
the Tracker stream (alert-rule- and flight-recorder-triggerable, joined
back to spans by :mod:`repro_torch.obs.forensics`).  :class:`AuditFaults` is
the fault-injection harness the monitors are proven against: each fault
is constructed to be *surgical* — visible to exactly one monitor — which
is what makes the suite evidence that the monitors are independent
checks rather than one aggregate alarm.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["AuditReport", "AuditFaults", "evaluate", "record",
           "audit_core", "audit_engine", "MONITORS"]

#: Monitor names in report order (``seq`` only on async engine states).
MONITORS = ("conservation", "counter", "edge", "stopping", "seq")


class AuditReport(NamedTuple):
    """Evaluated verdicts for one audited (query, window) pair."""

    ok: bool
    violations: int
    monitors: Dict[str, bool]  # name -> held
    raw: dict                  # host-scalar reductions the verdicts used
    claimed: Optional[bool]    # the quiescence claim `stopping` checked


def _scalar(v):
    return v.item() if hasattr(v, "item") else v


def evaluate(raw: dict, claimed_quiescent: Optional[bool] = None,
             max_sent: Optional[int] = None,
             stale_drops_metric: Optional[int] = None) -> AuditReport:
    """Fold raw audit reductions into per-monitor verdicts.

    ``claimed_quiescent`` is the quiescence bit the *serving path*
    reported for this window (default: the audit program's own recomputed
    bit, under which ``stopping`` is a pure self-consistency check).
    ``max_sent`` bounds the exact send counter (``k_cycles * n * D`` for
    the audited window's capacity).  ``stale_drops_metric`` is the
    ``engine_async_stale_drops_total`` gauge value to reconcile the
    device-side stale-drop counter against (async engines only).
    """
    raw = {k: _scalar(v) for k, v in raw.items()}
    monitors: Dict[str, bool] = {}
    monitors["conservation"] = raw["resid"] <= raw["tol"]
    msgs = raw.get("msgs")
    monitors["counter"] = (
        msgs is None
        or (msgs == int(msgs) and int(msgs) >= 0
            and (max_sent is None or int(msgs) <= int(max_sent))))
    monitors["edge"] = raw.get("edge_bad", 0) == 0
    claimed = (bool(claimed_quiescent) if claimed_quiescent is not None
               else bool(raw.get("quiescent", False)))
    monitors["stopping"] = not (claimed and raw.get("stop_bad", 0) > 0)
    if "seq_bad" in raw:
        seq_ok = raw["seq_bad"] == 0 and raw.get("ring_bad", 0) == 0
        if stale_drops_metric is not None:
            seq_ok = seq_ok and raw.get("stale_drops", 0) == int(
                stale_drops_metric)
        monitors["seq"] = seq_ok
    violations = sum(1 for held in monitors.values() if not held)
    return AuditReport(ok=violations == 0, violations=violations,
                       monitors=monitors, raw=raw, claimed=claimed)


def record(report: AuditReport, *, dispatch: int, t: int, query: str,
           slot: int, trace_id: str) -> dict:
    """Render a report as a schema'd ``kind="audit"`` Tracker record."""
    rec = {
        "kind": "audit",
        "dispatch": int(dispatch),
        "t": int(t),
        "query": str(query),
        "slot": int(slot),
        "ok": bool(report.ok),
        "violations": int(report.violations),
        "residual": float(report.raw["resid"]),
        "tol": float(report.raw["tol"]),
        "trace_id": str(trace_id),
        "monitors": {k: bool(v) for k, v in report.monitors.items()},
        "mag": float(report.raw.get("mag", 0.0)),
        "quiescent": bool(report.raw.get("quiescent", False)),
    }
    if report.claimed is not None:
        rec["claimed_quiescent"] = bool(report.claimed)
    for key in ("edge_bad", "edge_checked", "stop_bad", "seq_bad",
                "ring_bad", "stale_drops", "msgs", "live_slots"):
        if key in report.raw:
            rec[key] = int(report.raw[key])
    return rec


def audit_core(state, topo, decide, eps: float = 1e-9, sample_mod: int = 1,
               sample_phase: int = 0) -> dict:
    """Raw reductions for a core :class:`~repro_torch.core.lss.LSSState`
    as a dict of Python scalars (the service folds the same reductions
    into its observe's one host transfer instead)."""
    from ..core import lss

    raw = lss.audit_impl(state, topo, decide, eps=eps,
                         sample_mod=sample_mod, sample_phase=sample_phase)
    return {k: _scalar(v) for k, v in raw.items()}


def audit_engine(eng, state, **kw) -> dict:
    """Raw reductions for a ``ShardedLSS`` state (either kind); alias of
    ``eng.audit(state)`` so harness code reads symmetrically."""
    return eng.audit(state, **kw)


def _host(t) -> np.ndarray:
    """A tensor's values as a host numpy array."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _added(t: torch.Tensor, *edits) -> torch.Tensor:
    """A copy of ``t`` with ``(index, value)`` edits added in order."""
    out = t.clone()
    for idx, value in edits:
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        out[idx] += value.to(dtype=t.dtype, device=t.device)
    return out


class AuditFaults:
    """Surgical fault injectors the monitor suite is proven against.

    Core-layout faults take and return an :class:`~repro_torch.core.lss.LSSState`;
    :meth:`on_engine` lifts any of them onto an engine state via the
    ``to_lss_state`` / ``place_lss_state`` round-trip (send totals and
    delivery semantics are preserved at ``drop_rate=0`` — see
    ``place_lss_state``).  Each fault's blast radius:

    * :meth:`corrupt_knowledge` — *conservation only.*  Both endpoints of
      one link apply the same phantom knowledge bump: the pairwise
      agreements shift identically (edge check blind by construction),
      but the global weighted sum moves by 2·delta.  (In float32 the
      two agreements ``out + (in + delta)`` and ``in + (out + delta)``
      can round apart, so ``edge`` may fire beside ``conservation``, in
      the JAX package as here.)
    * :meth:`drop_halo_message` — *edge only.*  One endpoint loses a
      delivery the other endpoint double-applies: the perturbations
      cancel in the global sum, but the two agreement vectors for the
      shared edge now differ bitwise.
    * :meth:`skew_migration` — *stopping only.*  A migrated row's data
      vector is skewed.  ``X_ii`` enters the status sum and the global
      reference identically, so conservation cancels *exactly*, and no
      message slot is touched — but the peer's status vector crosses a
      region boundary while its agreements still point at the old
      region, so a (stale) quiescence claim is now unsound.
    * :meth:`regress_seq` — *seq only* (async engine states).  A
      sender-side out-slot counter jumps backward, the fault Alg. 1's
      monotone per-message guard assumes impossible.
    """

    @staticmethod
    def _live_slot(state, topo, row: int = 0):
        """First SETTLED live slot at or after ``row``, and its reverse:
        ``(i, k, j, r)``.

        Settled (neither direction pending) is the state in which both
        the conservation ledger and the edge check treat the link as
        at-rest — a perturbation injected into an *in-flight* slot is
        legitimately cancelled by the in-flight term, so faults target
        settled slots to stay attributable to exactly one monitor.
        Falls back to any live slot when nothing is settled."""
        nbr = _host(topo.nbr)
        rev = _host(topo.rev)
        alive = _host(state.alive)
        pending = _host(state.pending)
        live = _host(topo.mask) & alive[:, None] & alive[nbr]
        settled = live & ~pending & ~pending[nbr, rev]
        for cand in (settled, live):
            rows, slots = np.nonzero(cand)
            if rows.size == 0:
                continue
            sel = np.nonzero(rows >= row)[0]
            idx = int(sel[0]) if sel.size else 0
            i, k = int(rows[idx]), int(slots[idx])
            return i, k, int(nbr[i, k]), int(rev[i, k])
        raise ValueError("no live slots to fault")

    @staticmethod
    def corrupt_knowledge(state, topo, row: int = 0, delta: float = 5.0):
        """Symmetric phantom knowledge on one link: fires conservation."""
        i, k, j, r = AuditFaults._live_slot(state, topo, row)
        return state._replace(
            in_m=_added(state.in_m, ((i, k), delta), ((j, r), delta)))

    @staticmethod
    def drop_halo_message(state, topo, row: int = 0, delta: float = 5.0):
        """Dropped-then-duplicated delivery on one link: fires edge."""
        i, k, j, r = AuditFaults._live_slot(state, topo, row)
        return state._replace(
            in_m=_added(state.in_m, ((i, k), -delta), ((j, r), delta)))

    @staticmethod
    def skew_migration(state, delta, row: int = 0):
        """Skew one row's data vector by ``delta`` (shape (d,)): fires
        stopping under a (stale) quiescence claim, and nothing else."""
        return state._replace(x_m=_added(state.x_m, ((row,), delta)))

    @staticmethod
    def regress_seq(astate, tables, amount: int = 1000):
        """Regress the first boundary out-slot's seq counter: fires seq."""
        h = tables.halo
        ok = _host(h.send_ok)
        hits = np.argwhere(ok)
        if hits.size == 0:
            raise ValueError("no boundary slots to regress")
        src, dst, hh = (int(v) for v in hits[0])
        row = int(h.send_row[src, dst, hh])
        slot = int(h.send_slot[src, dst, hh])
        return astate._replace(out_seq=_added(
            astate.out_seq, ((src, row, slot), -int(amount))))

    @staticmethod
    def on_engine(eng, state, fault, *args, **kw):
        """Apply a core-layout fault to an engine state (either kind)."""
        snap = eng.to_lss_state(state)
        placed = eng.place_lss_state(fault(snap, *args, **kw))
        if hasattr(state, "sync"):
            return state._replace(sync=placed)
        return placed
