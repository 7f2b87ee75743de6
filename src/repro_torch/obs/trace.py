"""Causal trace trees assembled from ``kind="span"`` records.

Copy of ``src/repro/obs/trace.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

Every :class:`~repro_torch.obs.tracker.Span` carries a process-unique
``span_id`` and the ``span_id`` of its enclosing scope (``parent_id``),
plus the tenant ``trace_id`` strings it did work for.  The service mints
one ``trace_id`` per tenant at admission (deterministically — trace ids
are part of the record stream, which must stay bitwise identical across
tracker backends), so a flat record stream reconstructs into:

* a **global forest** — every span nested under its parent (tick →
  drains/dispatch/observe, epochs, per-tenant admission/preempt/resume/
  evict scopes), and
* a **per-tenant timeline** — the spans carrying one tenant's
  ``trace_id``, re-parented to the nearest ancestor that also carries it
  (falling back to the tenant's admission root), so "every dispatch has
  an admission ancestor" holds structurally.

Use :func:`assemble` on any record iterable (``InMemoryTracker.records``,
a parsed JSONL file, a flight-recorder dump) and render with
:func:`repro_torch.obs.dashboard.trace_view`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["SpanNode", "TenantTrace", "TraceForest", "assemble"]


class SpanNode:
    """One span in an assembled tree."""

    __slots__ = ("name", "span_id", "parent_id", "trace", "seconds",
                 "attrs", "children")

    def __init__(self, rec: dict):
        self.name: str = rec["name"]
        self.span_id: int = rec["span_id"]
        self.parent_id: Optional[int] = rec.get("parent_id")
        self.trace: Tuple[str, ...] = tuple(rec.get("trace", ()))
        self.seconds: float = float(rec.get("seconds", 0.0))
        self.attrs: dict = dict(rec.get("attrs", {}))
        self.children: List["SpanNode"] = []

    def walk(self):
        """Yield ``(depth, node)`` preorder, children in start order."""
        stack = [(0, self)]
        while stack:
            depth, node = stack.pop()
            yield depth, node
            for child in reversed(node.children):
                stack.append((depth + 1, child))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"SpanNode({self.name!r}, id={self.span_id}, "
                f"children={len(self.children)})")


class TenantTrace:
    """One tenant's causal timeline: the spans carrying its trace id,
    re-parented within the tenant's own set."""

    __slots__ = ("trace_id", "roots", "nodes")

    def __init__(self, trace_id: str, roots: List[SpanNode],
                 nodes: List[SpanNode]):
        self.trace_id = trace_id
        self.roots = roots
        self.nodes = nodes

    def spans_named(self, name: str) -> List[SpanNode]:
        return [n for n in self.nodes if n.name == name]

    def has_ancestry(self, child_name: str, ancestor_name: str) -> bool:
        """True when every ``child_name`` span in this tenant's tree sits
        under some ``ancestor_name`` span (used by the round-trip test:
        every dispatch has an admission ancestor)."""
        targets = self.spans_named(child_name)
        if not targets:
            return False
        covered = set()

        def mark(node: SpanNode, under: bool) -> None:
            under = under or node.name == ancestor_name
            if under and node.name == child_name:
                covered.add(node.span_id)
            for c in node.children:
                mark(c, under)

        for r in self.roots:
            mark(r, False)
        return all(t.span_id in covered for t in targets)


class TraceForest:
    """All spans from a record stream, assembled into trees.

    ``orphans`` lists spans whose ``parent_id`` names a span that never
    appeared — an empty list is the stream-completeness invariant that
    ``python -m repro_torch.obs.validate`` enforces on churn runs.
    """

    def __init__(self, records: Iterable[dict]):
        self.nodes: Dict[int, SpanNode] = {}
        self.roots: List[SpanNode] = []
        self.orphans: List[SpanNode] = []
        for rec in records:
            if rec.get("kind") != "span":
                continue
            node = SpanNode(rec)
            self.nodes[node.span_id] = node
        # Children sorted by span_id == start order (ids are minted at
        # span entry from one monotonic counter).
        for node in sorted(self.nodes.values(), key=lambda n: n.span_id):
            if node.parent_id is None:
                self.roots.append(node)
            elif node.parent_id in self.nodes:
                self.nodes[node.parent_id].children.append(node)
            else:
                self.orphans.append(node)

    # -- tenant views --------------------------------------------------
    def trace_ids(self) -> List[str]:
        seen: Dict[str, None] = {}
        for node in sorted(self.nodes.values(), key=lambda n: n.span_id):
            for tid in node.trace:
                seen.setdefault(tid, None)
        return list(seen)

    def tenant(self, trace_id: str) -> TenantTrace:
        """Project the forest onto one tenant: keep spans carrying
        ``trace_id``; each kept span's parent becomes its nearest kept
        ancestor.  A kept span with no kept scope-ancestor falls back
        under the tenant's FIRST span (its admission scope — span ids are
        minted at entry, so the lowest kept id is the admission span):
        scope nesting links a dispatch to its enclosing tick, temporal
        causality links it to the admission that minted the trace id, so
        "every dispatch has an admission ancestor" holds structurally."""
        keep = {n.span_id: SpanNode(_node_rec(n)) for n in
                self.nodes.values() if trace_id in n.trace}
        roots: List[SpanNode] = []
        for sid in sorted(keep):
            node = self.nodes[sid]
            anc = node.parent_id
            while anc is not None and anc not in keep:
                anc = self.nodes[anc].parent_id if anc in self.nodes else None
            if anc is not None:
                keep[anc].children.append(keep[sid])
            elif roots:
                roots[0].children.append(keep[sid])
            else:
                roots.append(keep[sid])
        nodes = [keep[sid] for sid in sorted(keep)]
        return TenantTrace(trace_id, roots, nodes)

    def tenants(self) -> List[TenantTrace]:
        return [self.tenant(tid) for tid in self.trace_ids()]


def _node_rec(n: SpanNode) -> dict:
    rec = {"name": n.name, "span_id": n.span_id, "seconds": n.seconds,
           "trace": list(n.trace), "attrs": dict(n.attrs)}
    if n.parent_id is not None:
        rec["parent_id"] = n.parent_id
    return rec


def assemble(records: Iterable[dict]) -> TraceForest:
    """Assemble the span records of a stream into a :class:`TraceForest`."""
    return TraceForest(records)
