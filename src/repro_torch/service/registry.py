"""Fixed-capacity query slot registry: admission without reshaping.

Port of ``repro/service/registry.py``.  The registry owns the host-side
bookkeeping (query id -> slot, the specs, admission order) and the
device-side :class:`~repro_torch.service.query.QueryParams` tensors.
Admit/retire/replace rewrite one slot of those fixed-shape tensors between
dispatches, so the batched step only ever sees the same shapes.  Free
slots carry masked no-op padding queries (``active = False``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import lss
from .query import QueryParams, QuerySpec

__all__ = ["QueryRegistry"]


class QueryRegistry:
    """Q fixed query slots with an active mask and stable query ids."""

    def __init__(self, capacity: int, k_max: int, d: int,
                 defaults: lss.LSSConfig = lss.LSSConfig(), device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.k_max = k_max
        self.d = d
        self.defaults = defaults
        self.params = QueryParams.empty(capacity, k_max, d, defaults,
                                        device=device)
        self._slot_of: Dict[str, int] = {}
        self._specs: List[Optional[QuerySpec]] = [None] * capacity
        self._ids: List[Optional[str]] = [None] * capacity
        self._serial = 0

    # -- introspection -----------------------------------------------------
    @property
    def num_active(self) -> int:
        return len(self._slot_of)

    @property
    def num_free(self) -> int:
        return self.capacity - self.num_active

    def slot_of(self, query_id: str) -> int:
        try:
            return self._slot_of[query_id]
        except KeyError:
            raise KeyError(f"unknown query id {query_id!r}") from None

    def spec_of(self, query_id: str) -> QuerySpec:
        return self._specs[self.slot_of(query_id)]

    def active_items(self) -> List[Tuple[str, int, QuerySpec]]:
        """(query_id, slot, spec) for every admitted query, slot order."""
        return [(qid, s, self._specs[s])
                for s, qid in enumerate(self._ids) if qid is not None]

    # -- admission ---------------------------------------------------------
    def reserve_id(self) -> str:
        """Mint a query id without claiming a slot (queued admissions:
        the service hands the id out immediately, the slot comes later)."""
        query_id = f"q{self._serial:06d}"
        self._serial += 1
        return query_id

    def admit(self, spec: QuerySpec, query_id: Optional[str] = None) -> str:
        """Claim a free slot for ``spec``; returns the tenant's query id.

        Raises ``RuntimeError`` when every slot is occupied (the caller —
        :class:`~repro_torch.service.service.Service` — queues or rejects).
        """
        if spec.inputs.shape[-1] != self.d:
            raise ValueError(
                f"query inputs have d={spec.inputs.shape[-1]}, "
                f"service is configured for d={self.d}")
        free = next((s for s, qid in enumerate(self._ids) if qid is None),
                    None)
        if free is None:
            raise RuntimeError(
                f"service full: all {self.capacity} query slots occupied")
        if query_id is None:
            query_id = self.reserve_id()
        elif query_id in self._slot_of:
            raise ValueError(f"query id {query_id!r} already admitted")
        self.params = self.params.set_slot(free, spec, self.defaults)
        self._slot_of[query_id] = free
        self._specs[free] = spec
        self._ids[free] = query_id
        return query_id

    def retire(self, query_id: str) -> int:
        """Release the query's slot back to padding; returns the slot."""
        slot = self.slot_of(query_id)
        self.params = self.params.clear_slot(slot, self.defaults)
        del self._slot_of[query_id]
        self._specs[slot] = None
        self._ids[slot] = None
        return slot

    def replace(self, query_id: str, spec: QuerySpec) -> int:
        """Swap the query's predicate/inputs in place (same id, same slot)."""
        slot = self.slot_of(query_id)
        if spec.inputs.shape[-1] != self.d:
            raise ValueError(
                f"query inputs have d={spec.inputs.shape[-1]}, "
                f"service is configured for d={self.d}")
        self.params = self.params.set_slot(slot, spec, self.defaults)
        self._specs[slot] = spec
        return slot
