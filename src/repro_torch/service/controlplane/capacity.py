"""Capacity policy: auto-regrow on exhaustion, drift-triggered rebalance.

Copy of ``src/repro/service/controlplane/capacity.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

Two explicitly-priced *epochs* keep a long-lived service healthy without
operator babysitting, both driven from here and executed by the service:

* **Regrow** — membership capacity (``n_cap`` rows / ``deg_cap`` slots)
  is a compiled-shape wall; hitting it raises :class:`~repro_torch.core.
  topology.CapacityError`.  With ``auto_regrow`` the service instead
  drives :meth:`DynTopology.grow` (factor :attr:`grow_factor`), re-shards
  the engine backend over the larger capacity, migrates all Q slots'
  state across ``new_of_old``, and recompiles ONCE — the price the
  DynTopology docs promise for outgrowing the padding, now paid
  transparently at a boundary instead of surfacing as an exception.

* **Rebalance** — the engine's partition is fixed at construction, so
  sustained churn (joins claim arbitrary free rows, rewires ignore shard
  geometry) drifts shard occupancy away from the BFS edge-cut optimum
  and the halo traffic grows.  The *drift metric* is the increase in
  cut-edge fraction (cross-shard edges / total edges) since the last
  partition epoch — cheap host-side numpy on the tables the engine
  already keeps.  Past :attr:`rebalance_drift`, the service runs a
  re-partition epoch: fresh BFS partition of the *current* graph, halo
  tables rebuilt, state migrated bitwise across ``new_of_old``.

Both epoch actions live in the service/engine; this module is the pure
policy (when to act) plus the drift bookkeeping, so it is trivially
testable and reusable by operators driving epochs by hand.
"""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["CapacityManager"]


class CapacityManager:
    """Decides regrow sizes and rebalance timing; owns the drift state."""

    def __init__(self, auto_regrow: bool = False, grow_factor: float = 1.5,
                 rebalance_drift: float = 0.0,
                 rebalance_check_every: int = 8):
        if grow_factor <= 1.0:
            raise ValueError(f"grow_factor must be > 1, got {grow_factor}")
        if rebalance_check_every < 1:
            raise ValueError("rebalance_check_every must be >= 1")
        self.auto_regrow = bool(auto_regrow)
        self.grow_factor = float(grow_factor)
        self.rebalance_drift = float(rebalance_drift)
        self.rebalance_check_every = int(rebalance_check_every)
        self._cut0: Optional[float] = None  # cut fraction at last epoch
        self.epochs: list = []  # host-side log of epoch events

    # -- regrow ------------------------------------------------------------
    def grown_caps(self, n_cap: int, deg_cap: int,
                   need: str) -> dict:
        """The ``grow()`` kwargs for an exhaustion of ``need``
        (``"rows"`` | ``"slots"``): geometric growth, minimum +2 so tiny
        capacities still make progress."""
        if need == "rows":
            return {"n_cap": max(n_cap + 2,
                                 int(math.ceil(n_cap * self.grow_factor)))}
        if need == "slots":
            return {"deg_cap": max(deg_cap + 2,
                                   int(math.ceil(deg_cap
                                                 * self.grow_factor)))}
        raise ValueError(f"unknown capacity kind {need!r}")

    # -- rebalance ---------------------------------------------------------
    def note_epoch(self, kind: str, cut_frac: Optional[float],
                   **info) -> dict:
        """Record a partition epoch (init counts as one): resets the
        drift baseline to ``cut_frac`` and logs the event."""
        self._cut0 = cut_frac
        ev = {"kind": kind, "cut_frac": cut_frac, **info}
        self.epochs.append(ev)
        del self.epochs[:-1000]  # bounded
        return ev

    def drift(self, cut_frac: Optional[float]) -> float:
        """Cut-fraction increase since the last epoch (>= 0)."""
        if cut_frac is None or self._cut0 is None:
            return 0.0
        return max(0.0, cut_frac - self._cut0)

    def should_rebalance(self, dispatch: int,
                         cut_frac: Optional[float]) -> bool:
        """True when a drift check is due this dispatch AND the drift
        exceeds the configured threshold (0 disables)."""
        if self.rebalance_drift <= 0.0 or cut_frac is None:
            return False
        if dispatch % self.rebalance_check_every != 0:
            return False
        return self.drift(cut_frac) > self.rebalance_drift
