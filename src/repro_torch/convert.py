"""Carry state across from the JAX package, as numpy arrays.

The port never imports JAX; a caller that holds a JAX ``LSSState``,
``TopoArrays`` or ``PackedSlot`` hands its fields over as numpy arrays
(``{f: np.asarray(getattr(s, f)) for f in s._fields}``) and gets the
port's twin back on ``device``.  This is how the parity tests start both
packages from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import lss, regions

__all__ = ["state_from_jax_numpy", "state_to_numpy", "topo_from_numpy",
           "slot_from_numpy"]

_STATE_DTYPES = {
    "out_m": torch.float32, "out_c": torch.float32,
    "in_m": torch.float32, "in_c": torch.float32,
    "x_m": torch.float32, "x_c": torch.float32,
    "pending": torch.bool, "last_send": torch.int32, "alive": torch.bool,
    "t": torch.int32, "msgs": lss.counter_dtype(),
}


def state_from_jax_numpy(fields, device, seed: int = 0) -> lss.LSSState:
    """The port's :class:`~repro_torch.core.lss.LSSState` from a dict of
    numpy arrays named like the JAX ``LSSState`` fields.

    The JAX ``rng`` key (if present) is dropped: its threefry stream has no
    torch counterpart, so the state gets a generator seeded with ``seed``.
    """
    out = {name: torch.tensor(np.asarray(fields[name]), dtype=dt,
                              device=device)
           for name, dt in _STATE_DTYPES.items()}
    out["rng"] = lss._generator(torch.device(device), seed)
    return lss.LSSState(**out)


def state_to_numpy(state: lss.LSSState) -> dict:
    """Every field but ``rng`` as a numpy array (on the host)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in _STATE_DTYPES}


def topo_from_numpy(nbr, mask, rev, device) -> lss.TopoArrays:
    """The port's ``TopoArrays`` from numpy ``nbr``/``mask``/``rev``."""
    return lss.TopoArrays(
        torch.tensor(np.asarray(nbr), dtype=torch.int32, device=device),
        torch.tensor(np.asarray(mask), dtype=torch.bool, device=device),
        torch.tensor(np.asarray(rev), dtype=torch.int32, device=device))


def slot_from_numpy(kind, centers, cmask, w, b, device) -> regions.PackedSlot:
    """The port's ``PackedSlot`` from the JAX slot's five fields."""
    return regions.PackedSlot(
        kind=torch.tensor(np.asarray(kind), dtype=torch.int32, device=device),
        centers=torch.tensor(np.asarray(centers), dtype=torch.float32,
                             device=device),
        cmask=torch.tensor(np.asarray(cmask), dtype=torch.bool,
                           device=device),
        w=torch.tensor(np.asarray(w), dtype=torch.float32, device=device),
        b=torch.tensor(np.asarray(b), dtype=torch.float32, device=device))
