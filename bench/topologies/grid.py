"""The paper's sensor grid (``core/topology.py::grid``): a square of
side sqrt(n), each peer linked to its right and lower neighbours, no wrap.
``{"kind": "grid", "n": <a square>}``."""

import numpy as np

from bench.harness.gen import undirected


def edges(spec):
    n = int(spec["n"])
    side = int(round(np.sqrt(n)))
    if side * side != n:
        raise ValueError(f"a grid needs a square n, got {n}")
    i = np.arange(n, dtype=np.int64)
    r, c = np.divmod(i, side)
    right = np.where(c + 1 < side, i + 1, -1)
    down = np.where(r + 1 < side, i + side, -1)
    dst = np.stack([right, down], axis=1)
    src = np.broadcast_to(i[:, None], dst.shape)
    e = np.stack([src.reshape(-1), dst.reshape(-1)], axis=1)
    return n, undirected(n, e[e[:, 1] >= 0])
