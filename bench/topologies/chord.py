"""The paper's symmetric Chord ring (``core/topology.py::chord``): each
peer links its successor and its fingers at 2^j, j < ceil(log2 n), both
directions.  ``{"kind": "chord", "n": <peers>}``."""

import numpy as np

from bench.harness.gen import undirected


def edges(spec):
    n = int(spec["n"])
    i = np.arange(n, dtype=np.int64)
    b = max(1, int(np.ceil(np.log2(n))))
    dst = np.stack([(i + 1) % n] + [(i + (1 << j)) % n for j in range(1, b)],
                   axis=1)
    src = np.broadcast_to(i[:, None], dst.shape)
    return n, undirected(n, np.stack([src.reshape(-1), dst.reshape(-1)],
                                     axis=1))
