"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Port of ``repro.kernels``: ``region_decide``, ``lss_state`` and
``correction`` are CUDA C++ kernels under ``csrc/`` (built by
:mod:`._build`, bound with ctypes), each batched over a leading query-slot
axis, with the public wrappers in :mod:`.ops` and the suite registry in
:mod:`.suite`.

:func:`counts` reads the launch counters of the kernels and the call
counters of their plain versions; :func:`reset_counts` zeroes them.
"""

from __future__ import annotations

from . import correction, lss_state, ref, region_decide
from .suite import (FusedSuite, KernelSuite, ReferenceSuite, get_suite,
                    register_suite, resolve_suite, suite_names)

__all__ = ["KernelSuite", "ReferenceSuite", "FusedSuite", "register_suite",
           "get_suite", "resolve_suite", "suite_names", "counts",
           "reset_counts"]


def counts() -> dict:
    """Kernel launches and plain-version calls since the last reset."""
    return {"region_decide": region_decide.launches,
            "lss_state": lss_state.launches,
            "correction": correction.launches,
            **ref.calls}


def reset_counts() -> None:
    region_decide.launches = 0
    lss_state.launches = 0
    correction.launches = 0
    ref.reset_calls()
