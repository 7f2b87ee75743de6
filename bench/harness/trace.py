"""What the traced run (``--trace 1``) adds: host ranges around the
program's layers, a counting pass after the window, and the reduction of
one ``torch.profiler`` trace to device time, busy time and labelled idle
gaps.

* :class:`HostRanges` wraps the service's boundary steps, the observe, the
  dispatch and the do-while in ``record_function`` ranges, so an idle gap
  of the device can be labelled with what the host was doing.
* :class:`KernelCounts` wraps the three kernels' public wrappers
  (``repro_torch.kernels.ops``) during the counting pass that follows the
  window: before each launch it sums the launch's live slots (the
  ``mask`` argument of ``lss_state``) or its violating set (``v_set`` of
  ``correction``), bound by parameter name, into one slot of a device
  buffer inside a ``bench::count`` range, with no host read; the buffer is
  read once when the pass ends.  The window runs without it, so its
  reductions cost the window nothing; the kernels' device time that the
  rooflines divide by is the pass's own.
* :func:`reduce_trace` reads the profiler's raw events once.  The
  harness's own copies (``bench::snapshot``) are left out of the window's
  wall and of its busy time.
"""

from __future__ import annotations

import bisect
import functools
import inspect
from collections import defaultdict

import torch
from torch.profiler import record_function

COUNT_RANGE = "bench::count"
WINDOW_RANGE = "bench::window"
PASS_RANGE = "bench::count_pass"
HARNESS_RANGES = ("bench::snapshot",)
SCALAR_READS = ("aten::_local_scalar_dense", "aten::item", "aten::is_nonzero")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
PASS_SHARE = 0.1  # the counting pass's length, a share of the window's


class KernelCounts:
    """Launch-by-launch counts of the kernels' data-dependent work."""

    def __init__(self, ops_module, device, cap=1 << 20):
        self.ops = ops_module
        self.live = torch.zeros(cap, dtype=torch.int32, device=device)
        self.viol = torch.zeros(cap, dtype=torch.int32, device=device)
        self.n_live = self.n_viol = self.n_global = 0
        self._saved = {}

    def _count(self, buf, idx, t):
        if idx >= buf.shape[0]:
            raise RuntimeError("kernel count buffer full")
        with record_function(COUNT_RANGE):
            torch.sum(t, dim=tuple(range(t.ndim)), dtype=torch.int32,
                      out=buf[idx])

    def _counted(self, fn, param, on_launch):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def counted(*args, **kw):
            on_launch(sig.bind(*args, **kw).arguments[param])
            return fn(*args, **kw)
        return counted

    def _live(self, mask):
        self._count(self.live, self.n_live, mask)
        self.n_live += 1

    def _viol(self, v_set):
        self._count(self.viol, self.n_viol, v_set)
        self.n_viol += 1

    def _global(self, _):
        self.n_global += 1

    def install(self):
        ops = self.ops
        self._saved = {name: getattr(ops, name) for name in
                       ("lss_state", "correction", "global_decision")}
        ops.lss_state = self._counted(self._saved["lss_state"], "mask",
                                      self._live)
        ops.correction = self._counted(self._saved["correction"], "v_set",
                                       self._viol)
        ops.global_decision = self._counted(self._saved["global_decision"],
                                            "alive", self._global)

    def uninstall(self):
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)
        self._saved = {}

    def totals(self):
        """(live slots, violating slots) summed over every counted launch:
        the one host read."""
        live = int(self.live[:self.n_live].to(torch.int64).sum())
        viol = int(self.viol[:self.n_viol].to(torch.int64).sum())
        return live, viol


class HostRanges:
    """``record_function`` ranges around one service's boundary steps, its
    dispatch, its observe, and the do-while of every cycle: the labels an
    idle gap of the device gets."""

    SERVICE = (("_prepare_membership", "drain"), ("_apply_membership", "drain"),
               ("_drain_admission", "admission"), ("_apply_ingest", "ingest"),
               ("_dispatch_call", "dispatch"), ("_finish_window", "observe"))

    def __init__(self, svc, lss_module):
        self.svc, self.lss = svc, lss_module
        self._loop = None

    @staticmethod
    def _wrap(fn, label):
        @functools.wraps(fn)
        def ranged(*args, **kw):
            with record_function(f"bench::{label}"):
                return fn(*args, **kw)
        return ranged

    def install(self):
        for attr, label in self.SERVICE:
            setattr(self.svc, attr, self._wrap(getattr(self.svc, attr), label))
        self._loop = self.lss._correction_loop
        self.lss._correction_loop = self._wrap(self._loop, "do-while")

    def uninstall(self):
        for attr, _ in self.SERVICE:
            fn = getattr(self.svc, attr)
            setattr(self.svc, attr, fn.__wrapped__)
        self.lss._correction_loop = self._loop


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _innermost(ranges, times):
    """For each of the increasing ``times``, the label of the innermost of
    the nested ``ranges`` ((start, end, label), sorted by start) that holds
    it, or ``harness`` outside them all."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "harness")
    return out


def _is_launch(e, name):
    """A host-side CUDA runtime or driver call (a launch or a copy)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in LAUNCH_KINDS
    return name.startswith(("cuda", "cu"))


def reduce_trace(prof):
    """The traced window's device time by kernel, busy time and idle gaps
    by host activity, and the counting pass's device time by kernel
    (seconds), from one pass over the profiler's raw events; None without
    a window or a device event."""
    cuda = torch.autograd.DeviceType.CUDA
    ev = {"device": [], "launches": {}, "window": None, "count_pass": None,
          "harness": [], "counts": [], "ranges": [], "reads": []}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # The host ranges' mirrors on the device's timeline are not
            # device work.
            if not name.startswith("bench::"):
                ev["device"].append((e.start_ns(), e.end_ns(), name,
                                     e.correlation_id()))
        elif _is_launch(e, name):
            ev["launches"][e.correlation_id()] = e.start_ns()
        elif name == WINDOW_RANGE:
            ev["window"] = (e.start_ns(), e.end_ns())
        elif name == PASS_RANGE:
            ev["count_pass"] = (e.start_ns(), e.end_ns())
        elif name in HARNESS_RANGES:
            ev["harness"].append((e.start_ns(), e.end_ns()))
        elif name == COUNT_RANGE:
            ev["counts"].append((e.start_ns(), e.end_ns()))
        elif name.startswith("bench::"):
            ev["ranges"].append((e.start_ns(), e.end_ns(),
                                 name[len("bench::"):]))
        elif name in SCALAR_READS:
            ev["reads"].append(e.end_ns())
    if ev["window"] is None or not ev["device"]:
        return None
    return summarize(**ev)


def _holder(intervals):
    """``inside(t)``: whether ``t`` lies in one of the disjoint-or-not
    ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]

    def inside(t):
        if t is None:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and merged[i][1] >= t
    return inside


def _minus(span, cuts):
    """The interval ``span`` without the intervals ``cuts``: a sorted list
    of disjoint intervals."""
    out, (lo, hi) = [], span
    for s, e in sorted(cuts):
        if e <= lo or s >= hi:
            continue
        if s > lo:
            out.append((lo, s))
        lo = max(lo, e)
    if lo < hi:
        out.append((lo, hi))
    return out


def _clip(s, e, pieces, starts):
    """The parts of (s, e) inside the sorted disjoint ``pieces``."""
    out = []
    i = max(0, bisect.bisect_right(starts, s) - 1)
    while i < len(pieces) and pieces[i][0] < e:
        a, b = max(s, pieces[i][0]), min(e, pieces[i][1])
        if b > a:
            out.append((a, b))
        i += 1
    return out


def summarize(device, launches, window, count_pass, harness, counts,
              ranges, reads):
    """:func:`reduce_trace` on plain lists (times in ns): ``device`` the
    device operations (start, end, name, correlation id), ``launches`` the
    host launch time by correlation id, ``window`` and ``count_pass``
    (start, end), ``harness`` the harness's own ranges inside the window
    (left out of it), ``counts`` the counting ranges, ``ranges`` the
    labelled host ranges, ``reads`` the end times of the host's scalar
    reads."""
    pieces = _minus(window, harness)
    starts = [a for a, _ in pieces]
    by_harness = _holder(harness)
    by_count = _holder(counts)
    in_pass = _holder([count_pass] if count_pass else [])
    by_name, pass_by_name = defaultdict(float), defaultdict(float)
    busy = []
    for s, e, name, corr in device:
        t = launches.get(corr)
        if by_harness(t) or by_count(t):
            continue
        if in_pass(t):
            pass_by_name[name] += (e - s) / 1e9
            continue
        for a, b in _clip(s, e, pieces, starts):
            by_name[name] += (b - a) / 1e9
            busy.append((a, b))
    busy_ns = _union(busy)
    busy.sort()
    idle = []
    for lo, hi in pieces:
        prev = lo
        for s, e in busy[bisect.bisect_left(busy, (lo, lo)):]:
            if s >= hi:
                break
            if s > prev:
                idle.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            idle.append((prev, hi))
    labels = _innermost(sorted(ranges), [(a + b) // 2 for a, b in idle])
    reads = sorted(reads)
    gaps = defaultdict(float)
    longest = []
    for (a, b), label in zip(idle, labels):
        if label == "do-while":
            # A read of the loop's flag that returned in or just before
            # the gap: the host waited for the device, then relaunched.
            i = bisect.bisect_right(reads, b) - 1
            label = ("do-while read" if i >= 0 and reads[i] >= a - 20_000
                     else "do-while launch")
        gaps[label] += (b - a) / 1e9
        longest.append(((b - a) / 1e9, label))
    longest.sort(reverse=True)
    return {
        "window_s": sum(b - a for a, b in pieces) / 1e9,
        "busy_s": busy_ns / 1e9,
        "by_name": dict(by_name),
        "pass_by_name": dict(pass_by_name),
        "idle_by_label": dict(gaps),
        "longest_gaps": longest[:10],
    }
