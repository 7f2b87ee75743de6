"""Device-time attribution for dispatches.

Port of ``src/repro/obs/profile.py``.  :class:`ProfiledDispatch` wraps a
dispatch callable and splits one wall-clock interval where the callable
returns::

    t0 ──(python + kernel launches)── t1 ──(device catches up)── t2
          host_ms = t1 - t0                 device_ms = t2 - t1

``t2`` is observed by a fence: a CUDA event recorded on the current
stream right after the call returns, then synchronized.  JAX fences with
``block_until_ready`` on the returned arrays; a torch dispatch returns
tensors whose work is queued on the current stream, and the event marks
the end of that queue.  The call's output is found by walking it for a
CUDA tensor; on CPU tensors there is nothing to fence, and ``device_ms``
reads about 0.

In the port the correction do-while reads its running flag on the host
once per iteration (:mod:`repro_torch.core.lss`), so the host waits for
the device inside the call and ``t1`` falls when the dispatch is nearly
done: ``host_overhead_frac = host / (host + device)`` reads near 1.  It
measures how much of the dispatch the host loop spans, not an idle card.

``sample_every=N`` fences and publishes only every Nth call, as in JAX;
the rest run the callable bare.  Per sampled call the wrapper publishes
the ``dispatch_host_ms`` / ``dispatch_device_ms`` / ``host_overhead_frac``
gauges (labeled by backend) through ``tracker.log_metrics``, so a
:class:`~repro_torch.obs.NoopTracker` keeps the registry empty.

``profiler_dir=`` runs each sampled call inside a ``torch.profiler``
session (:func:`profiler_session`) whose trace handler writes a Chrome
trace (``*.pt.trace.json``) into that directory; no TensorBoard is needed
to write or read it.  The session opens on the thread that makes the
call: the overlapped service's worker thread.
"""

from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter
from typing import Any, Callable, Optional

import torch

from .tracker import NoopTracker, Tracker

__all__ = ["ProfiledDispatch", "profiler_session"]


@contextmanager
def profiler_session(profiler_dir: Optional[str]):
    """A ``torch.profiler.profile`` scope writing a Chrome trace into
    ``profiler_dir`` when it closes (CPU activity, and the card's when
    CUDA is available); a no-op without a directory."""
    if not profiler_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profiler_dir)):
        yield


def _cuda_device(tree) -> Optional[torch.device]:
    """The device of the first CUDA tensor in nested tuples (named
    tuples, lists, dicts) of ``tree``, or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            dev = _cuda_device(sub)
            if dev is not None:
                return dev
    return None


def _fence(out) -> None:
    """Wait until the work queued on the current stream of ``out``'s
    device is done (nothing for host tensors)."""
    dev = _cuda_device(out)
    if dev is None:
        return
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()


class ProfiledDispatch:
    """Wrap a dispatch callable with host/device wall attribution.

    Args:
      fn: the dispatch callable; its return value (nested tuples of
        tensors) is fenced on the current stream of its CUDA device.
      tracker: the :class:`~repro_torch.obs.Tracker` whose registry
        receives the gauges.  Defaults to Noop (attribution still computed
        and readable off :attr:`last`, nothing published).
      backend: gauge label value (``"core"`` / ``"engine"`` / ...).
      profiler_dir: when set, every sampled call runs inside a
        :func:`profiler_session`.
      sample_every: fence cadence.  1 (default) fences every call; N > 1
        fences and publishes only calls where ``calls % N == 0``.
    """

    __slots__ = ("fn", "tracker", "backend", "profiler_dir", "calls",
                 "last", "sample_every", "sampled")

    def __init__(self, fn: Callable[..., Any], tracker: Optional[Tracker]
                 = None, backend: str = "core",
                 profiler_dir: Optional[str] = None,
                 sample_every: int = 1):
        self.fn = fn
        self.tracker = tracker if tracker is not None else NoopTracker()
        self.backend = backend
        self.profiler_dir = profiler_dir
        self.sample_every = max(1, int(sample_every))
        self.calls = 0
        self.sampled = 0  # how many calls actually fenced + published
        # Most recent attribution:
        # {"host_ms", "device_ms", "total_ms", "host_overhead_frac"}.
        self.last: dict = {}

    def __call__(self, *args, **kwargs):
        if self.calls % self.sample_every != 0:
            self.calls += 1
            return self.fn(*args, **kwargs)
        with profiler_session(self.profiler_dir):
            t0 = perf_counter()
            out = self.fn(*args, **kwargs)
            t1 = perf_counter()
            _fence(out)
            t2 = perf_counter()
        host_ms = (t1 - t0) * 1e3
        device_ms = max((t2 - t1) * 1e3, 0.0)
        total_ms = max((t2 - t0) * 1e3, 1e-12)
        self.calls += 1
        self.sampled += 1
        self.last = {
            "host_ms": host_ms,
            "device_ms": device_ms,
            "total_ms": total_ms,
            "host_overhead_frac": host_ms / total_ms,
        }
        self.tracker.log_metrics(
            {"dispatch_host_ms": host_ms,
             "dispatch_device_ms": device_ms,
             "host_overhead_frac": host_ms / total_ms},
            backend=self.backend)
        return out
