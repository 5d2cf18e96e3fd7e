"""Profiling and step timing (the JAX package's ``utils/profiling.py``).

``trace(logdir)`` records the enclosed block with ``torch.profiler`` (host
and CUDA activities) and writes a gzipped Chrome trace, viewable in Perfetto;
``device_busy`` reads from such a record how much of the observed time the
card was busy and its longest idle gaps.  ``StepTimer`` keeps the same EMA
of the wall time per step as the JAX one.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace", cpu: bool = True):
    """Profile the enclosed block; yields the profiler, whose record is
    written to ``logdir/<name>.json.gz`` on exit.  ``cpu=False`` records
    the card's activity only (where there is a card), which costs the host
    far less.

    >>> with trace("/tmp/profile") as prof:
    ...     train_step(...)
    """
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu or not cuda else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json.gz"))


def device_busy(prof, top_gaps: int = 5) -> dict:
    """From a finished profile: the span it observed (first to last event,
    host or device, in ms; the card's own span when only it was recorded),
    the card's busy time (the union of its kernel and copy intervals),
    their ratio and the longest idle gaps between device intervals (ms,
    longest first)."""
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not events:
        return {"span_ms": 0.0, "busy_ms": 0.0, "busy_share": 0.0, "idle_gaps_ms": []}
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, gaps, cur = 0.0, [], None
    for s, e in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append(s - cur[1])
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = max(t1 - t0, 1e-9)
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / span,
            "idle_gaps_ms": [g / 1e3 for g in sorted(gaps, reverse=True)[:top_gaps]]}


class StepTimer:
    """Wall-clock time per step with an EMA, for throughput reporting."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self.last = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.last = dt
        self.ema = dt if self.ema is None else self.alpha * dt + (1 - self.alpha) * self.ema
        return False

    def throughput(self, items: int) -> float:
        """Items per second from the EMA of the step time."""
        return items / self.ema if self.ema else float("nan")
