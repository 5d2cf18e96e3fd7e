"""Profiling: the program's own spans and counters, and the profiler's trace.

The recorder.  ``span(name, rid=None, rids=None)`` is a context manager
that, while recording, keeps the name, start and end (``time.perf_counter``,
the clock the benchmark places its own spans on), the thread, its own id,
its parent's id (the innermost span open on the same thread) and a request
id: ``rid`` (one request; by default the parent's) or ``rids`` (a batch of
them).  ``add`` records a span whose times are already known (a request's
wait in a queue, seen by the thread that ends it); ``annotate`` attaches
values to the innermost open span of the thread; ``count(name, n)`` sums a
counter.  ``start()`` turns recording on; ``stop()`` turns it off and
returns ``{"spans": [...], "counters": {...}}``: spans that ended while it
was on, as dicts, oldest end first.  Nothing is written anywhere.

Off, ``span`` is one test of a module global that returns a shared null
context, and ``count``, ``add`` and ``annotate`` return at once.

On a card, ``start()`` also records an anchor CUDA event right after a
synchronise.  A span that carries a pair of CUDA events
(``annotate(device_events=(start, end))``, as ``ops.decoder_loop`` does
around kernel K1, whose body the profiler cannot see) gets at ``stop()``
its placed device interval ``device = (t0, t1)`` on the host clock: the
anchor's host time plus the event's time after the anchor.

``trace(logdir)`` records the enclosed block with ``torch.profiler`` (host
and CUDA activities) and writes a gzipped Chrome trace, viewable in
Perfetto; ``device_busy`` reads from such a record how much of the
observed time the card was busy and its longest idle gaps.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

_on = False                       # the one test the off path makes
_session = None                   # the recording under way: a _Session
_NULL = contextlib.nullcontext()  # what span() returns when off
_local = threading.local()        # each thread's stack of open spans
_ids = itertools.count(1)
_rids = itertools.count(1)


class _Session:
    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.lock = threading.Lock()
        self.anchor = None        # (host time, CUDA event) on a card


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("session", "name", "start", "end", "thread", "id", "parent", "rid", "rids",
                 "attrs")

    def __init__(self, name, rid, rids):
        self.session = _session
        self.name, self.rid, self.rids = name, rid, rids
        self.attrs = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.rid is None and parent is not None:
            self.rid = parent.rid
        self.id = next(_ids)
        self.thread = threading.get_ident()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if _session is self.session:
            self.session.spans.append(self)
        return False

    def asdict(self) -> dict:
        d = {"name": self.name, "start": self.start, "end": self.end, "thread": self.thread,
             "id": self.id, "parent": self.parent, "rid": self.rid, "rids": self.rids}
        if self.attrs:
            d.update(self.attrs)
        return d


def span(name: str, rid=None, rids=None):
    """A span of the program's work (see the module's doc); while not
    recording, the shared null context."""
    if not _on:
        return _NULL
    return _Span(name, rid, rids)


def recording() -> bool:
    return _on


def next_rid():
    """A new request id while recording, else None."""
    return next(_rids) if _on else None


def current_rid():
    """The request id of the innermost span open on this thread (None when
    there is none, or while not recording)."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1].rid if stack else None


def current_rids():
    """The ``rids`` of the innermost span open on this thread that has
    them (a batch), else None."""
    if not _on:
        return None
    for sp in reversed(_stack()):
        if sp.rids is not None:
            return sp.rids
    return None


def add(name: str, start: float, end: float, rid=None) -> None:
    """Record a finished span of this thread whose times are known."""
    if not _on:
        return
    sp = _Span(name, rid, None)
    stack = _stack()
    sp.parent = stack[-1].id if stack else None
    sp.id, sp.thread, sp.start, sp.end = next(_ids), threading.get_ident(), start, end
    if _session is sp.session:
        sp.session.spans.append(sp)


def annotate(**attrs) -> None:
    """Attach ``attrs`` to the innermost span open on this thread."""
    if not _on:
        return
    stack = _stack()
    if stack:
        sp = stack[-1]
        sp.attrs = {**(sp.attrs or {}), **attrs}


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _on:
        return
    s = _session
    with s.lock:
        s.counters[name] = s.counters.get(name, 0) + n


def start() -> None:
    """Start recording (a new, empty record).  On a card whose CUDA
    context exists, synchronise and record the anchor event."""
    global _on, _session
    s = _Session()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        ev.record()
        s.anchor = (t, ev)
    _session = s
    _on = True


def stop() -> dict:
    """Stop recording; the spans that ended while it ran (dicts, in the
    order they ended) and the counters.  A span's ``device_events`` pair
    becomes its placed interval ``device`` (host seconds) and ``device_ms``."""
    global _on, _session
    s = _session
    _on, _session = False, None
    if s is None:
        return {"spans": [], "counters": {}}
    spans = [sp.asdict() for sp in s.spans]
    timed = [d for d in spans if "device_events" in d]
    if timed and s.anchor is not None:
        torch.cuda.synchronize()
        t_anchor, anchor = s.anchor
        for d in timed:
            a, b = d.pop("device_events")
            d["device"] = (t_anchor + anchor.elapsed_time(a) / 1e3,
                           t_anchor + anchor.elapsed_time(b) / 1e3)
            d["device_ms"] = a.elapsed_time(b)
    else:
        for d in timed:
            d.pop("device_events")
    return {"spans": spans, "counters": dict(s.counters)}


def self_s(spans: list) -> dict:
    """Each span's own seconds: its length less its children's (by id)."""
    own = {d["id"]: d["end"] - d["start"] for d in spans}
    for d in spans:
        if d["parent"] in own:
            own[d["parent"]] -= d["end"] - d["start"]
    return own


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
    observed = max(t1 - t0, 1e-9)
    return {"span_ms": observed / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / observed,
            "idle_gaps_ms": [g / 1e3 for g in sorted(gaps, reverse=True)[:top_gaps]]}
