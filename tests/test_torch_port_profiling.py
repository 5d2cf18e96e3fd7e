"""Port: ``utils/profiling.py``.

- ``StepTimer`` keeps the same EMA as the JAX package's (same step times
  fed to both);
- ``device_busy`` merges overlapping device intervals (two streams), sums
  the busy time over the span the record observed, and lists the idle
  gaps longest first;
- ``trace`` writes a gzipped Chrome trace and yields the profiler.
"""

import gzip
import json
import os
from types import SimpleNamespace

import pytest
import torch

from tacotron2_vae_torch.utils import profiling
from tacotron2_vae_tpu.utils import profiling as jprofiling


def test_step_timer_ema_matches_jax(monkeypatch):
    times = [0.0, 0.5, 1.0, 1.2, 2.0, 2.9]  # three steps: 0.5, 0.2, 0.9 s
    timers = []
    for mod in (profiling, jprofiling):
        ticks = iter(times)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(alpha=0.25)
        for _ in range(3):
            with timer:
                pass
        timers.append(timer)
    a, b = timers
    assert a.ema == pytest.approx(b.ema, rel=1e-12) and a.last == pytest.approx(b.last)
    assert a.ema == pytest.approx(0.25 * 0.9 + 0.75 * (0.25 * 0.2 + 0.75 * 0.5))
    assert a.throughput(64) == pytest.approx(64 / a.ema)


def _event(start, end, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end), device_type=kind)


def test_device_busy_merges_streams_and_lists_gaps():
    events = [_event(0, 1000, False),            # host: the span is 0..1000 us
              _event(100, 300, True), _event(200, 400, True),   # overlap: 100..400
              _event(450, 500, True), _event(800, 900, True)]
    got = profiling.device_busy(SimpleNamespace(events=lambda: events))
    assert got["span_ms"] == pytest.approx(1.0)
    assert got["busy_ms"] == pytest.approx(0.45)
    assert got["busy_share"] == pytest.approx(0.45)
    assert got["idle_gaps_ms"] == pytest.approx([0.3, 0.05])


def test_trace_writes_a_gzipped_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), name="t") as prof:
        torch.ones(64) @ torch.ones(64)
    path = os.path.join(str(tmp_path), "t.json.gz")
    with gzip.open(path, "rt") as f:
        assert "traceEvents" in json.load(f)
    assert profiling.device_busy(prof)["busy_ms"] == 0.0  # no card here
