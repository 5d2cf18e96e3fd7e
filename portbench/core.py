"""What every cell shares: the manifest, the cell's files, the statistics
of the end-to-end metrics, the per-layer readers, the device's busy time
from a profiler trace, and the result line.

A cell is found by name: ``BENCHMARK.json`` gives its configuration and
traffic, ``configs/<config>.json`` the model's sizes, ``traffic/<traffic>
.json`` the parameters of the traffic and the runner that runs it
(``portbench/<runner>.py``), ``metrics/<name>.py`` the reader of each
per-layer metric.  A new cell, configuration, traffic mix or per-layer
metric is new files and new entries.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import threading
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tacotron2_vae_tpu")
TRACE_S = 10.0      # seconds of a --trace 1 window that the profiler records


def load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_spec(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its traffic and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(configs[cell["config"]])
    config["sizes"] = load_json(os.path.join(root, config["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer, "bench_dir": bench_dir}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def percentile(values, p: float) -> float:
    """Nearest-rank percentile; a failed request is +inf and counts."""
    xs = sorted(values)
    if not xs:
        return math.inf
    k = max(0, math.ceil(p / 100.0 * len(xs)) - 1)
    return xs[k]


def median(values) -> float:
    return percentile(values, 50.0)


def load_reader(name: str, bench_dir: str = BENCH_DIR):
    """``metrics/<name>.py``'s ``read(rec) -> float | None``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(spec: dict, rec: dict) -> dict:
    """Every per-layer metric of the cell whose reader finds something.  A
    metric whose ``workloads`` name this cell has to find something: the
    run fails rather than leave it out."""
    out, missing = {}, []
    for m in spec["per_layer"]:
        v = load_reader(m["name"], spec["bench_dir"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        elif spec["cell"]["name"] in m.get("workloads", []):
            missing.append(m["name"])
    if missing:
        raise RuntimeError(f"per-layer metrics declared for {spec['cell']['name']} "
                           f"found nothing to read: {missing}")
    return out


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


class Spans:
    """Host spans of the harness's wraps: (start, end, name) on the
    ``time.perf_counter`` clock."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((t, time.perf_counter(), name))


class Pause:
    """Lets one thread hold the device work of the others between their
    calls: ``work()`` wraps a worker's call, ``hold()`` waits until no call
    runs and keeps new ones out until it ends.  The profiler is stopped
    under ``hold()``: stopping it while another thread launches work on
    the card can hang both."""

    def __init__(self):
        self._cv = threading.Condition()
        self._held = False
        self._busy = 0

    @contextlib.contextmanager
    def work(self):
        with self._cv:
            self._cv.wait_for(lambda: not self._held)
            self._busy += 1
        try:
            yield
        finally:
            with self._cv:
                self._busy -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def hold(self):
        with self._cv:
            self._held = True
            self._cv.wait_for(lambda: self._busy == 0)
        try:
            yield
        finally:
            with self._cv:
                self._held = False
                self._cv.notify_all()


def start_trace():
    """A running ``torch.profiler`` record of the card's activity alone
    (host activity recording would slow the host several-fold), and an
    anchor: the host time at which a marker kernel was launched on an idle
    card, to place host spans on the trace's clock."""
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    anchor = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return prof, anchor


def device_trace(prof, anchor: float, spans: list, hidden=()) -> dict:
    """From a finished ``start_trace`` record: the card's busy seconds (the
    union of its kernel, copy and set intervals), the device time of each
    kernel name, the device ops that took most time, and the longest idle
    gaps, each named by the innermost host span holding its middle.

    ``hidden`` = [(kernel name fragments, seconds by CUDA events)]: work of
    those kernels the profiler did not see (launched from a conditional
    graph node's body, as K1's decode is) is added to the busy time: the
    event seconds less what the profiler saw of kernels with those names."""
    import torch

    dev = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name))
    dev.sort()
    marker = next((d for d in dev if "sleep" in d[2] or "spin" in d[2]), dev[0] if dev else None)
    offset = marker[0] - anchor if marker else 0.0
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    busy = union_s([(s, e) for s, e, _ in dev])
    for frags, seconds in hidden:
        seen = sum(t for n, t in by_name.items() if any(f in n for f in frags))
        busy += max(0.0, seconds - seen)
    gaps, end = [], None
    for s, e, _ in dev:
        if end is not None and s > end:
            gaps.append((s - end, (s + end) / 2))
        end = e if end is None else max(end, e)
    host = [(a + offset, b + offset, n) for a, b, n in spans]
    named: dict = {}
    for length, mid in gaps:
        inner = [sp for sp in host if sp[0] <= mid <= sp[1]]
        label = ("host: " + min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                 else "host: outside the harness's spans")
        named[label] = named.get(label, 0.0) + length
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "kernels": by_name,
            "breakdown": {"device_ops": [[n, t] for n, t in top_ops],
                          "idle_gaps": [[n, t] for n, t in top_gaps]}}


def device_info(count: int = 1) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def checks_line(checks: dict) -> str:
    """One line per compared number: name, value, limit, verdict."""
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r} "
                     f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}"
                     for k, v in checks.items())
