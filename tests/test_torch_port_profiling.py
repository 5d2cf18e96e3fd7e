"""Port: ``utils/profiling.py``.

- the recorder: off, ``span`` returns the shared null context and nothing
  is recorded or allocated; nested spans give parent ids, request ids
  inherited from the parent, and self time; two threads keep separate
  stacks; ``count`` sums; ``add`` and ``annotate``; a span open when
  ``stop()`` is called is left out;
- a CPU train step records ``step`` with ``step.forward`` (the model's
  ``fwd.*``), ``step.loss``, ``step.backward`` and ``step.optimizer``, and
  ``train()`` its ``loop.data`` and ``loop.log``;
- ``device_busy`` merges overlapping device intervals (two streams), sums
  the busy time over the span the record observed, and lists the idle
  gaps longest first;
- ``trace`` writes a gzipped Chrome trace and yields the profiler.
"""

import gzip
import json
import os
import threading
import tracemalloc
from types import SimpleNamespace

import pytest
import torch

from _torch_port_common import TINY
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.training import train as tr
from tacotron2_vae_torch.training.train_state import create_train_state, make_train_step
from tacotron2_vae_torch.utils import profiling


@pytest.fixture(autouse=True)
def _stopped():
    yield
    profiling.stop()


def _fake_clock(monkeypatch, step=1.0):
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: step * next(ticks))


def test_off_path_records_nothing_and_returns_the_shared_null_context():
    assert not profiling.recording()
    assert profiling.span("x") is profiling.span("y", rid=3) is profiling._NULL
    assert profiling.next_rid() is None and profiling.current_rid() is None
    assert profiling.current_rids() is None

    def off_calls():
        for _ in range(1000):
            with profiling.span("x"):
                profiling.count("c")
                profiling.add("q", 0.0, 1.0)
                profiling.annotate(k=1)

    off_calls()   # warm: any lazy state made once
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        off_calls()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, profiling.__file__)
    grown = [d for d in after.filter_traces([here]).compare_to(
        before.filter_traces([here]), "lineno") if d.size_diff > 0]
    assert not grown, grown
    profiling.start()
    assert profiling.stop() == {"spans": [], "counters": {}}


def test_nested_spans_give_parents_rids_and_self_time(monkeypatch):
    _fake_clock(monkeypatch)
    profiling.start()
    with profiling.span("outer", rid=7):                 # 0 .. 5
        with profiling.span("inner"):                     # 1 .. 2
            pass
        with profiling.span("other", rid=8):              # 3 .. 4
            profiling.annotate(extra="a")
    rec = profiling.stop()
    by = {d["name"]: d for d in rec["spans"]}
    assert [d["name"] for d in rec["spans"]] == ["inner", "other", "outer"]
    assert by["outer"]["parent"] is None
    assert by["inner"]["parent"] == by["other"]["parent"] == by["outer"]["id"]
    assert (by["outer"]["rid"], by["inner"]["rid"], by["other"]["rid"]) == (7, 7, 8)
    assert by["other"]["extra"] == "a"
    own = profiling.self_s(rec["spans"])
    assert own[by["outer"]["id"]] == 5 - 1 - 1 and own[by["inner"]["id"]] == 1
    assert by["outer"]["thread"] == threading.get_ident()


def test_two_threads_keep_separate_stacks():
    profiling.start()
    ready, go = threading.Barrier(2), threading.Event()
    rids = {}

    def worker(name):
        with profiling.span(name, rid=profiling.next_rid()):
            ready.wait()          # both spans open at once
            with profiling.span(name + ".child"):
                rids[name] = profiling.current_rid()
            go.wait()

    threads = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=30)
    rec = profiling.stop()
    by = {d["name"]: d for d in rec["spans"]}
    for n in ("a", "b"):
        assert by[n + ".child"]["parent"] == by[n]["id"]
        assert by[n + ".child"]["thread"] == by[n]["thread"]
        assert by[n]["parent"] is None and rids[n] == by[n]["rid"]
    assert by["a"]["thread"] != by["b"]["thread"] and by["a"]["rid"] != by["b"]["rid"]


def test_count_sums_add_records_and_open_spans_are_left_out():
    profiling.start()
    for n in (1, 2, 3):
        profiling.count("k1.instantiate_ns", n)
    profiling.count("calls")
    with profiling.span("batch", rids=[4, 5]):
        assert profiling.current_rids() == [4, 5]
        profiling.add("batcher.queue", 1.0, 2.0, rid=4)
    late = profiling.span("late")
    late.__enter__()
    rec = profiling.stop()
    late.__exit__(None, None, None)
    assert rec["counters"] == {"k1.instantiate_ns": 6, "calls": 1}
    q, batch = rec["spans"]
    assert (q["name"], batch["name"]) == ("batcher.queue", "batch")
    assert (q["start"], q["end"], q["rid"], q["parent"]) == (1.0, 2.0, 4, batch["id"])
    assert profiling.stop() == {"spans": [], "counters": {}}


def test_many_threads_lose_no_count_or_span():
    import sys

    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.start()
    try:
        def work():
            for _ in range(n):
                with profiling.span("s"):
                    profiling.count("c")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        rec = profiling.stop()
    assert rec["counters"] == {"c": n_threads * n}
    assert len(rec["spans"]) == n_threads * n
    assert all(d["parent"] is None for d in rec["spans"])


def _batch(hp, B=2, S=8, T=16):
    g = torch.Generator().manual_seed(0)
    out_lens = torch.tensor([T, T - 4][:B])
    return {"text": torch.randint(1, hp.n_symbols, (B, S), generator=g),
            "input_lengths": torch.tensor([S, S - 2][:B]),
            "mel": torch.randn(B, 80, T, generator=g) - 3,
            "output_lengths": out_lens,
            "gate": (torch.arange(T)[None] >= out_lens[:, None] - 1).float()}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_records_its_phases(accum):
    hp = create_hparams(TINY + f",grad_accum_steps={accum}")
    ts = create_train_state(hp, "cpu")
    step = make_train_step(hp)
    profiling.start()
    step(ts, _batch(hp), torch.Generator().manual_seed(0))
    spans = profiling.stop()["spans"]
    names = [d["name"] for d in spans]
    top = next(d for d in spans if d["name"] == "step")
    kids = [d["name"] for d in spans if d["parent"] == top["id"]]
    assert kids == ["step.forward", "step.loss", "step.backward"] * accum + ["step.optimizer"]
    fwd = {d["id"] for d in spans if d["name"] == "step.forward"}
    assert [d["name"] for d in spans if d["parent"] in fwd] == [
        "fwd.encoder", "fwd.vae", "fwd.decoder", "fwd.postnet"] * accum
    assert names[-1] == "step" and all(top["start"] <= d["start"] <= d["end"] <= top["end"]
                                       for d in spans)


def test_train_loop_records_data_and_log(tmp_path, monkeypatch):
    import numpy as np
    from scipy.io import wavfile

    rows = []
    for i in range(4):
        wav = str(tmp_path / f"c{i}.wav")
        x = 0.3 * np.sin(2 * np.pi * 150 * np.arange(8000) / 16000)
        wavfile.write(wav, 16000, (x * 32767).astype(np.int16))
        rows.append(f"{wav}|안녕하세요.|0|{i % 4}\n")
    flist = tmp_path / "train.txt"
    flist.write_text("".join(rows), encoding="utf-8")
    hp = create_hparams(TINY + f",training_files='{flist}',validation_files='{flist}',"
                        "batch_size=2,epochs=1,iters_per_checkpoint=100,log_fetch_window=1")
    profiling.start()
    tr.train(str(tmp_path / "out"), "", None, False, hp, device="cpu")
    spans = profiling.stop()["spans"]
    count = {n: sum(d["name"] == n for d in spans) for n in ("loop.data", "loop.log", "step")}
    # two batches: a wait for each and one for the end of the epoch; a log a step
    assert count == {"loop.data": 3, "loop.log": 2, "step": 2}


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
