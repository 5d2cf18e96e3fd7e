"""The statistics and the per-layer readers on records made by hand."""

import math
import os
import threading
import time

import pytest

from portbench import core


def test_percentile_over_all_requests_failures_as_inf():
    lat = [float(i) for i in range(1, 21)]           # 20 requests, 1..20 ms
    assert core.percentile(lat, 50) == 10.0
    assert core.percentile(lat, 95) == 19.0
    failed = lat[:-2] + [math.inf, math.inf]          # two failures
    assert core.percentile(failed, 95) == math.inf
    assert core.percentile(failed, 50) == 10.0
    assert core.percentile([], 95) == math.inf


def test_a_stall_moves_the_rate():
    """Audio completed in the window over the window: a stall that pushes
    replies past the close lowers the rate; nothing is a median of chunks."""
    t0, t1 = 100.0, 110.0
    done = [(100.5 + i, 9.6) for i in range(10)]      # one reply a second
    rate = sum(a for t, a in done if t <= t1) / (t1 - t0)
    stalled = [(t + 3.0 if t > 105 else t, a) for t, a in done]
    rate_stalled = sum(a for t, a in stalled if t <= t1) / (t1 - t0)
    assert rate == pytest.approx(9.6)
    assert rate_stalled == pytest.approx(9.6 * 0.7)


def test_pause_holds_between_calls():
    """``hold()`` waits for the running call to end and keeps the next one
    out until it ends: the profiler stops with no launch in flight."""
    pause, log = core.Pause(), []
    started, go = threading.Event(), threading.Event()

    def worker():
        with pause.work():
            started.set()
            go.wait(5)
            log.append("call 1 ends")
        time.sleep(0.05)
        with pause.work():
            log.append("call 2 starts")

    th = threading.Thread(target=worker)
    th.start()
    started.wait(5)
    threading.Timer(0.2, go.set).start()
    with pause.hold():
        log.append("held")
        time.sleep(0.3)
        log.append("released")
    th.join(5)
    assert log == ["call 1 ends", "held", "released", "call 2 starts"]


def test_union_of_intervals():
    assert core.union_s([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert core.union_s([]) == 0.0


def reader(name):
    return core.load_reader(name)


def test_serve_readers():
    rec = {"batches": [{"rows": 4, "t0": 10.0, "sent": [9.9, 9.8, 9.95, 9.7]},
                       {"rows": 2, "t0": 11.0, "sent": [10.99, None]}],
           "mel_s": [0.03, 0.05, 0.04], "vocode_s": [0.12, 0.12], "vocode_audio_s": [9.6, 9.6],
           "k1_graphs": 3, "busy_s": 7.5, "trace_window_s": 10.0}
    assert reader("batch_rows.serve")(rec) == 3.0
    assert reader("batch_wait_ms.serve")(rec) == pytest.approx(100.0)
    assert reader("mel_ms.serve")(rec) == pytest.approx(40.0)
    assert reader("vocode_ms_per_audio_s.serve")(rec) == pytest.approx(12.5)
    assert reader("k1_graphs.serve")(rec) == 3
    assert reader("device_idle.serve")(rec) == pytest.approx(25.0)
    assert reader("k1_roofline.serve")(rec) is None           # nothing to read
    assert reader("mfu.serve")({}) is None


def test_train_readers():
    rec = {"step_host_s": [0.3, 0.25, 0.35], "data_wait_s": [0.01, 0.03], "k34_graphs": 6,
           "steps": 8, "busy_s": 4.0, "trace_window_s": 8.0}
    assert reader("host_step_ms.train")(rec) == pytest.approx(300.0)
    assert reader("data_wait_ms.train")(rec) == pytest.approx(20.0)
    assert reader("k34_graphs_per_it.train")(rec) == 0.75
    assert reader("device_idle.train")(rec) == pytest.approx(50.0)
    assert reader("k34_roofline.train")({}) is None


def test_k34_kernel_names_cover_what_k3_and_k4_launch():
    """Every kernel that the K3/K4 sources launch matches the names
    ``k34_roofline.train`` sums, in the profiler's spelling; K1's, K2's and
    PyTorch's kernels do not."""
    import os
    import re

    from portbench import train

    csrc = os.path.join(core.ROOT, "tacotron2_vae_torch", "csrc")
    launched = set()
    for f in ("teacher_fwd.cu", "teacher_bwd.cu"):
        with open(os.path.join(csrc, f), encoding="utf-8") as fh:
            launched |= set(re.findall(r"\b([a-z_0-9]+)(?:<[^<>]*>)?<<<", fh.read()))
    assert {"lstm_tc", "att_fwd", "att_bwd", "dx_tc", "att_query"} <= launched
    ns = {"att_query": "t2v"}
    for k in launched:
        name = f"void {ns.get(k, '(anonymous namespace)')}::{k}<__nv_bfloat16>(int)"
        assert train.K34_KERNELS.search(name), name
    for other in ("void (anonymous namespace)::lstm_kernel<__nv_bfloat16>(int)",
                  "void (anonymous namespace)::tail_kernel(TailArgs)",
                  "void (anonymous namespace)::stft_mel_kernel(int)",
                  "void at::native::vectorized_elementwise_kernel<4, at::native::"
                  "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)",
                  "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(int)"):
        assert not train.K34_KERNELS.search(other), other


def test_k34_roofline_over_the_profilers_kernel_time():
    call = {"kind": "fwd", "B": 64, "S": 128, "T": 800, "dtype": "bfloat16", "masks": True}
    sizes = core.load_json(os.path.join(core.ROOT, "portbench", "configs",
                                        "t2vae-ko-train.json"))
    rec = {"k34": [call, {**call, "kind": "bwd"}], "k34_kernel_s": 0.1, "sizes": sizes}
    from portbench import counts

    t2 = sizes["tacotron2"]
    bound = (counts.k3_bound_s(t2, 64, 128, 800, "bfloat16", True)
             + counts.k4_bound_s(t2, 64, 128, 800, "bfloat16", True))
    assert reader("k34_roofline.train")(rec) == pytest.approx(100.0 * bound / 0.1)
    assert reader("k34_roofline.train")({**rec, "k34_kernel_s": 0.0}) is None
