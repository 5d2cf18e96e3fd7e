#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one card: build, check, train, serve.

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --k34      # build, then only the K3/K4 checks
    python3 chip_smoke.py --k78      # build K7/K8 alone: their checks and timings
    python3 chip_smoke.py --k9       # build K9 alone (BigVGAN's anti-aliased activation):
                                     # its checks and timings, the served path's 109
                                     # launches a vocode (not in the default run)
    python3 chip_smoke.py --k56      # build, then only K5/K6 and the probes' entry
    python3 chip_smoke.py --k12      # build K1/K2 alone: their checks, then their timings
                                     # (K1's L2 facts first)
    python3 chip_smoke.py --dp       # build, then only the data-parallel checks (train_dp)
    python3 chip_smoke.py --fp16     # build K1-K4, then only the float16 checks and fp16_run
    python3 chip_smoke.py --tp       # build K2-K4, then only the model-axis checks (train_tp)
    python3 chip_smoke.py --tp --nccl  # the same on 4 cards, a rank a card over NCCL, and
                                       # train_waveglow at --mesh 2,2 (needs 4 cards)
    python3 chip_smoke.py --tools    # build K1-K4, then only the three tools (phase 6)
    python3 chip_smoke.py --studies  # build K1-K4, then only the three study tools (phase 7)

1. Environment: torch/CUDA versions, the card's name and power limit.
2. Kernels: builds every CUDA kernel of the port from ``csrc/`` (one nvcc
   per source, started together) and holds each against its plain PyTorch
   twin on the card at full width, each output against its own tolerance:
   K1 (decode loop) in bf16, float16 and f32, B=1 and B=4, at S=64 with 200
   forced steps, prenet dropout off and on, and at the serve phase's S=32 with
   600 forced steps; its graph reused by repeated calls at one shape (one
   instantiation); its tail kernel alone against its plain version on the
   same inputs (ops/decoder_loop.py tail_step), timed by the profiler
   inside a decode; K2 (STFT -> mel -> log) on a 3 s and a 2 s synthetic wav;
   K3 and K4 (teacher-forced recurrence forward and backward) at B=64,
   S=128, T=512 and at B=6, S=77, T=45 with masked rows, in bf16, float16 and f32,
   recurrent dropout off and on: every output, and every gradient of the
   recurrence through K4 against the same gradients through the twin;
   K5 and K6 (the reshape and output-block probes) at the probes' shapes,
   on the probes' inputs and on random ones; K7 and K8 (the encoder's
   BiLSTM recurrence forward and backward) through their autograd.Function
   against autograd through the plain loop at serve shapes (B 1/2/4, T
   64-128), a partial row tile and training shapes (B=64, T 151 and 561,
   mixed lengths) at H=256 and at the other hidden sizes they take, in
   bf16, float16 and f32 (``k78_phase``), and a served and a trained
   encoder call, one K7 launch each and one K8 for the backward.  Times each kernel, its twin
   and, for K2, K5 and K6, one library call, in turns (5 rounds): K2 at the
   serve shape and at a training clip; K5 and K6 at the probes' shapes,
   each call from a 200-call CUDA graph, beside an empty kernel launched
   the same way (the floor of launch cost); K7/K8 in bf16 at four shapes
   beside their twins, autograd through the loop and cuDNN's LSTM (a
   yardstick the port never calls); for K3/K4
   also the device time per step of each of their kernels and, as a
   yardstick the port never calls, one bf16 ``torch.mm`` per LSTM product
   shape; K3/K4 and K1 in float16 are timed too.
3. Train: 11 ``make_train_step`` steps on a fixed full-width batch (B=64,
   S=128, T=512, bf16) with random weights from the seed (ms/step, mel
   frames/s, peak memory; the loss must fall), 10 more back to back (one
   synchronise), one under ``torch.cuda.set_sync_debug_mode("error")`` (no
   host sync allowed); ``fp16_run`` on the same batch from the 2^32 loss
   scale (n skipped steps, then the scale 2^32 / 2^n; 10 updates with a
   falling loss; no host sync; K3/K4 on float16 streams) and the bf16 and
   float16 steps' ms and peak memory in turns; then the real entry point
   ``training.train.train``
   on a synthetic corpus of 128 + 16 clips through a validation, a
   checkpoint and a resume (K2 from the loader's threads), and again under
   ``fp16_run`` (the resumed state holds the saved loss scale); ``train()`` at
   B=64 on 1024 clips with the reference corpus's texts, its input
   pipeline and metric window at their defaults against all at 1, one
   run each, with the card's busy share from a trace (``train_pipeline``);
   data parallel: ``train()`` under torchrun's environment at world 1 on
   NCCL against the plain run, and two gloo ranks on the card against one
   process, losses and state after 3 steps (``train_dp``, through
   ``tools/multihost_dryrun.py``); the mesh's model axis (``train_tp``):
   the full-width batch at 1x2 and 2x2 (gloo ranks on the card) against
   one process, 3 steps, losses, rank 0's logical state and each rank's
   bytes of parameters and Adam moments; a full-width WaveGlow (batch 4 of
   16000 samples, 2 steps) at 2x1 and 1x2 against one process; and
   ``tools/train_waveglow.py`` on synthetic wavs: 20 steps, a checkpoint, a
   resume onto the uninterrupted run's state, a float16 export that
   ``Synthesizer.load`` adopts and vocodes a 600-frame mel with.  K2, K3
   and K4 must launch; K3/K4 must instantiate at most one graph per batch
   shape not among the last ``GRAPHS``.
4. Probe entry: ``tacotron2_vae_torch.tools.reshape_probe.main`` on the
   card; all four probes must report correct (K5 and K6 launch there).
5. Serve: a full-width ``Synthesizer`` with random weights from a fixed seed
   (gate bias set low, so every request decodes the full 600 steps),
   centroids from a synthetic manifest, then ``synthesize`` with a reference
   wav, ``synthesize`` with ratios, ``interpolate``, and ``synthesize_batch``
   of 4 requests, vocoded by Griffin-Lim; then the same four through a
   full-width WaveGlow with random weights (seed 1234, ``end`` not zero),
   loaded from a self-describing pickle, in float32 and in bf16 (RTF and
   vocoder ms per second of audio).  The WaveGlow alone on a 600-frame mel
   (ms against its bound from the shapes), and the card's float32 WaveGlow
   against the same module on the CPU on a 32-frame mel with a fixed z.
   Then the HTTP API (``serving.app.make_server``) with that synthesizer:
   4 concurrent ``POST /api`` and one ``GET /generate``; every reply a
   finite wav, and the micro-batcher must group >= 2 requests into one K1
   launch.  Over the phase each decode (K1) must follow a K7 launch, its
   batch's encoder call, and no K8 may launch.  Last, 3 full-width WaveGlow
   train steps (batch 4, 16000-sample segments): finite loss, ms/step, peak
   memory.
6. Tools, each through its ``main`` on the card: ``tools/smoke_train.py`` at
   full width (B=16, S=32, T=128) in bf16 and in ``fp16_run``: the loss must
   fall, and in bf16 fall below ``SMOKE_LOSS_RATIO_MAX`` of its 25th step's
   with the eval forward's attention diagonal above ``SMOKE_DIAG_MIN`` (K3,
   K4); ``tools/inference_demo.py``'s four modes on the serve phase's files
   (latents, a reference wav, the interpolation ladder, a mix; K1, K2):
   latents of shape (clips, z), every wav finite with T * hop samples;
   ``tools/train_waveglow.py`` for a few full-width steps, then
   ``tools/waveglow_eval.py`` on its checkpoints and export (K2): a finite
   held-out NLL per checkpoint and three finite copy-synthesis rows.
   Prints each tool's wall time and the phase's beside the card's name and
   power limit.
7. Studies, each through its ``main`` on the card at full model width,
   under a temporary directory (never the repo's ``res/`` or
   ``samples/``): ``tools/make_result_assets.py --steps 250`` (B=16, S=32,
   bf16; one validation point): K3 and K4 launch, every loss finite, the
   loss at step 250 below the loss at step 25; ``tools/curves_run.py all``
   for ``STUDY_CURVES_STEPS`` = 16 steps (two epochs of 8 at B=64 on the
   full 512 + 64-clip corpus, a checkpoint at step 8), vocoded by the
   export ``waveglow_eval_run`` left (``--studies`` alone: a random
   full-width WaveGlow): K1-K4 launch, ``metrics.csv`` has 16 rows, the
   checkpoint exists, the assets summary has the JAX tool's keys (read
   from its source) with finite numbers, the four recipes' files exist
   and every wav is finite; ``tools/bench_pooled.py --items 64 --steps 8
   --batch 16`` with ``mel_cache=False`` (so its loader featurises each
   clip through K2; the bulk mel cache uses the chunked DFT product):
   K2-K4 launch, ``padding_saving`` > 1, steps/s finite and > 0 pooled
   and unpooled.  Rows in ``chiprun_out/chip_smoke_studies.json``; each
   tool's wall time beside the card line.

Each phase of the whole run prints ``{"phase_s": {"name": ..., "s": ...}}``
when it ends (the build first, the total last; ``PERF.md`` keeps them: the
whole script must stay well inside its 1200 s limit, so the longest earlier
path is cut in depth before a new phase is added).  Every launch counter
is zeroed just before its path runs and read just after; each kernel must
have launched.  Prints one JSON line per check, train phase and request,
the card line, the ``kernels`` JSON line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure and when
no CUDA card is present.  Long logs go to ``chiprun_out/``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

SEED = 1234
TEXT = "안녕하세요. 오늘은 날씨가 참 좋네요."
TEXTS = [TEXT, "감사합니다.", "반갑습니다, 만나서 정말 기뻐요.", "내일 다시 만나요."]
# K1 against its twin, max abs error per output, in two parts (PERF.md gives
# the errors measured on the card and those of planted rounding faults).
# Early: the first K1_EARLY_STEPS steps, before a bf16 rounding that sum
# order flipped feeds back through the loop; a missing or misplaced rounding
# shows here.  Whole run: in bf16 a bound on that drift.  Alignment limits
# are in units of the uniform weight 1/S.
# In float16 (8x finer than bf16) a sum-order difference flips a rounding
# within the first steps now and then (4.6e-5 at one element), about as far
# as a missing rounding moves the worst element (3.2-8.0e-5), so float16
# holds the early max loosely and the early mean of the mel tightly: a
# flip moves a few elements, a missing rounding all of them (means 0.4-2.0e-6
# correct, 1.0-1.8e-5 with one planted; PERF.md section 6).
K1_EARLY_STEPS = 2
K1_EARLY_TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float16": 1e-4}
K1_EARLY_MEAN_TOL = {"float16": {"mel": 5e-6}}
K1_TOL = {"float32": {"mel": 1e-5, "gate": 1e-5, "align": 3e-4},
          "bfloat16": {"mel": 1e-2, "gate": 1e-2, "align": 0.25},
          "float16": {"mel": 1.25e-3, "gate": 1.25e-3, "align": 0.03125}}
# (S, steps, memory lengths of rows 0..3, dropout settings): the shape the
# kernels are tuned at (8 positions a CTA of the 8-CTA attention cluster),
# and the serve phase's text bucket and step cap (4 a CTA, masked rows, 600
# steps)
K1_CASES = ((64, 200, (64, 50, 33, 17), (False, True)),
            (32, 600, (32, 25, 17, 9), (True,)))
K2_TOL = 1e-4                                    # tests/test_pallas_stft.py:36
# 3 s (188 frames, one block each) and the serve phase's 2 s reference clip
# (126 frames)
K2_SECONDS = (3, 2)
# K2 against its library call, timed in turns (kernel, library, library,
# kernel) for K2_ROUNDS rounds: at the serve shape (3 s) and at a training
# clip (4 s, the middle of train_entry's 2-6 s clips)
K2_TURN_SECONDS, K2_ROUNDS = (3, 4), 5
# K5: B rows of S*X; the probes' (S, X) shapes, the first one timed
K5_B, K5_SHAPES = 4, ((128, 128), (128, 32), (128, 256))
K6_SHAPE = (512, 128, 32, 4)                     # BS, K, F, T
K6_TOL = 1e-5                                    # float32 sum order over K=128
# K5/K6 timed in turns with their library call, twin and an empty kernel:
# K56_ROUNDS rounds, each timing one replay of K56_REPS calls in one graph
K56_ROUNDS, K56_REPS = 5, 200
WG_MEL_FRAMES = 600                              # the serve phase's longest mel
WG_CPU_FRAMES, WG_CPU_TOL = 32, 1e-4             # card vs CPU, relative to max |audio|
WG_TRAIN = (4, 16000, 3)                         # batch, segment samples, steps
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_model(hp, device):
    import torch
    from tacotron2_vae_torch.models.tacotron2 import Tacotron2, init_weights

    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # random weights fire the gate at a random early step; a low bias
        # makes every request decode max_decoder_steps, the longest case
        model.decoder.gate_layer.linear_layer.bias.fill_(-10.0)
    return model.to(device).eval().requires_grad_(False)


# ----------------------------------------------------------------- kernels


def bound(n_bytes, ops, dtype_name):
    """(ms, "bytes" or "operations"): the larger of bytes over the HBM rate
    and operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(kw, B, S, steps, dtype_name):
    """Least time for the decode loop on these inputs: bytes with every input
    read once and every output written once, or the products' operations at
    the peak rate of their type, whichever is larger."""
    itemsize = 4 if dtype_name == "float32" else 2
    Ha, Hd = kw["att_w"].shape[0] // 4, kw["dec_w"].shape[0] // 4
    P, n_in = kw["w1"].shape
    A, (KL, _, F) = kw["wq"].shape[0], kw["locw"].shape
    N, Kp = kw["pg_w"].shape
    E = Kp - Hd
    weight_bytes = sum(t.numel() * t.element_size() for t in kw.values())
    io_bytes = (B * S * (E + A) * itemsize + B * S * 4
                + steps * B * (n_in + 1 + S) * 4)
    macs = (kw["att_w"].numel() + kw["dec_w"].numel() + kw["pg_w"].numel()
            + n_in * P + P * P + Ha * A + S * (2 * KL * F + F * A + A + E))
    return bound(weight_bytes + io_bytes, 2.0 * macs * B * steps, dtype_name)


def k1_weight_stream_us(kw):
    """Per-step time to stream every packed weight from HBM once."""
    return sum(t.numel() * t.element_size() for t in kw.values()) / HBM_BYTES_PER_S * 1e6


def k2_tables(hp, device):
    """K2's constant tables for ``hp`` on ``device`` (``dsp.stft.Tables``)."""
    from tacotron2_vae_torch.dsp.stft import device_tables

    return device_tables(str(device), hp.filter_length, hp.win_length, hp.n_mel_channels,
                         hp.sampling_rate, hp.mel_fmin, hp.mel_fmax)


def k2_bound(n, frames, tab):
    """Least time for the log-mel of one wav: the bytes of the wav, the
    output and the tables the kernel reads (window, twiddles, band table,
    packed filterbank weights), or the operations of a real FFT per frame
    (2.5 N log2 N), the window, |X| (3 per bin) and the mel product over the
    filterbank's nonzeros, whichever is larger."""
    n_mels, n_freq = tab.fb.shape
    n_fft = tab.window.numel()
    n_bytes = (n + n_mels * frames) * 4 + sum(
        t.numel() * t.element_size() for t in (tab.window, tab.twiddle, tab.bands, tab.melw))
    ops = frames * (2.5 * n_fft * math.log2(n_fft) + n_fft + 3 * n_freq + 2 * tab.melw.numel())
    return bound(n_bytes, ops, "float32")


def k1_compare(got, want, dtype_name, r):
    """Kernel outputs against the twin's (``decode_loop`` contract): per
    output the whole-run and early max abs errors and the twin's largest
    value, and the names of the outputs outside their limits."""
    import torch

    S, k = want[2].shape[-1], K1_EARLY_STEPS
    early = (lambda x: x[..., :k * r], lambda x: x[:, :k], lambda x: x[:, :k])
    row, fails = {}, [] if torch.equal(got[3], want[3]) else ["lengths"]
    for name, g, w, first in zip(("mel", "gate", "align"), got, want, early):
        d = (g.float() - w.float()).abs()
        tol = K1_TOL[dtype_name][name] / (S if name == "align" else 1)
        row[f"err_{name}"], row[f"early_err_{name}"] = float(d.max()), float(first(d).max())
        row[f"early_mean_err_{name}"] = float(first(d).mean())
        row[f"scale_{name}"] = float(w.abs().max())
        mean_tol = K1_EARLY_MEAN_TOL.get(dtype_name, {}).get(name, math.inf)
        if not (row[f"err_{name}"] <= tol and row[f"early_err_{name}"] <= K1_EARLY_TOL[dtype_name]
                and row[f"early_mean_err_{name}"] <= mean_tol
                and bool(torch.isfinite(g).all())):
            fails.append(name)
    return row, fails


def k1_check(dl, kw, memory, pmem, mask, dtype_name, steps, dropout_on, r):
    """Kernel against twin on one input: a row of per-output errors."""
    import torch

    args = dict(max_steps=steps, gate_threshold=1.0, seed=7, dropout_on=dropout_on)
    got = dl.decode_loop(kw, memory, pmem, mask, **args)
    want = dl.finish(*dl.decode_loop_plain(kw, memory, pmem, mask, **args), 1.0, r)
    torch.cuda.synchronize()
    B, S, _ = memory.shape
    row = {"kernel": "K1", "dtype": dtype_name, "B": B, "S": S, "steps": steps,
           "dropout": dropout_on}
    errs, fails = k1_compare(got, want, dtype_name, r)
    row.update(errs, max_abs_err=max(errs[f"err_{k}"] for k in ("mel", "gate", "align")),
               fails=fails)
    if dropout_on:
        row["ms"] = cuda_ms(lambda: dl.decode_loop(kw, memory, pmem, mask, **args), 3)
        row["us_per_step"] = row["ms"] * 1e3 / steps
    return row, args


K1_DTYPES = ("bfloat16", "float16", "float32")
K1_REUSE = (2, 48, 40, 5)  # B, S, steps, calls: a shape no other check uses


def k1_inputs(dec, B, S, device, seed):
    """Memory (B, S, E) from the seed, its processed memory, no mask."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.ops.layers import linear

    rng = np.random.RandomState(seed)
    memory = torch.from_numpy(
        (rng.randn(B, S, dec.hp.encoder_embedding_dim) * 0.3).astype(np.float32)).to(device)
    return memory, linear(memory, dec.attention_layer.memory_layer.linear_layer.weight)


def k1_graph_reuse(dec, device):
    """Repeated K1 calls at one new shape, each on new memory: graphs
    instantiated (must be 1, by the first call), the persisting-L2 limit
    before and after (must match), and the first call's outputs unchanged
    by the later calls (no buffer shared across calls).  The calls run
    under ``utils.profiling``, each in a span: the first call's graph build
    time must be above 0 and the others' 0, their sum the counter's and
    the change of ``info()["instantiate_ns"]``, and each call's placed
    device interval (its CUDA events) must lie inside its span."""
    import torch
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.utils import profiling

    B, S, steps, calls = K1_REUSE
    kw = dl.pack_weights(dec, torch.float32)  # the dtype whose decode sets L2 aside
    args = dict(max_steps=steps, gate_threshold=1.0, seed=7, dropout_on=True)
    before = dl.info()
    profiling.start()
    outs = []
    for i in range(calls):
        with profiling.span("k1"):
            outs.append(dl.decode_loop(kw, *k1_inputs(dec, B, S, device, i), None, **args))
    rec = profiling.stop()
    first = dl.decode_loop(kw, *k1_inputs(dec, B, S, device, 0), None, **args)
    after = dl.info()
    spans = [d for d in rec["spans"] if d["name"] == "k1"]
    built = [d["k1_instantiate_ns"] for d in spans]
    slack = 1e-3    # the anchor event runs a few microseconds after its host time
    row = {"kernel": "K1", "check": "graph_reuse", "B": B, "S": S, "steps": steps,
           "calls": calls + 1, "graphs_instantiated": after["graphs_instantiated"]
           - before["graphs_instantiated"], "persisting_l2_limit": [
               before["persisting_l2_limit"], after["persisting_l2_limit"]],
           "windowed_lstm_nodes": after["windowed_lstm_nodes"],
           "first_call_kept": all(torch.equal(a, b) for a, b in zip(outs[0], first)),
           "instantiate_ns": built, "counter_ns": rec["counters"].get("k1.instantiate_ns"),
           "device_ms": [d["device_ms"] for d in spans],
           "device_in_span_ms": [[(d["device"][0] - d["start"]) * 1e3,
                                  (d["end"] - d["device"][1]) * 1e3] for d in spans]}
    row["fails"] = [k for k, ok in (
        ("instantiate_ns", len(built) == calls and built[0] > 0 and not any(built[1:])
         and sum(built) == row["counter_ns"]
         == after["instantiate_ns"] - before["instantiate_ns"]),
        ("device_ms", all(v > 0 for v in row["device_ms"])),
        ("device_in_span", all(d["start"] - slack <= d["device"][0] <= d["device"][1]
                               <= d["end"] + slack for d in spans)),
        ("graphs_instantiated", row["graphs_instantiated"] == 1),
        ("persisting_l2_limit", before["persisting_l2_limit"] == after["persisting_l2_limit"]),
        ("windowed_lstm_nodes",
         after["windowed_lstm_nodes"] == (2 * dl.UNROLL if dl.l2_window(kw) else 0)),
        ("first_call_kept", row["first_call_kept"])) if not ok]
    print(json.dumps(row), flush=True)
    return row


# tail_kernel alone against its plain version (ops/decoder_loop.py
# tail_step and tail_step_plain): (dtype, B, S) at the main check's shape and
# the serve phase's, each at a step with a finished row that continues, at
# the step cap (no prenet) and past the end.  The frame (mel, gate) is one
# float32 dot product of the same rounded inputs in another order, held to
# K1's early-step limit; the alignments, h_dec and the flags are copies,
# held exactly; the next prenet rounds the frame and its hidden layer, where
# a sum-order flip moves an element by one ulp, held to K1's whole-run mel
# limit.
TAIL_CASES = (("bfloat16", 4, 64), ("float32", 1, 32))
TAIL_STEPS = 200


def tail_inputs(kw, B, S, device, seed):
    """Random float32 state around one tail launch: xa, xd (their other
    columns must stay), xp = [h_dec in (-1, 1), ctx], wprev a softmax over
    S, and output buffers already holding values (rows not written keep
    them)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    Ha, Hd = kw["att_w"].shape[0] // 4, kw["dec_w"].shape[0] // 4
    P, n_out = kw["w1"].shape
    E = kw["pg_w"].shape[1] - Hd

    def r(*shape):
        return torch.randn(*shape, generator=g, device=device)

    return {"xa": r(B, P + E + Ha), "xd": r(B, Ha + E + Hd),
            "xp": torch.cat([torch.tanh(r(B, Hd)), 0.3 * r(B, E)], 1),
            "wprev": torch.softmax(r(B, S), 1), "mel": r(TAIL_STEPS, B, n_out),
            "gate": r(TAIL_STEPS, B), "align": r(TAIL_STEPS, B, S)}


def tail_call(fn, kw, bufs, flags):
    fn(kw, bufs["xa"], bufs["xd"], bufs["xp"], bufs["wprev"], flags, bufs["mel"],
       bufs["gate"], bufs["align"], max_steps=TAIL_STEPS, gate_threshold=0.5, seed=7,
       dropout_on=True)


def tail_check(dec, device):
    """tail_kernel against tail_step_plain on the same inputs at each
    TAIL_CASES case and step; then, at the main check's shape (bf16, B=4,
    S=64), its device time a launch (the profiler over one stream-launched
    decode, a launch a step), its plain version's time (CUDA events) and its
    bound: the bytes of its weights, inputs and outputs, or its products'
    operations."""
    import torch
    from tacotron2_vae_torch import profile_decode as pd
    from tacotron2_vae_torch.ops import decoder_loop as dl

    checks, fails, err = [], [], 0.0
    for dtype_name, B, S in TAIL_CASES:
        kw = dl.pack_weights(dec, getattr(torch, dtype_name))
        for t, done in ((5, 0), (TAIL_STEPS - 1, 0), (7, 1)):
            bufs = tail_inputs(kw, B, S, device, t)
            flags = torch.zeros(dl.FLAGS, dtype=torch.int32, device=device)
            flags[0], flags[1] = done, t
            flags[3:min(4, 2 + B)] = 1  # row 1 has finished
            got, want = ({k: v.clone() for k, v in bufs.items()} for _ in range(2))
            got_flags, want_flags = flags.clone(), flags.clone()
            tail_call(dl.tail_step, kw, got, got_flags)
            tail_call(dl.tail_step_plain, kw, want, want_flags)
            errs = {k: (got[k] - want[k]).abs().max().item() for k in got}
            tol = {k: 0.0 for k in ("align", "xd", "xp", "wprev")}
            tol.update(mel=K1_EARLY_TOL[dtype_name], gate=K1_EARLY_TOL[dtype_name],
                       xa=K1_TOL[dtype_name]["mel"])
            bad = [k for k in errs if errs[k] > tol[k]]
            bad += [] if torch.equal(got_flags, want_flags) else ["flags"]
            checks.append({"dtype": dtype_name, "B": B, "S": S, "t": t, "done": done,
                           "errs": errs, "fails": bad})
            fails += bad
            err = max(err, *errs.values())

    prof = pd.profile(dec, 4, 64, TAIL_STEPS, torch.bfloat16, device)
    kw = dl.pack_weights(dec, torch.bfloat16)
    bufs = tail_inputs(kw, 4, 64, device, 0)
    flags = torch.zeros(dl.FLAGS, dtype=torch.int32, device=device)
    flags[1] = 5
    plain_ms = cuda_ms(lambda: tail_call(dl.tail_step_plain, kw, bufs, flags), 20)
    Hd = kw["dec_w"].shape[0] // 4
    (N, Kp), (P, n_in) = kw["pg_w"].shape, kw["w1"].shape
    B, S = 4, 64
    weight_bytes = sum(kw[k].numel() * kw[k].element_size() for k in ("pg_w", "pg_b", "w1", "w2"))
    io_bytes = 4 * B * (Kp + S + N + S + Hd + P)
    bound_ms, bound_by = bound(weight_bytes + io_bytes, 2.0 * B * (N * Kp + P * n_in + P * P),
                               "bfloat16")
    by_kernel = us_by_kernel(prof)
    row = {"kernel": "tail_kernel", "dtype": "bfloat16", "B": B, "S": S, "steps": TAIL_STEPS,
           "ms": by_kernel["tail_kernel"] / 1e3, "plain_ms": plain_ms, "max_abs_err": err,
           "bound_ms": bound_ms, "bound_by": bound_by, "us_per_step_by_kernel": by_kernel,
           "checks": checks, "fails": fails}
    print(json.dumps(row), flush=True)
    return row


def kernels_phase(model, hp, device, k1_dtypes=K1_DTYPES, k2=True):
    """K1 against its twin at every K1_CASES case and each of ``k1_dtypes``,
    and K2 against its twin (and timed in turns with its library call)
    unless ``k2`` is false."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.ops.layers import linear

    rows, report, failed = [], {}, []
    rng = np.random.RandomState(SEED)
    dec = model.decoder
    mem_w = dec.attention_layer.memory_layer.linear_layer.weight
    k1_err, k1_main = 0.0, None
    for dtype_name in k1_dtypes:
        kw = dl.pack_weights(dec, getattr(torch, dtype_name))
        for S, steps, lengths, dropouts in K1_CASES:
            for B in (1, 4):
                memory = torch.from_numpy(
                    (rng.randn(B, S, hp.encoder_embedding_dim) * 0.3).astype(np.float32)
                ).to(device)
                lens = torch.tensor(lengths[:B], device=device)
                mask = torch.arange(S, device=device)[None, :] < lens[:, None]
                pmem = linear(memory, mem_w)
                for dropout_on in dropouts:
                    row, args = k1_check(dl, kw, memory, pmem, mask, dtype_name, steps,
                                         dropout_on, hp.n_frames_per_step)
                    if dropout_on and S == K1_CASES[0][0]:
                        row["plain_ms"] = cuda_ms(lambda: dl.decode_loop_plain(
                            kw, memory, pmem, mask, **args), 1)
                        row["bound_ms"], row["bound_by"] = k1_bound(kw, B, S, steps,
                                                                    dtype_name)
                        row["weight_stream_us_per_step"] = k1_weight_stream_us(kw)
                        if dtype_name == k1_dtypes[0] and B == 4:
                            k1_main = row
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                    failed += [row] if row["fails"] else []
                    k1_err = max(k1_err, row["max_abs_err"])
    report["K1"] = dict(k1_main, max_abs_err=k1_err)
    if "bfloat16" in k1_dtypes:
        graphs = k1_graph_reuse(dec, device)
        rows.append(graphs)
        failed += [graphs] if graphs["fails"] else []
        report["tail"] = tail_check(dec, device)
        rows.append(report["tail"])
        failed += [report["tail"]] if report["tail"]["fails"] else []
    if not k2:
        if failed:
            raise AssertionError(f"{len(failed)} kernel check(s) disagree with the twin: "
                                 f"{failed}")
        return report, rows

    key = (hp.filter_length, hp.hop_length, hp.win_length, hp.n_mel_channels,
           hp.sampling_rate, hp.mel_fmin, hp.mel_fmax)
    tab = k2_tables(hp, device)
    window, fb = tab.window, tab.fb
    k2_err, k2_main = 0.0, None
    for seconds in K2_SECONDS:
        n = seconds * hp.sampling_rate
        t = np.arange(n) / hp.sampling_rate
        wav = torch.from_numpy(
            (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1375 * t)
             + 0.01 * rng.randn(n)).astype(np.float32)).to(device)
        got = sm.mel_spectrogram_fused(wav, *key)
        want = sm.mel_spectrogram_plain(wav, *key)
        torch.cuda.synchronize()
        frames = n // hp.hop_length + 1
        err = float((got - want).abs().max())
        k2 = {"kernel": "K2", "n": n, "frames": frames, "max_abs_err": err, "tol": K2_TOL,
              "fails": [] if err <= K2_TOL and got.shape == (1, hp.n_mel_channels, frames)
              else ["mel"]}
        if seconds == K2_SECONDS[0]:
            library = k2_library(hp, wav, window, fb)
            k2.update(library_max_abs_err=float((library()[None] - want).abs().max()),
                      plain_ms=cuda_ms(lambda: sm.mel_spectrogram_plain(wav, *key), 20))
            k2["bound_ms"], k2["bound_by"] = k2_bound(n, frames, tab)
            k2_main = k2
        print(json.dumps(k2), flush=True)
        rows.append(k2)
        failed += [k2] if k2["fails"] else []
        k2_err = max(k2_err, err)
    turns = k2_turns(hp, key, window, fb, rng, device)
    rows += turns
    k2_main.update(ms=turns[0]["ms"], library_ms=turns[0]["library_ms"])
    if failed:
        raise AssertionError(f"{len(failed)} kernel check(s) disagree with the twin: {failed}")
    report["K2"] = dict(k2_main, max_abs_err=k2_err)
    return report, rows


def k2_library(hp, wav, window, fb):
    """K2's library call on ``wav``: ``torch.stft`` + the mel product + log."""
    import torch

    def library():
        spec = torch.stft(wav, hp.filter_length, hp.hop_length, hp.win_length, window,
                          center=True, pad_mode="reflect", return_complex=True)
        return torch.log(torch.clamp(fb @ spec.abs(), min=1e-5))

    return library


def k2_turn_wav(hp, seconds, rng, device):
    """The synthetic wav K2 is timed on: a 220 Hz tone and a little noise."""
    import numpy as np
    import torch

    n = seconds * hp.sampling_rate
    t = np.arange(n) / hp.sampling_rate
    return torch.from_numpy((0.4 * np.sin(2 * np.pi * 220 * t)
                             + 0.01 * rng.randn(n)).astype(np.float32)).to(device)


def k2_turns(hp, key, window, fb, rng, device):
    """K2 and its library call (``torch.stft`` + the mel product + log) timed
    in turns, kernel, library, library, kernel, for K2_ROUNDS rounds (20
    calls each, CUDA events) on one synthetic wav per K2_TURN_SECONDS: the
    median and the spread (min, max) of each."""
    import numpy as np
    from tacotron2_vae_torch.ops import stft_mel as sm

    rows = []
    for seconds in K2_TURN_SECONDS:
        wav = k2_turn_wav(hp, seconds, rng, device)

        def kernel():
            return sm.mel_spectrogram_fused(wav, *key)

        library = k2_library(hp, wav, window, fb)
        k, lib = [], []
        for _ in range(K2_ROUNDS):
            k.append(cuda_ms(kernel, 20))
            lib += [cuda_ms(library, 20), cuda_ms(library, 20)]
            k.append(cuda_ms(kernel, 20))
        row = {"kernel": "K2", "turns": "kernel, library, library, kernel", "seconds": seconds,
               "rounds": K2_ROUNDS, "ms": float(np.median(k)), "ms_spread": [min(k), max(k)],
               "library_ms": float(np.median(lib)), "library_ms_spread": [min(lib), max(lib)],
               "ms_each": k, "library_ms_each": lib, "fails": []}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# ------------------------------------------------ K5 / K6 (the probes)


def graph_timer(fn, reps: int):
    """``reps`` calls of ``fn`` captured once in a CUDA graph; returns a
    function that replays the graph and gives the device time per call in
    ms (the host's per-call work drops out, the gaps between the graph's
    launches stay in)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def time_one() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    return time_one


def in_turns(fns: dict, rounds: int, reps: int) -> dict:
    """Each of ``fns`` ({key: fn}) captured as ``reps`` calls in one graph,
    then timed in turns, ``rounds`` rounds of the keys in order and back
    (for K5/K6: kernel, library, plain, floor, floor, plain, library,
    kernel): {key: (median, min, max, [every time])} in ms per call."""
    import numpy as np

    timers = {k: graph_timer(fn, reps) for k, fn in fns.items()}
    times = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for k in order:
            times[k].append(timers[k]())
    return {k: (float(np.median(v)), min(v), max(v), v) for k, v in times.items()}


def device_us(fn, calls: int) -> dict:
    """The device kernels that ``calls`` eager calls of ``fn`` run, from
    ``torch.profiler``: {kernel name: µs per call}, each kernel's own run
    on the card without the launch around it."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / calls for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def k56_timed(row, device, kernel, library, plain):
    """K5 or K6 at its probe shape against one library call, its twin and
    the empty kernel, in turns (K56_ROUNDS rounds, K56_REPS calls a graph);
    ``host_bound_ms`` is the kernel timed back to back from the host, and
    ``device_us`` the kernels' own run on the card (profiler, K56_REPS
    eager calls) for the kernel, the library call and the empty kernel."""
    from tacotron2_vae_torch.ops import reshape_probe as rp

    def floor():
        rp.empty_kernel(device)

    t = in_turns({"ms": kernel, "library_ms": library, "plain_ms": plain, "floor_ms": floor},
                 K56_ROUNDS, K56_REPS)
    row["turns"] = "kernel, library, plain, floor, floor, plain, library, kernel"
    row["rounds"] = K56_ROUNDS
    for key, (median, lo, hi, each) in t.items():
        row.update({key: median, f"{key}_spread": [lo, hi], f"{key}_each": each})
    row["host_bound_ms"] = cuda_ms(kernel, K56_REPS)
    row["device_us"] = {name: device_us(fn, K56_REPS)
                        for name, fn in (("kernel", kernel), ("library", library),
                                         ("floor", floor))}


def k56_phase(device):
    """K5 and K6 against their twins at the probes' shapes, on the probes'
    inputs and on random ones; the first shape of each timed in turns with
    its twin, one library call and the empty kernel (``k56_timed``), beside
    its bound.  ``main`` keeps TF32 off, so the twin and the library call
    multiply in full float32 (TF32 would blur the 1e-5 comparison)."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.ops import reshape_probe as rp

    rng = np.random.RandomState(SEED)
    rows, report = [], {}
    for S, X in K5_SHAPES:
        n = K5_B * S * X
        for inputs in ("probe", "random"):
            x = (torch.arange(n, dtype=torch.float32) if inputs == "probe"
                 else torch.from_numpy(rng.randn(n).astype(np.float32))).to(device)
            x = x.reshape(K5_B, S * X)
            got = rp.reshape_rows_plus_one(x, S, X)
            want = rp.reshape_rows_plus_one_plain(x, S, X)
            torch.cuda.synchronize()
            row = {"kernel": "K5", "B": K5_B, "S": S, "X": X, "inputs": inputs,
                   "max_abs_err": float((got - want).abs().max()),
                   "fails": [] if torch.equal(got, want) else ["out"]}
            if (S, X) == K5_SHAPES[0] and inputs == "random":
                k56_timed(row, device, lambda: rp.reshape_rows_plus_one(x, S, X),
                          lambda: x.reshape(K5_B * S, X) + 1,
                          lambda: rp.reshape_rows_plus_one_plain(x, S, X))
                row["bound_ms"], row["bound_by"] = bound(2 * n * 4, n, "float32")
                report["K5"] = row
            rows.append(row)
    BS, K, F, T = K6_SHAPE
    for inputs in ("probe", "random"):
        if inputs == "probe":
            x, w = torch.ones((BS, K), device=device), torch.ones((K, F), device=device)
        else:
            x = torch.from_numpy((0.3 * rng.randn(BS, K)).astype(np.float32)).to(device)
            w = torch.from_numpy((0.3 * rng.randn(K, F)).astype(np.float32)).to(device)
        got = rp.out_block_matmul(x, w, T)
        want = rp.out_block_matmul_plain(x, w, T)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        row = {"kernel": "K6", "BS": BS, "K": K, "F": F, "T": T, "inputs": inputs,
               "max_abs_err": err, "tol": K6_TOL,
               "fails": [] if err <= K6_TOL and got.shape == (T, BS, F) else ["out"]}
        if inputs == "random":
            xt = x.expand(T, BS, K)
            row["library_max_abs_err"] = float((torch.matmul(xt, w) - want).abs().max())
            k56_timed(row, device, lambda: rp.out_block_matmul(x, w, T),
                      lambda: torch.matmul(xt, w),
                      lambda: rp.out_block_matmul_plain(x, w, T))
            # the least work: one product (stored T times), each byte moved once
            row["bound_ms"], row["bound_by"] = bound((BS * K + K * F + T * BS * F) * 4,
                                                     2.0 * BS * K * F, "float32")
            report["K6"] = row
        rows.append(row)
    for row in rows:
        print(json.dumps(row), flush=True)
    failed = [r for r in rows if r["fails"]]
    if failed:
        raise AssertionError(f"K5/K6 disagree with their twins: {failed}")
    report["K5"]["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["kernel"] == "K5")
    report["K6"]["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["kernel"] == "K6")
    return report, rows


def probe_entry():
    """The probes' entry point on the card: all four must pass, through K5
    and K6."""
    from tacotron2_vae_torch.ops import reshape_probe as rp
    from tacotron2_vae_torch.tools import reshape_probe

    rp.reshape_rows_plus_one.launches = rp.out_block_matmul.launches = 0
    ok = reshape_probe.main([])
    launches = {"K5": rp.reshape_rows_plus_one.launches, "K6": rp.out_block_matmul.launches}
    row = {"phase": "probe_entry", "ok": ok, "launches": launches}
    print(json.dumps(row), flush=True)
    if not ok or min(launches.values()) < 1:
        raise AssertionError(f"the reshape probes failed or skipped K5/K6: {row}")
    return row


# ------------------------------------------------- K3 / K4 (recurrence)

# (B, S, T, memory lengths): the full-width training shape, the largest for
# which the JAX package's auto rule engaged its TPU kernels
# (decoder_bptt.py:727-733), and a small one with masked rows and odd sizes
K34_CASES = ((64, 128, 512, None), (6, 77, 45, (77, 70, 61, 50, 33, 9)))
K34_EARLY = 2
# Limits on max |kernel - twin| / max |twin| per output (PERF.md gives the
# measured errors and those of planted faults): "early" over the first
# K34_EARLY forward steps / the last K34_EARLY reverse steps, "run" over the
# whole call and for every gradient.  In bf16 a sum-order difference can
# flip a rounding of an LSTM input or a stored gate from step 0 on: outputs
# stored in bf16 (g_*, dg_*, dloc) get one bf16 ulp (2^-7) early, and
# outputs downstream of such flips (the decoder LSTM's h and c, dpn) a
# looser early limit than those that are not (attention, h_att, dctx).
K34_TOL = {"float32": {"early": 1e-5, "run": 2e-5},
           "bfloat16": {"early": {"h_att": 1e-4, "c_att_prev": 1e-4, "ctx": 1e-4, "w": 1e-4,
                                  "dctx": 1e-4, "h_dec": 1e-3, "c_dec_prev": 1e-3,
                                  "dpn": 4e-3, "stream": 2 ** -7},
                        "run": 2e-2},
           # the bf16 limits times the ratio of the two ulps, 2^-3
           "float16": {"early": {"h_att": 1.25e-5, "c_att_prev": 1.25e-5, "ctx": 1.25e-5,
                                 "w": 1.25e-5, "dctx": 1.25e-5, "h_dec": 1.25e-4,
                                 "c_dec_prev": 1.25e-4, "dpn": 5e-4, "stream": 2 ** -10},
                       "run": 2.5e-3}}
K34_DTYPES = ("bfloat16", "float16", "float32")
K3_OUT = ("h_dec", "ctx", "w", "g_att", "g_dec", "c_att_prev", "c_dec_prev", "h_att")
K4_STREAMS = ("dg_att", "dg_dec", "dpn", "dctx", "dloc")
K4_ACC = ("dv", "dWq", "dWld", "dpmem")
GRADS = ("attn_w", "attn_b", "dec_w", "dec_b", "query_w", "loc_w", "loc_dense_w", "v",
         "prenet_seq", "memory", "pmem")


def rel_err(got, want, steps=None):
    """max |got - want| / max |want|, over the time steps ``steps`` (a slice)
    of (T, ...) tensors when given."""
    g, w = got.float(), want.float()
    if steps is not None:
        g, w = g[steps], w[steps]
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def k34_inputs(dec, B, S, T, lengths, dtype, dropout_on, device):
    import numpy as np
    import torch
    from tacotron2_vae_torch.models import decoder_bptt as bp
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.ops.layers import linear

    rng = np.random.RandomState(SEED + B * 1000 + S)
    hp = dec.hp

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)

    w = tf.pack(bp.scan_params(dec), dtype)
    memory = rand(B, S, hp.encoder_embedding_dim, scale=0.3)
    pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight).contiguous()
    prenet = torch.relu(rand(T, B, hp.prenet_dim))
    lens = torch.tensor(lengths or (S,) * B, device=device)
    add = torch.where(torch.arange(S, device=device)[None] < lens[:, None], 0.0,
                      float(np.finfo(np.float32).min)).contiguous()
    masks = None
    if dropout_on:
        g = torch.Generator(device=device).manual_seed(SEED)
        masks = tuple(bp.dropout_masks(T, B, hp.attention_rnn_dim, 0.9, dtype, g, device)
                      for _ in range(4))
    dys = (rand(T, B, hp.decoder_rnn_dim, scale=0.1), rand(T, B, hp.encoder_embedding_dim,
                                                           scale=0.1), rand(T, B, S, scale=0.1))
    return w, prenet, memory, pmem, add, masks, dys


def k3_bound(w, B, S, T, dtype_name, masks):
    """Least time of one K3 call: the LSTM products at the peak of the
    stream dtype plus the float32 attention at the float32 peak, against
    every input read once and every output written once."""
    Ka, H4 = w["attn_w"].shape
    Kd = w["dec_w"].shape[0]
    H, (A, E) = H4 // 4, (w["query_w"].shape[1], Kd - 2 * (H4 // 4))
    K, _, F = w["loc_w"].shape
    P = Ka - E - H
    itemsize = 4 if dtype_name == "float32" else 2
    lstm = 2.0 * T * B * (Ka + Kd) * H4
    att = 2.0 * T * B * (H * A + S * (2 * K * F + F * A + A + E))
    weights = sum(t.numel() * t.element_size() for t in w.values())
    io = 4 * (T * B * P + B * S * (E + A + 1))
    io += 4 * T * B * H * itemsize if masks is not None else 0
    out = 4 * T * B * (4 * H + E + S) + 2 * T * B * H4 * itemsize
    t_ops = lstm / PEAK[dtype_name] + att / PEAK["float32"]
    t_bytes = (weights + io + out) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k4_bound(w, B, S, T, dtype_name, masks):
    """Least time of one K4 call, counted as ``k3_bound`` does: the two dx
    products, the attention recompute and its backward."""
    Ka, H4 = w["attn_w"].shape
    Kd = w["dec_w"].shape[0]
    H, (A, E) = H4 // 4, (w["query_w"].shape[1], Kd - 2 * (H4 // 4))
    K, _, F = w["loc_w"].shape
    P = Ka - E - H
    itemsize = 4 if dtype_name == "float32" else 2
    lstm = 2.0 * T * B * (Ka + Kd) * H4
    att = 2.0 * T * B * (2 * H * A + S * (4 * K * F + 3 * F * A + 3 * A + 2 * E))
    weights = sum(t.numel() * t.element_size() for t in w.values())
    io = 4 * (B * S * (E + A) + T * B * (H + E + S)                  # memory, pmem, dys
              + T * B * (3 * H + 2 * S)) + 2 * T * B * H4 * itemsize  # resids, w seqs
    io += 4 * T * B * H * itemsize if masks is not None else 0
    out = (2 * T * B * H4 + T * B * S * F) * itemsize + 4 * (T * B * (P + E) + B * S * A
                                                             + H * A + F * A + A)
    t_ops = lstm / PEAK[dtype_name] + att / PEAK["float32"]
    t_bytes = (weights + io + out) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k34_check(dec, B, S, T, lengths, dtype_name, dropout_on, device, timed, breakdown=True):
    """K3 and K4 against their twins on one input, and every gradient of
    the recurrence through K4 against the same gradients through the twin."""
    import torch
    from tacotron2_vae_torch.models import decoder_bptt as bp
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    dtype = getattr(torch, dtype_name)
    w, pn, mem, pm, add, masks, dys = k34_inputs(dec, B, S, T, lengths, dtype, dropout_on,
                                                 device)
    tol = K34_TOL[dtype_name]
    row = {"kernel": "K3+K4", "dtype": dtype_name, "B": B, "S": S, "T": T,
           "dropout": dropout_on, "fails": []}
    ys_k, res_k = tf.teacher_fwd(w, pn, mem, pm, add, masks)
    ys_t, res_t = tf.teacher_fwd_plain(w, pn, mem, pm, add, masks)
    torch.cuda.synchronize()
    early = slice(0, K34_EARLY)
    def early_limit(name):
        if not isinstance(tol["early"], dict):
            return tol["early"]
        return tol["early"].get(name, tol["early"]["stream"])

    for name, g, t in zip(K3_OUT, (*ys_k, *res_k), (*ys_t, *res_t)):
        lim = early_limit(name)
        row[f"K3_{name}"] = [rel_err(g, t, early), rel_err(g, t)]
        if not (row[f"K3_{name}"][0] <= lim and row[f"K3_{name}"][1] <= tol["run"]
                and bool(torch.isfinite(g).all())):
            row["fails"].append(f"K3_{name}")

    # K4 and the weight gradients, both from the twin's forward
    zero = torch.zeros_like(ys_t[2][:1])
    w_cum_prev = torch.cat([zero, torch.cumsum(ys_t[2], 0)[:-1]]).contiguous()
    bwd_args = (w, mem, pm, masks, dys, ys_t, res_t, w_cum_prev)
    out_k = tf.teacher_bwd(*bwd_args)
    out_t = tf.teacher_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    late = slice(T - K34_EARLY, T)
    for name, g, t in zip(K4_STREAMS + K4_ACC, out_k, out_t):
        stream = name in K4_STREAMS
        lim = early_limit(name)
        errs = [rel_err(g, t, late) if stream else None, rel_err(g, t)]
        row[f"K4_{name}"] = errs
        if not ((errs[0] is None or errs[0] <= lim) and errs[1] <= tol["run"]
                and bool(torch.isfinite(g).all())):
            row["fails"].append(f"K4_{name}")
    grads = (bp.scan_backward(w, pn, mem, pm, masks, ys_t, res_t, dys),
             bp.scan_backward(w, pn, mem, pm, masks, ys_t, res_t, dys,
                              bwd=tf.teacher_bwd_plain))
    for name, g, t in zip(GRADS, *grads):
        row[f"grad_{name}"] = rel_err(g, t)
        if not row[f"grad_{name}"] <= tol["run"]:
            row["fails"].append(f"grad_{name}")
    row["K3_max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                                for a, b in zip((*ys_k, *res_k), (*ys_t, *res_t)))
    row["K4_max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(out_k, out_t))
    if timed:
        from tacotron2_vae_torch.profile_train import mm_yardstick

        def fwd():
            return tf.teacher_fwd(w, pn, mem, pm, add, masks)

        def bwd():
            return tf.teacher_bwd(*bwd_args)

        row["K3_ms"] = cuda_ms(fwd, 3)
        row["K3_plain_ms"] = cuda_ms(lambda: tf.teacher_fwd_plain(w, pn, mem, pm, add, masks), 1)
        row["K4_ms"] = cuda_ms(bwd, 3)
        row["K4_plain_ms"] = cuda_ms(lambda: tf.teacher_bwd_plain(*bwd_args), 1)
        row["K3_bound_ms"], row["K3_bound_by"] = k3_bound(w, B, S, T, dtype_name, masks)
        row["K4_bound_ms"], row["K4_bound_by"] = k4_bound(w, B, S, T, dtype_name, masks)
        if breakdown:
            for k, fn in (("K3", fwd), ("K4", bwd)):
                row[f"{k}_us_per_step_by_kernel"] = kernel_breakdown(fn, T)
            row["torch_mm_ms"] = mm_yardstick(device)
    return row


def kernel_breakdown(fn, steps):
    """Device microseconds per step of each kernel of one call of ``fn``
    (a K3 or K4 call launched kernel by kernel, not from its CUDA graph),
    by ``torch.profiler``; "device" is their sum."""
    import torch
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    tf.USE_GRAPH = False
    try:
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        tf.USE_GRAPH = True
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = short_name(evt.key)
        out[name] = out.get(name, 0.0) + evt.device_time_total / steps
    out["device"] = sum(out.values())
    return out


# K4's att_bwd<T, phase>: its phase argument (kCoef, kChain, kAccum)
ATT_BWD_PHASES = ("coef", "chain", "accum")


def short_name(key):
    """A kernel's name from a profiler key: no namespace, template or
    arguments; K4's ``att_bwd`` keeps its phase (``att_bwd<chain>``)."""
    import re

    name = re.sub(r"^void |\(anonymous namespace\)::", "", key)
    phase = re.match(r"att_bwd<[^<>]*, (\d+)>", name)
    if phase:
        return f"att_bwd<{ATT_BWD_PHASES[int(phase.group(1))]}>"
    return re.split(r"[(<]", name)[0].split("::")[-1] or key[:40]


def us_by_kernel(prof):
    """Device µs a step by kernel name from ``profile_decode.profile``."""
    out = {}
    for key, k in prof["kernels"].items():
        name = short_name(key)
        out[name] = out.get(name, 0.0) + k["total_us"] / prof["steps"]
    return out


def k4_timed(dec, B, S, T, device):
    """K4 at (B, S, T), bf16 with dropout, on K3's forward: its time a
    call, its bound and its µs a step by kernel (the three phases of
    ``att_bwd`` apart)."""
    import torch
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    w, pn, mem, pm, add, masks, dys = k34_inputs(dec, B, S, T, None, torch.bfloat16, True,
                                                 device)
    ys, res = tf.teacher_fwd(w, pn, mem, pm, add, masks)
    w_cum_prev = torch.cat([torch.zeros_like(ys[2][:1]), torch.cumsum(ys[2], 0)[:-1]])
    args = (w, mem, pm, masks, dys, ys, res, w_cum_prev.contiguous())

    def bwd():
        return tf.teacher_bwd(*args)

    row = {"chunk": tf.bwd_chunk(T, B, S, dec.hp.attention_rnn_dim, dec.hp.attention_dim,
                                 dec.hp.attention_location_n_filters,
                                 dec.hp.attention_location_kernel_size)}
    row["K4_ms"] = cuda_ms(bwd, 3)
    row["K4_bound_ms"], row["K4_bound_by"] = k4_bound(w, B, S, T, "bfloat16", masks)
    row["K4_us_per_step_by_kernel"] = kernel_breakdown(bwd, T)
    row["att_bwd_us_per_step"] = sum(v for k, v in row["K4_us_per_step_by_kernel"].items()
                                     if k.startswith("att_bwd"))
    return row


# train_fixed_shapes' batch shape: K3/K4 checked and K4 timed there too
K34_FIXED = (64, 384, 1344)


def k34_phase(model, device, dtypes=K34_DTYPES):
    """K3 and K4 against their twins at every case, dtype of ``dtypes`` and
    dropout setting; the full-width case with dropout is timed in bf16 (with
    the per-kernel breakdown: ``report["row"]``) and float16
    (``report["row_float16"]``); with bf16 among ``dtypes``, K3 and K4
    against their twins at ``K34_FIXED`` (bf16, dropout) by the same limits
    too, and K4 timed there (``report["row_fixed"]``)."""
    rows, failed = [], []
    report = {}
    for B, S, T, lengths in K34_CASES:
        for dtype_name in dtypes:
            for dropout_on in (False, True):
                timed = (B == K34_CASES[0][0] and dtype_name in ("bfloat16", "float16")
                         and dropout_on)
                row = k34_check(model.decoder, B, S, T, lengths, dtype_name, dropout_on,
                                device, timed, breakdown=dtype_name == "bfloat16")
                print(json.dumps(row), flush=True)
                rows.append(row)
                failed += [row] if row["fails"] else []
                if timed:
                    report["row" if dtype_name == "bfloat16" else "row_float16"] = row
                for k in ("K3", "K4"):
                    report[k] = max(report.get(k, 0.0), row[f"{k}_max_abs_err"])
    if "bfloat16" in dtypes:
        B, S, T = K34_FIXED
        row = k34_check(model.decoder, B, S, T, None, "bfloat16", True, device, timed=False)
        row.update(k4_timed(model.decoder, B, S, T, device))
        print(json.dumps(row), flush=True)
        rows.append(row)
        failed += [row] if row["fails"] else []
        report["row_fixed"] = row
    if failed:
        raise AssertionError(f"{len(failed)} K3/K4 check(s) disagree with the twins: "
                             f"{[(r['dtype'], r['B'], r['dropout'], r['fails']) for r in failed]}")
    return report, rows


# ------------------------------------------------ K7 / K8 (--k78)

K78_IN, K78_H = 512, 256   # the encoder's input width and hidden size a direction
# (B, T, lengths) held to the twins at H = K78_H: served batches (B 1/2/4,
# texts of 32-128 symbols) and training batches (B = 64; the corpus's texts
# are 14-561 symbols, 151 at the 90th percentile), a partial row tile (13
# rows in a tile of 16); "mixed": row 0 is T long, the others drawn in 1..T
K78_CASES = ((1, 64, None), (2, 77, (77, 40)), (4, 128, (128, 97, 64, 3)), (13, 45, "mixed"),
             (64, 151, "mixed"), (64, 561, "mixed"))
K78_SIZES = ((16, 4, 11), (32, 5, 19), (64, 9, 23), (128, 3, 17))  # the other hidden sizes: (H, B, T)
K78_TIMED = ((1, 64), (4, 128), (64, 151), (64, 561))  # (B, T) timed in bf16
K78_DTYPES = ("bfloat16", "float16", "float32")
# Limits on the kernels against autograd through the plain loop on the card,
# per output: ``out`` max |difference| (the outputs lie in (-1, 1)); dgx,
# dw_hh and dbias max |difference| / max |loop|.  float32: sum order alone
# (measured 1.8e-7 and 4.4e-6 at most, PERF.md).  bf16 and float16: the
# products take the same rounded operands, but a sum-order difference flips
# a rounding of h (or of the rounded dh, or of dw_hh) now and then, and the
# flip feeds back through the steps that follow (bf16 measured 1.3e-4 and
# 5.4e-3 at most; float16 1.6e-5 and 6.7e-4: its ulp is 2^-3 of bf16's).
K78_TOL = {"float32": {"out": 2e-6, "grad": 5e-5},
           "bfloat16": {"out": 2e-3, "grad": 2e-2},
           "float16": {"out": 2.5e-4, "grad": 2.5e-3}}


def k78_inputs(B, T, lengths, H, device, seed):
    """gx (2, B, T, 4H), w_hh (2, 4H, H), bias (2, 4H), lengths (B,) and an
    output gradient (2, B, T, H) from ``seed``: w_hh and bias at PyTorch's
    LSTM init, U(-1/sqrt(H), 1/sqrt(H))."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    if lengths == "mixed":
        lengths = (T, *rng.randint(1, T + 1, B - 1))
    lens = torch.tensor(lengths or (T,) * B, device=device)

    def rand(*shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)

    k = 1.0 / math.sqrt(H)
    w = torch.from_numpy(rng.uniform(-k, k, (2, 4 * H, H)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.uniform(-2 * k, 2 * k, (2, 4 * H)).astype(np.float32)).to(device)
    return rand(2, B, T, 4 * H, scale=0.5), w, b, lens, rand(2, B, T, H, scale=0.1)


def k78_bound(B, T, H, dtype_name, fwd):
    """Least time of one K7 (with its residuals) or K8 call: the recurrent
    product at the stream dtype's peak, against every input read once and
    every output written once (all T steps of each row)."""
    itemsize = 4 if dtype_name == "float32" else 2
    ops = 2.0 * 2 * B * T * 4 * H * H
    rows = 2 * B * T
    if fwd:  # gx in; out, gates and cells out
        n_bytes = 4 * rows * (4 * H + H + 4 * H + H)
    else:    # dout, gates and cells in; dg out
        n_bytes = 4 * rows * (H + 4 * H + H + 4 * H)
    return bound(n_bytes + 2 * 4 * H * H * itemsize, ops, dtype_name)


def k78_check(B, T, lengths, H, dtype_name, device, timed=False, seed=SEED):
    """K7 and K8, through the recurrence's autograd.Function as the encoder
    calls it, against autograd through the plain loop on the same card;
    the inference call (no residuals) against the training call bit for bit,
    and a second K8 call against the first; each call one launch."""
    import torch
    from tacotron2_vae_torch.ops import encoder_lstm as el

    gx, w, b, lens, dout = k78_inputs(B, T, lengths, H, device, seed + 1000 * B + T)
    dtype = None if dtype_name == "float32" else getattr(torch, dtype_name)
    rev = (False, True)
    tol = K78_TOL[dtype_name]
    row = {"kernel": "K7+K8", "dtype": dtype_name, "B": B, "T": T, "H": H,
           "lengths": lens.tolist() if B <= 4 else [int(lens.min()), int(lens.max())],
           "fails": []}
    leaves = [x.clone().requires_grad_() for x in (gx, w, b)]
    n0 = (el.lstm_fwd.launches, el.lstm_bwd.launches)
    out = el.lstm_dirs(*leaves, lens, rev, dtype)
    got = torch.autograd.grad(out, leaves, dout)
    row["launches"] = [el.lstm_fwd.launches - n0[0], el.lstm_bwd.launches - n0[1]]
    again = torch.autograd.grad(el.lstm_dirs(*leaves, lens, rev, dtype), leaves, dout)
    with torch.no_grad():
        infer = el.lstm_dirs(gx, w, b, lens, rev, dtype)
    ref = el.lstm_fwd_plain(*leaves, el.valid_mask(T, lens, rev, device), dtype)[0]
    want = torch.autograd.grad(ref, leaves, dout)
    torch.cuda.synchronize()
    row["out"] = float((out - ref).detach().abs().max())
    for name, g, r in zip(("dgx", "dw_hh", "dbias"), got, want):
        row[name] = rel_err(g, r)
        if not row[name] <= tol["grad"] or not bool(torch.isfinite(g).all()):
            row["fails"].append(name)
    if not row["out"] <= tol["out"] or not bool(torch.isfinite(out).all()):
        row["fails"].append("out")
    if not torch.equal(infer, out):
        row["fails"].append("inference call")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        row["fails"].append("K8 deterministic")
    if row["launches"] != [1, 1]:
        row["fails"].append("one launch a call")
    if timed:
        wq = w.to(dtype or torch.float32).contiguous()
        _, g, c = el.lstm_fwd(gx, wq, b, lens, rev)
        t0 = time.perf_counter()
        el.lstm_fwd(gx, wq, b, lens, rev, save=False)
        row["K7_host_ms"] = (time.perf_counter() - t0) * 1e3
        reps = 20 if T <= 200 else 5
        row["K7_ms"] = cuda_ms(lambda: el.lstm_fwd(gx, wq, b, lens, rev), reps)
        row["K7_infer_ms"] = cuda_ms(lambda: el.lstm_fwd(gx, wq, b, lens, rev, save=False), reps)
        row["K8_ms"] = cuda_ms(lambda: el.lstm_bwd(dout, g, c, wq, lens, rev), reps)
        valid = el.valid_mask(T, lens, rev, device)
        with torch.no_grad():
            row["K7_plain_ms"] = cuda_ms(lambda: el.lstm_fwd_plain(gx, wq, b, valid, dtype), 2)
            row["K8_plain_ms"] = cuda_ms(
                lambda: el.lstm_bwd_plain(dout, g, c, wq, valid, dtype), 2)

        def loop_fwd_bwd():
            o = el.lstm_fwd_plain(*leaves, valid, dtype)[0]
            torch.autograd.grad(o, leaves, dout)

        row["loop_autograd_ms"] = cuda_ms(loop_fwd_bwd, 1)
        # the library yardstick (never called by the port): cuDNN's LSTM on
        # the padded batch, its input product included
        lib = torch.nn.LSTM(K78_IN, H, batch_first=True, bidirectional=True).to(
            device, dtype or torch.float32)
        x = torch.randn(B, T, K78_IN, device=device, dtype=dtype or torch.float32)
        with torch.no_grad():
            row["cudnn_fwd_ms"] = cuda_ms(lambda: lib(x), reps)
        xg = x.clone().requires_grad_()
        row["cudnn_fwd_bwd_ms"] = cuda_ms(lambda: lib(xg)[0].sum().backward(), reps)
        for k, fwd in (("K7", True), ("K8", False)):
            row[f"{k}_bound_ms"], row[f"{k}_bound_by"] = k78_bound(B, T, H, dtype_name, fwd)
            row[f"{k}_us_per_step"] = row[f"{k}_ms"] * 1e3 / T
    return row


def k78_encoder_launches(model, device):
    """One K7 launch for a served encoder call, one K7 and one K8 for a
    training forward and backward, and the program's counters agree."""
    import torch
    from tacotron2_vae_torch.ops import encoder_lstm as el
    from tacotron2_vae_torch.utils import profiling

    enc = copy.deepcopy(model.encoder).requires_grad_(True)
    B, T = 4, 96
    x = torch.randn(B, T, enc.lstm.input_size, device=device, dtype=torch.bfloat16)
    lens = torch.tensor([96, 80, 41, 7], device=device)
    n0 = (el.lstm_fwd.launches, el.lstm_bwd.launches)
    profiling.start()
    with torch.no_grad():
        enc(x, lens, dtype=torch.bfloat16, mask_conv_inputs=True)
    served = (el.lstm_fwd.launches - n0[0], el.lstm_bwd.launches - n0[1])
    g = torch.Generator(device=device).manual_seed(SEED)
    enc(x, lens, dtype=torch.bfloat16, train=True, generator=g).float().square().mean().backward()
    counters = profiling.stop()["counters"]
    row = {"check": "encoder_launches", "served": list(served),
           "trained": [el.lstm_fwd.launches - n0[0] - served[0],
                       el.lstm_bwd.launches - n0[1] - served[1]],
           "counters": {k: v for k, v in counters.items() if k.startswith("encoder_lstm")}}
    print(json.dumps(row), flush=True)
    if (row["served"] != [1, 0] or row["trained"] != [1, 1]
            or row["counters"] != {"encoder_lstm.fwd": 2, "encoder_lstm.bwd": 1}):
        raise AssertionError(f"the encoder did not run through K7/K8 once a call: {row}")
    return row


def k78_phase(model, device, dtypes=K78_DTYPES):
    """K7 and K8 against autograd through the loop at every case and dtype
    (the K78_TIMED shapes timed in bf16), the other hidden sizes, and the
    encoder's launches; rows to ``chiprun_out/chip_smoke_k78.json``.
    Returns ({"K7": ..., "K8": ...} for the kernel table, rows)."""
    rows, failed = [], []
    cases = [(B, T, lens, K78_H) for B, T, lens in K78_CASES]
    cases += [(B, T, "mixed", H) for H, B, T in K78_SIZES]
    report = {"K7": {"max_abs_err": 0.0}, "K8": {"max_abs_err": 0.0}}
    for B, T, lens, H in cases:
        for dtype_name in dtypes:
            timed = dtype_name == "bfloat16" and (B, T) in K78_TIMED and H == K78_H
            row = k78_check(B, T, lens, H, dtype_name, device, timed)
            print(json.dumps(row), flush=True)
            rows.append(row)
            failed += [row] if row["fails"] else []
            report["K7"]["max_abs_err"] = max(report["K7"]["max_abs_err"], row["out"])
            report["K8"]["max_abs_err"] = max(report["K8"]["max_abs_err"], row["dgx"])
            if timed and (B, T) == K78_TIMED[-1]:  # the longest training batch
                for k in ("K7", "K8"):
                    report[k].update(ms=row[f"{k}_ms"], plain_ms=row[f"{k}_plain_ms"],
                                     bound_ms=row[f"{k}_bound_ms"],
                                     bound_by=row[f"{k}_bound_by"],
                                     library_ms=row["cudnn_fwd_ms" if k == "K7"
                                                    else "cudnn_fwd_bwd_ms"])
    rows.append(k78_encoder_launches(model, device))
    with open(os.path.join(OUT_DIR, "chip_smoke_k78.json"), "w") as f:
        json.dump(rows, f, indent=1)
    if failed:
        raise AssertionError(f"{len(failed)} K7/K8 check(s) disagree with the loop: "
                             f"{[(r['dtype'], r['B'], r['T'], r['H'], r['fails']) for r in failed]}")
    return report, rows


# ------------------------------------------------ K9 (--k9)

# (C, L) of each BigVGAN stage for a 9.6 s request (600 frames, padded to
# 640 by the 64-frame bucket): 18 K9 launches a stage, one more at the last
# stage's shape (activation_post), 109 a generator call
K9_STAGES = ((768, 2560), (384, 10240), (192, 20480), (96, 40960), (48, 81920), (24, 163840))
K9_EDGES = ((5, 1), (5, 7), (5, 64), (3, 1025))
# K9 against its twin on the card: max |difference| over max(1, max |twin|).
# Both are float32 with the same operations; the kernel fuses multiply-adds
# and takes another sine, so the two differ by a few float32 ulps of the
# largest intermediate (sin's argument reaches tens of radians).
K9_TOL = 2e-6
# The served wav against the same generator with the library path in K9's
# place: max |difference| of the tanh output (the generator read 1.0e-7 on
# the card; a K9 that dropped a filter or a pad moves it by > 1e-2).
K9_WAV_TOL = 1e-5
K9_OPS_PER_SAMPLE = 60   # portbench/counts/bigvgan.py gives the count


def k9_library(x, alpha, beta, up, down):
    """The activation as BigVGAN's published modules compute it, a library
    call at a time (a yardstick the port never calls): replicate pad, a
    depthwise transposed convolution, a slice, SnakeBeta, a pad, a depthwise
    strided convolution."""
    import torch
    import torch.nn.functional as F

    C = x.shape[1]
    u = 2 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), up.expand(C, -1, -1),
                               stride=2, groups=C)[..., 15:-15]
    a, b = torch.exp(alpha)[None, :, None], torch.exp(beta)[None, :, None]
    s = u + (1.0 / (b + 1e-9)) * torch.pow(torch.sin(u * a), 2)
    return F.conv1d(F.pad(s, (5, 6), mode="replicate"), down.expand(C, -1, -1), stride=2,
                    groups=C)


def k9_inputs(C, L, device, seed):
    import torch

    from tacotron2_vae_torch.models.bigvgan import kaiser_sinc_filter1d

    g = torch.Generator(device=device).manual_seed(seed)
    x = 2.0 * torch.randn(1, C, L, generator=g, device=device)
    alpha = 0.3 * torch.randn(C, generator=g, device=device)
    beta = 0.3 * torch.randn(C, generator=g, device=device)
    filt = kaiser_sinc_filter1d(0.25, 0.3, 12).to(device)
    return x, alpha, beta, filt, filt


def k9_check(C, L, device, rounds=0, seed=SEED):
    """K9 against its twin and the library path on one (C, L); with
    ``rounds``, each timed in turns (kernel, twin, library) that many
    times, a CUDA-event mean over a burst of calls each."""
    import torch

    from tacotron2_vae_torch.ops import aa_snake as k9

    args = k9_inputs(C, L, device, seed + C + L)
    got = k9.aa_snake(*args)
    torch.cuda.synchronize()
    want = k9.aa_snake_plain(*args)
    lib = k9_library(*args)
    scale = max(1.0, float(want.abs().max()))
    row = {"check": "K9", "C": C, "L": L, "err": float((got - want).abs().max()) / scale,
           "err_library": float((got - lib).abs().max()) / scale}
    row["fails"] = [k for k in ("err", "err_library") if not row[k] <= K9_TOL]
    if rounds:
        reps = max(5, min(200, int(4e7 // (C * L))))
        times = {"K9_ms": [], "plain_ms": [], "library_ms": []}
        for _ in range(rounds):
            times["K9_ms"].append(cuda_ms(lambda: k9.aa_snake(*args), reps))
            times["plain_ms"].append(cuda_ms(lambda: k9.aa_snake_plain(*args), max(2, reps // 20)))
            times["library_ms"].append(cuda_ms(lambda: k9_library(*args), reps))
        row.update({k: sorted(v)[len(v) // 2] for k, v in times.items()})
        row.update({k.replace("_ms", "_ms_all"): v for k, v in times.items()})
        row["bound_ms"], row["bound_by"] = bound(8.0 * C * L, K9_OPS_PER_SAMPLE * C * L,
                                                 "float32")
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["K9_ms"]
    return row


def bigvgan_checkpoint(model, tmp):
    """A BigVGAN generator checkpoint at the published widths in its
    published layout, written into ``tmp/bigvgan``: ``model``'s weights,
    each convolution's split into ``weight_g`` (its row norms) and
    ``weight_v``, and the config's ``config.json`` beside it."""
    import dataclasses

    import torch

    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith(".weight") and v.ndim == 3:
            sd[k + "_v"] = v.cpu()
            sd[k + "_g"] = v.norm(dim=(1, 2), keepdim=True).cpu()
        else:
            sd[k] = v.cpu()
    os.makedirs(os.path.join(tmp, "bigvgan"), exist_ok=True)
    path = os.path.join(tmp, "bigvgan", "g_00000000")
    torch.save({"generator": sd}, path)
    with open(os.path.join(tmp, "bigvgan", "config.json"), "w", encoding="utf-8") as f:
        json.dump(dataclasses.asdict(model.cfg), f)
    return path


def k9_served(hp, t2, device, tmp):
    """BigVGAN at the published widths loaded by ``Synthesizer.load`` from a
    checkpoint in the published layout, then one ``Synthesizer.vocode`` of a
    600-frame mel (a 9.6 s request, padded to 640 frames): K9's launches
    counted over that call must be one an ``Activation1d`` (109), and its
    wav must match the generator with the library path in K9's place
    (``K9_WAV_TOL``).  Then the loaded generator timed with K9 and with the
    library path, in turns."""
    import warnings

    import numpy as np
    import torch

    import tacotron2_vae_torch.models.bigvgan as mbv
    from tacotron2_vae_torch.ops import aa_snake as k9
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer

    model = mbv.BigVGAN()
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) * (0.5 / math.sqrt(p[0].numel())))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    ckpt = os.path.join(tmp, "checkpoint_random.pt")
    torch.save({"state_dict": {k: v.cpu() for k, v in t2.state_dict().items()}}, ckpt)
    synth = Synthesizer(hp, device=device)
    with warnings.catch_warnings():     # no centroid clips: vocode needs none
        warnings.simplefilter("ignore")
        synth.load(ckpt, bigvgan_checkpoint(model, tmp),
                   centroid_filelist=os.path.join(tmp, "no_clips.txt"))
    if synth.bigvgan is None:
        raise AssertionError("Synthesizer.load did not load the BigVGAN checkpoint")
    voc = synth.bigvgan
    n_act = sum(isinstance(m, mbv.Activation1d) for m in voc.modules())
    frames = 600
    mel = (0.15 * torch.randn(1, 80, frames, generator=g)).numpy()
    k9.aa_snake.launches = 0
    wav = synth.vocode(mel)
    torch.cuda.synchronize()
    launches = k9.aa_snake.launches
    shp = synth.hparams
    bucket = -(-frames // shp.mel_bucket_size) * shp.mel_bucket_size
    mel_p = torch.nn.functional.pad(torch.from_numpy(mel), (0, bucket - frames),
                                    value=float(np.log(1e-5))).to(device)
    row = {"check": "K9_served", "frames": frames, "padded_frames": bucket,
           "activations": n_act, "launches": launches, "K9_ms": [], "library_ms": []}
    inner = mbv.aa_snake
    with torch.no_grad():
        for _ in range(3):
            row["K9_ms"].append(cuda_ms(lambda: voc(mel_p), 5))
            mbv.aa_snake = k9_library
            try:
                row["library_ms"].append(cuda_ms(lambda: voc(mel_p), 5))
                lib = voc(mel_p)[0, :frames * shp.hop_length].cpu().numpy()
            finally:
                mbv.aa_snake = inner
    row["max_abs_diff"] = float(np.abs(wav - lib).max())
    row["rms"] = float(np.sqrt(np.mean(np.square(wav, dtype=np.float64))))
    row["share_above_0.99"] = float(np.mean(np.abs(wav) > 0.99))
    row["fails"] = ([] if launches == n_act == 109 else ["launches"]) + (
        [] if row["max_abs_diff"] <= K9_WAV_TOL and wav.shape == (frames * shp.hop_length,)
        else ["wav"])
    del synth, voc
    torch.cuda.empty_cache()
    return row


def k9_phase(hp, t2, device, tmp):
    """K9 against its twin and the library path at each BigVGAN stage of a
    9.6 s request and at the edge lengths, the stages timed in turns (5
    rounds), the served path's launches and wav (``k9_served``), and a
    request's launches summed; rows to ``chiprun_out/chip_smoke_k9.json``.
    Returns the ``kernels`` entry of K9."""
    rows = [k9_check(C, L, device, rounds=5) for C, L in K9_STAGES]
    rows += [k9_check(C, L, device) for C, L in K9_EDGES]
    for row in rows:
        print(json.dumps({k: v for k, v in row.items() if not k.endswith("_all")}), flush=True)
    served = k9_served(hp, t2, device, tmp)
    print(json.dumps(served), flush=True)
    n = {shape: 18 for shape in K9_STAGES}
    n[K9_STAGES[-1]] += 1
    total = {"check": "K9_request", "launches": served["launches"]}
    for k in ("K9_ms", "plain_ms", "library_ms", "bound_ms"):
        total[k] = sum(r[k] * n[(r["C"], r["L"])] for r in rows[:len(K9_STAGES)])
    total["roofline_pct"] = 100.0 * total["bound_ms"] / total["K9_ms"]
    print(json.dumps(total), flush=True)
    rows += [served, total]
    with open(os.path.join(OUT_DIR, "chip_smoke_k9.json"), "w") as f:
        json.dump(rows, f, indent=1)
    failed = [r for r in rows if r.get("fails")]
    if failed:
        raise AssertionError(f"{len(failed)} K9 check(s) failed: "
                             f"{[(r['check'], r.get('C'), r.get('L'), r['fails']) for r in failed]}")
    return {"name": "aa_snake_kernel", "route": "cuda",
            "source": "tacotron2_vae_torch/csrc/aa_snake.cu",
            "replaces": "none: BigVGAN's Activation1d (no TPU counterpart)",
            "launches": served["launches"],
            "max_abs_err": max(r["err"] for r in rows if r["check"] == "K9"),
            "ms": total["K9_ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": rows[0]["bound_by"], "library_ms": total["library_ms"]}


# ------------------------------------------------ K1 / K2 (--k12)

# (S, steps) of K1's per-kernel reads: the shape the kernels are tuned at and
# the serve phase's text bucket and step cap
K12_DECODE = ((64, 200), (32, 600))
K12_PROFILED_CALLS = 20  # eager K2 calls (and library calls) under the profiler
def k12_phase(model, hp, device):
    """K1 and K2 alone: their checks at full width and K2 in turns with its
    library call (``kernels_phase``); the profiler's device µs per call of
    K2 and of its library call at each K2_TURN_SECONDS; K1's device µs per
    step of each of its kernels (``profile_decode.profile``: each step's
    kernels launched on the stream under the profiler) at B=1 and B=4, bf16 and f32, at each K12_DECODE
    shape; and the host-clock split of one ``infer`` at the serve shape
    (``profile_decode.profile_infer``).  Writes every row to
    ``chiprun_out/chip_smoke_k12.json``."""
    import numpy as np
    import torch
    from tacotron2_vae_torch import profile_decode as pd
    from tacotron2_vae_torch.ops import stft_mel as sm

    from tacotron2_vae_torch.ops import decoder_loop as dl

    print(json.dumps({"K1_l2": dl.info()}), flush=True)  # before any decode
    report, rows = kernels_phase(model, hp, device)
    tab = k2_tables(hp, device)
    key = (hp.filter_length, hp.hop_length, hp.win_length, hp.n_mel_channels,
           hp.sampling_rate, hp.mel_fmin, hp.mel_fmax)
    rng = np.random.RandomState(SEED)
    for seconds in K2_TURN_SECONDS:
        wav = k2_turn_wav(hp, seconds, rng, device)
        fns = {"kernel": lambda: sm.mel_spectrogram_fused(wav, *key),
               "library": k2_library(hp, wav, tab.window, tab.fb)}
        row = {"kernel": "K2", "seconds": seconds, "calls": K12_PROFILED_CALLS,
               "device_us": {k: device_us(fn, K12_PROFILED_CALLS) for k, fn in fns.items()}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    for S, steps in K12_DECODE:
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 4):
                prof = pd.profile(model.decoder, B, S, steps, dtype, device)
                row = {"kernel": "K1", **{k: prof[k] for k in (
                    "B", "S", "steps", "dtype", "us_per_step", "stream_ms",
                    "kernel_us_per_step", "device_busy_share", "graphs_instantiated")},
                       "us_per_step_by_kernel": us_by_kernel(prof)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    for B in (1, 4):
        row = pd.profile_infer(model, B)
        print(json.dumps(row), flush=True)
        rows.append(row)
    with open(os.path.join(OUT_DIR, "chip_smoke_k12.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return report, rows


# ------------------------------------------------------------------- train

TRAIN_SHAPE = (64, 128, 512)   # B, S, T of the steady-state steps
TRAIN_STEPS = 10               # timed steps after one warm-up step
PIPELINED = 10                 # then steps back to back, one synchronise at the end
KO_TEXTS = ["안녕하세요. 오늘은 날씨가 참 좋네요.", "감사합니다, 다음에 또 만나요.",
            "반갑습니다, 만나서 정말 기뻐요.", "내일 아침에 다시 연락드릴게요.",
            "이 문장은 학습용 합성 데이터입니다.", "바람이 불고 비가 내리는 저녁이에요."]


def fixed_batch(hp, device):
    """A full-width batch from the seed: random tokens, a smooth random
    log-mel (a learnable target), lengths below the padded sizes."""
    import numpy as np
    import torch

    B, S, T = TRAIN_SHAPE
    rng = np.random.RandomState(SEED)
    in_lens = np.sort(S - rng.randint(0, S // 4, B))[::-1].copy()
    out_lens = T - rng.randint(0, T // 8, B)
    freq = np.linspace(0, 1, hp.n_mel_channels)[None, :, None]
    time_ = np.linspace(0, 8 * np.pi, T)[None, None, :]
    mel = (-4 + 2 * np.sin(time_ * (1 + rng.rand(B, 1, 1)) + 6 * freq)
           + 0.1 * rng.randn(B, hp.n_mel_channels, T)).astype(np.float32)
    mel *= np.arange(T)[None, None, :] < out_lens[:, None, None]
    gate = (np.arange(T)[None, :] >= out_lens[:, None] - 1).astype(np.float32)
    batch = {"text": rng.randint(1, hp.n_symbols, (B, S)), "input_lengths": in_lens,
             "mel": mel, "output_lengths": out_lens, "gate": gate,
             "emotions": np.eye(hp.n_emotions, dtype=np.float32)[rng.randint(0, 4, B)]}
    return {k: torch.as_tensor(v).to(device, torch.long if v.dtype.kind == "i" else torch.float32)
            for k, v in batch.items()}


def steady_steps(hp, device):
    """``make_train_step`` on one fixed full-width batch: ms per step by
    CUDA events with a synchronise after each step, then ``PIPELINED``
    steps back to back with one synchronise at the end, then one step with
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
    that makes the host wait for the card (the step must make none); mel
    frames per second, peak device memory.  The loss and the gradient norm
    must stay finite and the loss fall."""
    import torch
    from tacotron2_vae_torch.ops import encoder_lstm as el
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.training.train_state import create_train_state, make_train_step

    ts = create_train_state(hp, device, seed=SEED)
    step = make_train_step(hp)
    batch = fixed_batch(hp, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tf.teacher_fwd.launches = tf.teacher_bwd.launches = 0
    el.lstm_fwd.launches = el.lstm_bwd.launches = 0
    captures, updates = tf.graph_captures(), tf.graph_updates()
    build_ms = tf.graph_instantiate_ms()
    n_steps = TRAIN_STEPS + 1 + PIPELINED + 1
    metrics = []

    def run(i):
        m = step(ts, batch, gen)
        metrics.append(torch.stack([m["loss"], m["grad_norm"], m["updated"].float()]))

    times = []
    for i in range(TRAIN_STEPS + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TRAIN_STEPS + 1, TRAIN_STEPS + 1 + PIPELINED):
        run(i)
    end.record()
    torch.cuda.synchronize()
    pipelined = start.elapsed_time(end) / PIPELINED
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(n_steps - 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    metrics = torch.stack(metrics).cpu().tolist()
    launches = {"K3": tf.teacher_fwd.launches, "K4": tf.teacher_bwd.launches,
                "K7": el.lstm_fwd.launches, "K8": el.lstm_bwd.launches}
    captures = {k: v - captures[k] for k, v in tf.graph_captures().items()}
    updates = {k: v - updates[k] for k, v in tf.graph_updates().items()}
    build_ms = {k: v - build_ms[k] for k, v in tf.graph_instantiate_ms().items()}
    B, S, T = TRAIN_SHAPE
    ms = sum(times[1:]) / TRAIN_STEPS
    row = {"phase": "train_steady", "B": B, "S": S, "T": T, "steps": TRAIN_STEPS,
           "ms_per_step": ms, "ms_per_step_pipelined": pipelined,
           "pipelined_steps": PIPELINED, "ms_per_step_each": times,
           "mel_frames_per_s": B * T / ms * 1e3,
           "mel_frames_per_s_pipelined": B * T / pipelined * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": [m[0] for m in metrics], "grad_norm": [m[1] for m in metrics],
           "sync_debug_step": "no host sync", "launches": launches,
           "graph_captures": captures, "graph_updates": updates,
           "graph_instantiate_ms": build_ms}
    print(json.dumps(row), flush=True)
    if any((captures[k] + updates[k] > 0) != (build_ms[k] > 0) for k in captures):
        raise AssertionError(f"K3/K4 graph build time {build_ms} against builds "
                             f"{captures} {updates}")
    losses = row["loss"]
    if not all(math.isfinite(v) for v in losses + row["grad_norm"]):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {row['grad_norm']}")
    if not (all(m[2] == 1.0 for m in metrics) and losses[TRAIN_STEPS] < losses[0]):
        raise AssertionError(f"the loss did not fall over {TRAIN_STEPS + 1} steps: {losses}")
    if any(n != n_steps for n in launches.values()):
        raise AssertionError(f"the train steps did not run through K3/K4/K7/K8 once a step: "
                             f"{launches}")
    if max(captures.values()) > 1:
        raise AssertionError(f"K3/K4 instantiated more than one graph for one batch shape: "
                             f"{captures}")
    return row


def write_corpus(tmp, n, rng, name):
    """``n`` 16 kHz wavs of 2-6 s with Korean texts and a filelist."""
    path = os.path.join(tmp, f"{name}.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            wav = os.path.join(tmp, f"{name}{i}.wav")
            write_wav(wav, 2.0 + 4.0 * rng.rand(), 110 + 5 * (i % 60), rng)
            f.write(f"{wav}|{KO_TEXTS[i % len(KO_TEXTS)]}|0|{i % 4}\n")
    return path


def train_entry(hp, device, tmp):
    """The real entry point ``training.train.train`` on a synthetic corpus
    (128 training and 16 validation clips, B=64): two epochs with one
    validation and checkpoint at iteration 2, mels featurised per clip by
    K2 (no cache); then a resume from that checkpoint (``-c``) with the mel
    cache warmed in bulk, which continues at iteration 3 and checkpoints at
    4 and 6.  K2, K3 and K4 must all launch."""
    import numpy as np
    from tacotron2_vae_torch.ops import encoder_lstm as el
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.training import train as tr

    rng = np.random.RandomState(SEED)
    hp2 = hp.replace(training_files=write_corpus(tmp, 128, rng, "train"),
                     validation_files=write_corpus(tmp, 16, rng, "val"),
                     batch_size=64, epochs=2, iters_per_checkpoint=2, mel_cache=False)
    out = os.path.join(tmp, "out")
    sm.mel_spectrogram_fused.launches = 0
    tf.teacher_fwd.launches = tf.teacher_bwd.launches = 0
    el.lstm_fwd.launches = el.lstm_bwd.launches = 0
    t0 = time.perf_counter()
    _, it = tr.train(out, "logs", None, False, hp2, device=str(device))
    ckpt = os.path.join(out, "checkpoint_2")
    _, it2 = tr.train(out, "logs", ckpt, False, hp2.replace(epochs=3, mel_cache=True),
                      device=str(device))
    wall = time.perf_counter() - t0
    launches = {"K2": sm.mel_spectrogram_fused.launches, "K3": tf.teacher_fwd.launches,
                "K4": tf.teacher_bwd.launches, "K7": el.lstm_fwd.launches,
                "K8": el.lstm_bwd.launches}
    with open(os.path.join(out, "logs", "metrics.csv")) as f:
        iters = [int(line.split(",")[0]) for line in f.readlines()[1:]]
    with open(os.path.join(out, "logs", "val_metrics.csv")) as f:
        val = [line.strip().split(",") for line in f.readlines()[1:]]
    row = {"phase": "train_entry", "iterations": iters, "validations": val, "end": [it, it2],
           "checkpoints": sorted(os.listdir(out)), "wall_s": wall, "launches": launches}
    print(json.dumps(row), flush=True)
    if iters != [0, 1, 2, 3, 3, 4, 5, 6] or [v[0] for v in val] != ["2", "4", "6"]:
        raise AssertionError(f"train/resume iterations wrong: {iters}, validations {val}")
    if not all(math.isfinite(float(x)) for v in val for x in v[1:]):
        raise AssertionError(f"non-finite validation loss: {val}")
    if not all(os.path.exists(os.path.join(out, f"checkpoint_{i}")) for i in (2, 4, 6)):
        raise AssertionError(f"missing checkpoints: {row['checkpoints']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"train() did not run through K2/K3/K4/K7/K8: {launches}")
    return row


FP16_UPDATES, FP16_MAX_STEPS = 10, 60   # train_fp16: updates to take, within this many steps
FP16_TURNS = ("bfloat16", "float16", "float16", "bfloat16")
FP16_TURN_STEPS = 3                     # timed steps a turn, after one untimed


def stream_spy(tf):
    """Record the stream dtype of every K3 and K4 launch: wraps the
    wrappers' launch functions (``_run_fwd``, ``_run_bwd``) until the
    returned ``restore`` is called."""
    seen = {"K3": [], "K4": []}
    run_fwd, run_bwd = tf._run_fwd, tf._run_bwd

    def fwd(w, *a, **k):
        seen["K3"].append(str(w["attn_w"].dtype).replace("torch.", ""))
        return run_fwd(w, *a, **k)

    def bwd(w, *a, **k):
        seen["K4"].append(str(w["attn_w"].dtype).replace("torch.", ""))
        return run_bwd(w, *a, **k)

    tf._run_fwd, tf._run_bwd = fwd, bwd

    def restore():
        tf._run_fwd, tf._run_bwd = run_fwd, run_bwd

    return seen, restore


def train_fp16(hp, device):
    """``make_train_step`` under ``fp16_run`` on the fixed full-width batch
    from the default 2^32 loss scale: the steps before the first update
    are skipped (the float16 streams overflow) and each halves the scale,
    so the first update's scale is 2^32 / 2^n after n skips; steps run
    until FP16_UPDATES updates (at most FP16_MAX_STEPS), the loss must fall
    over the updated steps, one more step runs under
    ``torch.cuda.set_sync_debug_mode("error")``, and K3/K4 must launch on
    float16 streams only.  Then ms/step and peak memory of the bf16 and the
    float16 step in turns (FP16_TURNS, each FP16_TURN_STEPS synchronised
    steps after one untimed)."""
    import torch
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.training.train_state import create_train_state, make_train_step

    hp16 = hp.replace(fp16_run=True)
    batch = fixed_batch(hp, device)
    ts = create_train_state(hp16, device, seed=SEED)
    step = make_train_step(hp16)
    gen = torch.Generator(device=device).manual_seed(SEED)
    init_scale = float(ts.scaler.scale)
    seen, restore = stream_spy(tf)
    tf.teacher_fwd.launches = tf.teacher_bwd.launches = 0
    rows = []
    try:
        while len(rows) < FP16_MAX_STEPS and sum(r[2] for r in rows) < FP16_UPDATES:
            m = step(ts, batch, gen)
            rows.append(torch.stack([m["loss"], m["grad_norm"], m["updated"].float(),
                                     m["loss_scale"]]).tolist())
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = step(ts, batch, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        restore()
    launches = {"K3": tf.teacher_fwd.launches, "K4": tf.teacher_bwd.launches}
    updated = [r for r in rows if r[2] == 1.0]
    n_skipped = next((i for i, r in enumerate(rows) if r[2] == 1.0), len(rows))
    first_scale = rows[n_skipped][3] if updated else None
    row = {"phase": "train_fp16", "B": TRAIN_SHAPE[0], "S": TRAIN_SHAPE[1],
           "T": TRAIN_SHAPE[2], "init_scale": init_scale, "skipped_before_first_update": n_skipped,
           "first_update_scale": first_scale, "steps": len(rows), "updates": len(updated),
           "loss_updated": [r[0] for r in updated], "grad_norm_updated": [r[1] for r in updated],
           "loss_scale": [r[3] for r in rows], "sync_debug_step": "no host sync",
           "launches": launches, "stream_dtypes": {k: sorted(set(v)) for k, v in seen.items()}}
    row.update(step_turns(hp, hp16, batch, device))
    print(json.dumps(row), flush=True)
    if len(updated) < FP16_UPDATES:
        raise AssertionError(f"fp16_run took {len(updated)} updates in {len(rows)} steps")
    if first_scale != init_scale / 2 ** n_skipped:
        raise AssertionError(f"scale {first_scale} after {n_skipped} skips from {init_scale}")
    if not (all(math.isfinite(v) for v in row["loss_updated"] + row["grad_norm_updated"])
            and row["loss_updated"][-1] < row["loss_updated"][0]):
        raise AssertionError(f"the fp16 loss did not fall over its updates: "
                             f"{row['loss_updated']}")
    if row["stream_dtypes"] != {"K3": ["float16"], "K4": ["float16"]} or min(
            launches.values()) < len(rows) + 1:
        raise AssertionError(f"the fp16 steps did not run K3/K4 on float16 streams: "
                             f"{row['stream_dtypes']}, {launches}")
    return row


def step_turns(hp, hp16, batch, device):
    """ms/step (CUDA events, synchronised) and peak memory of the bf16 and
    the fp16_run step on ``batch``, in the turns of FP16_TURNS."""
    import torch
    from tacotron2_vae_torch.training.train_state import create_train_state, make_train_step

    configs = {"bfloat16": hp, "float16": hp16}
    states = {k: create_train_state(h, device, seed=SEED) for k, h in configs.items()}
    steps = {k: make_train_step(h) for k, h in configs.items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {f"ms_per_step_{k}": [] for k in configs}
    out.update({f"peak_memory_gb_{k}": [] for k in configs})
    for name in FP16_TURNS:
        steps[name](states[name], batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(FP16_TURN_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            steps[name](states[name], batch, gen)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[f"ms_per_step_{name}"].append(sum(times) / len(times))
        out[f"peak_memory_gb_{name}"].append(torch.cuda.max_memory_allocated() / 1e9)
    return out


def train_entry_fp16(hp, device, tmp):
    """``training.train.train`` under ``fp16_run`` on a synthetic corpus (64
    training and 16 validation clips, B=32, two batches an epoch): two
    epochs with a validation and a checkpoint at iteration 2 (the scaler
    saved in it), then a resume from checkpoint_2 through a third epoch
    (validations at 4 and 6).  A state resumed from
    checkpoint_2 must hold its saved scale, below the fresh 2^32 (the
    float16 steps skipped), and K3/K4 must launch."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.training import train as tr
    from tacotron2_vae_torch.training.checkpoint import load_checkpoint
    from tacotron2_vae_torch.training.train_state import create_train_state

    rng = np.random.RandomState(SEED + 16)
    hp16 = hp.replace(training_files=write_corpus(tmp, 64, rng, "train"),
                      validation_files=write_corpus(tmp, 16, rng, "val"),
                      batch_size=32, epochs=2, iters_per_checkpoint=2, mel_cache=True,
                      fp16_run=True)
    out = os.path.join(tmp, "out16")
    tf.teacher_fwd.launches = tf.teacher_bwd.launches = 0
    t0 = time.perf_counter()
    ts1, it = tr.train(out, "logs", None, False, hp16, device=str(device))
    ckpt = os.path.join(out, "checkpoint_2")
    saved = [float(x) for x in torch.load(ckpt, weights_only=True)["scaler"]]
    resumed, _, _ = load_checkpoint(ckpt, create_train_state(hp16, device))
    ts2, it2 = tr.train(out, "logs", ckpt, False, hp16.replace(epochs=3), device=str(device))
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "logs", "val_metrics.csv")) as f:
        val = [line.strip().split(",") for line in f.readlines()[1:]]
    row = {"phase": "train_entry_fp16", "end": [it, it2], "validations": val,
           "checkpoints": sorted(os.listdir(out)), "saved_scaler": saved,
           "resumed_scaler": [float(x) for x in resumed.scaler],
           "final_scale": [float(ts1.scaler.scale), float(ts2.scaler.scale)], "wall_s": wall,
           "launches": {"K3": tf.teacher_fwd.launches, "K4": tf.teacher_bwd.launches}}
    print(json.dumps(row), flush=True)
    if [v[0] for v in val] != ["2", "4", "6"] or not all(
            math.isfinite(float(x)) for v in val for x in v[1:]):
        raise AssertionError(f"fp16 train/resume validations wrong: {val}")
    if row["resumed_scaler"] != saved or not saved[0] < 2.0 ** 32:
        raise AssertionError(f"resumed scaler {row['resumed_scaler']} against saved {saved}")
    if min(row["launches"].values()) < 1:
        raise AssertionError(f"fp16 train() did not run through K3/K4: {row['launches']}")
    return row


PIPE_ITERS = 16       # batches of 64 in train_pipeline's corpus (one epoch)
PIPE_WARM = 3         # iterations before the steady s/it and the trace
PIPE_TRACED = 5       # iterations under utils.profiling.trace
# (prefetch_depth, log_fetch_window, num_workers): the defaults, then all 1
PIPE_CONFIGS = {"defaults": (2, 16, 4), "serial": (1, 1, 1)}
# one run of each, then the traced run: two turns of each cost ~40 s more
# on an H100 (PERF.md section 6) and the script has a time limit
PIPE_ORDER = ("defaults", "serial")


def train_pipeline(hp, device, tmp):
    """The real ``train()`` at full width (B=64, bf16) on a synthetic
    corpus of ``PIPE_ITERS`` batches (``profile_train.synthetic_corpus``:
    texts of the reference corpus's train filelist, clips as long as their
    texts), mel cache warmed first: the defaults (prefetch 2 deep, metrics
    fetched 16 steps at a time, 4 loader workers) against all three at 1
    (``PIPE_ORDER``).  Each run's steady s/it
    (CUDA events after each queued step, from iteration ``PIPE_WARM``),
    batch shapes, K2/K3/K4 launches and K3/K4 graphs instantiated and
    updated per iteration; then one run with the defaults whose iterations
    ``PIPE_WARM .. PIPE_WARM + 4`` are traced, the card's activity alone
    (its busy ms per iteration, longest idle gaps); each untraced run's
    busy share is that busy ms over its s/it.  K3 and K4 must launch once
    an iteration; each must instantiate no more graphs than there are
    batches whose shape is not among the last ``GRAPHS`` shapes; the
    native data-IO library must load."""
    from tacotron2_vae_torch import profile_train as pt
    from tacotron2_vae_torch.data import native
    from tacotron2_vae_torch.data.dataset import TextMelDataset

    flist = pt.synthetic_corpus(tmp, PIPE_ITERS * hp.batch_size, seed=SEED, name="pipe")
    base = hp.replace(training_files=flist, validation_files=flist, epochs=1,
                      iters_per_checkpoint=10 ** 6)
    t0 = time.perf_counter()
    warmed = TextMelDataset(flist, base, device=str(device)).warm_mel_cache()
    warm_s = time.perf_counter() - t0
    runs = []
    for name in PIPE_ORDER:
        depth, window, workers = PIPE_CONFIGS[name]
        cfg = base.replace(prefetch_depth=depth, log_fetch_window=window, num_workers=workers)
        run = pt.loop_run(cfg, device, os.path.join(tmp, f"pipe_{name}"), warm=PIPE_WARM)
        runs.append(dict(run, config=name))
    traced = pt.loop_run(base, device, os.path.join(tmp, "pipe_traced"), warm=PIPE_WARM,
                         traced=PIPE_TRACED, trace_dir=OUT_DIR)
    s_per_it = {name: [r["s_per_it"] for r in runs if r["config"] == name]
                for name in PIPE_CONFIGS}
    # the card's busy ms a traced iteration over the untraced runs' s/it
    busy_share = {name: [traced["device_ms_per_it"] / (v * 1e3) for v in s_per_it[name]]
                  for name in PIPE_CONFIGS}
    row = {"phase": "train_pipeline", "B": hp.batch_size, "iterations": PIPE_ITERS,
           "steady_from": PIPE_WARM, "mels_warmed": warmed, "warm_cache_s": warm_s,
           "native_available": native.available(), "s_per_it": s_per_it,
           "busy_share": busy_share, "runs": runs, "traced": traced}
    print(json.dumps(row), flush=True)
    if not row["native_available"]:
        raise AssertionError("the native data-IO library did not build or load")
    for r in runs + [traced]:
        if r["iterations"] != PIPE_ITERS:
            raise AssertionError(f"train() ran {r['iterations']} iterations: {r}")
        if r["launches"]["K3"] != PIPE_ITERS or r["launches"]["K4"] != PIPE_ITERS:
            raise AssertionError(f"train() did not run each step through K3/K4: {r}")
        # one graph per batch shape that is not among the last GRAPHS shapes
        if max(r["graph_captures_per_it"].values()) * PIPE_ITERS > r["graph_misses_at_most"]:
            raise AssertionError(f"K3/K4 graph captures not bounded: {r}")
    if not 0.0 < traced["busy_share"] <= 1.0:
        raise AssertionError(f"no device time in the traced iterations: {traced}")
    return row


def run_ranks(cmds: dict, tmp, log_name, timeout=600) -> dict:
    """Start every command of ``cmds`` (name -> argv after the python
    executable) at once; wait for all; their ``DRYRUN`` objects by name.
    Fails when one exits non-zero; kills what outlives ``timeout``."""
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                              "MASTER_PORT")}
    child_env["PYTHONPATH"] = ROOT
    procs = {name: subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=child_env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
             for name, cmd in cmds.items()}
    logs = {}
    for name, proc in procs.items():
        try:
            logs[name], _ = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    with open(os.path.join(OUT_DIR, log_name), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"{name} failed ({proc.returncode}): {logs[name][-2000:]}")
    return {name: [json.loads(line[len("DRYRUN "):]) for line in logs[name].splitlines()
                   if line.startswith("DRYRUN ")] for name in logs}


def state_rel_err(one: dict, got: dict) -> float:
    """|got - one| / |one - first| over every float entry of the saved
    logical state dicts; both runs must have started from one state."""
    import torch

    moved = diff = 0.0
    for k, v in one["state_dict"].items():
        if v.is_floating_point():
            first = one["init_state_dict"][k].double()
            if not torch.equal(got["init_state_dict"][k].double(), first):
                raise AssertionError(f"the runs did not start from one state: {k}")
            moved += (v.double() - first).pow(2).sum().item()
            diff += (got["state_dict"][k].double() - v.double()).pow(2).sum().item()
    return (diff / moved) ** 0.5


# --nccl: a rank a card over NCCL (4 cards), not gloo ranks sharing one
NCCL = "--nccl" in sys.argv[1:]


def _grid_cmd(grid, args, module="tacotron2_vae_torch.tools.multihost_dryrun", gloo=None):
    """argv of ``module`` over a (data, model) grid of torchrun ranks (one
    plain process for 1x1); gloo ranks sharing the card unless ``--nccl``
    (``gloo`` overrides)."""
    n = grid[0] * grid[1]
    head = ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={n}"] if n > 1 else []
    gloo = not NCCL if gloo is None else gloo
    return [*head, "-m", module, *args, *(["--backend", "gloo"] if n > 1 and gloo else [])]


DP_STEPS = 3           # steps of the two-rank run against one process
DP_ITERS = 4           # batches of the world-1 NCCL run's corpus
# Two ranks of B=32 against one process of B=64, bf16, three steps: the
# recurrence kernels tile each rank's 32 rows differently from 64, so
# roundings differ in bf16; the loss is a mean over ~3M terms.  Measured
# 1.15e-4 (H100 80GB HBM3, 700 W; PERF.md).
DP_LOSS_RTOL = 1e-3
# The state after DP_STEPS (parameters and running statistics) of rank 0
# against the one process: |two - one| / |one - first|, the norms over every
# float entry.  Adam moves an element whose gradient is rounding noise
# (a bias before a batchnorm) by +-lr a step either way, so this is not 0.
DP_STATE_RTOL = 0.1


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _draw_elements(hp, B, S, T):
    """Random numbers one train step draws at batch B (dropout masks of the
    prenet, encoder and postnet, the recurrent masks, the VAE's noise)."""
    return (2 * B * T * hp.prenet_dim
            + hp.encoder_n_convolutions * B * S * hp.encoder_embedding_dim
            + B * T * ((hp.postnet_n_convolutions - 1) * hp.postnet_embedding_dim
                       + hp.n_mel_channels)
            + 2 * T * B * (hp.attention_rnn_dim + hp.decoder_rnn_dim)
            + B * hp.z_latent_dim)


def train_dp(hp, device, tmp):
    """Data parallelism on the one card.  (1) ``train()`` under
    torchrun's environment at world 1 (NCCL) against the plain process on
    the same corpus of ``DP_ITERS`` batches: the iterations and the CSV's
    losses and norms must be equal.  (2) Two ranks over gloo on the card,
    each a ``tools/multihost_dryrun.py`` process of 32 rows of the fixed
    full-width batch, ``DP_STEPS`` steps, against one such process on all
    64 rows: losses within ``DP_LOSS_RTOL``, rank 0's state after the
    steps within ``DP_STATE_RTOL`` of the process's, K3 and K4 launched in
    each rank.  (3) What drawing every random number at the global batch's shape
    costs a rank of a 2-way run: one step's draws at B=64 against B=32,
    timed on the card.  The pair in (1) runs with cuDNN's autotuning off
    and its ``deterministic`` flag on.  cuDNN keeps one plan per
    convolution key (shapes, pointer alignment, ``deterministic``) for the
    process, found by timing where autotuning is on and by its heuristics
    where it is off, and reuses it whatever the flag.  A key that one run
    of the pair misses would be timed anew, or meet a plan the earlier
    phases timed, and the two runs could differ in the last bits; with
    ``deterministic`` on no earlier phase's key is met, and a miss takes
    the heuristics' plan every time.  (1) asks whether world-1 data
    parallelism is the plain run's computation, so it needs the same
    plans in both."""
    import numpy as np
    import torch
    from tacotron2_vae_torch import profile_train as pt
    from tacotron2_vae_torch.parallel import mesh
    from tacotron2_vae_torch.training import train as tr

    flist = pt.synthetic_corpus(tmp, DP_ITERS * hp.batch_size, seed=SEED + 1, name="dp")
    cfg = hp.replace(training_files=flist, validation_files=flist, epochs=1,
                     iters_per_checkpoint=10 ** 6, log_fetch_window=2, cudnn_benchmark=False)

    def csv_rows(out):
        with open(os.path.join(out, "logs", "metrics.csv")) as f:
            return [line.split(",")[:3] for line in f.readlines()[1:]]

    plain_out, dp_out = os.path.join(tmp, "dp_plain"), os.path.join(tmp, "dp_world1")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    try:
        tr.train(plain_out, "logs", None, False, cfg, device=str(device))
        os.environ.update(env)
        tr.train(dp_out, "logs", None, False, cfg, device=str(device))
        backend = torch.distributed.get_backend()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        mesh.shutdown()
        for k in env:
            os.environ.pop(k, None)
    plain, world1 = csv_rows(plain_out), csv_rows(dp_out)

    batch = fixed_batch(hp, device)
    npz = os.path.join(tmp, "dp_batch.npz")
    np.savez(npz, **{k: v.cpu().numpy() for k, v in batch.items()})
    common = ["--batch", npz, "--full-width", "--steps", str(DP_STEPS)]
    ranks = run_ranks({"one": _grid_cmd((1, 1), [*common, "--out",
                                                 os.path.join(tmp, "dp_one.pt")]),
                       "two": _grid_cmd((2, 1), [*common, "--out",
                                                 os.path.join(tmp, "dp_two.pt")], gloo=True)},
                      tmp, "chip_smoke_dp.log", timeout=300)

    B, S, T = TRAIN_SHAPE
    draws = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    for rows in (B // 2, B):
        n = _draw_elements(hp, rows, S, T)
        torch.rand(n, generator=gen, device=device)
        draws[rows] = cuda_ms(lambda: torch.rand(n, generator=gen, device=device), 20)
    one, two = ranks["one"][0], ranks["two"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(two[0]["loss"], one["loss"]))
    saved = {name: torch.load(os.path.join(tmp, f"dp_{name}.pt"), weights_only=True)
             for name in ("one", "two")}
    state_err = state_rel_err(saved["one"], saved["two"])
    row = {"phase": "train_dp", "world1_backend": backend, "world1_iterations": len(world1),
           "world1_equal": world1 == plain, "world1_rows": world1,
           "two_ranks": {"backend": "gloo", "B": B, "rows_per_rank": B // 2,
                         "steps": DP_STEPS, "loss_one": one["loss"],
                         "loss_two": [r["loss"] for r in two],
                         "grad_norm_one": one["grad_norm"],
                         "grad_norm_two": [r["grad_norm"] for r in two],
                         "loss_rel_err": loss_err, "loss_rtol": DP_LOSS_RTOL,
                         "state_rel_err": state_err, "state_rtol": DP_STATE_RTOL,
                         "launches": [r["launches"] for r in two]},
           "draw_elements_per_step": {"rank_rows": _draw_elements(hp, B // 2, S, T),
                                      "global_rows": _draw_elements(hp, B, S, T)},
           "draw_ms_per_step": {"rank_rows": draws[B // 2], "global_rows": draws[B]}}
    print(json.dumps(row), flush=True)
    if backend != "nccl" or len(world1) != DP_ITERS or world1 != plain:
        raise AssertionError(f"world-1 train() differs from the plain run: {world1} {plain}")
    if len(two) != 2 or any(r["world"] != 2 for r in two):
        raise AssertionError(f"the two-rank run did not report two ranks: {two}")
    if (two[0]["loss"] != two[1]["loss"] or loss_err > DP_LOSS_RTOL
            or state_err > DP_STATE_RTOL):
        raise AssertionError(f"two ranks do not match one process: {row['two_ranks']}")
    if any(min(r["launches"]["K3"], r["launches"]["K4"]) < DP_STEPS for r in two):
        raise AssertionError(f"a rank did not run through K3/K4: {row['two_ranks']}")
    return row


# ---------------------------------------------------------- the model axis

TP_STEPS = 3                   # steps of the Tacotron2 grid runs against one process
TP_GRIDS = ((1, 2), (2, 2))    # (data, model): gloo ranks sharing the card
WG_TP = (4, 16000, 2)          # WaveGlow grid runs: batch, segment samples, steps
WG_TP_GRIDS = ((2, 1), (1, 2))
# float32 WaveGlow on the grid against one process after WG_TP steps: the
# loss (the row sums partial products in another order), and the state as
# DP_STATE_RTOL measures it (Adam moves an element whose gradient is
# rounding noise by up to lr either way).  Set from the prediction written
# into PERF.md (section 6) before the first run on the card.
WG_TP_LOSS_RTOL = 1e-4
WG_TP_STATE_RTOL = 0.05
WG_CLI = (4, 16000, 20, 10)    # train_waveglow: batch, segment, steps, checkpoint every


def tp_tacotron2(hp, device, tmp):
    """The full-width fixed batch, ``TP_STEPS`` steps, at each of
    ``TP_GRIDS`` (every rank a gloo process on the card) and in one
    process on all 64 rows; and ``train()`` itself at 1x2 (the dryrun's
    corpus mode: full width, 8 clips, batch 4, 2 epochs); all started at
    once."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.tools import multihost_dryrun as mh

    work = os.path.join(tmp, "tp_corpus")
    mh.make_corpus(work)
    batch = fixed_batch(hp, device)
    npz = os.path.join(tmp, "tp_batch.npz")
    np.savez(npz, **{k: v.cpu().numpy() for k, v in batch.items()})
    cmds = {}
    for grid in ((1, 1),) + TP_GRIDS:
        name = f"{grid[0]}x{grid[1]}"
        args = ["--batch", npz, "--full-width", "--steps", str(TP_STEPS),
                "--out", os.path.join(tmp, f"tp_{name}.pt")]
        if grid[1] > 1:
            args += ["--hparams", f"mesh_model={grid[1]}"]
        cmds[name] = _grid_cmd(grid, args)
    cmds["train"] = _grid_cmd((1, 2), ["--workdir", work, "--full-width",
                                       "--hparams", "mesh_model=2"])
    ranks = run_ranks(cmds, tmp, "chip_smoke_tp.log")
    one = ranks["1x1"][0]
    saved_one = torch.load(os.path.join(tmp, "tp_1x1.pt"), weights_only=True)
    rows, failures = [], []
    for grid in TP_GRIDS:
        name = f"{grid[0]}x{grid[1]}"
        got = ranks[name]
        saved = torch.load(os.path.join(tmp, f"tp_{name}.pt"), weights_only=True)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got[0]["loss"], one["loss"]))
        state_err = state_rel_err(saved_one, saved)
        split_one = sum(v.numel() * 4 * 3 for k, v in saved_one["state_dict"].items()
                        if _tp_split(k))
        row = {"grid": name, "ranks": len(got), "rows_per_rank": got[0]["rows"],
               "loss_one": one["loss"], "loss": [r["loss"] for r in got],
               "loss_rel_err": loss_err, "loss_rtol": DP_LOSS_RTOL,
               "state_rel_err": state_err, "state_rtol": DP_STATE_RTOL,
               "bytes_one": one["bytes"], "bytes_rank": [r["bytes"] for r in got],
               "split_bytes_one": split_one,
               "split_bytes_rank": [r["split_bytes"] for r in got],
               "s_per_step_one": one["s_per_step"],
               "s_per_step_rank": [r["s_per_step"] for r in got],
               "launches": [r["launches"] for r in got]}
        rows.append(row)
        if len(got) != grid[0] * grid[1] or any(r["loss"] != got[0]["loss"] for r in got):
            failures.append(f"{name}: a rank is missing or the ranks' losses disagree")
        if loss_err > DP_LOSS_RTOL or state_err > DP_STATE_RTOL:
            failures.append(f"{name}: does not match one process")
        if any(r["split_bytes"] * grid[1] != split_one for r in got):
            failures.append(f"{name}: a rank does not store 1/{grid[1]} of the split weights")
        if any(min(r["launches"]["K3"], r["launches"]["K4"]) < TP_STEPS for r in got):
            failures.append(f"{name}: a rank did not run through K3/K4")
    entry = ranks["train"]
    rows.append({"grid": "1x2", "entry": "train()", "ranks": len(entry),
                 "iterations": [r["iters"] for r in entry],
                 "launches": [r["launches"] for r in entry]})
    if len(entry) != 2 or any(r["iters"] != 4 or min(r["launches"]["K3"],
                                                      r["launches"]["K4"]) < 4 for r in entry):
        failures.append(f"train() at 1x2 did not take its 4 steps through K3/K4: {rows[-1]}")
    return rows, failures


def _tp_split(name):
    from tacotron2_vae_torch.parallel import mesh

    return mesh.tacotron2_spec(name) is not None and "running" not in name


def tp_waveglow(device, tmp):
    """A full-width WaveGlow (random weights, ``end`` not zero), batch 4
    of 16000-sample segments with mels through K2, ``WG_TP`` steps with
    the CLI's clip at each of ``WG_TP_GRIDS`` against one process."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.ops import stft_mel as sm

    B, n, steps = WG_TP
    wg = random_waveglow()
    init = os.path.join(tmp, "wg_init.pt")
    torch.save(wg.state_dict(), init)
    rng = np.random.RandomState(SEED)
    t = np.arange(n) / 16000
    audio = np.stack([0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t) + 0.02 * rng.randn(n)
                      for i in range(B)]).astype(np.float32)
    mel = torch.cat([sm.mel_spectrogram_fused(torch.from_numpy(a).to(device)) for a in audio])
    npz = os.path.join(tmp, "wg_batch.npz")
    np.savez(npz, audio=audio, mel=mel.cpu().numpy())
    cmds = {}
    for grid in ((1, 1),) + WG_TP_GRIDS:
        name = f"{grid[0]}x{grid[1]}"
        cmds[name] = _grid_cmd(grid, [
            "--waveglow", "--batch", npz, "--init", init, "--steps", str(steps),
            "--clip", "1.0", "--mesh-model", str(grid[1]),
            "--out", os.path.join(tmp, f"wg_{name}.pt")])
    ranks = run_ranks(cmds, tmp, "chip_smoke_tp_waveglow.log")
    one = ranks["1x1"][0]
    saved_one = torch.load(os.path.join(tmp, "wg_1x1.pt"), weights_only=True)
    rows, failures = [], []
    for grid in WG_TP_GRIDS:
        name = f"{grid[0]}x{grid[1]}"
        got = ranks[name]
        saved = torch.load(os.path.join(tmp, f"wg_{name}.pt"), weights_only=True)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got[0]["loss"], one["loss"]))
        state_err = state_rel_err(saved_one, saved)
        row = {"grid": name, "ranks": len(got), "loss_one": one["loss"],
               "loss": [r["loss"] for r in got], "grad_norm_one": one["grad_norm"],
               "grad_norm": [r["grad_norm"] for r in got],
               "loss_rel_err": loss_err, "loss_rtol": WG_TP_LOSS_RTOL,
               "state_rel_err": state_err, "state_rtol": WG_TP_STATE_RTOL,
               "bytes_one": one["bytes"], "bytes_rank": [r["bytes"] for r in got],
               "split_bytes_rank": [r["split_bytes"] for r in got],
               "s_per_step_one": one["s_per_step"],
               "s_per_step_rank": [r["s_per_step"] for r in got]}
        rows.append(row)
        if not all(all(r["updated"]) for r in got + [one]):
            failures.append(f"WaveGlow {name}: a step was skipped")
        if loss_err > WG_TP_LOSS_RTOL or state_err > WG_TP_STATE_RTOL:
            failures.append(f"WaveGlow {name}: does not match one process")
    return rows, failures


def waveglow_cli_args(tmp, every):
    """The filelist of 8 synthetic wavs that ``tools/train_waveglow.py``
    trains on here (written into ``tmp``), and the CLI's data flags: batch
    and segment of ``WG_CLI``, a checkpoint every ``every`` steps."""
    import numpy as np

    B, n, _, _ = WG_CLI
    rng = np.random.RandomState(SEED + 2)
    flist = os.path.join(tmp, "wg_train.txt")
    with open(flist, "w", encoding="utf-8") as f:
        for i in range(8):
            p = os.path.join(tmp, f"wg_clip{i}.wav")
            write_wav(p, 1.5 + 0.1 * i, 140 + 30 * i, rng)
            f.write(f"{p}|{TEXT}|0|0\n")
    return ["--filelist", flist, "--batch", str(B), "--segment", str(n),
            "--checkpoint_every", str(every)]


def tp_waveglow_cli(model, hp, device, tmp):
    """``tools/train_waveglow.py`` on the card, full width, on 8 synthetic
    wavs: ``WG_CLI`` steps with a checkpoint halfway; a resume from it to
    the end, whose state must match the uninterrupted run's; the
    export-only call in float16; ``Synthesizer.load`` of that export
    vocodes a 600-frame mel."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer
    from tacotron2_vae_torch.tools import train_waveglow as tw

    B, n, steps, every = WG_CLI
    common = waveglow_cli_args(tmp, every)
    full, part = os.path.join(tmp, "wg_full"), os.path.join(tmp, "wg_part")
    start = time.perf_counter()
    last = tw.train_waveglow(tw.parse_args(["--output_dir", full, "--steps", str(steps),
                                            *common]))
    seconds = time.perf_counter() - start
    resumed = tw.train_waveglow(tw.parse_args([
        "--output_dir", part, "--steps", str(steps), "--resume",
        os.path.join(full, f"waveglow_{every}"), *common]))
    a = torch.load(os.path.join(full, f"waveglow_{steps}"), weights_only=True)
    b = torch.load(os.path.join(part, f"waveglow_{steps}"), weights_only=True)
    first = torch.load(os.path.join(full, f"waveglow_{every}"), weights_only=True)
    err = state_rel_err({"state_dict": a["state_dict"], "init_state_dict": first["state_dict"]},
                        {"state_dict": b["state_dict"], "init_state_dict": first["state_dict"]})
    pkl = os.path.join(tmp, "wg_export16.pkl")
    tw.train_waveglow(tw.parse_args(["--output_dir", os.path.join(tmp, "wg_only"),
                                     "--steps", "0", "--resume",
                                     os.path.join(full, f"waveglow_{steps}"), "--export", pkl,
                                     "--export_dtype", "float16", *common]))
    ckpt = os.path.join(tmp, "tp_t2.pt")
    torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
    synth = Synthesizer(hp, device=device)
    synth.load(ckpt, pkl, centroid_filelist=os.path.join(tmp, "none.txt"))
    mel = np.random.RandomState(SEED).randn(1, hp.n_mel_channels, WG_MEL_FRAMES) - 4.0
    wav = synth.vocode(mel.astype(np.float32))
    row = {"phase": "train_waveglow_cli", "B": B, "segment": n, "steps": steps,
           "s_per_step_first_run": seconds / steps,
           "steps_per_sec_after_first": last["steps_per_sec"], "final_loss": last["final_loss"],
           "resumed_final_loss": resumed["final_loss"], "resume_state_rel_err": err,
           "resume_state_rtol": WG_TP_STATE_RTOL, "export_bytes": os.path.getsize(pkl),
           "vocoded_samples": int(wav.shape[0]),
           "vocoded_finite": bool(np.isfinite(wav).all())}
    failures = []
    if NCCL:  # the CLI on a 2x2 grid, a rank a card
        out = os.path.join(tmp, "wg_grid")
        log = run_ranks({"cli": _grid_cmd((2, 2), ["--output_dir", out, "--steps", str(steps),
                                                   "--mesh", "2,2", *common],
                                          module="tacotron2_vae_torch.tools.train_waveglow")},
                        tmp, "chip_smoke_tp_cli.log")
        with open(os.path.join(OUT_DIR, "chip_smoke_tp_cli.log")) as f:
            grid_last = json.loads([line for line in f if line.startswith('{"final_loss"')][-1])
        row["grid_2x2"] = grid_last
        if not math.isfinite(grid_last["final_loss"]) or log["cli"]:
            failures.append("train_waveglow --mesh 2,2 failed")
    if err > WG_TP_STATE_RTOL or not math.isfinite(last["final_loss"]):
        failures.append("train_waveglow: the resumed run left the uninterrupted one")
    if synth.vocoder is None or wav.shape[0] != WG_MEL_FRAMES * hp.hop_length \
            or not row["vocoded_finite"]:
        failures.append("train_waveglow: the export did not vocode")
    return row, failures


def train_tp(model, hp, device, tmp):
    """The mesh's model axis on the one card: ``tp_tacotron2``,
    ``tp_waveglow`` and ``tp_waveglow_cli``; one JSON row."""
    import torch
    from tacotron2_vae_torch.ops import stft_mel as sm

    sm.mel_spectrogram_fused.launches = 0
    t2, f1 = tp_tacotron2(hp, device, tmp)
    torch.cuda.empty_cache()
    wg, f2 = tp_waveglow(device, tmp)
    torch.cuda.empty_cache()
    cli, f3 = tp_waveglow_cli(model, hp, device, tmp)
    row = {"phase": "train_tp", "backend": "nccl" if NCCL else "gloo",
           "cards": torch.cuda.device_count(), "tacotron2": t2, "waveglow": wg, "cli": cli,
           "k2_launches": sm.mel_spectrogram_fused.launches}
    print(json.dumps(row), flush=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_tp.json"), "w") as f:
        json.dump(row, f, indent=1)
    failures = f1 + f2 + f3
    if failures:
        raise AssertionError(f"model-axis checks failed: {failures}")
    return row


# ------------------------------------------------------------------- serve


def write_wav(path, seconds, freq, rng, sr=16000):
    import numpy as np
    from scipy.io import wavfile

    t = np.arange(int(seconds * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.02 * rng.randn(len(t)))
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def random_waveglow():
    """A full-width WaveGlow with random weights from the seed, on the CPU.
    The JAX-style init zeroes every ``end``, which makes each coupling the
    identity; a random ``end`` makes the WaveNets count.  Its scale, 0.01
    (``profile_vocoder.END_SCALE``), gives log_s a spread of ~0.23; at 0.05
    (the tiny CPU tests' scale) the full-width flow is chaotic (log_s ~1.2,
    |audio| ~1e6, and a 1e-6 change of z moves the audio by ~3e-3 of its
    scale), which would hide a kernel's error behind the flow's own."""
    import torch
    from tacotron2_vae_torch.models.waveglow import WaveGlow, init_weights
    from tacotron2_vae_torch.profile_vocoder import END_SCALE

    wg = init_weights(WaveGlow(), torch.Generator().manual_seed(SEED), end_scale=END_SCALE)
    return wg.eval().requires_grad_(False)


def serve_files(model, wg, tmp):
    """The checkpoint, the WaveGlow pickle, a centroid manifest and a
    reference wav, written into ``tmp``."""
    import pickle

    import numpy as np
    import torch
    from tacotron2_vae_torch.convert import to_jax_waveglow

    rng = np.random.RandomState(SEED)
    ckpt = os.path.join(tmp, "checkpoint_random.pt")
    torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
    wg_path = os.path.join(tmp, "waveglow_random.pkl")
    with open(wg_path, "wb") as f:
        pickle.dump({"waveglow": to_jax_waveglow(wg.state_dict()),
                     "config": wg.cfg.__dict__}, f)
    manifest = os.path.join(tmp, "manifest_test.txt")
    with open(manifest, "w", encoding="utf-8") as f:
        for i in range(8):
            p = os.path.join(tmp, f"clip{i}.wav")
            write_wav(p, 1.0 + 0.1 * i, 150 + 40 * i, rng)
            f.write(f"{p}|{TEXT}|0|{i % 4}\n")
    ref = os.path.join(tmp, "ref.wav")
    write_wav(ref, 2.0, 180, rng)
    return ckpt, wg_path, manifest, ref


def serve_requests(synth, hp, tmp, ref, vocoder):
    """The four kinds of request through ``synth``: one JSON row each with
    decode time, vocoder time and RTF."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    decode, vocode = [], []
    inner_mel, inner_voc = synth.synthesize_mel_batch, synth.vocode

    def timed_mel_batch(texts, styles):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = inner_mel(texts, styles)
        decode.append((time.perf_counter() - t0, items))
        return items

    def timed_vocode(mel, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = inner_voc(mel, *args, **kw)  # a host array: the card is done
        vocode.append(time.perf_counter() - t0)
        return wav

    synth.synthesize_mel_batch, synth.vocode = timed_mel_batch, timed_vocode
    results = []

    def run(name, fn, paths):
        decode.clear()
        vocode.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (dec_s, items), = decode
        frames = [it[4] for it in items]
        audio_s = 0.0
        for path, it in zip(paths, items):
            sr, wav = wavfile.read(path)
            mel_post = it[1]
            if not (np.isfinite(it[0]).all() and np.isfinite(mel_post).all()):
                raise AssertionError(f"{name}: non-finite mel")
            if mel_post.shape != (1, hp.n_mel_channels, it[4]) or it[4] < 1:
                raise AssertionError(f"{name}: mel shape {mel_post.shape}")
            if len(wav) < (it[4] - 1) * hp.hop_length or not np.isfinite(wav).all():
                raise AssertionError(f"{name}: wav of {len(wav)} samples")
            audio_s += len(wav) / sr
        row = {"request": name, "vocoder": vocoder, "rows": len(items), "frames": frames,
               "decode_s": dec_s, "decode_us_per_frame": dec_s * 1e6 / max(frames),
               "vocode_s": sum(vocode), "vocoder_ms_per_audio_s": sum(vocode) * 1e3 / audio_s,
               "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s}
        print(json.dumps(row), flush=True)
        results.append(row)

    out = [os.path.join(tmp, f"{vocoder}_out{i}.wav") for i in range(8)]
    run("synthesize_ref", lambda: synth.synthesize(TEXT, out[0], True, ref, None), out[:1])
    run("synthesize_ratios", lambda: synth.synthesize(
        TEXT, out[1], False, None, [0.1, 0.6, 0.2, 0.1]), out[1:2])

    def interp():
        style = synth.interpolate("neu", "sad", 0.5)
        mel, mel_post, *_ = synth.synthesize_mel(TEXT, style)
        wavfile.write(out[2], hp.sampling_rate,
                      (np.clip(synth.vocode(mel_post), -1, 1) * 32767).astype(np.int16))

    run("interpolate", interp, out[2:3])
    reqs = [(TEXTS[i], out[4 + i], i % 2 == 0, ref if i % 2 == 0 else None,
             None if i % 2 == 0 else [0.25, 0.25, 0.25, 0.25]) for i in range(4)]
    run("synthesize_batch_4", lambda: synth.synthesize_batch(reqs), out[4:8])
    synth.synthesize_mel_batch, synth.vocode = inner_mel, inner_voc
    return results


def waveglow_flops(cfg, frames):
    """(bf16-able, float32) operations of one ``infer`` on ``frames`` mel
    frames: the WaveNet convolutions, and the upsampler plus 1x1 mixing."""
    T = frames * cfg.upsample_stride // cfg.n_group
    nc, L, K = cfg.n_channels, cfg.n_layers, cfg.kernel_size
    wavenet = mixing = 0
    for c in cfg.audio_channels():
        h = c // 2
        wavenet += 2 * T * (h * nc + cfg.n_mel_channels * cfg.n_group * 2 * nc * L
                            + L * K * nc * 2 * nc + (L - 1) * nc * 2 * nc + nc * nc + nc * 2 * h)
        mixing += 2 * T * c * c
    up = 2 * frames * cfg.n_mel_channels ** 2 * cfg.upsample_kernel
    return float(wavenet), float(mixing + up)


def vocoder_phase(wg, device):
    """The WaveGlow alone on a 600-frame mel, float32 and bf16 (CUDA events,
    bound from the shapes), and the card's float32 inverse against the same
    module on the CPU on a short mel with a fixed z."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    card = copy.deepcopy(wg).to(device)
    w_inv = card.inverse_weights()
    mel = torch.from_numpy((-6 + 2 * rng.rand(1, 80, WG_MEL_FRAMES)).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    weight_bytes = sum(p.numel() * 4 for p in card.parameters())
    wavenet, rest = waveglow_flops(card.cfg, WG_MEL_FRAMES)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        audio = card.infer(mel, 0.666, gen, dtype, w_inv)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(audio).all()) or audio.shape != (1, WG_MEL_FRAMES * 256):
            raise AssertionError(f"WaveGlow {name}: audio {tuple(audio.shape)} not finite")
        ms = cuda_ms(lambda: card.infer(mel, 0.666, gen, dtype, w_inv), 3)
        t_ops = wavenet / PEAK[name] + rest / PEAK["float32"]
        t_bytes = (weight_bytes + mel.numel() * 4 + audio.numel() * 4) / HBM_BYTES_PER_S
        row = {"phase": "vocoder", "dtype": name, "frames": WG_MEL_FRAMES, "ms": ms,
               "ms_per_audio_s": ms / (audio.shape[1] / 16000),
               "gflop": (wavenet + rest) / 1e9, "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(json.dumps(row), flush=True)
        rows.append(row)
    # the card's float32 WaveGlow against the CPU: a TF32 convolution would
    # show as ~1e-3, the card's float32 sum order as far less
    z = rng.randn(1, WG_CPU_FRAMES * 32, 8).astype(np.float32)
    short = rng.randn(1, 80, WG_CPU_FRAMES).astype(np.float32) - 5
    got = card.inverse(torch.from_numpy(z).to(device), torch.from_numpy(short).to(device),
                       w_inv=w_inv).cpu()
    t0 = time.perf_counter()
    want = wg.inverse(torch.from_numpy(z), torch.from_numpy(short))
    cpu_s = time.perf_counter() - t0
    err = float((got - want).abs().max()) / float(want.abs().max())
    row = {"phase": "vocoder_vs_cpu", "frames": WG_CPU_FRAMES, "rel_err": err,
           "tol": WG_CPU_TOL, "cpu_s": cpu_s, "max_abs_audio": float(want.abs().max())}
    print(json.dumps(row), flush=True)
    rows.append(row)
    if not err <= WG_CPU_TOL:
        raise AssertionError(f"the card's WaveGlow disagrees with the CPU: {row}")
    return rows


def http_phase(synth, tmp):
    """``make_server(0)`` with ``synth``: 4 concurrent ``POST /api`` and one
    ``GET /generate``; every reply a finite wav, one K1 launch per batch, a
    batch of >= 2 requests."""
    import base64
    import io
    import threading
    import urllib.request
    from urllib.parse import quote

    import numpy as np
    from scipy.io import wavfile
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.serving import app

    app.synthesizer, app._WEB, app._batcher = synth, os.path.join(tmp, "web"), None
    sizes = []
    inner = synth.synthesize_batch

    def spy(reqs, **kw):
        t0 = time.perf_counter()
        out = inner(reqs, **kw)
        sizes.append(len(reqs))
        batch_s.append(time.perf_counter() - t0)
        return out

    batch_s = []
    synth.synthesize_batch = spy
    server = app.make_server(0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    replies, errors = {}, []

    def hit(i):
        t0 = time.perf_counter()
        try:
            if i < 4:
                body = json.dumps({"text": TEXTS[i], "neu": 1, "sad": i, "hap": 0, "ang": 1})
                req = urllib.request.Request(f"{base}/api", data=body.encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    status, data = r.status, base64.b64decode(json.loads(r.read())["data"])
            else:
                url = f"{base}/generate?text={quote(TEXT)}&n=1&s=0&h=1&a=0"
                with urllib.request.urlopen(url, timeout=300) as r:
                    status, data = r.status, r.read()
            sr, wav = wavfile.read(io.BytesIO(data))
            ok = status == 200 and sr == 16000 and len(wav) > 0 and bool(np.isfinite(wav).all())
            replies[i] = {"status": status, "samples": len(wav), "ok": ok,
                          "latency_s": time.perf_counter() - t0}
        except Exception as e:  # noqa: BLE001 - every failure is raised below
            errors.append((i, repr(e)))

    k1_before = dl.decode_loop.launches
    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        server.shutdown()
        server.server_close()
        synth.synthesize_batch = inner
    row = {"phase": "http", "batches": sizes, "batch_s": batch_s,
           "k1_launches": dl.decode_loop.launches - k1_before,
           "replies": replies, "errors": errors}
    print(json.dumps(row), flush=True)
    if errors or len(replies) != 5 or not all(r["ok"] for r in replies.values()):
        raise AssertionError(f"HTTP requests failed: {row}")
    if max(sizes) < 2 or row["k1_launches"] != len(sizes):
        raise AssertionError(f"the micro-batcher did not group requests into K1 launches: {row}")
    return row


def waveglow_train(wg, device):
    """3 full-width ``make_waveglow_train_step`` steps at batch 4 on
    16000-sample segments of synthetic audio, mels through K2."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.models.waveglow import WaveGlow, make_waveglow_train_step
    from tacotron2_vae_torch.ops import stft_mel as sm

    B, n, steps = WG_TRAIN
    model = WaveGlow(wg.cfg)
    model.load_state_dict(wg.state_dict())
    model = model.to(device).train()
    step = make_waveglow_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-4,
                                                            fused=True))
    rng = np.random.RandomState(SEED)
    t = np.arange(n) / 16000
    audio = torch.from_numpy(np.stack([
        0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t) + 0.02 * rng.randn(n) for i in range(B)
    ]).astype(np.float32)).to(device)
    mel = torch.cat([sm.mel_spectrogram_fused(a) for a in audio])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(audio, mel))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    row = {"phase": "waveglow_train", "B": B, "samples": n, "mel_frames": mel.shape[2],
           "ms_per_step_each": times, "ms_per_step_after_first": sum(times[1:]) / (steps - 1),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics]}
    print(json.dumps(row), flush=True)
    if not all(m["updated"] == 1.0 and math.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"WaveGlow train steps not finite: {row}")
    return row


def serve_phase(model, hp, device, tmp):
    """Griffin-Lim requests, WaveGlow requests (float32, bf16), the vocoder
    alone, the HTTP API, WaveGlow train steps.  K1, K2, K7 and K8 launches
    are counted over the whole phase: every decode (K1) follows its
    batch's encoder call, which must run K7, and serving runs no K8."""
    import torch
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.ops import encoder_lstm as el
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer

    wg = random_waveglow()
    ckpt, wg_path, manifest, ref = serve_files(model, wg, tmp)
    dl.decode_loop.launches = dl.decode_loop.tail_launches = 0
    sm.mel_spectrogram_fused.launches = 0
    el.lstm_fwd.launches = el.lstm_bwd.launches = 0
    synth = Synthesizer(hp, device=device)
    synth.load(ckpt, centroid_filelist=manifest)
    if not synth.centroids_loaded:
        raise AssertionError("centroid precompute embedded no clips")
    results = serve_requests(synth, hp, tmp, ref, "griffin_lim")
    del synth
    synth = Synthesizer(hp, device=device)
    synth.load(ckpt, wg_path, centroid_filelist=manifest)
    if synth.vocoder is None or synth.vocoder.module.cfg != wg.cfg:
        raise AssertionError("the WaveGlow pickle was not adopted")
    for dtype in (None, torch.bfloat16):
        synth.vocoder_dtype = dtype
        results += serve_requests(synth, hp, tmp, ref,
                                  "waveglow_" + ("bfloat16" if dtype else "float32"))
    synth.vocoder_dtype = None
    http = http_phase(synth, tmp)
    launches = {"K1": dl.decode_loop.launches, "K2": sm.mel_spectrogram_fused.launches,
                "tail_kernel": dl.decode_loop.tail_launches, "K7": el.lstm_fwd.launches,
                "K8": el.lstm_bwd.launches}
    if (launches["K1"] < 4 or launches["K2"] < 1 or launches["tail_kernel"] < 1
            or launches["K7"] < launches["K1"] or launches["K8"]):
        raise AssertionError(f"serving did not run through the kernels: {launches}")
    del synth
    torch.cuda.empty_cache()
    vocoder = vocoder_phase(wg, device)
    train = waveglow_train(wg, device)
    return results + vocoder + [http, train], launches


# ------------------------------------------------------------------- tools


# smoke_train (tools/smoke_train.py) at full width, B=16, S=32, T=128: steps
# of the bf16 run and of the fp16_run one, and the limits the bf16 run must
# clear.  A correct run read a loss ratio of 0.61-0.64 and a diagonality of
# 0.91 at 600 steps; chance diagonality is ~5/32 = 0.16 (PERF.md section 6
# gives the card's readings and a planted learning fault's)
SMOKE_STEPS = {"bfloat16": 600, "fp16_run": 200}
SMOKE_LOSS_RATIO_MAX = 0.8
SMOKE_DIAG_MIN = 0.5
WG_EVAL_STEPS, WG_EVAL_EVERY = 6, 2    # train_waveglow run that waveglow_eval reads


def smoke_runs(card):
    """``tools/smoke_train.py`` through its ``main`` on the card: bf16 at
    r=1, then ``fp16_run``; one row each.  The bf16 loss must fall below
    ``SMOKE_LOSS_RATIO_MAX`` of its 25th step's and its attention be
    diagonal above ``SMOKE_DIAG_MIN``; the fp16_run loss must be finite
    and fall."""
    from tacotron2_vae_torch.tools import smoke_train

    rows, failures = [], []
    for name, steps in SMOKE_STEPS.items():
        argv = ["--steps", str(steps)] + (["--hparams", "fp16_run=True"]
                                          if name == "fp16_run" else [])
        t0 = time.perf_counter()
        summary = smoke_train.main(argv)
        row = {"phase": "tool_smoke_train", "run": name, "wall_s": time.perf_counter() - t0,
               "card": card, **summary}
        print(json.dumps(row), flush=True)
        rows.append(row)
        losses = (summary["loss_first25"], summary["loss_final"])
        if not all(math.isfinite(x) for x in losses) or not summary["loss_ratio"] < 1.0:
            failures.append(f"smoke_train {name}: loss not finite or not falling {losses}")
        if name == "bfloat16" and not (summary["loss_ratio"] < SMOKE_LOSS_RATIO_MAX
                                       and summary["alignment_diagonality"] > SMOKE_DIAG_MIN):
            failures.append(f"smoke_train {name}: loss ratio {summary['loss_ratio']} "
                            f"(limit {SMOKE_LOSS_RATIO_MAX}), diagonality "
                            f"{summary['alignment_diagonality']} (limit {SMOKE_DIAG_MIN})")
    return rows, failures


def inference_runs(model, wg, hp, tmp, card):
    """``tools/inference_demo.py``'s four modes through its ``main`` on the
    card, on the serve phase's files (full-width random weights, the
    random WaveGlow pickle, the four-emotion manifest, the reference wav);
    one row each.  Every wav finite with T * hop samples for the T frames
    each vocode call got; latents of shape (clips, z)."""
    import numpy as np
    from scipy.io import wavfile
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer
    from tacotron2_vae_torch.tools import inference_demo

    ckpt, wg_path, manifest, ref = serve_files(model, wg, tmp)
    frames, finite = [], []
    vocode = Synthesizer.vocode

    def counted(self, mel, *args, **kw):
        wav = vocode(self, mel, *args, **kw)
        frames.append(mel.shape[2])
        finite.append(bool(np.isfinite(wav).all()))
        return wav

    modes = {"latents": [], "ref": ["--ref_audio", ref],
             "interp": ["--from", "neu", "--to", "sad"], "mix": ["--ratios", "0.1,0.6,0.2,0.1"]}
    rows, failures = [], []
    Synthesizer.vocode = counted
    try:
        for mode, extra in modes.items():
            out = os.path.join(tmp, f"demo_{mode}")
            frames.clear()
            finite.clear()
            t0 = time.perf_counter()
            inference_demo.main([mode, "--checkpoint", ckpt, "--waveglow", wg_path,
                                 "--filelist", manifest, "--text", TEXT, "-o", out, *extra])
            wall = time.perf_counter() - t0
            files = sorted(os.listdir(out))
            row = {"phase": "tool_inference_demo", "mode": mode, "wall_s": wall, "card": card,
                   "files": files}
            if mode == "latents":
                with np.load(os.path.join(out, "latents.npz")) as d:
                    shapes = [d["mus"].shape, d["zs"].shape]
                    ok = bool(np.isfinite(d["mus"]).all() and np.isfinite(d["zs"]).all())
                row["latent_shapes"] = shapes
                if shapes != [(8, hp.z_latent_dim)] * 2 or not ok:
                    failures.append(f"inference_demo latents: {shapes}, finite {ok}")
            else:
                samples = [len(wavfile.read(os.path.join(out, name))[1]) for name in files]
                row.update(frames=list(frames), samples=samples)
                if not all(finite):
                    failures.append(f"inference_demo {mode}: a vocoded wav is not finite")
                if sorted(samples) != sorted(t * hp.hop_length for t in frames):
                    failures.append(f"inference_demo {mode}: {samples} samples for frames "
                                    f"{frames}")
                if mode == "interp" and len(files) != len(inference_demo.INTERP_RATIOS):
                    failures.append(f"inference_demo interp wrote {files}")
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        Synthesizer.vocode = vocode
    return rows, failures


def waveglow_eval_run(tmp, card):
    """``tools/train_waveglow.py`` at full width for ``WG_EVAL_STEPS`` steps
    (a checkpoint every ``WG_EVAL_EVERY``) and an export, through the CLI
    args of ``tp_waveglow_cli``; then ``tools/waveglow_eval.py`` on that
    run: one finite held-out NLL per checkpoint, three finite
    copy-synthesis rows."""
    from tacotron2_vae_torch.tools import train_waveglow as tw
    from tacotron2_vae_torch.tools import waveglow_eval

    common = waveglow_cli_args(tmp, WG_EVAL_EVERY)
    run, pkl = os.path.join(tmp, "wg_eval_run"), os.path.join(tmp, "wg_eval.pkl")
    t0 = time.perf_counter()
    tw.train_waveglow(tw.parse_args(["--output_dir", run, "--steps", str(WG_EVAL_STEPS),
                                     "--export", pkl, *common]))
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = waveglow_eval.main(["--export", pkl, "--ckpt_dir", run, "--filelist",
                                 common[1], "--out", os.path.join(OUT_DIR, "waveglow_eval.json")])
    row = {"phase": "tool_waveglow_eval", "train_waveglow_s": train_s,
           "wall_s": time.perf_counter() - t0, "card": card,
           "heldout_nll": report["heldout_nll"], "copy_synthesis": report["copy_synthesis"]}
    print(json.dumps(row), flush=True)
    failures = []
    steps = [r["step"] for r in report["heldout_nll"]]
    if steps != list(range(WG_EVAL_EVERY, WG_EVAL_STEPS + 1, WG_EVAL_EVERY)) or not all(
            r["nll"] is not None and math.isfinite(r["nll"]) for r in report["heldout_nll"]):
        failures.append(f"waveglow_eval NLL rows: {report['heldout_nll']}")
    scores = report["copy_synthesis"]
    if len(scores) != 3 or not all(math.isfinite(v) for r in scores.values() for v in r.values()):
        failures.append(f"waveglow_eval copy synthesis: {scores}")
    return row, failures


def tools_phase(model, hp, tmp, card):
    """The port's three tools through their ``main`` on the card:
    ``smoke_runs``, ``inference_runs``, ``waveglow_eval_run``.  K3/K4 are
    counted over smoke_train, K1 over inference_demo, K2 over inference_demo
    and waveglow_eval (each counter zeroed just before); each must launch."""
    import torch
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    t0 = time.perf_counter()
    tf.teacher_fwd.launches = tf.teacher_bwd.launches = 0
    smoke, f1 = smoke_runs(card)
    launches = {"K3": tf.teacher_fwd.launches, "K4": tf.teacher_bwd.launches}
    torch.cuda.empty_cache()
    dl.decode_loop.launches = dl.decode_loop.tail_launches = 0
    sm.mel_spectrogram_fused.launches = 0
    demo, f2 = inference_runs(model, random_waveglow(), hp, tmp, card)
    launches["K1"] = dl.decode_loop.launches
    launches["tail_kernel"] = dl.decode_loop.tail_launches
    k2_demo = sm.mel_spectrogram_fused.launches
    torch.cuda.empty_cache()
    sm.mel_spectrogram_fused.launches = 0
    wg_eval, f3 = waveglow_eval_run(tmp, card)
    k2_eval = sm.mel_spectrogram_fused.launches
    launches["K2"] = k2_demo + k2_eval
    failures = f1 + f2 + f3
    if min(launches.values()) < 1 or k2_demo < 1 or k2_eval < 1:
        failures.append(f"the tools did not run through the kernels: {launches}, K2 "
                        f"{k2_demo} in inference_demo, {k2_eval} in waveglow_eval")
    row = {"phase": "tools", "wall_s": time.perf_counter() - t0, "card": card,
           "launches": launches, "k2_inference_demo": k2_demo, "k2_waveglow_eval": k2_eval}
    print(json.dumps(row), flush=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_tools.json"), "w") as f:
        json.dump({"smoke_train": smoke, "inference_demo": demo, "waveglow_eval": wg_eval,
                   "tools": row}, f, indent=1)
    if failures:
        raise AssertionError(f"tool checks failed: {failures}")
    return row, launches

# The three study tools (studies_phase), at reduced depths: make_result_assets
# to its first validation point; curves_run for two epochs of 8 steps at
# B=64 on the full corpus, a checkpoint at step 8; bench_pooled on 64 clips.
STUDY_ASSETS_STEPS = 250
STUDY_CURVES_STEPS = 16
STUDY_CURVES_CKPT = 8
STUDY_BENCH_ARGS = ("--items", "64", "--steps", "8", "--batch", "16")


def _jax_tool_summary_keys(tool, function):
    """The keys of the ``summary`` dict in ``function`` of the JAX package's
    ``tools/<tool>.py``, read from its source (nothing of it is imported)."""
    import ast

    with open(os.path.join(ROOT, "tools", f"{tool}.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == function:
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Dict)
                        and getattr(sub.targets[0], "id", None) == "summary"):
                    return [k.value for k in sub.value.keys]
    raise AssertionError(f"no summary dict in tools/{tool}.py {function}")


def _finite_wav(path):
    import numpy as np
    from scipy.io import wavfile

    _sr, wav = wavfile.read(path)
    return wav.size > 0 and bool(np.isfinite(wav.astype(np.float64)).all())


def studies_phase(tmp, card, waveglow):
    """The port's study tools through their ``main`` on the card, at full
    model width, under ``tmp``: ``make_result_assets`` (K3, K4),
    ``curves_run all`` with ``waveglow`` as ``T2V_WAVEGLOW`` (K1-K4) and
    ``bench_pooled`` with the mel cache off, so its loader featurises each
    clip through K2 (K2-K4).  Each tool's counters are zeroed just before
    it; each of its kernels must launch.  Returns (row, launches summed)."""
    import torch
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.tools import bench_pooled, curves_run, make_result_assets

    counters = {"K1": dl.decode_loop, "K2": sm.mel_spectrogram_fused,
                "K3": tf.teacher_fwd, "K4": tf.teacher_bwd}

    def run(name, fn, kernels, depth):
        for c in counters.values():
            c.launches = 0
        dl.decode_loop.tail_launches = 0
        t0 = time.perf_counter()
        out = fn()
        row = {"phase": f"study_{name}", "wall_s": time.perf_counter() - t0, "card": card,
               "depth": depth, "launches": {k: counters[k].launches for k in counters}}
        row["launches"]["tail_kernel"] = dl.decode_loop.tail_launches
        missing = [k for k in kernels if row["launches"][k] < 1]
        if missing:
            failures.append(f"{name} did not launch {missing}: {row['launches']}")
        torch.cuda.empty_cache()
        return out, row

    failures, rows = [], []
    t_phase = time.perf_counter()

    res = os.path.join(tmp, "result_assets")
    summary, row = run("make_result_assets", lambda: make_result_assets.main(
        ["--steps", str(STUDY_ASSETS_STEPS), "--out", res]), ("K3", "K4"),
        {"steps": STUDY_ASSETS_STEPS, "batch": 16, "seq": 32, "compute_dtype": "bfloat16"})
    with open(os.path.join(res, "curves.json")) as f:
        curves = json.load(f)
    losses = curves["train"]["loss"] + curves["val"]["loss"]
    row.update(summary=summary, loss_25=curves["train"]["loss"][0],
               loss_250=curves["train"]["loss"][-1], val_loss=curves["val"]["loss"])
    if list(summary) != _jax_tool_summary_keys("make_result_assets", "main"):
        failures.append(f"make_result_assets summary keys {list(summary)}")
    if not (losses and all(math.isfinite(x) for x in losses)):
        failures.append(f"make_result_assets: a loss is not finite: {losses}")
    elif not row["loss_250"] < row["loss_25"] or len(curves["val"]["loss"]) != 1:
        failures.append(f"make_result_assets: loss at 250 {row['loss_250']} not below "
                        f"loss at 25 {row['loss_25']}, or validations {curves['val']}")
    print(json.dumps(row), flush=True)
    rows.append(row)

    work, cres, csam = (os.path.join(tmp, d) for d in ("curves", "curves_res", "curves_samples"))
    saved = {k: os.environ.get(k) for k in ("T2V_STEPS_TARGET", "T2V_WAVEGLOW")}
    os.environ.update(T2V_STEPS_TARGET=str(STUDY_CURVES_STEPS), T2V_WAVEGLOW=waveglow)
    try:
        report, row = run("curves_run", lambda: curves_run.main(
            ["all", "--workdir", work, "--res", cres, "--samples", csam,
             "--hparams", f"iters_per_checkpoint={STUDY_CURVES_CKPT}"]),
            ("K1", "K2", "K3", "K4"),
            {"T2V_STEPS_TARGET": STUDY_CURVES_STEPS, "batch": 64,
             "iters_per_checkpoint": STUDY_CURVES_CKPT, "corpus": "512 + 64 clips"})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assets = report["assets"]
    with open(os.path.join(work, "out", "logs", "metrics.csv")) as f:
        iters = [int(line.split(",")[0]) for line in f.readlines()[1:]]
    interp = [f"interp_sad{r:.2f}_hap{1 - r:.2f}.wav" for r in (1.0, 0.64, 0.34, 0.0)]
    want_samples = {"README.md", "latents.npz", "ref_conditioned.wav", "mix.wav", *interp}
    wavs = [n for n in report["samples"] if n.endswith(".wav")]
    row.update(iterations=len(iters), checkpoints=report["checkpoints"], assets=assets,
               samples=report["samples"])
    if iters != list(range(STUDY_CURVES_STEPS)):
        failures.append(f"curves_run metrics.csv iterations {iters}")
    if f"checkpoint_{STUDY_CURVES_CKPT}" not in report["checkpoints"]:
        failures.append(f"curves_run checkpoints {report['checkpoints']}")
    numbers = [assets.get(k) for k in ("steps", "batch", "final_train_loss_ema",
                                       "final_recon_loss_ema", "final_val_loss", "kl_final_ema")]
    # the run ends before the priced region (curves_run.PRICED_AFTER): no post-lag KL
    if (list(assets) != _jax_tool_summary_keys("curves_run", "run_assets")
            or not all(isinstance(v, (int, float)) and math.isfinite(v) for v in numbers)
            or assets["steps"] != STUDY_CURVES_STEPS or assets["kl_postlag_max_ema"] is not None):
        failures.append(f"curves_run assets summary: {assets}")
    if not want_samples <= set(report["samples"]) or not all(
            _finite_wav(os.path.join(csam, n)) for n in wavs):
        failures.append(f"curves_run samples {report['samples']}")
    print(json.dumps(row), flush=True)
    rows.append(row)

    bench, row = run("bench_pooled", lambda: bench_pooled.main(
        [*STUDY_BENCH_ARGS, "--hparams", "mel_cache=False"]), ("K2", "K3", "K4"),
        {"args": " ".join(STUDY_BENCH_ARGS), "hparams": "mel_cache=False"})
    row.update(result=bench)
    if not bench["padding_saving"] > 1:
        failures.append(f"bench_pooled padding_saving {bench['padding_saving']}")
    for tag in ("pooled", "unpooled"):
        sps = bench[f"steps_per_sec_{tag}"]
        if not (math.isfinite(sps) and sps > 0):
            failures.append(f"bench_pooled steps_per_sec_{tag} {sps}")
    print(json.dumps(row), flush=True)
    rows.append(row)

    launches = {k: sum(r["launches"][k] for r in rows) for k in (*counters, "tail_kernel")}
    phase = {"phase": "studies", "wall_s": time.perf_counter() - t_phase, "card": card,
             "tools_wall_s": {r["phase"][6:]: r["wall_s"] for r in rows},
             "launches": launches}
    print(json.dumps(phase), flush=True)
    for r in rows:
        print(f"{r['phase']}: {r['wall_s']:.1f} s | {card}", flush=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_studies.json"), "w") as f:
        json.dump({"rows": rows, "studies": phase}, f, indent=1, default=float)
    if failures:
        raise AssertionError(f"study checks failed: {failures}")
    return phase, launches


def studies_alone(tmp, card):
    """``studies_phase`` with a full-width random WaveGlow exported into
    ``tmp`` (the full run hands it ``waveglow_eval_run``'s export)."""
    from tacotron2_vae_torch.tools import train_waveglow

    wg = random_waveglow()
    pkl = os.path.join(tmp, "wg_random.pkl")
    train_waveglow.export(wg.state_dict(), wg.cfg, pkl, "float32")
    return studies_phase(tmp, card, pkl)


PHASE_S: dict = {}   # wall seconds of each phase of main(), in order


def timed(name, fn, *args, **kwargs):
    """Run one phase of ``main``, print ``{"phase_s": {"name": ..., "s": ...}}``
    for it and keep its time in ``PHASE_S``.  A failure propagates."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = time.perf_counter() - t0
    print(json.dumps({"phase_s": {"name": name, "s": PHASE_S[name]}}), flush=True)
    return out


def in_tmp(fn, *args):
    """``fn(*args, tmp)`` in a temporary directory, then the card's cache emptied."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        out = fn(*args, tmp)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    import tacotron2_vae_torch  # noqa: F401  (fails outside a checkout)
    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.ops import _build

    card = nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {card}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    names = (["reshape_probe"] if "--k56" in sys.argv[1:] else
             ["decoder_loop", "stft_mel"] if "--k12" in sys.argv[1:] else
             ["encoder_lstm"] if "--k78" in sys.argv[1:] else
             ["aa_snake"] if "--k9" in sys.argv[1:] else
             ["decoder_loop", "stft_mel", "teacher_fwd", "teacher_bwd", "encoder_lstm"]
             if "--fp16" in sys.argv[1:]
             else ["stft_mel", "teacher_fwd", "teacher_bwd", "encoder_lstm"] if "--tp" in sys.argv[1:]
             else ["decoder_loop", "stft_mel", "teacher_fwd", "teacher_bwd", "encoder_lstm"]
             if "--tools" in sys.argv[1:] or "--studies" in sys.argv[1:]
             else ["decoder_loop", "stft_mel", "teacher_fwd", "teacher_bwd", "encoder_lstm",
                   "reshape_probe"])
    logs = _build.build(names, verbose=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"built kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the default; K6's yardsticks need it
    if "--k9" in sys.argv[1:]:  # BigVGAN's activation kernel alone: checks and timings
        hp = create_hparams()
        with tempfile.TemporaryDirectory() as tmp:
            k9 = k9_phase(hp, random_model(hp, device), device, tmp)
        total = time.perf_counter() - t0
        print(f"chip_smoke --k9: {total:.1f} s in all | {card}", flush=True)
        print(json.dumps({"kernels": [k9]}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if "--k56" in sys.argv[1:]:  # the probe kernels' checks and timings alone
        k56_phase(device)
        probe_entry()
        return 0
    hp = create_hparams()
    model = random_model(hp, device)
    if "--dp" in sys.argv[1:]:  # the data-parallel checks alone
        with tempfile.TemporaryDirectory() as tmp:
            train_dp(hp, device, tmp)
        return 0
    if "--tp" in sys.argv[1:]:  # the model-axis checks alone
        if NCCL and torch.cuda.device_count() < 4:
            print("chip_smoke: --nccl needs 4 cards", file=sys.stderr)
            return 1
        with tempfile.TemporaryDirectory() as tmp:
            train_tp(model, hp, device, tmp)
        return 0
    if "--tools" in sys.argv[1:]:  # the three tools alone
        with tempfile.TemporaryDirectory() as tmp:
            tools_phase(model, hp, tmp, card)
        print(f"chip_smoke --tools: {time.perf_counter() - t0:.1f} s in all | {card}",
              flush=True)
        return 0
    if "--studies" in sys.argv[1:]:  # the three study tools alone
        with tempfile.TemporaryDirectory() as tmp:
            timed("studies", studies_alone, tmp, card)
        print(f"chip_smoke --studies: {time.perf_counter() - t0:.1f} s in all | {card}",
              flush=True)
        return 0
    if "--k34" in sys.argv[1:]:  # the recurrence kernels' checks alone
        k34_phase(model, device)
        return 0
    if "--k78" in sys.argv[1:]:  # the encoder LSTM kernels' checks and timings alone
        k78_phase(model, device)
        return 0
    if "--k12" in sys.argv[1:]:  # the decode-loop and log-mel kernels alone, then timed
        k12_phase(model, hp, device)
        return 0
    if "--fp16" in sys.argv[1:]:  # the float16 kernel checks and fp16_run alone
        kernels_phase(model, hp, device, k1_dtypes=("float16",), k2=False)
        k34_phase(model, device, dtypes=("float16",))
        train_fp16(hp, device)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            train_entry_fp16(hp, device, tmp)
        return 0
    PHASE_S["build"] = time.perf_counter() - t0
    print(json.dumps({"phase_s": {"name": "build", "s": PHASE_S["build"]}}), flush=True)
    report, rows = timed("kernels", kernels_phase, model, hp, device)
    k56, k56_rows = timed("k56", k56_phase, device)
    report.update(k56)
    k34, k34_rows = timed("k34", k34_phase, model, device)
    k78, k78_rows = timed("k78", k78_phase, model, device)
    steady = timed("steady_steps", steady_steps, hp, device)
    torch.cuda.empty_cache()
    fp16 = timed("train_fp16", train_fp16, hp, device)
    torch.cuda.empty_cache()
    entry = timed("train_entry", in_tmp, train_entry, hp, device)
    entry16 = timed("train_entry_fp16", in_tmp, train_entry_fp16, hp, device)
    pipeline = timed("train_pipeline", in_tmp, train_pipeline, hp, device)
    dp = timed("train_dp", in_tmp, train_dp, hp, device)
    tp = timed("train_tp", in_tmp, train_tp, model, hp, device)
    results, launches = timed("serve", in_tmp, serve_phase, model, hp, device)
    with tempfile.TemporaryDirectory() as tmp:
        tools, tool_launches = timed("tools", tools_phase, model, hp, tmp, card)
        torch.cuda.empty_cache()
        # curves_run vocodes with the export waveglow_eval_run leaves in tmp
        studies, study_launches = timed("studies", studies_phase, tmp, card,
                                        os.path.join(tmp, "wg_eval.pkl"))
    torch.cuda.empty_cache()
    probes = timed("probe_entry", probe_entry)
    launches.update({k: entry["launches"][k] for k in ("K3", "K4")}, **probes["launches"])
    for key in ("K7", "K8"):  # the served path's (serve_phase) and the trained path's
        launches[key] += entry["launches"][key]
    for key, n in list(tool_launches.items()) + list(study_launches.items()):
        launches[key] += n
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernel_checks": rows + k56_rows + k34_rows + k78_rows,
                   "requests": results, "train": [steady, fp16, entry, entry16, pipeline, dp, tp],
                   "tools": tools, "studies": studies, "probes": probes,
                   "launches": launches, "phase_s": PHASE_S}, f, indent=1)

    t = k34["row"]
    report["K3"] = {"max_abs_err": k34["K3"], "ms": t["K3_ms"], "plain_ms": t["K3_plain_ms"],
                    "bound_ms": t["K3_bound_ms"], "bound_by": t["K3_bound_by"]}
    report["K4"] = {"max_abs_err": k34["K4"], "ms": t["K4_ms"], "plain_ms": t["K4_plain_ms"],
                    "bound_ms": t["K4_bound_ms"], "bound_by": t["K4_bound_by"]}
    report.update(k78)
    meta = {
        "K1": ("decode_loop", "tacotron2_vae_torch/csrc/decoder_loop.cu",
               "tacotron2_vae_tpu/ops/pallas/decoder_loop.py:112 (_kernel), "
               ":408 (_kernel_batched)"),
        "tail": ("tail_kernel", "tacotron2_vae_torch/csrc/decoder_loop.cu",
                 "tacotron2_vae_tpu/ops/pallas/decoder_loop.py:112 (_kernel), "
                 ":408 (_kernel_batched): the step's projection, outputs and next prenet"),
        "K2": ("stft_mel", "tacotron2_vae_torch/csrc/stft_mel.cu",
               "tacotron2_vae_tpu/ops/pallas/stft_mel.py:31 (_kernel)"),
        "K3": ("teacher_fwd", "tacotron2_vae_torch/csrc/teacher_fwd.cu",
               "tacotron2_vae_tpu/ops/pallas/teacher_fwd.py:75 (_kernel)"),
        "K4": ("teacher_bwd", "tacotron2_vae_torch/csrc/teacher_bwd.cu",
               "tacotron2_vae_tpu/ops/pallas/teacher_fwd.py:306 (_bwd_kernel)"),
        "K7": ("encoder_lstm_fwd", "tacotron2_vae_torch/csrc/encoder_lstm.cu",
               "none: tacotron2_vae_tpu/ops/rnn.py lstm_scan's XLA scan (encoder BiLSTM)"),
        "K8": ("encoder_lstm_bwd", "tacotron2_vae_torch/csrc/encoder_lstm.cu",
               "none: autograd of tacotron2_vae_tpu/ops/rnn.py lstm_scan"),
        "K5": ("probe_reshape", "tacotron2_vae_torch/csrc/reshape_probe.cu",
               "tools/reshape_probe.py:31 (probe_reshape.kernel)"),
        "K6": ("probe_out_block", "tacotron2_vae_torch/csrc/reshape_probe.cu",
               "tools/reshape_probe.py:54 (probe_out_block.kernel)"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        r = report[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name if key == "tail" else key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    total = time.perf_counter() - t0
    print(json.dumps({"phase_s": {"name": "total", "s": total}}), flush=True)
    print(f"chip_smoke: {total:.1f} s in all | {card}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
