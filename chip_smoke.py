#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one card: build, check, train, serve.

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --k34      # build, then only the K3/K4 checks

1. Environment: torch/CUDA versions, the card's name and power limit.
2. Kernels: builds every CUDA kernel of the port from ``csrc/`` (one nvcc
   per source, started together) and holds each against its plain PyTorch
   twin on the card at full width, each output against its own tolerance:
   K1 (decode loop) in bf16 and f32, B=1 and B=4, at S=64 with 200 forced
   steps, prenet dropout off and on, and at the serve phase's S=32 with 600
   forced steps; K2 (STFT -> mel -> log) on a 3 s and a 2 s synthetic wav;
   K3 and K4 (teacher-forced recurrence forward and backward) at B=64,
   S=128, T=512 and at B=6, S=77, T=45 with masked rows, in bf16 and f32,
   recurrent dropout off and on: every output, and every gradient of the
   recurrence through K4 against the same gradients through the twin;
   K5 and K6 (the reshape and output-block probes) at the probes' shapes,
   on the probes' inputs and on random ones.  Times each kernel, its twin
   and, for K2, K5 and K6, one library call (K2 and its library call in
   turns, 5 rounds, at the serve shape and at a training clip); for K3/K4
   also the device time per step of each of their kernels and, as a
   yardstick the port never calls, one bf16 ``torch.mm`` per LSTM product
   shape.
3. Train: 11 ``make_train_step`` steps on a fixed full-width batch (B=64,
   S=128, T=512, bf16) with random weights from the seed (ms/step, mel
   frames/s, peak memory; the loss must fall), then the real entry point
   ``training.train.train`` on a synthetic corpus of 128 + 16 clips through
   a validation, a checkpoint and a resume.  K2, K3 and K4 must launch.
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
   launch.  Last, 3 full-width WaveGlow train steps (batch 4, 16000-sample
   segments): finite loss, ms/step, peak memory.

Every launch counter is zeroed just before its path runs and read just
after; each kernel must have launched.  Prints one JSON line per check,
train phase and request, the card line, the ``kernels`` JSON line, and last
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
K1_EARLY_STEPS, K1_EARLY_TOL = 2, 1e-5
K1_TOL = {"float32": {"mel": 1e-5, "gate": 1e-5, "align": 3e-4},
          "bfloat16": {"mel": 1e-2, "gate": 1e-2, "align": 0.25}}
# (S, steps, memory lengths of rows 0..3, dropout settings): the shape the
# kernels are tuned at, and the serve phase's text bucket and step cap
# (S < the kernel's 64-position chunk, masked rows, 600 steps)
K1_CASES = ((64, 200, (64, 50, 33, 17), (False, True)),
            (32, 600, (32, 25, 17, 9), (True,)))
K2_TOL = 1e-4                                    # tests/test_pallas_stft.py:36
# 3 s (188 frames, a multiple of the kernel's 4-frame block) and the serve
# phase's 2 s reference clip (126 frames: a partial last block)
K2_SECONDS = (3, 2)
# K2 against its library call, timed in turns (kernel, library, library,
# kernel) for K2_ROUNDS rounds: at the serve shape (3 s) and at a training
# clip (4 s, the middle of train_entry's 2-6 s clips)
K2_TURN_SECONDS, K2_ROUNDS = (3, 4), 5
# K5: B rows of S*X; the probes' (S, X) shapes, the first one timed
K5_B, K5_SHAPES = 4, ((128, 128), (128, 32), (128, 256))
K6_SHAPE = (512, 128, 32, 4)                     # BS, K, F, T
K6_TOL = 1e-5                                    # float32 sum order over K=128
WG_MEL_FRAMES = 600                              # the serve phase's longest mel
WG_CPU_FRAMES, WG_CPU_TOL = 32, 1e-4             # card vs CPU, relative to max |audio|
WG_TRAIN = (4, 16000, 3)                         # batch, segment samples, steps
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12}


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


def graph_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` (a few microseconds of work): ``reps``
    calls captured in one CUDA graph and replayed, so the host's per-call
    work, larger than the kernel here, drops out; the gaps between the
    graph's launches stay in."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
    itemsize = 2 if dtype_name == "bfloat16" else 4
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


def k2_bound(n, frames, tables):
    """Least time for the log-mel of one wav: the bytes of the wav, the
    tables and the output, or the operations of a real FFT per frame
    (2.5 N log2 N), the window, |X| (3 per bin) and the mel product over the
    filterbank's nonzeros, whichever is larger."""
    window, costab, fb = tables
    n_fft = window.numel()
    n_mels, n_freq = fb.shape
    n_bytes = (n + n_mels * frames + window.numel() + costab.numel() + fb.numel()) * 4
    ops = frames * (2.5 * n_fft * math.log2(n_fft) + n_fft + 3 * n_freq
                    + 2 * int((fb != 0).sum()))
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
        row[f"scale_{name}"] = float(w.abs().max())
        if not (row[f"err_{name}"] <= tol and row[f"early_err_{name}"] <= K1_EARLY_TOL
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


def kernels_phase(model, hp, device):
    import numpy as np
    import torch
    from tacotron2_vae_torch.dsp.stft import device_tables
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.ops.layers import linear

    rows, report, failed = [], {}, []
    rng = np.random.RandomState(SEED)
    dec = model.decoder
    mem_w = dec.attention_layer.memory_layer.linear_layer.weight
    k1_err, k1_main = 0.0, None
    for dtype_name in ("bfloat16", "float32"):
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
                        if dtype_name == "bfloat16" and B == 4:
                            k1_main = row
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                    failed += [row] if row["fails"] else []
                    k1_err = max(k1_err, row["max_abs_err"])

    key = (hp.filter_length, hp.hop_length, hp.win_length, hp.n_mel_channels,
           hp.sampling_rate, hp.mel_fmin, hp.mel_fmax)
    window, costab, _, _, fb = device_tables(str(device), hp.filter_length, hp.win_length,
                                             hp.n_mel_channels, hp.sampling_rate,
                                             hp.mel_fmin, hp.mel_fmax)
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
            def library():
                spec = torch.stft(wav, hp.filter_length, hp.hop_length, hp.win_length,
                                  window, center=True, pad_mode="reflect",
                                  return_complex=True)
                return torch.log(torch.clamp(fb @ spec.abs(), min=1e-5))

            k2.update(library_max_abs_err=float((library()[None] - want).abs().max()),
                      plain_ms=cuda_ms(lambda: sm.mel_spectrogram_plain(wav, *key), 20))
            k2["bound_ms"], k2["bound_by"] = k2_bound(n, frames, (window, costab, fb))
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
    report["K1"] = dict(k1_main, max_abs_err=k1_err)
    report["K2"] = dict(k2_main, max_abs_err=k2_err)
    return report, rows


def k2_turns(hp, key, window, fb, rng, device):
    """K2 and its library call (``torch.stft`` + the mel product + log) timed
    in turns, kernel, library, library, kernel, for K2_ROUNDS rounds (20
    calls each, CUDA events) on one synthetic wav per K2_TURN_SECONDS: the
    median and the spread (min, max) of each."""
    import numpy as np
    import torch
    from tacotron2_vae_torch.ops import stft_mel as sm

    rows = []
    for seconds in K2_TURN_SECONDS:
        n = seconds * hp.sampling_rate
        t = np.arange(n) / hp.sampling_rate
        wav = torch.from_numpy((0.4 * np.sin(2 * np.pi * 220 * t)
                                + 0.01 * rng.randn(n)).astype(np.float32)).to(device)

        def kernel():
            return sm.mel_spectrogram_fused(wav, *key)

        def library():
            spec = torch.stft(wav, hp.filter_length, hp.hop_length, hp.win_length, window,
                              center=True, pad_mode="reflect", return_complex=True)
            return torch.log(torch.clamp(fb @ spec.abs(), min=1e-5))

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


def k56_phase(device):
    """K5 and K6 against their twins at the probes' shapes, on the probes'
    inputs and on random ones; the first shape of each timed beside its
    twin, one library call and its bound (device time per call from graph
    replay; ``host_bound_ms`` is the same call timed back to back from the
    host)."""
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
                row.update(ms=graph_ms(lambda: rp.reshape_rows_plus_one(x, S, X), 200),
                           plain_ms=graph_ms(lambda: rp.reshape_rows_plus_one_plain(x, S, X),
                                             200),
                           library_ms=graph_ms(lambda: x.reshape(K5_B * S, X) + 1, 200),
                           host_bound_ms=cuda_ms(lambda: rp.reshape_rows_plus_one(x, S, X),
                                                 200))
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
            row.update(ms=graph_ms(lambda: rp.out_block_matmul(x, w, T), 200),
                       plain_ms=graph_ms(lambda: rp.out_block_matmul_plain(x, w, T), 200),
                       library_ms=graph_ms(lambda: torch.matmul(xt, w), 200),
                       host_bound_ms=cuda_ms(lambda: rp.out_block_matmul(x, w, T), 200),
                       library_max_abs_err=float((torch.matmul(xt, w) - want).abs().max()))
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
                        "run": 2e-2}}
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
    itemsize = 2 if dtype_name == "bfloat16" else 4
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
    itemsize = 2 if dtype_name == "bfloat16" else 4
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


def k34_check(dec, B, S, T, lengths, dtype_name, dropout_on, device, timed):
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
        for k, fn in (("K3", fwd), ("K4", bwd)):
            row[f"{k}_us_per_step_by_kernel"] = kernel_breakdown(fn, T)
        row["torch_mm_ms"] = mm_yardstick(device)
    return row


def kernel_breakdown(fn, steps):
    """Device microseconds per step of each kernel of one call of ``fn``
    (a K3 or K4 call launched kernel by kernel, not from its CUDA graph),
    by ``torch.profiler``; "device" is their sum."""
    import re

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
        name = re.sub(r"^void |\(anonymous namespace\)::", "", evt.key)
        name = re.split(r"[(<]", name)[0].split("::")[-1] or evt.key[:40]
        out[name] = out.get(name, 0.0) + evt.device_time_total / steps
    out["device"] = sum(out.values())
    return out


def k34_phase(model, device):
    """K3 and K4 against their twins at every case, dtype and dropout
    setting; the bf16 full-width case with dropout is timed."""
    rows, failed = [], []
    report = {}
    for B, S, T, lengths in K34_CASES:
        for dtype_name in ("bfloat16", "float32"):
            for dropout_on in (False, True):
                timed = B == K34_CASES[0][0] and dtype_name == "bfloat16" and dropout_on
                row = k34_check(model.decoder, B, S, T, lengths, dtype_name, dropout_on,
                                device, timed)
                print(json.dumps(row), flush=True)
                rows.append(row)
                failed += [row] if row["fails"] else []
                if timed:
                    report["row"] = row
                for k in ("K3", "K4"):
                    report[k] = max(report.get(k, 0.0), row[f"{k}_max_abs_err"])
    if failed:
        raise AssertionError(f"{len(failed)} K3/K4 check(s) disagree with the twins: "
                             f"{[(r['dtype'], r['B'], r['dropout'], r['fails']) for r in failed]}")
    return report, rows


# ------------------------------------------------------------------- train

TRAIN_SHAPE = (64, 128, 512)   # B, S, T of the steady-state steps
TRAIN_STEPS = 10               # timed steps after one warm-up step
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
    CUDA events, mel frames per second, peak device memory; the loss and
    the gradient norm must stay finite and the loss fall."""
    import torch
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.training.train_state import create_train_state, make_train_step

    ts = create_train_state(hp, device, seed=SEED)
    step = make_train_step(hp)
    batch = fixed_batch(hp, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tf.teacher_fwd.launches = tf.teacher_bwd.launches = 0
    captures = tf.graph_captures()
    metrics, times = [], []
    for i in range(TRAIN_STEPS + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(ts, batch, gen))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = {"K3": tf.teacher_fwd.launches, "K4": tf.teacher_bwd.launches}
    captures = {k: v - captures[k] for k, v in tf.graph_captures().items()}
    B, S, T = TRAIN_SHAPE
    ms = sum(times[1:]) / TRAIN_STEPS
    row = {"phase": "train_steady", "B": B, "S": S, "T": T, "steps": TRAIN_STEPS,
           "ms_per_step": ms, "ms_per_step_each": times, "mel_frames_per_s": B * T / ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics],
           "launches": launches, "graph_captures": captures}
    print(json.dumps(row), flush=True)
    losses = row["loss"]
    if not all(math.isfinite(v) for v in losses + row["grad_norm"]):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {row['grad_norm']}")
    if not (all(m["updated"] for m in metrics) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall over {len(losses)} steps: {losses}")
    if launches["K3"] != TRAIN_STEPS + 1 or launches["K4"] != TRAIN_STEPS + 1:
        raise AssertionError(f"the train steps did not run through K3/K4: {launches}")
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
    t0 = time.perf_counter()
    _, it = tr.train(out, "logs", None, False, hp2, device=str(device))
    ckpt = os.path.join(out, "checkpoint_2")
    _, it2 = tr.train(out, "logs", ckpt, False, hp2.replace(epochs=3, mel_cache=True),
                      device=str(device))
    wall = time.perf_counter() - t0
    launches = {"K2": sm.mel_spectrogram_fused.launches, "K3": tf.teacher_fwd.launches,
                "K4": tf.teacher_bwd.launches}
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
        raise AssertionError(f"train() did not run through K2/K3/K4: {launches}")
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
    step = make_waveglow_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-4))
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
    row = {"phase": "waveglow_train", "B": B, "samples": n, "mel_frames": mel.shape[2],
           "ms_per_step_each": times, "ms_per_step_after_first": sum(times[1:]) / (steps - 1),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics]}
    print(json.dumps(row), flush=True)
    if not all(m["updated"] and math.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"WaveGlow train steps not finite: {row}")
    return row


def serve_phase(model, hp, device, tmp):
    """Griffin-Lim requests, WaveGlow requests (float32, bf16), the vocoder
    alone, the HTTP API, WaveGlow train steps.  K1 and K2 launches are
    counted over the whole phase."""
    import torch
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer

    wg = random_waveglow()
    ckpt, wg_path, manifest, ref = serve_files(model, wg, tmp)
    dl.decode_loop.launches = 0
    sm.mel_spectrogram_fused.launches = 0
    synth = Synthesizer(hp, device=device)
    synth.load(ckpt, centroid_filelist=manifest)
    if not synth.centroids_loaded:
        raise AssertionError("centroid precompute embedded no clips")
    results = serve_requests(synth, hp, tmp, ref, "griffin_lim")
    del synth
    synth = Synthesizer(hp, device=device)
    synth.load(ckpt, waveglow_path=wg_path, centroid_filelist=manifest)
    if synth.waveglow_cfg != wg.cfg or synth.waveglow is None:
        raise AssertionError("the WaveGlow pickle was not adopted")
    for dtype in (None, torch.bfloat16):
        synth.vocoder_dtype = dtype
        results += serve_requests(synth, hp, tmp, ref,
                                  "waveglow_" + ("bfloat16" if dtype else "float32"))
    synth.vocoder_dtype = None
    http = http_phase(synth, tmp)
    launches = {"K1": dl.decode_loop.launches, "K2": sm.mel_spectrogram_fused.launches}
    if launches["K1"] < 4 or launches["K2"] < 1:
        raise AssertionError(f"serving did not run through the kernels: {launches}")
    del synth
    torch.cuda.empty_cache()
    vocoder = vocoder_phase(wg, device)
    train = waveglow_train(wg, device)
    return results + vocoder + [http, train], launches


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
    logs = _build.build(["decoder_loop", "stft_mel", "teacher_fwd", "teacher_bwd",
                         "reshape_probe"], verbose=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"built kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    device = torch.device("cuda")
    hp = create_hparams()
    model = random_model(hp, device)
    if "--k34" in sys.argv[1:]:  # the recurrence kernels' checks alone
        k34_phase(model, device)
        return 0
    report, rows = kernels_phase(model, hp, device)
    k56, k56_rows = k56_phase(device)
    report.update(k56)
    k34, k34_rows = k34_phase(model, device)
    steady = steady_steps(hp, device)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        entry = train_entry(hp, device, tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        results, launches = serve_phase(model, hp, device, tmp)
    probes = probe_entry()
    launches.update({k: entry["launches"][k] for k in ("K3", "K4")}, **probes["launches"])
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernel_checks": rows + k56_rows + k34_rows,
                   "requests": results, "train": [steady, entry], "probes": probes,
                   "launches": launches}, f, indent=1)

    t = k34["row"]
    report["K3"] = {"max_abs_err": k34["K3"], "ms": t["K3_ms"], "plain_ms": t["K3_plain_ms"],
                    "bound_ms": t["K3_bound_ms"], "bound_by": t["K3_bound_by"]}
    report["K4"] = {"max_abs_err": k34["K4"], "ms": t["K4_ms"], "plain_ms": t["K4_plain_ms"],
                    "bound_ms": t["K4_bound_ms"], "bound_by": t["K4_bound_by"]}
    meta = {
        "K1": ("decode_loop", "tacotron2_vae_torch/csrc/decoder_loop.cu",
               "tacotron2_vae_tpu/ops/pallas/decoder_loop.py:112 (_kernel), "
               ":408 (_kernel_batched)"),
        "K2": ("stft_mel", "tacotron2_vae_torch/csrc/stft_mel.cu",
               "tacotron2_vae_tpu/ops/pallas/stft_mel.py:31 (_kernel)"),
        "K3": ("teacher_fwd", "tacotron2_vae_torch/csrc/teacher_fwd.cu",
               "tacotron2_vae_tpu/ops/pallas/teacher_fwd.py:75 (_kernel)"),
        "K4": ("teacher_bwd", "tacotron2_vae_torch/csrc/teacher_bwd.cu",
               "tacotron2_vae_tpu/ops/pallas/teacher_fwd.py:306 (_bwd_kernel)"),
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
            "launches": launches[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
