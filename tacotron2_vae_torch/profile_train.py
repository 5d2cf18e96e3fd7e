"""Where a training step's time goes on the card (kernels K3/K4, full width).

    python -m tacotron2_vae_torch.profile_train

1. K3 (``teacher_fwd``) and K4 (``teacher_bwd``) at B=64, S=128, T=512
   with recurrent dropout, in bf16 and f32: the wall time of one call (CUDA
   events, mean of 2 after a warm-up) with the step loop replayed from a
   CUDA graph and launched kernel by kernel, then one call (launched kernel
   by kernel) under ``torch.profiler`` with the device time of each of its
   kernels (total and per step: lstm_tc, att_query, att_fwd; lstm_bwd,
   dx_tc, att_query, att_bwd in bf16) and the device's busy share of the
   call; ``gap_us_per_step`` is the graph call's wall time less the device
   time, per step (``graph_captures`` / ``graph_updates``: graphs
   instantiated / updated in place in those 3 calls, each adding its
   capture, and its instantiation or update, to the wall time).
2. A yardstick the port never calls: one bf16 ``torch.mm`` (cuBLAS) of each
   per-step LSTM product shape at B=64, (64 x 1792) . (1792 x 4096) and
   (64 x 2560) . (2560 x 4096), and the backward's transposed ones,
   (64 x 4096) . (4096 x 2560) and (64 x 4096) . (4096 x 1792).
3. One full-width ``make_train_step`` step (bf16 defaults, B=64, S=128,
   T=512) under ``torch.profiler``: the wall time, the device's busy time
   and share of the step and the 15 costliest device kernels.
Random weights and inputs from a fixed seed.  Prints one JSON line per
part.  Needs a CUDA card.

    python -m tacotron2_vae_torch.profile_train --loop [--iters 16] [--warm 3]

``--loop`` profiles the real ``training.train.train`` instead (hparams
defaults: B=64, bf16, prefetch on) on a synthetic corpus of ``iters * 64``
clips (``synthetic_corpus``: texts of the reference corpus's train
filelist, each clip as long as its text takes to read), its mel cache
warmed first: one run timed by CUDA events
recorded after each queued step (steady s/it from iteration ``warm`` on),
then one run with iterations ``warm .. warm + 4`` under
``utils.profiling.trace`` with the card's activity alone (its busy ms per
iteration, its busy share of those iterations and the longest idle gaps;
the gzipped Chrome trace goes to ``chiprun_out/``).  The busy share of the
untraced run is the traced busy ms per iteration over its s/it.  Under
``torchrun --nproc_per_node=N`` every rank runs it on its shard (a global
batch of 64) and prints its own line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import create_hparams
from .models import decoder_bptt as bp
from .ops import stft_mel as sm
from .ops import teacher_fwd as tf
from .ops.layers import linear
from .training.train_state import create_train_state, make_train_step
from .utils import profiling

B, S, T = 64, 128, 512


def _kernels(prof, steps):
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[evt.key[:90]] = {"total_us": evt.device_time_total, "count": evt.count,
                             "us_per_step": evt.device_time_total / steps}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_us"]))


def _timed(fn, reps=2):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return wall_ms, prof


@torch.no_grad()
def profile_recurrence(dec, dtype, device, seed=0):
    hp = dec.hp
    rng = np.random.RandomState(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)

    w = tf.pack(bp.scan_params(dec), dtype)
    memory = rand(B, S, hp.encoder_embedding_dim, scale=0.3)
    pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight).contiguous()
    prenet = torch.relu(rand(T, B, hp.prenet_dim))
    add = torch.zeros(B, S, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    masks = tuple(bp.dropout_masks(T, B, hp.attention_rnn_dim, 0.9, dtype, g, device)
                  for _ in range(4))
    ys, resids = tf.teacher_fwd(w, prenet, memory, pmem, add, masks)
    dys = tuple(rand(*y.shape, scale=0.1) for y in ys)
    zero = torch.zeros_like(ys[2][:1])
    w_cum_prev = torch.cat([zero, torch.cumsum(ys[2], 0)[:-1]]).contiguous()
    rows = []
    for name, fn in (("K3", lambda: tf.teacher_fwd(w, prenet, memory, pmem, add, masks)),
                     ("K4", lambda: tf.teacher_bwd(w, memory, pmem, masks, dys, ys, resids,
                                                   w_cum_prev))):
        captures, updates = tf.graph_captures()[name], tf.graph_updates()[name]
        graph_ms, _ = _timed(fn)
        captures = tf.graph_captures()[name] - captures
        updates = tf.graph_updates()[name] - updates
        tf.USE_GRAPH = False
        try:
            wall_ms, prof = _timed(fn)
        finally:
            tf.USE_GRAPH = True
        kernels = _kernels(prof, T)
        busy = sum(k["total_us"] for k in kernels.values())
        rows.append({"kernel": name, "dtype": str(dtype).replace("torch.", ""), "B": B,
                     "S": S, "T": T, "wall_ms_graph": graph_ms, "graph_captures": captures,
                     "graph_updates": updates,
                     "wall_ms_stream": wall_ms,
                     "us_per_step": graph_ms * 1e3 / T, "device_us_per_step": busy / T,
                     "gap_us_per_step": (graph_ms * 1e3 - busy) / T,
                     "device_busy_share": busy / (graph_ms * 1e3), "kernels": kernels})
    return rows


MM_SHAPES = ((64, 1792, 4096), (64, 2560, 4096), (64, 4096, 2560), (64, 4096, 1792))


def mm_yardstick(device, reps=50):
    """ms of one bf16 ``torch.mm`` (cuBLAS, float32 accumulation) per
    per-step LSTM product shape (M, K, N): a yardstick only, never called
    by the port."""
    g = torch.Generator(device=device).manual_seed(0)
    out = {}
    for m, k, n in MM_SHAPES:
        a = torch.randn(m, k, generator=g, device=device).bfloat16()
        b = torch.randn(k, n, generator=g, device=device).bfloat16()
        torch.mm(a, b)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            torch.mm(a, b)
        end.record()
        torch.cuda.synchronize()
        out[f"{m}x{k}.{k}x{n}"] = start.elapsed_time(end) / reps
    return out


def profile_step(hp, device, seed=0):
    ts = create_train_state(hp, device, seed=seed)
    step = make_train_step(hp)
    rng = np.random.RandomState(seed)
    batch = {"text": torch.from_numpy(rng.randint(1, hp.n_symbols, (B, S))).to(device),
             "input_lengths": torch.full((B,), S, device=device),
             "mel": torch.from_numpy(rng.randn(B, hp.n_mel_channels, T).astype(np.float32)
                                     ).to(device),
             "output_lengths": torch.full((B,), T, device=device),
             "gate": torch.zeros(B, T, device=device)}
    batch["gate"][:, -1] = 1.0
    gen = torch.Generator(device=device).manual_seed(seed)
    step(ts, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(ts, batch, gen)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernels(prof, 1)
    busy = sum(k["total_us"] for k in kernels.values())
    return {"train_step": "bf16", "B": B, "S": S, "T": T, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy / 1e3, "device_busy_share": busy / 1e3 / wall_ms,
            "top_kernels": dict(list(kernels.items())[:15])}


# the reference corpus's train filelist: its texts, speakers and emotions
KOEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "filelists", "koemo_spk_emo_all_train.txt")
SYLLABLES_PER_S = 6.0   # read speech; each clip adds SILENCE_S of leading/trailing silence
SILENCE_S = 0.5


def clip_seconds(text: str) -> float:
    """A clip's duration from its text: ``SILENCE_S`` plus its Hangul
    syllables at ``SYLLABLES_PER_S``."""
    return SILENCE_S + sum("\uac00" <= c <= "\ud7a3" for c in text) / SYLLABLES_PER_S


def synthetic_corpus(tmp, n, seed=1234, name="train"):
    """``n`` lines drawn without replacement, from ``seed``, from the
    reference corpus's train filelist (``KOEMO``), texts, speakers and
    emotions as they are; each clip a 16 kHz tone and noise lasting
    ``clip_seconds(text)``.  Writes the wavs and their
    ``path|text|speaker|emotion`` filelist; returns its path."""
    from scipy.io import wavfile

    with open(KOEMO, encoding="utf-8") as f:
        lines = [line.rstrip("\n").split("|") for line in f if line.strip()]
    rng = np.random.RandomState(seed)
    path = os.path.join(tmp, f"{name}.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i, j in enumerate(rng.choice(len(lines), n, replace=False)):
            _, text, speaker, emotion = lines[j]
            wav = os.path.join(tmp, f"{name}{i}.wav")
            k = int(16000 * clip_seconds(text))
            x = (0.3 * np.sin(2 * np.pi * (110 + 5 * (i % 60)) * np.arange(k) / 16000)
                 + 0.01 * rng.randn(k))
            wavfile.write(wav, 16000, (x * 32767).astype(np.int16))
            f.write(f"{wav}|{text}|{speaker}|{emotion}\n")
    return path


def loop_run(hp, device, out_dir, warm=3, traced=0, trace_dir=None):
    """``tools.train_turns.timed_train`` with ``hp``; with ``traced`` > 0
    the steps ``warm .. warm + traced - 1`` run under
    ``utils.profiling.trace`` (the card's activity alone), and the row adds
    the device's busy ms per iteration, its busy share of those iterations
    and the longest idle gaps."""
    from .tools.train_turns import timed_train

    stack, busy = contextlib.ExitStack(), {}

    def on_step(i):
        if traced and i == warm - 1:
            rank = dist.get_rank() if dist.is_initialized() else 0
            busy["prof"] = stack.enter_context(profiling.trace(
                trace_dir or out_dir, name=f"train_loop_rank{rank}", cpu=False))
        if traced and i == warm + traced - 1:
            stack.close()

    try:
        row = timed_train(hp, device, out_dir, warm=warm, on_step=on_step)
    finally:
        stack.close()
    if "prof" in busy:
        row["traced_iterations"] = traced
        row.update(profiling.device_busy(busy["prof"]))
        row["device_ms_per_it"] = row["busy_ms"] / traced
    return row


def profile_loop(iters=16, warm=3):
    """``loop_run`` at the hparams defaults on a synthetic corpus of
    ``iters`` batches of 64, its mel cache warmed first."""
    from .data.dataset import TextMelDataset

    hp = create_hparams()
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out")
    with tempfile.TemporaryDirectory() as tmp:
        flist = synthetic_corpus(tmp, iters * hp.batch_size)
        hp = hp.replace(training_files=flist, validation_files=flist, epochs=1,
                        iters_per_checkpoint=10 ** 6)
        TextMelDataset(flist, hp).warm_mel_cache()
        timed = loop_run(hp, "cuda", os.path.join(tmp, "out"), warm=warm)
        traced = loop_run(hp, "cuda", os.path.join(tmp, "out"), warm=warm, traced=5,
                          trace_dir=out_dir)
    return {"timed": timed, "traced": traced,
            "busy_share": traced["device_ms_per_it"] / (timed["s_per_it"] * 1e3)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    device = torch.device("cuda")
    args = sys.argv[1:]
    if "--loop" in args:
        iters = int(args[args.index("--iters") + 1]) if "--iters" in args else 16
        warm = int(args[args.index("--warm") + 1]) if "--warm" in args else 3
        print(json.dumps(dict(profile_loop(iters, warm), card=card)), flush=True)
        return
    hp = create_hparams()
    ts = create_train_state(hp, device, seed=1234)
    for dtype in (torch.bfloat16, torch.float32):
        for row in profile_recurrence(ts.model.decoder, dtype, device):
            print(json.dumps(dict(row, card=card)), flush=True)
    del ts
    print(json.dumps({"torch_mm_ms": mm_yardstick(device), "card": card}), flush=True)
    print(json.dumps(dict(profile_step(hp, device), card=card)), flush=True)


if __name__ == "__main__":
    main()
