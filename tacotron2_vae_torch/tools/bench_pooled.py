"""Measure what length-pooled batching (``hp.sort_by_length``) buys.

The port's counterpart of the JAX package's ``tools/bench_pooled.py``, with
its corpus, flags and JSON keys.  On a corpus of 1-8 s clips (a ~65-510
mel-frame spread), without and with pooling:

* ``padded_frame_ratio_*``: padded mel frames / true mel frames over one
  host-side epoch of the loader;
* ``batch_shapes_*``: the distinct (S, T) batch shapes of that epoch;
* ``steps_per_sec_*`` / ``true_frames_per_sec_*``: real train steps on the
  device, each timed alone (the step, then a read of its loss), after a
  warm-up of shuffled epochs that ends at the first epoch bringing no new
  shape (at most 5); steps longer than 5x the median are left out;
* ``compiles_in_timed_window_*``: shapes first seen in the timed window
  (the JAX meaning: under XLA each is a compile);
* ``graph_captures_in_timed_window_*`` (the port's own): step-loop CUDA
  graphs that K3 and K4 instantiated in the timed window
  (``ops.teacher_fwd.graph_captures``), what a new shape costs on the card;
  None on the CPU, where no graph exists.

    python -m tacotron2_vae_torch.tools.bench_pooled [--batch 16] [--items 256] \\
        [--steps 24] [--host_only] [--hparams ...] [--device cpu]

Prints one JSON line and returns it as a dict.  The train steps run K3 and
K4 on the card.  The loader featurises through the bulk mel cache (the
chunked DFT product, as the JAX package's does); with ``--hparams
mel_cache=False`` it featurises every clip through K2 instead.  The corpus
lives in a temporary directory, removed at the end.  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..config import create_hparams
from ..data.dataset import DataLoader, TextMelDataset
from ..dsp import save_wav
from ..ops.layers import set_cudnn_flags
from ..training.train_state import (batch_to_device, create_train_state, make_train_step,
                                    resolve_device)

WARM_EPOCHS_MAX = 5
OUTLIER = 5.0   # steps slower than OUTLIER x the median are left out


def build_corpus(tmpd: str, n_items: int, sr: int = 16000) -> str:
    """Wide spread: 1.0-8.0 s clips (a ~65-510 mel-frame spread), the regime
    real speech corpora live in (koemo clips span ~1-10 s)."""
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n_items):
        secs = 1.0 + 7.0 * rng.rand()
        n = int(secs * sr)
        t = np.arange(n) / sr
        wav = (0.3 * np.sin(2 * np.pi * (120 + 5 * (i % 40)) * t)).astype(np.float32)
        p = os.path.join(tmpd, f"p{i:03d}.wav")
        save_wav(p, wav, sr)
        # text length loosely tracks audio length (like real transcripts)
        text = "가나다라마바사아자차" * max(1, int(secs * 1.5))
        lines.append(f"{p}|{text[:int(8 + secs * 6)]}|0|{i % 4}")
    filelist = os.path.join(tmpd, "pool.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return filelist


def epoch_stats(dl, ds, hp):
    """(padded_ratio, n_shapes, batches) from one host-side epoch."""
    true_frames = padded_frames = 0
    shapes = set()
    batches = 0
    for b in dl.epoch(0):
        B, T = b.mel.shape[0], b.mel.shape[2]
        padded_frames += B * T
        true_frames += int(np.sum(np.asarray(b.output_lengths)))
        shapes.add((b.text.shape[1], T))
        batches += 1
    return padded_frames / max(true_frames, 1), len(shapes), batches


def _captures(dev) -> int | None:
    if dev.type != "cuda":
        return None
    from ..ops import teacher_fwd

    return sum(teacher_fwd.graph_captures().values())


def device_steps_per_sec(filelist, hp, steps, device):
    """(steps/s, true frames/s, new shapes, K3/K4 graphs instantiated) over
    ``steps`` timed train steps after the warm-up."""
    dev = torch.device(device)
    ds = TextMelDataset(filelist, hp, device=dev)
    ds.warm_mel_cache()
    dl = DataLoader(ds, hp.batch_size, hp, shuffle=True)
    ts = create_train_state(hp, dev, seed=0)
    step = make_train_step(hp)
    generator = torch.Generator(device=dev).manual_seed(1)

    # Warm-up: shuffled epochs until one brings no new (S, T) shape (at
    # most 5).  Reshuffling regroups lengths, so one epoch is not enough;
    # a first-seen shape in the timed window pays its compile (JAX) or its
    # graph instantiation (here) there.
    seen = set()
    epoch = 0
    while epoch < WARM_EPOCHS_MAX:
        new = 0
        m = None
        for batch in dl.epoch(epoch):
            shape = (batch.text.shape[1], batch.mel.shape[2])
            if shape not in seen:
                seen.add(shape)
                new += 1
            m = step(ts, batch_to_device(batch, dev), generator)
        if m is not None:
            float(m["loss"])
        epoch += 1
        if new == 0:
            break
    # Timed window, each step synchronised on its own: a rare new shape can
    # still surface late, and the median-outlier cut keeps its one-off cost
    # from swamping the steady steps.
    times, fcounts = [], []
    n = new_in_timed = 0
    captures0 = _captures(dev)
    while n < steps:
        for batch in dl.epoch(epoch):
            shape = (batch.text.shape[1], batch.mel.shape[2])
            if shape not in seen:
                seen.add(shape)
                new_in_timed += 1
            t0 = time.perf_counter()
            m = step(ts, batch_to_device(batch, dev), generator)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
            fcounts.append(int(np.sum(np.asarray(batch.output_lengths))))
            n += 1
            if n >= steps:
                break
        epoch += 1
    captures = None if captures0 is None else _captures(dev) - captures0
    med = float(np.median(times))
    keep = [i for i, t in enumerate(times) if t < OUTLIER * med]
    dt = sum(times[i] for i in keep)
    frames = sum(fcounts[i] for i in keep)
    return len(keep) / dt, frames / dt, new_in_timed, captures


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--items", type=int, default=256)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--host_only", action="store_true",
                   help="skip device timing (padded-ratio analysis only)")
    p.add_argument("--hparams", default="",
                   help="extra name=value overrides (e.g. a tiny model for a CPU run)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    out = {"batch": args.batch, "items": args.items}
    with tempfile.TemporaryDirectory(prefix="bench_pool_") as tmpd:
        filelist = build_corpus(tmpd, args.items)
        for pooled in (False, True):
            extra = f",{args.hparams}" if args.hparams else ""
            hp = create_hparams(f"batch_size={args.batch},sort_by_length={pooled}{extra}")
            set_cudnn_flags(hp)
            ds = TextMelDataset(filelist, hp, device=dev)
            ds.warm_mel_cache()
            dl = DataLoader(ds, args.batch, hp, shuffle=True)
            ratio, n_shapes, _batches = epoch_stats(dl, ds, hp)
            tag = "pooled" if pooled else "unpooled"
            out[f"padded_frame_ratio_{tag}"] = round(ratio, 3)
            out[f"batch_shapes_{tag}"] = n_shapes
            if not args.host_only:
                sps, fps, cold, graphs = device_steps_per_sec(filelist, hp, args.steps, dev)
                out[f"steps_per_sec_{tag}"] = round(sps, 2)
                out[f"true_frames_per_sec_{tag}"] = round(fps, 1)
                out[f"compiles_in_timed_window_{tag}"] = cold
                out[f"graph_captures_in_timed_window_{tag}"] = graphs

    if "true_frames_per_sec_pooled" in out:
        out["pooled_speedup_true_frames"] = round(
            out["true_frames_per_sec_pooled"] / out["true_frames_per_sec_unpooled"], 3)
    out["padding_saving"] = round(
        out["padded_frame_ratio_unpooled"] / out["padded_frame_ratio_pooled"], 3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
