"""Time ``train()`` and the synchronised train step of checkouts in turns.

    python -m tacotron2_vae_torch.tools.train_turns --trees OLD . . OLD [--iters 16]

Each tree is a directory that holds a ``tacotron2_vae_torch`` package: this
checkout (``.``) or another commit unpacked with ``git archive``.  The runs
go in the order given, each in a process of its own that imports that
tree's package and nothing of this one, so two commits compare on one card
in one call.  One corpus serves every run: ``profile_train.synthetic_corpus``
of this checkout, ``iters`` batches at the hparams defaults (B=64, bf16),
its mel cache warmed first.  Every tree's kernels (those of ``KERNELS``
its ``csrc`` holds) are built before the first run, all at once.  Each
run prints one ``TURN {json}`` line:

* ``sync_ms_per_step``: ``make_train_step`` on one fixed batch (B, S, T =
  64, 128, 512), CUDA events around each step and a synchronise after it,
  the mean of ``STEPS`` steps after one warm-up step;
* ``train()`` on the corpus (``timed_train``): steady s/it, the batch
  shapes, K2/K3/K4 launches, and K3/K4 step-loop graphs instantiated and
  updated in place per iteration (``None`` for a tree without the update
  counter).

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

STEPS = 5                 # synchronised steps timed after one warm-up step
SYNC_SHAPE = (64, 128, 512)
KERNELS = ("stft_mel", "teacher_fwd", "teacher_bwd", "encoder_lstm")  # those a tree has


def lru_misses(keys, size: int) -> int:
    """Calls among ``keys`` that miss a most-recently-used cache of
    ``size`` entries that starts empty: the most graphs K3 or K4 may
    instantiate for batches of those shapes."""
    cache: list = []
    misses = 0
    for k in keys:
        if k in cache:
            cache.remove(k)
        else:
            misses += 1
            if len(cache) == size:
                cache.pop()
        cache.insert(0, k)
    return misses


def timed_train(hp, device, out_dir, warm: int = 3, on_step=None) -> dict:
    """One run of ``training.train.train`` with ``hp``, each train step
    wrapped to record its batch's (B, S, T) and a CUDA event (on the CPU a
    clock reading) as soon as it is queued, and then to call
    ``on_step(index)``.  Returns the steady s/it (from step ``warm`` to the
    last), the iterations, the shapes, K2/K3/K4 launches and the K3/K4
    graph counters per iteration."""
    from tacotron2_vae_torch.ops import stft_mel as sm
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.training import train as tr

    cuda = torch.device(device).type == "cuda"
    marks, shapes = [], []
    make = tr.make_train_step

    def make_timed(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(ts, batch, generator):
            out = step(ts, batch, generator)
            b = batch if isinstance(batch, dict) else batch.asdict()
            shapes.append((int(b["text"].shape[0]), int(b["text"].shape[1]),
                           int(b["mel"].shape[-1])))
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
            if on_step is not None:
                on_step(len(marks) - 1)
            return out
        return timed

    updates = getattr(tf, "graph_updates", None)

    def counters():
        if not cuda:
            return {}, {}
        return tf.graph_captures(), updates() if updates else {}

    sm.mel_spectrogram_fused.launches = 0
    tf.teacher_fwd.launches = tf.teacher_bwd.launches = 0
    captures0, updates0 = counters()
    tr.make_train_step = make_timed
    t0 = time.perf_counter()
    try:
        _, iters = tr.train(out_dir, "", None, False, hp, device=str(device))
    finally:
        tr.make_train_step = make
    wall = time.perf_counter() - t0
    last = len(marks) - 1
    if cuda:
        torch.cuda.synchronize()
        steady = marks[warm].elapsed_time(marks[last]) / 1e3 / (last - warm)
    else:
        steady = (marks[last] - marks[warm]) / (last - warm)
    captures1, updates1 = counters()
    return {"iterations": iters, "s_per_it": steady, "wall_s": wall, "shapes": shapes,
            "distinct_shapes": len(set(shapes)),
            "graph_misses_at_most": lru_misses(shapes, getattr(tf, "GRAPHS", 4)),
            "launches": {"K2": sm.mel_spectrogram_fused.launches,
                         "K3": tf.teacher_fwd.launches, "K4": tf.teacher_bwd.launches},
            "graph_captures_per_it": {k: (v - captures0[k]) / iters
                                      for k, v in captures1.items()},
            "graph_updates_per_it": ({k: (v - updates0[k]) / iters
                                      for k, v in updates1.items()} if updates else None)}


def sync_step_ms(hp, device) -> float:
    """ms per ``make_train_step`` step on one fixed batch of random tokens
    and mels at ``SYNC_SHAPE``, with a synchronise after each step."""
    from tacotron2_vae_torch.training.train_state import create_train_state, make_train_step

    B, S, T = SYNC_SHAPE
    ts = create_train_state(hp, device, seed=0)
    step = make_train_step(hp)
    rng = np.random.RandomState(0)
    batch = {"text": torch.from_numpy(rng.randint(1, hp.n_symbols, (B, S))).to(device),
             "input_lengths": torch.full((B,), S, device=device),
             "mel": torch.from_numpy(rng.randn(B, hp.n_mel_channels, T).astype(np.float32)
                                     ).to(device),
             "output_lengths": torch.full((B,), T, device=device),
             "gate": torch.zeros(B, T, device=device)}
    batch["gate"][:, -1] = 1.0
    gen = torch.Generator(device=device).manual_seed(0)
    times = []
    for _ in range(STEPS + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(ts, batch, gen)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times[1:]) / STEPS


def child(args):
    """One turn: the package of ``args.tree`` alone."""
    sys.path.insert(0, os.path.abspath(args.tree))
    from tacotron2_vae_torch.config import create_hparams

    device = torch.device("cuda")
    hp = create_hparams().replace(training_files=args.flist, validation_files=args.flist,
                                  epochs=1, iters_per_checkpoint=10 ** 6)
    row = {"tree": args.tree, "sync_ms_per_step": sync_step_ms(hp, device)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        row["train"] = timed_train(hp, device, tmp, warm=args.warm)
    print("TURN " + json.dumps(row), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trees", nargs="+", default=["."], help="checkouts, in turn order")
    p.add_argument("--iters", type=int, default=16, help="batches of 64 in the corpus")
    p.add_argument("--warm", type=int, default=3, help="iterations before the steady s/it")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    p.add_argument("--flist", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        child(args)
        return
    if not torch.cuda.is_available():
        raise SystemExit("train_turns needs a CUDA card")
    from tacotron2_vae_torch import profile_train as pt
    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.data.dataset import TextMelDataset

    build = ("import os; from tacotron2_vae_torch.ops import _build; _build.build("
             "[n for n in %r if os.path.exists(f'tacotron2_vae_torch/csrc/{n}.cu')])"
             % (list(KERNELS),))
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
              for tree in dict.fromkeys(args.trees)]
    hp = create_hparams()
    with tempfile.TemporaryDirectory() as tmp:
        flist = pt.synthetic_corpus(tmp, args.iters * hp.batch_size)
        TextMelDataset(flist, hp.replace(training_files=flist)).warm_mel_cache()
        if any(b.wait() != 0 for b in builds):
            raise SystemExit("a tree's kernels did not build")
        for tree in args.trees:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--tree",
                            tree, "--flist", flist, "--warm", str(args.warm)],
                           check=True, timeout=900)


if __name__ == "__main__":
    main()
