"""Time the decode loop, ``infer``, serving and WaveGlow of checkouts in turns.

    python -m tacotron2_vae_torch.tools.decode_turns --trees OLD . . OLD

Each tree is a directory that holds a ``tacotron2_vae_torch`` package: this
checkout (``.``) or another commit's package unpacked with ``git archive``
(without its ``chip_smoke.py``: the serving helpers come from this
checkout's).  The runs go in the order given, each in a process of its own
that imports that tree's package and nothing of this one, so two commits
compare on one card in one call.  Every tree's kernels (those of
``KERNELS`` its ``csrc`` holds) are built before the first run, all at
once.  Each run builds the full-width model of ``chip_smoke.random_model``
(random weights from its seed, gate bias -10, so every decode runs its
full step cap) and prints one ``TURN {json}`` line:

* ``k1``: for each weight dtype and B in ``ROWS``, ``profile_decode.profile``
  at S=64, 200 steps: the ms of one ``decode_loop`` call (CUDA events, mean
  of 3 after a warm-up), device µs a step by kernel name, the busy share
  (each tree's ``profile_decode`` says of which call: since the device-side
  loop, a stream-launched one, whose ms is ``stream_ms``);
* ``infer``: ``profile_decode.profile_infer`` at B in ``ROWS`` (S=32, 600
  steps): encoder, decode loop and postnet ms by host clock;
* ``serve``: ``chip_smoke.serve_requests`` through a ``Synthesizer`` with a
  random full-width WaveGlow in float32 and bf16 (the four kinds of
  request, 600 frames each): RTF, decode and vocoder time;
* ``vocoder``: ``chip_smoke.vocoder_phase``: WaveGlow alone on a 600-frame
  mel in float32 and bf16 (ms, bound), and the card against the CPU;
* ``after_decode``: WaveGlow on that mel by CUDA events in float32 and
  bf16, alone and right after a K1 decode (S=32, 600 steps, B=1) in bf16
  and in float32 (the dtype whose decode sets L2 aside): the median and
  range of ``AFTER_ROUNDS`` rounds, the three in turn within a round;
* ``launch_us``: the host's µs per launch of a small eager elementwise op
  (``LAUNCHES`` in a row, synchronised), before the first decode, after the
  ``k1`` rows and at the end: what the host-bound stages (encoder, postnet,
  WaveGlow in bf16) pay, and whether a tree's decodes leave it changed.

``--k1`` keeps the ``k1`` rows alone: for copies of one tree that differ
only in K1 (a constant of ``csrc/decoder_loop.cu`` changed in the copy),
timed in turns with the tree itself.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = ("decoder_loop", "stft_mel", "encoder_lstm")  # those a tree has
ROWS = (1, 4)
DTYPES = ("bfloat16", "float16", "float32")
SEQ, STEPS = 64, 200
LAUNCHES = 2000
AFTER_ROUNDS = 6


def launch_us(device) -> float:
    """Host µs per launch of ``x.add_(1)`` on a one-element tensor."""
    x = torch.zeros(1, device=device)
    x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / LAUNCHES


def after_decode(cs, dl, model, wg, device):
    """WaveGlow alone and right after a decode, for each vocoder dtype."""
    card = copy.deepcopy(wg).to(device)
    w_inv = card.inverse_weights()
    rng = np.random.RandomState(cs.SEED)
    mel = torch.from_numpy((-6 + 2 * rng.rand(1, 80, cs.WG_MEL_FRAMES)).astype(np.float32))
    mel = mel.to(device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    dec = model.decoder
    kws = {name: dl.pack_weights(dec, getattr(torch, name)) for name in ("bfloat16", "float32")}
    memory, pmem = cs.k1_inputs(dec, 1, 32, device, 0)
    args = dict(max_steps=600, gate_threshold=1.0, seed=7, dropout_on=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = {}
    for vdt in (torch.float32, torch.bfloat16):
        card.infer(mel, 0.666, gen, vdt, w_inv)
        times = {"alone": [], "after_bfloat16": [], "after_float32": []}
        for _ in range(AFTER_ROUNDS):
            for key, ms in times.items():
                if key != "alone":
                    dl.decode_loop(kws[key[len("after_"):]], memory, pmem, None, **args)
                torch.cuda.synchronize()
                start.record()
                card.infer(mel, 0.666, gen, vdt, w_inv)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
        out[str(vdt).split(".")[1]] = {k: {"median": float(np.median(v)), "range": [min(v), max(v)]}
                                       for k, v in times.items()}
    return out


def child(tree: str, k1_only: bool = False):
    """One turn: the package of ``tree`` alone, this checkout's chip_smoke."""
    sys.path[:0] = [os.path.abspath(tree), ROOT]
    import chip_smoke as cs
    from tacotron2_vae_torch import profile_decode as pd
    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer

    device = torch.device("cuda")
    hp = create_hparams()
    model = cs.random_model(hp, device)
    row = {"tree": tree, "card": cs.nvidia_smi(), "k1": [], "infer": [],
           "launch_us": {"start": launch_us(device)}}
    for dtype in DTYPES:
        for B in ROWS:
            prof = pd.profile(model.decoder, B, SEQ, STEPS, getattr(torch, dtype), device)
            row["k1"].append({"dtype": dtype, "B": B, "ms": prof["wall_ms"],
                              "us_per_step": prof["us_per_step"],
                              "kernel_us_per_step": prof["kernel_us_per_step"],
                              "device_busy_share": prof["device_busy_share"],
                              "stream_ms": prof.get("stream_ms"),
                              "us_per_step_by_kernel": cs.us_by_kernel(prof)})
    row["launch_us"]["after_k1"] = launch_us(device)
    if k1_only:
        print("TURN " + json.dumps(row), flush=True)
        return
    for B in ROWS:
        row["infer"].append(pd.profile_infer(model, B))
    wg = cs.random_waveglow()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, wg_path, manifest, ref = cs.serve_files(model, wg, tmp)
        synth = Synthesizer(hp, device=device)
        synth.load(ckpt, wg_path, centroid_filelist=manifest)
        row["serve"] = []
        for dtype in (None, torch.bfloat16):
            synth.vocoder_dtype = dtype
            row["serve"] += cs.serve_requests(
                synth, hp, tmp, ref, "waveglow_" + ("bfloat16" if dtype else "float32"))
        del synth
    torch.cuda.empty_cache()
    row["vocoder"] = cs.vocoder_phase(wg, device)
    row["after_decode"] = after_decode(cs, dl, model, wg, device)
    row["launch_us"]["end"] = launch_us(device)
    print("TURN " + json.dumps(row), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trees", nargs="+", default=["."], help="checkouts, in turn order")
    p.add_argument("--k1", action="store_true", help="time K1 alone, not infer or serving")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        child(args.child, args.k1)
        return
    if not torch.cuda.is_available():
        raise SystemExit("decode_turns needs a CUDA card")
    build = ("import os; from tacotron2_vae_torch.ops import _build; _build.build("
             "[n for n in %r if os.path.exists(f'tacotron2_vae_torch/csrc/{n}.cu')])"
             % (list(KERNELS),))
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
              for tree in dict.fromkeys(args.trees)]
    if any(b.wait() != 0 for b in builds):
        raise SystemExit("a tree's kernels did not build")
    for tree in args.trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree]
                       + ["--k1"] * args.k1, check=True, timeout=900)


if __name__ == "__main__":
    main()
