"""Train the port's WaveGlow vocoder on a wav filelist (flow NLL).

The port's counterpart of the JAX package's ``tools/train_waveglow.py``,
with its flags: NVIDIA mel2samp-style data (random fixed-length audio
segments, the mel computed from each segment), Adam on the flow negative
log-likelihood after a clip to global norm 1 (``models/waveglow.py``
``make_waveglow_train_step``).

    python -m tacotron2_vae_torch.tools.train_waveglow --filelist F \\
        --output_dir D --steps 10000 [--segment 16000] [--batch 4] \\
        [--sigma 1.0] [--lr 1e-4] [--export P.pkl [--export_dtype float16]]
    torchrun --nproc_per_node=N -m tacotron2_vae_torch.tools.train_waveglow \\
        --mesh DATA,MODEL ...           # DATA * MODEL = N ranks

Checkpoints are ``waveglow_{step}`` files (``torch.save``) of the logical
training state: the step, the parameters, Adam's state and the segment
sampler's generator, so ``--resume`` continues the stream where the run
left it and a resumed run takes the steps the uninterrupted run takes (a
checkpoint without the generator seeds it ``1234 + step``, the JAX tool's
resume; a fresh run draws the JAX tool's stream from ``1234``).  Orbax
directories of the JAX tool need JAX and are refused.  ``--resume C
--steps 0 --export P`` only exports.  ``--export`` writes the self-describing serving pickle
``{"waveglow": JAX-layout params, "config": ...}`` that both packages'
``Synthesizer.load`` read.  ``nll.csv`` gets the loss every 50 steps (the
only reads of the card's loss), ``run_config.json`` the flags; the last
line printed is one JSON object (``steps_per_sec``: after the first step,
checkpoints included).

Under torchrun ``--mesh DATA,MODEL`` trains on that grid
(``parallel.mesh``): every rank draws the global batch's segments from the
one stream and featurises its data index's rows; the model axis splits the
WaveNet stack (``mesh.waveglow_spec``); rank 0 writes.  ``--batch`` must
split evenly over DATA.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import time

import numpy as np
import torch

from .. import convert
from ..data.dataset import load_filepaths_and_text
from ..data.native import load_wav
from ..dsp.stft import TacotronSTFT
from ..models.waveglow import WaveGlow, WaveGlowConfig, init_weights, make_waveglow_train_step
from ..parallel import mesh
from ..training.train_state import resolve_device


class SegmentSampler:
    """mel2samp: random fixed-length segments and their mels, the JAX
    tool's numpy stream (``RandomState(seed)``, one ``randint`` for the
    file and one for the start)."""

    def __init__(self, filelist, segment, sr, seed=1234, device="cpu"):
        self.entries = [e[0] for e in load_filepaths_and_text(filelist)]
        self.segment = segment
        self.sr = sr
        self.rng = np.random.RandomState(seed)
        self.stft = TacotronSTFT(1024, 256, 1024, 80, sr, 0.0, 8000.0, device=device)

    def segments(self, n) -> np.ndarray:
        """(n, segment) float32 audio."""
        segs, failures = [], 0
        while len(segs) < n:
            if failures >= max(50, 3 * len(self.entries)):
                raise RuntimeError(
                    f"No usable wavs after {failures} attempts: check the filelist paths "
                    f"and that the corpus is {self.sr} Hz (use --sampling_rate).")
            path = self.entries[self.rng.randint(len(self.entries))]
            try:
                audio, sr = load_wav(path, scale=32768.0)
            except (FileNotFoundError, OSError, ValueError):
                failures += 1
                continue
            if sr != self.sr:
                failures += 1
                continue
            if len(audio) < self.segment:
                audio = np.pad(audio, (0, self.segment - len(audio)))
                start = 0
            else:
                start = self.rng.randint(len(audio) - self.segment + 1)
            segs.append(audio[start:start + self.segment])
        return np.stack(segs).astype(np.float32)

    def mel(self, audio: np.ndarray) -> torch.Tensor:
        """(n, 80, segment // hop + 1) mels of segments, through the
        batched prepadded STFT."""
        pad = self.stft.filter_length // 2
        padded = np.stack([np.pad(a, pad, mode="reflect") for a in audio])
        n_frames = self.segment // self.stft.hop_length + 1
        return self.stft.mel_spectrogram_prepadded(padded)[:, :, :n_frames]

    def state(self) -> dict:
        """The generator's state, as tensors and numbers (``torch.save``)."""
        _, keys, pos, has_gauss, gauss = self.rng.get_state()
        return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
                "has_gauss": int(has_gauss), "gauss": float(gauss)}

    def set_state(self, state: dict) -> None:
        self.rng.set_state(("MT19937", state["keys"].numpy().astype(np.uint32),
                            state["pos"], state["has_gauss"], state["gauss"]))


def export(state_dict: dict, cfg: WaveGlowConfig, path: str, dtype: str) -> None:
    """Write the serving pickle: JAX-layout params stored in ``dtype``,
    and the config."""
    tree = convert.to_jax_waveglow({k: v.detach().cpu() for k, v in state_dict.items()})
    store = np.dtype(dtype)
    blob = {"waveglow": _map(tree, lambda x: np.asarray(x, store)),
            "config": dataclasses.asdict(cfg)}
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    print("exported", path, flush=True)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--filelist", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--segment", type=int, default=16000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--sampling_rate", type=int, default=16000)
    p.add_argument("--checkpoint_every", type=int, default=2000)
    p.add_argument("--resume", default=None, help="a waveglow_{step} checkpoint")
    p.add_argument("--n_flows", type=int, default=12)
    p.add_argument("--n_channels", type=int, default=256)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                   help="train on a (data, model) grid of torchrun ranks, e.g. 4,1 for "
                        "data parallelism or 2,2 for data and tensor parallelism")
    p.add_argument("--export", default=None, metavar="PATH.pkl",
                   help="after the last step, write the serving pickle "
                        "{waveglow: params, config: ...} that Synthesizer.load reads")
    p.add_argument("--export_dtype", default="float32", choices=["float32", "float16"],
                   help="storage dtype of --export (serving casts back to float32)")
    p.add_argument("--upsample_kernel", type=int, default=1024)
    p.add_argument("--n_group", type=int, default=8)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def train_waveglow(args) -> dict:
    """Train, checkpoint and export as ``args`` say; returns the last
    line's object."""
    if args.segment % args.n_group:
        raise SystemExit(f"--segment {args.segment} does not squeeze into "
                         f"{args.n_group} groups")
    if args.resume and os.path.isdir(args.resume):
        raise SystemExit(f"{args.resume} is a directory (an Orbax checkpoint of the JAX "
                         "tool, which needs JAX); the port resumes from its own "
                         "waveglow_{step} files")
    data, model = (int(x) for x in args.mesh.split(",")) if args.mesh else (1, 1)
    if args.batch % data:
        raise SystemExit(f"--batch {args.batch} not divisible by data axis {data}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if data * model != world:
        raise SystemExit(f"--mesh {data},{model} needs {data * model} ranks, got {world}")
    grid, dev = mesh.init_distributed(None, args.device, model=model)
    if grid is None:
        dev = resolve_device(args.device)
    lead = grid is None or grid.rank == 0
    os.makedirs(args.output_dir, exist_ok=True)

    cfg = WaveGlowConfig(n_flows=args.n_flows, n_channels=args.n_channels,
                         n_layers=args.n_layers, upsample_kernel=args.upsample_kernel,
                         n_group=args.n_group)
    net = init_weights(WaveGlow(cfg), torch.Generator().manual_seed(0))
    payload = None
    if args.resume:
        payload = torch.load(args.resume, map_location="cpu", weights_only=True)
        net.load_state_dict(payload["state_dict"])
    start_step = int(payload["step"]) if payload else 0
    if start_step >= args.steps:
        # export-only: --resume <ckpt> --steps 0 --export <pkl> turns any saved
        # checkpoint (the best held-out one, say) into a serving artifact
        if args.export and lead:
            export(net.state_dict(), cfg, args.export, args.export_dtype)
        return {"final_loss": None, "steps": start_step,
                "note": "resume step >= --steps; " + ("exported only" if args.export
                                                      else "nothing to do")}
    if grid is not None and grid.model > 1:
        mesh.shard_module(net, lambda n: mesh.waveglow_spec(n, cfg.n_layers), grid)
    net = net.to(dev).train()
    opt = torch.optim.Adam(net.parameters(), lr=args.lr, fused=True)
    if payload:
        opt.load_state_dict(mesh.local_optimizer_state(payload["optimizer"], net, grid))
    step_fn = make_waveglow_train_step(net, opt, args.sigma, clip=1.0, grid=grid)
    if grid is not None and lead:
        print(f"mesh: data={grid.data} model={grid.model}", flush=True)

    # a resumed run continues the stream (without the saved generator: seeded
    # past the segments earlier steps consumed, as the JAX tool does)
    sampler = SegmentSampler(args.filelist, args.segment, args.sampling_rate,
                             seed=1234 + start_step, device=dev)
    if payload and "sampler" in payload:
        sampler.set_state(payload["sampler"])
    rows = args.batch // data
    mine = slice(grid.data_index * rows, (grid.data_index + 1) * rows) if grid else slice(None)
    csv_f = None
    if lead:
        with open(os.path.join(args.output_dir, "run_config.json"), "w") as f:
            json.dump(vars(args), f, indent=1)
        nll_csv = os.path.join(args.output_dir, "nll.csv")
        write_header = not os.path.exists(nll_csv)
        csv_f = open(nll_csv, "a")  # append: --resume continues the curve
        if write_header:
            csv_f.write("step,nll,steps_per_sec\n")
            csv_f.flush()
    t0, loss = None, None
    for i in range(start_step, args.steps):
        audio = sampler.segments(args.batch)[mine]
        metrics = step_fn(torch.from_numpy(audio).to(dev), sampler.mel(audio))
        loss = metrics["loss"]
        if i == start_step:
            if lead:
                print(f"step {i}: loss {float(loss):.4f} (first)", flush=True)
            t0 = time.perf_counter()
        elif (i + 1) % 50 == 0:
            value = float(loss)
            rate = (i - start_step) / (time.perf_counter() - t0)
            if lead:
                print(f"step {i + 1}: loss {value:.4f}  {rate:.1f} steps/s", flush=True)
                csv_f.write(f"{i + 1},{value:.6f},{rate:.2f}\n")
                csv_f.flush()
        if (i + 1) % args.checkpoint_every == 0 or i + 1 == args.steps:
            state = {"step": i + 1, "state_dict": mesh.logical_state_dict(net, grid),
                     "optimizer": mesh.logical_optimizer_state(opt, net, grid),
                     "sampler": sampler.state()}
            if lead:
                path = os.path.abspath(os.path.join(args.output_dir, f"waveglow_{i + 1}"))
                torch.save(state, path)
                print("saved", path, flush=True)
    if lead:
        csv_f.close()
    if args.export:
        state = mesh.logical_state_dict(net, grid)
        if lead:
            export(state, cfg, args.export, args.export_dtype)
    final = float(loss)
    rate = (args.steps - start_step - 1) / (time.perf_counter() - t0)
    mesh.barrier(grid)
    return {"final_loss": final, "steps": args.steps, "steps_per_sec": rate}


def main(argv=None):
    args = parse_args(argv)
    try:
        out = train_waveglow(args)
    finally:
        mesh.shutdown()
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
