"""Result images from a training run of the port on the synthetic emotion task.

The port's counterpart of the JAX package's ``tools/make_result_assets.py``,
with its batches, cadences, images and summary.  A full-model-size run
(the hparams' width) on the emotion-conditional variant of ``smoke_train``'s
aligned task: each character has a spectral pattern and each emotion adds a
spectral tilt that only the VAE latent can carry.  It writes the four curves
(``trainingloss``, ``validloss``, ``reconloss``, ``kldiv``), four images of
an eval-mode forward of the validation batch (``alignment``,
``mel_predicted``, ``mel_target``, ``gate``), the latent ``scatter`` and
``tsne`` over 12 evaluation batches, a ``README.md`` with the summary, and
prints the summary JSON.

    python -m tacotron2_vae_torch.tools.make_result_assets [--steps 3000] \\
        [--batch 16] [--seq 32] [--out res_torch] [--hparams ...] [--device cpu]

Train steps run through ``make_train_step`` (K3 and K4 on the card) and
the eval forwards through the model in eval mode (K3).  The metrics stay
on the device and are read every 25 steps (history) and every 250
(validation) only.  Each step draws its dropout from a ``torch.Generator``
seeded with the step's index.  Runs on the card unless ``--device cpu``.

Divergences from the JAX tool:

* ``--out`` defaults to ``res_torch/`` in the checkout, never to the JAX
  package's committed ``res/``;
* ``--hparams`` (empty by default) adds overrides after
  ``anneal_function='constant'``, for runs at a small width;
* the series behind the images are always written too, as ``curves.json``
  and ``latents.npz``; without matplotlib (the card's machine has none)
  only these are written, the images are skipped and the tool says so;
* the summary's ``device`` and the README name the card (or the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..config import create_hparams
from ..ops.layers import set_cudnn_flags
from ..training.train_state import (batch_to_device, create_train_state, make_eval_step,
                                    make_train_step, resolve_device)
from ..utils import plotting
from .smoke_train import synth_batch as _synth_batch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FRAMES_PER_CHAR = 4
EMO_TILT = 0.8  # per-emotion spectral tilt amplitude
HIST_EVERY, VAL_EVERY = 25, 250
N_TRAIN_BATCHES, N_LATENT_BATCHES = 16, 12


def synth_batch(rng, hp, B, S):
    """Emotion-conditional variant of the smoke task (tilt through the VAE)."""
    return _synth_batch(rng, hp, B, S, frames_per_char=FRAMES_PER_CHAR, emotion_tilt=EMO_TILT)


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, else
    ``torch.cuda.get_device_name``; ``"cpu"`` on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(index)],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(index)


def save_image(img: np.ndarray, path: str):
    plotting.pyplot().imsave(path, img)
    print("wrote", path)


def _curve(path: str, xs, ys, title: str, ylabel: str):
    plt = plotting.pyplot()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(xs, ys, lw=1.2, label=ylabel)
    ax.set_xlabel("step")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print("wrote", path)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=3000)  # min 25 (curve cadence)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--out", type=str, default=os.path.join(REPO, "res_torch"))
    p.add_argument("--hparams", type=str, default="",
                   help="extra hparam overrides after anneal_function='constant'")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.steps < HIST_EVERY:
        p.error("--steps must be >= 25 (metrics are recorded every 25 steps)")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    # constant KL weight 0.001: the task's only emotion signal is the tilt,
    # reachable only through the latent, which the logistic schedule's late
    # weight near 1 collapses (the JAX tool's reasoning)
    hp = create_hparams("anneal_function='constant'"
                        + ("," + args.hparams if args.hparams else ""))
    set_cudnn_flags(hp)
    rng = np.random.RandomState(0)
    train_batches = [batch_to_device(synth_batch(rng, hp, args.batch, args.seq), dev)
                     for _ in range(N_TRAIN_BATCHES)]
    val_np = synth_batch(np.random.RandomState(777), hp, args.batch, args.seq)
    val_batch = batch_to_device(val_np, dev)

    ts = create_train_state(hp, dev, seed=0)
    step, eval_step = make_train_step(hp), make_eval_step(hp)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    hist = {"step": [], "loss": [], "recon": [], "kl": []}
    val_hist = {"step": [], "loss": []}
    t0 = time.perf_counter()
    for i in range(args.steps):
        m = step(ts, train_batches[i % N_TRAIN_BATCHES], gen(i))
        if (i + 1) % HIST_EVERY == 0:
            loss, recon, kl = torch.stack(
                [m["loss"], m["recon_loss"], m["kl_loss"]]).float().tolist()
            hist["step"].append(i + 1)
            hist["loss"].append(loss)
            hist["recon"].append(recon)
            hist["kl"].append(kl)
        if (i + 1) % VAL_EVERY == 0:
            v_total, _aux, _out = eval_step(ts, val_batch, gen(10_000 + i))
            val_hist["step"].append(i + 1)
            val_hist["loss"].append(float(v_total))
            print(f"step {i + 1}: train {hist['loss'][-1]:.4f} "
                  f"val {val_hist['loss'][-1]:.4f} kl {hist['kl'][-1]:.2f}", flush=True)
    wall = time.perf_counter() - t0

    # ---- eval-mode forwards: the validation batch, then the latent batches
    @torch.no_grad()
    def fwd(batch, seed):
        return ts.model(batch, train=False, generator=gen(seed))

    out = fwd(val_batch, 1)
    mus, zs, labels = [], [], []
    for b in range(N_LATENT_BATCHES):
        eb = synth_batch(np.random.RandomState(5000 + b), hp, args.batch, args.seq)
        o = fwd(batch_to_device(eb, dev), b)
        mus.append(o.mu.float().cpu().numpy())
        zs.append(o.z.float().cpu().numpy())
        labels.append(eb["emotions"].argmax(axis=1))
    mus, zs, labels = np.concatenate(mus), np.concatenate(zs), np.concatenate(labels)
    with open(os.path.join(args.out, "curves.json"), "w") as f:
        json.dump({"train": hist, "val": val_hist}, f)
    np.savez(os.path.join(args.out, "latents.npz"), mus=mus, zs=zs, emotions=labels)

    if plotting.available():
        _curve(os.path.join(args.out, "trainingloss.png"), hist["step"], hist["loss"],
               "training.loss (synthetic task, full model size)", "total loss")
        _curve(os.path.join(args.out, "validloss.png"), val_hist["step"], val_hist["loss"],
               "validation.loss", "val loss")
        _curve(os.path.join(args.out, "reconloss.png"), hist["step"], hist["recon"],
               "recon_loss (mel MSE x2 + gate BCE)", "recon loss")
        _curve(os.path.join(args.out, "kldiv.png"), hist["step"], hist["kl"],
               "kl_div (summed KL)", "KL")
        save_image(plotting.plot_alignment_to_numpy(out.alignments[0].float().cpu().numpy().T),
                   os.path.join(args.out, "alignment.png"))
        save_image(plotting.plot_spectrogram_to_numpy(
            out.mel_outputs_postnet[0].float().cpu().numpy()),
            os.path.join(args.out, "mel_predicted.png"))
        save_image(plotting.plot_spectrogram_to_numpy(val_np["mel"][0]),
                   os.path.join(args.out, "mel_target.png"))
        save_image(plotting.plot_gate_outputs_to_numpy(
            val_np["gate"][0], torch.sigmoid(out.gate_outputs[0].float()).cpu().numpy()),
            os.path.join(args.out, "gate.png"))
        save_image(plotting.plot_scatter(mus, labels), os.path.join(args.out, "scatter.png"))
        save_image(plotting.plot_tsne(zs, labels), os.path.join(args.out, "tsne.png"))
    else:
        print(f"wrote curves.json and latents.npz to {args.out}; "
              "curves, images, scatter and tsne skipped: no matplotlib", flush=True)

    summary = {
        "steps": args.steps,
        "batch": args.batch,
        "final_train_loss": hist["loss"][-1],
        "final_val_loss": val_hist["loss"][-1] if val_hist["loss"] else None,
        "wall_s": round(wall, 1),
        "device": device_label(dev),
    }
    with open(os.path.join(args.out, "README.md"), "w") as f:
        f.write(README.format(summary_json=json.dumps(summary, indent=2),
                              device=summary["device"]))
    print(json.dumps(summary), flush=True)
    return summary


README = """# res_torch/ — result images from the PyTorch/CUDA port

Counterpart of the reference's `res/` (its images come from a ~250k-step
run on the Korean Emotion Speech dataset).  These were generated by
`python -m tacotron2_vae_torch.tools.make_result_assets` from a training
run of the port at the hparams' model width on a synthetic
emotion-conditional aligned text->mel task (per-character spectral patterns
+ per-emotion spectral tilt), on {device}:

```json
{summary_json}
```

- `trainingloss/validloss/reconloss/kldiv.png` — the same four
  TensorBoard curves the reference publishes (series in `curves.json`)
- `alignment.png` — eval-mode attention (diagonal = learned
  monotonic alignment)
- `mel_target/mel_predicted.png`, `gate.png`
- `scatter.png` / `tsne.png` — VAE latent mu / z colored by
  emotion label (arrays in `latents.npz`)

Without matplotlib only `curves.json`, `latents.npz` and this file are
written.
"""


if __name__ == "__main__":
    main()
