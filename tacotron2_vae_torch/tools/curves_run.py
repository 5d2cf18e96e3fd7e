"""The curve study: a synthetic emotional corpus, a long ``train()`` run,
its result images and the four inference recipes on its checkpoint.

The port's counterpart of the JAX package's ``tools/curves_run.py``, with
its stages, constants, corpus, hparams and summary.  The corpus (512
training + 64 validation wavs: per-syllable harmonic chords, per-emotion
spectral tilt, register and vibrato) carries the emotion in the audio only,
never in the text, so the VAE latent is the model's only path to it.  The
run trains at batch 64 through the real training stack
(``training.train.train``: filelist -> bulk mel cache -> bucketed batches
-> train step -> checkpoints -> CSV logs) under the reference's 'linear' KL
schedule with a free-latent lag of 1200 steps and a weight capped at 1e-4
(the JAX tool's ``_hparams`` gives the measurements behind that choice).

Stages (``all`` or any subset, in this order):

  corpus   wavs + filelists under --workdir (byte for byte the JAX tool's)
  train    the curve run; resumes from the newest checkpoint in
           ``--workdir/out``; 16 032 steps unless ``T2V_STEPS_TARGET``
           says otherwise (read when the stage starts)
  assets   curves from the run's CSV logs, an eval-mode forward of 16
           validation clips, the latent scatter and t-SNE of the training
           corpus, the summary and a README, into --res
  samples  ``tools/inference_demo.py``'s four recipes on the newest
           checkpoint, into --samples; with a WaveGlow export
           (``T2V_WAVEGLOW``, else ``--workdir/waveglow_export.pkl``) the
           audio is vocoded by it and checked by copy synthesis

    python -m tacotron2_vae_torch.tools.curves_run all [--workdir DIR] \\
        [--res res_torch] [--samples samples/generated_torch] \\
        [--hparams iters_per_checkpoint=500] [--device cpu]

On the card the train steps run K3 and K4, the eval forward K3, the
clips' log-mels of the recipes and of the copy synthesis K2 (the bulk
mel cache featurises by the chunked DFT product, as the JAX package's
does) and the decode loops K1.  Runs on the card unless ``--device cpu``.

Divergences from the JAX tool:

* ``--res`` and ``--samples`` default to ``res_torch/`` and
  ``samples/generated_torch/`` in the checkout, never to the JAX
  package's committed ``res/`` and ``samples/generated/``; ``--workdir``
  defaults to ``t2v_curves_torch`` in the temporary directory;
* ``--hparams`` (empty by default) adds overrides after the run's own,
  for example ``iters_per_checkpoint`` for a short run, which needs a
  checkpoint before ``assets``;
* ``assets`` also writes the series and latents behind its images as
  ``curves.json`` and ``latents.npz``; without matplotlib (the card's
  machine has none) it writes only these and skips the images, and says
  so; ``samples`` skips the scatter and t-SNE likewise;
* ``kl_postlag_max_ema`` is None for a run that ends before the priced
  region (the JAX tool raises there);
* the READMEs name the CUDA kernels and the card the run was made on.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from ..config import create_hparams
from ..data.dataset import TextMelDataset, collate
from ..dsp import save_wav
from ..serving.synthesizer import Synthesizer
from ..training import checkpoint
from ..training.train_state import batch_to_device, resolve_device
from ..utils import plotting
from . import inference_demo
from .make_result_assets import device_label, save_image

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SR = 16000

# 16 syllables, each a distinct harmonic chord the decoder must learn to
# emit in text order; emotions recolor the same sentence (label order
# [neu, sad, ang, hap]).  Prosody carries future information that only the
# VAE can know: per-syllable sampled realization (amplitude, f0 jitter and
# glide, duration jitter) on top of per-utterance emotion-mean prosody, so
# the recon gain from the latent persists and KL settles at a positive
# plateau (the JAX tool gives the failure modes that led here).
SYLLS = list("가나다라마바사아자차카타파하고노")
PARTIAL_AMPS = np.array([1.0, 0.6, 0.45, 0.32, 0.22])
EMO_TILT = {0: 0.0, 1: -0.55, 2: 0.55, 3: 0.30}     # brightness slope mean
EMO_F0 = {0: 1.0, 1: 0.88, 2: 1.12, 3: 1.05}        # register mean
EMO_DUR = {0: 1.0, 1: 1.15, 2: 0.85, 3: 0.95}       # tempo mean
EMO_VIBRATO = {0: (0.0, 0.0), 1: (0.0, 0.0),        # (rate Hz, depth mean)
               2: (3.0, 0.012), 3: (5.5, 0.022)}
TILT_SD, F0_SD, DUR_SD, VIB_SD = 0.10, 0.035, 0.06, 0.006
# Per-syllable realization spread, large on purpose: at the 1e-4 weight
# and summed KL the realization must be worth more recon than its nats.
SYL_AMP_SD, SYL_F0_SD, SYL_DUR_SD = 0.80, 0.10, 0.08
SYL_GLIDE_SD = 0.12     # per-syllable log-f0 glide over the syllable
EMO_AMP = {0: 1.0, 1: 0.75, 2: 1.30, 3: 1.10}  # loudness mean by emotion
SYLL_S = 0.12
TAIL_S = 0.10
TRAIN_SENTS, VAL_SENTS = 128, 16
STEPS_PER_EPOCH = 8     # 512 utterances at batch 64
ANNEAL_LAG = 1200
PRICED_AFTER = ANNEAL_LAG + 400   # KL statistics over the priced region only
SAMPLE_TEXT = "가나다라마바사아"


def steps_target() -> int:
    """The run's length: ``T2V_STEPS_TARGET`` (default 16 032, the JAX
    run's curve anchor) rounded down to whole epochs, read at each call."""
    steps = int(os.environ.get("T2V_STEPS_TARGET", "16032"))
    return steps // STEPS_PER_EPOCH * STEPS_PER_EPOCH


def _syll_wave(syl_idx: int, prosody: dict, t: np.ndarray) -> np.ndarray:
    f0 = (140.0 + 22.0 * syl_idx) * prosody["f0"]
    rate, depth = prosody["vib"]
    vib = depth * np.sin(2 * np.pi * rate * t) if rate else 0.0
    # linear log-f0 glide across the syllable (slope is per-syllable random)
    glide = prosody.get("glide", 0.0)
    tt = t / max(t[-1], 1e-6)
    inst = np.exp(glide * (tt - 0.5))  # frequency multiplier over time
    # integrate the multiplier for a phase-coherent glide
    cum = np.concatenate([[0.0], np.cumsum(inst[:-1])]) / len(t) * t[-1]
    phase = 2 * np.pi * f0 * (cum + vib * t)
    out = np.zeros_like(t)
    for k, amp in enumerate(PARTIAL_AMPS, start=1):
        a = amp * np.exp(prosody["tilt"] * (k - 1) / 2.0)
        f = f0 * k
        if f >= SR / 2 - 200:
            break
        out += a * np.sin(k * phase)
    return out


def _sample_prosody(emotion: int, rng: np.random.RandomState) -> dict:
    rate, depth = EMO_VIBRATO[emotion]
    return {
        "f0": EMO_F0[emotion] * np.exp(F0_SD * rng.randn()),
        "tilt": EMO_TILT[emotion] + TILT_SD * rng.randn(),
        # the clamp keeps the longest (sad, 12-syllable) utterance under 128
        # mel frames, so every batch pads to one bucketed shape
        "dur": float(np.clip(EMO_DUR[emotion] * np.exp(DUR_SD * rng.randn()), 0.75, 1.28)),
        "vib": (rate, max(0.0, depth + VIB_SD * rng.randn()) if rate else 0.0),
    }


def _sentence_wav(sylls: list[int], emotion: int, rng: np.random.RandomState) -> np.ndarray:
    prosody = _sample_prosody(emotion, rng)
    fade = int(0.008 * SR)
    segs = []
    for s in sylls:
        # per-syllable realization: unpredictable at each boundary
        syl_p = dict(prosody)
        syl_p["f0"] = prosody["f0"] * np.exp(SYL_F0_SD * rng.randn())
        syl_p["glide"] = SYL_GLIDE_SD * rng.randn()
        amp = EMO_AMP[emotion] * np.exp(SYL_AMP_SD * rng.randn())
        # the 1.30 cap keeps even an all-max 12-syllable utterance < 128 frames
        dur = float(np.clip(prosody["dur"] * np.exp(SYL_DUR_SD * rng.randn()), 0.7, 1.30))
        n_syl = int(SYLL_S * dur * SR)
        env = np.ones(n_syl)
        env[:fade] = np.linspace(0, 1, fade)
        env[-fade:] = np.linspace(1, 0, fade)
        t = np.arange(n_syl) / SR
        segs.append(amp * _syll_wave(s, syl_p, t) * env)
    wav = np.concatenate(segs + [np.zeros(int(TAIL_S * SR))])
    # a fixed gain, not a per-wav peak normalization, which would erase the
    # emotion-mean loudness differences the latent is meant to encode
    wav = np.clip(0.10 * wav, -0.99, 0.99)
    wav = wav + 0.004 * rng.randn(len(wav))
    return wav.astype(np.float32)


def make_corpus(workdir: str) -> tuple[str, str]:
    """Write train/val wavs + filelists; returns (train_list, val_list)."""
    cdir = os.path.join(workdir, "corpus")
    os.makedirs(cdir, exist_ok=True)
    rng = np.random.RandomState(1234)

    def gen(n_sents, tag, seed):
        srng = np.random.RandomState(seed)
        lines = []
        for i in range(n_sents):
            n_syl = 8 if i % 2 == 0 else 12
            sylls = [int(srng.randint(0, len(SYLLS))) for _ in range(n_syl)]
            text = "".join(SYLLS[s] for s in sylls)
            for emo in range(4):
                path = os.path.join(cdir, f"{tag}_{i:03d}_e{emo}.wav")
                if not os.path.exists(path):
                    save_wav(path, _sentence_wav(sylls, emo, rng), SR)
                lines.append(f"{path}|{text}|0|{emo}")
        flist = os.path.join(workdir, f"{tag}.txt")
        with open(flist, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        return flist

    train_list = gen(TRAIN_SENTS, "train", 7)
    val_list = gen(VAL_SENTS, "val", 8)
    print(f"corpus: {TRAIN_SENTS * 4} train / {VAL_SENTS * 4} val wavs in {cdir}", flush=True)
    return train_list, val_list


def _hparams(workdir: str, extra: str = ""):
    """The run's hparams: the reference's 'linear' schedule (weight 0 until
    ``anneal_lag``, then min(upper, step / x0)) with a lag of 1200 (the
    z -> decoder pathway must form before the latent is priced) and a cap
    of 1e-4 (1.5e-3 collapsed the latent, 1e-4 settles at KL 150-300 in the
    JAX runs); then ``extra`` overrides."""
    return create_hparams(
        f"training_files={workdir}/train.txt,"
        f"validation_files={workdir}/val.txt,"
        f"batch_size=64,epochs={steps_target() // STEPS_PER_EPOCH},iters_per_checkpoint=2000,"
        f"anneal_function='linear',anneal_lag={ANNEAL_LAG},anneal_x0=1000000,"
        "anneal_upper=0.0001" + ("," + extra if extra else ""))


def latest_ckpt(out_dir: str) -> str:
    path = checkpoint.latest_checkpoint(out_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint_* in {out_dir}")
    return path


def run_train(workdir: str, extra: str = "", device=None) -> str:
    from ..training.train import train

    hp = _hparams(workdir, extra)
    out = os.path.join(workdir, "out")
    # resume from the newest checkpoint if there is one
    ckpt = checkpoint.latest_checkpoint(out)
    if ckpt:
        print(f"resuming from {ckpt}", flush=True)
    _ts, it = train(out, "logs", ckpt, False, hp, device=device)
    print(f"training done at iteration {it}", flush=True)
    return out


def _ema(xs, alpha=0.92):
    out, m = [], None
    for x in xs:
        m = x if m is None else alpha * m + (1 - alpha) * x
        out.append(m)
    return out


def _read_csv(path):
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f if line.strip()]
    # resumed runs re-log an overlapping iteration range: keep the last
    # occurrence of each iteration, in iteration order
    by_it = {}
    for r in rows:
        by_it[int(float(r[0]))] = r
    rows = [by_it[k] for k in sorted(by_it)]
    return {h: np.array([float(r[i]) for r in rows]) for i, h in enumerate(header)}


def _cap(series, factor):
    """(0, 99.5th percentile x factor) of the finite values, None if none."""
    series = np.asarray(series, np.float64)
    series = series[np.isfinite(series)]
    if series.size == 0:
        return None
    return (0.0, float(np.percentile(series, 99.5)) * factor)


def _curve(res_dir, name, xs, ys, title, ylabel, smooth=True, ylim=None):
    plt = plotting.pyplot()
    fig, ax = plt.subplots(figsize=(9, 3.6))
    ax.plot(xs, ys, lw=0.7, alpha=0.35, color="#ff6f4f")
    if smooth and len(ys) > 10:
        ax.plot(xs, _ema(ys), lw=1.4, color="#e8552e")
    if ylim is not None:
        ax.set_ylim(*ylim)
    ax.set_xlabel("step")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    p = os.path.join(res_dir, name)
    fig.savefig(p, dpi=110)
    plt.close(fig)
    print("wrote", p)


def _plot_curves(res_dir, tr, va):
    it = tr["iteration"]
    # the y-limits clip the init transient and the free-latent spike so the
    # plateau shows; the clipped region is stated in each title
    loss_ylim = _cap(tr["loss"][len(it) // 10:], 1.6) or _cap(tr["loss"], 1.6)
    _curve(res_dir, "trainingloss.png", it, tr["loss"],
           f"training.loss — {int(it[-1]) + 1:,}-step run, synthetic corpus, B=64 "
           "(init transient clipped)", "total loss", ylim=loss_ylim)
    _curve(res_dir, "reconloss.png", it, tr["recon_loss"],
           "recon_loss (mel MSE x2 + gate BCE; init transient clipped)", "recon loss",
           ylim=loss_ylim)
    kl_ylim = _cap(np.asarray(tr["kl_div"])[np.asarray(it) > 2000], 1.8) or _cap(tr["kl_div"],
                                                                                1.8)
    _curve(res_dir, "kldiv.png", it, tr["kl_div"],
           "kl_div (summed KL) — free-latent warmup spike clipped; priced plateau shown",
           "KL", ylim=kl_ylim)
    _curve(res_dir, "klweight.png", it, tr["kl_weight"],
           "kl_weight (reference 'linear' schedule: free until lag=1200, then capped at 1e-4)",
           "kl weight", smooth=False)
    _curve(res_dir, "validloss.png", va["iteration"], va["loss"],
           "validation.loss (averaged over val set)", "val loss", smooth=False)


def run_assets(workdir: str, res_dir: str, extra: str = "", device=None) -> dict:
    """The curves, the eval images, scatter and t-SNE, the summary and its
    README; returns the summary."""
    dev = resolve_device(device)
    hp = _hparams(workdir, extra)
    out_dir = os.path.join(workdir, "out")
    logdir = os.path.join(out_dir, "logs")
    tr = _read_csv(os.path.join(logdir, "metrics.csv"))
    va = _read_csv(os.path.join(logdir, "val_metrics.csv"))
    os.makedirs(res_dir, exist_ok=True)
    plots = plotting.available()
    if plots:
        _plot_curves(res_dir, tr, va)

    # ---- the checkpoint as serving loads it; an eval-mode forward of a
    # validation batch through its model
    ckpt = latest_ckpt(out_dir)
    synth = Synthesizer(hp, device=dev)
    synth.load(ckpt, None, centroid_filelist=os.path.join(workdir, "val.txt"))
    ds = TextMelDataset(os.path.join(workdir, "val.txt"), hp, shuffle=False, device=dev)
    ds.warm_mel_cache()
    b = collate([ds[i] for i in range(min(16, len(ds)))], hp.n_frames_per_step,
                hp.text_bucket_size, hp.mel_bucket_size)
    with torch.no_grad():
        out = synth.model(batch_to_device(b, dev), train=False,
                          generator=torch.Generator(device=dev).manual_seed(1))
    T0, S0 = int(b.output_lengths[0]), int(b.input_lengths[0])

    # ---- latents of the whole training corpus through the serving path
    tds = TextMelDataset(os.path.join(workdir, "train.txt"), hp, shuffle=False, device=dev)
    tds.warm_mel_cache()
    mels = [tds.get_mel(e[0]) for e in tds.entries]
    labels = np.array([int(e[3]) for e in tds.entries])
    zs = np.stack(synth._embed_mels(mels))
    mus = zs  # serving embeds the mean path in eval mode
    np.savez(os.path.join(res_dir, "latents.npz"), mus=mus, zs=zs, emotions=labels)
    with open(os.path.join(res_dir, "curves.json"), "w") as f:
        json.dump({"train": {k: v.tolist() for k, v in tr.items()},
                   "val": {k: v.tolist() for k, v in va.items()}}, f)
    if plots:
        save_image(plotting.plot_alignment_to_numpy(
            out.alignments[0].float().cpu().numpy()[:T0, :S0].T),
            os.path.join(res_dir, "alignment.png"))
        save_image(plotting.plot_spectrogram_to_numpy(
            out.mel_outputs_postnet[0].float().cpu().numpy()[:, :T0]),
            os.path.join(res_dir, "mel_predicted.png"))
        save_image(plotting.plot_spectrogram_to_numpy(b.mel[0][:, :T0]),
                   os.path.join(res_dir, "mel_target.png"))
        save_image(plotting.plot_gate_outputs_to_numpy(
            b.gate[0], torch.sigmoid(out.gate_outputs[0].float()).cpu().numpy()),
            os.path.join(res_dir, "gate.png"))
        save_image(plotting.plot_scatter(mus, labels), os.path.join(res_dir, "scatter.png"))
        save_image(plotting.plot_tsne(zs, labels), os.path.join(res_dir, "tsne.png"))
    else:
        print(f"wrote curves.json and latents.npz to {res_dir}; "
              "curves, images, scatter and tsne skipped: no matplotlib", flush=True)

    it = tr["iteration"]
    kl_ema = np.array(_ema(tr["kl_div"]))
    # KL statistics over the priced region only (past the lag; the
    # free-latent warmup spike to thousands of nats is another regime)
    priced = it > PRICED_AFTER
    summary = {
        "steps": int(it[-1]) + 1,
        "batch": hp.batch_size,
        "anneal": "reference linear schedule, lag=1200 upper=1e-4 (price chosen so "
                  "weight*KL/recon matches the reference's published ~10% gap; its logistic "
                  "default collapses the latent — see the JAX package's res/README.md)",
        "final_train_loss_ema": round(float(_ema(tr["loss"])[-1]), 4),
        "final_recon_loss_ema": round(float(_ema(tr["recon_loss"])[-1]), 4),
        "final_val_loss": round(float(va["loss"][-1]), 4),
        "kl_postlag_max_ema": round(float(kl_ema[priced].max()), 2) if priced.any() else None,
        "kl_final_ema": round(float(kl_ema[-1]), 2),
        "checkpoint": os.path.basename(ckpt),
        "corpus": f"{TRAIN_SENTS * 4} train / {VAL_SENTS * 4} val wavs, "
                  "4 emotions (audio-only signal)",
    }
    with open(os.path.join(res_dir, "README.md"), "w") as f:
        f.write(RES_README.format(summary_json=json.dumps(summary, indent=2),
                                  steps=summary["steps"], device=device_label(dev)))
        if os.path.exists(os.path.join(res_dir, "waveglow_eval.json")):
            f.write(
                "\n## WaveGlow vocoder provenance\n\n"
                "- `waveglow_nll.png` / `waveglow_eval.json` — held-out NLL at every "
                "checkpoint of a WaveGlow run of the port "
                "(`python -m tacotron2_vae_torch.tools.train_waveglow`) and copy synthesis "
                "(WaveGlow sigma=0.666 / sigma=0 / Griffin-Lim, each scored by |dlog-mel| "
                "and a multi-scale STFT distance), from "
                "`python -m tacotron2_vae_torch.tools.waveglow_eval`.\n")
    # archive the logistic-collapse evidence CSVs when the workdir has them
    ev_src = os.path.join(workdir, "evidence")
    if os.path.isdir(ev_src):
        ev_dst = os.path.join(res_dir, "kl_forensics")
        os.makedirs(ev_dst, exist_ok=True)
        for name in os.listdir(ev_src):
            shutil.copy2(os.path.join(ev_src, name), os.path.join(ev_dst, name))
            print("archived", os.path.join(ev_dst, name))
    print(json.dumps(summary), flush=True)
    return summary


RES_README = """# res_torch/ — result images from the PyTorch/CUDA port

Counterpart of the reference's `res/` and of the JAX package's `res/`.
These were generated by `python -m tacotron2_vae_torch.tools.curves_run`
from a {steps}-step `train()` run of the port at the hparams' model width
and batch 64 on a 512-utterance synthetic emotional corpus (per-syllable
harmonic chords; emotion exists only in the audio — spectral tilt,
register, vibrato — so the VAE latent is the model's only path to it), on
{device}.  On the card every training step ran the teacher-forced
recurrence as the port's CUDA kernels K3 (forward) and K4 (backward,
`tacotron2_vae_torch/csrc/teacher_fwd.cu`, `teacher_bwd.cu`):

```json
{summary_json}
```

- `trainingloss.png`, `reconloss.png`: total and recon loss (the
  reference's `res/trainingloss.png`); the init transient is clipped.
- `kldiv.png`: the summed KL; after the free-latent warmup spike it should
  hold a positive plateau while the latent stays alive and priced.
- `klweight.png`: the 'linear' schedule, 0 until step 1200, then 1e-4.
- `validloss.png`: the validation loss averaged over the validation set.
- `alignment.png`, `mel_target.png` / `mel_predicted.png`, `gate.png`:
  an eval-mode forward of 16 validation clips.
- `scatter.png` / `tsne.png`: the latent of every training clip, colored
  by emotion (arrays in `latents.npz`); the CSV series in `curves.json`.

Without matplotlib only `latents.npz`, `curves.json` and this file are
written.  The JAX package's `res/README.md` gives the KL-anneal
forensics behind the schedule.
"""


def _eval_vocoder(synth, wav_path: str) -> str:
    """Copy synthesis on a ground-truth validation mel: vocode it with the
    WaveGlow and with Griffin-Lim, featurise both outputs again and give
    the mean |dlog-mel| to the target mel of each."""
    mel_t = synth.load_mel(wav_path).cpu().numpy()  # (1, 80, T)
    T = mel_t.shape[2]

    def roundtrip(wav):
        n = min(len(wav), (T - 1) * synth.hparams.hop_length)
        wav = np.clip(np.asarray(wav[:n], np.float32), -1.0, 1.0)
        m = synth.stft.mel_spectrogram(wav[None]).cpu().numpy()
        k = min(m.shape[2], T)
        return float(np.mean(np.abs(m[:, :, :k] - mel_t[:, :, :k])))

    wav_wg = synth.vocode(mel_t)
    saved = synth.vocoder
    try:
        synth.vocoder = None  # the Griffin-Lim path
        wav_gl = synth.vocode(mel_t)
    finally:
        synth.vocoder = saved
    err_wg, err_gl = roundtrip(wav_wg), roundtrip(wav_gl)
    return (
        f"\nCopy synthesis on a held-out validation mel (vocode the ground-truth "
        f"mel, featurise again, mean |dlog-mel| to the target): **WaveGlow "
        f"{err_wg:.3f}**, Griffin-Lim {err_gl:.3f}.  Lower is better, but the metric "
        f"favours Griffin-Lim (its 30 iterations optimise spectral consistency "
        f"against the target magnitudes, while WaveGlow samples at sigma=0.666); "
        f"it shows that the flow reconstructs its conditioning mel, not a listening "
        f"ranking.  `python -m tacotron2_vae_torch.tools.waveglow_eval` gives the "
        f"sigma=0 control, a multi-scale STFT distance and the held-out NLL curve.")


def run_samples(workdir: str, out_dir: str, extra: str = "", device=None) -> list[str]:
    """The four recipes of ``tools/inference_demo.py`` on the newest
    checkpoint, in this process; returns the files written."""
    dev = resolve_device(device)
    hp = _hparams(workdir, extra)
    ckpt = latest_ckpt(os.path.join(workdir, "out"))
    val_list = os.path.join(workdir, "val.txt")
    os.makedirs(out_dir, exist_ok=True)
    with open(val_list, encoding="utf-8") as f:
        ref_wav = [line.split("|")[0] for line in f][1]
    # the vocoder: a WaveGlow export if there is one, else Griffin-Lim
    waveglow = os.environ.get("T2V_WAVEGLOW", os.path.join(workdir, "waveglow_export.pkl"))
    if not os.path.exists(waveglow):
        waveglow = None

    synth = Synthesizer(hp, device=dev)
    synth.load(ckpt, waveglow, centroid_filelist=val_list)

    def ns(**kw):
        return argparse.Namespace(outdir=out_dir, filelist=val_list, text=SAMPLE_TEXT, **kw)

    inference_demo.cmd_latents(ns(), synth)
    inference_demo.cmd_ref(ns(ref_audio=ref_wav), synth)
    inference_demo.cmd_interp(ns(frm="sad", to="hap"), synth)
    inference_demo.cmd_mix(ns(ratios="0.25,0.25,0.25,0.25"), synth)
    steps = int(os.path.basename(ckpt).rsplit("_", 1)[1])
    if waveglow:
        vocoder_para = (
            "The audio is vocoded by a WaveGlow export (`--export` of "
            "`python -m tacotron2_vae_torch.tools.train_waveglow`, sigma=0.666 at "
            "inference like the reference) through the same `Synthesizer`: the whole "
            "text -> mel -> WaveGlow -> wav loop of the reference runs in the port."
            + _eval_vocoder(synth, ref_wav))
    else:
        vocoder_para = (
            "The audio is vocoded with Griffin-Lim (no WaveGlow export was present; "
            "train one with `python -m tacotron2_vae_torch.tools.train_waveglow "
            "--export` and run the samples stage again for the full text -> wav loop).")
    vocoder_para += (
        "  The model was trained on synthetic harmonic \"speech\": this shows the "
        "pipeline end to end with emotion-conditional latents, not human speech "
        "quality.")
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(SAMPLES_README.format(steps=steps, device=device_label(dev),
                                      vocoder_para=vocoder_para))
    print("samples refreshed in", out_dir, flush=True)
    return sorted(os.listdir(out_dir))


SAMPLES_README = """# samples/generated_torch/ — outputs of the PyTorch/CUDA port

Everything here was produced end to end by the port on {device}:

1. `python -m tacotron2_vae_torch.tools.curves_run corpus` generated a
   512-utterance synthetic emotional corpus (16-syllable harmonic
   inventory; emotion = audio-only spectral tilt / register / vibrato,
   never visible in the text);
2. `curves_run train` ran the real training path (filelist -> bulk mel
   cache -> bucketed batches -> train step with the recurrence as CUDA
   kernels K3/K4 -> checkpoints) for {steps} steps at batch 64;
3. `curves_run samples` ran the four inference recipes of
   `tacotron2_vae_torch/tools/inference_demo.py` against the checkpoint of
   iteration {steps}, with centroids from the validation manifest (log-mels
   by kernel K2, decode loops by kernel K1):
   - `latents.npz`, `scatter.png`, `tsne.png` — latent extraction
   - `ref_conditioned.wav` — reference-audio style conditioning
   - `interp_sad*_hap*.wav` — centroid interpolation ladder
     (ratios [1.0, 0.64, 0.34, 0.0])
   - `mix.wav` — equal-ratio emotion mixing

{vocoder_para}
"""


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("stages", nargs="+", choices=["corpus", "train", "assets", "samples", "all"])
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "t2v_curves_torch"))
    p.add_argument("--res", default=os.path.join(REPO, "res_torch"))
    p.add_argument("--samples", default=os.path.join(REPO, "samples", "generated_torch"))
    p.add_argument("--hparams", type=str, default="",
                   help="extra hparam overrides after the run's own")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the stages; returns {"stages", "workdir", "train_list",
    "val_list", "checkpoints", "assets" (the summary), "samples" (files)}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    stages = set(args.stages)
    if "all" in stages:
        stages = {"corpus", "train", "assets", "samples"}
    os.makedirs(args.workdir, exist_ok=True)
    report = {"stages": [s for s in ("corpus", "train", "assets", "samples") if s in stages],
              "workdir": args.workdir}
    if "corpus" in stages:
        report["train_list"], report["val_list"] = make_corpus(args.workdir)
    if "train" in stages:
        out = run_train(args.workdir, args.hparams, dev)
        report["checkpoints"] = sorted(os.path.basename(p) for p in
                                       glob.glob(os.path.join(out, "checkpoint_*")))
    if "assets" in stages:
        report["assets"] = run_assets(args.workdir, args.res, args.hparams, dev)
    if "samples" in stages:
        report["samples"] = run_samples(args.workdir, args.samples, args.hparams, dev)
    return report


if __name__ == "__main__":
    main()
