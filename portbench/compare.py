"""The comparisons that decide ``correct``, and their limits.

Serving: for a sample of the requests served in the window the reference
works out again the token ids, the style (the emotion centroids from the
manifest's clips, or the reference clip's latent), the encoder, and the
decoder teacher-forced on the frames the program served (step t reads
served frame t - 1, with the served decode's dropout masks), the postnet
on the served frames, and WaveGlow on the served postnet mel with the
served vocode's noise.  Numbers (the largest over the sample):

* ``mel``: |served frame - reference frame|, max over frames and bins,
  over max |reference frame|;
* ``post``: |served postnet mel - (served mel + reference residual)|
  likewise;
* ``wav``: |served PCM16 - reference PCM16|, max over samples, over 32767;
* ``frames``: served frames against the reference's stop (exact);
* ``bytes``: replies whose bytes differ from the wav the program wrote
  (exact).

Training: the reference takes the first three steps from the same
weights, batches and seed.  Numbers: ``loss1``, the relative gap of the
first step's loss; ``out1``, the first step's postnet mel (the model's
output in training mode, teacher-forced), max |program - reference| over
max |reference|; ``change_med``, the median over the leaves of the gap
between the norms of the program's and the reference's change of a leaf
over three steps, over the larger of the reference's norm of that leaf
and of the median leaf.  Leaves whose reference gradient is under a
thousandth of the median leaf's (Adam moves them by round-off alone) are
left out of the change.  The largest step-loss gap, the first gradient
(Adam's first moment after one step) and the worst leaf are logged, not
compared (PERF.md says why).

Limits: see ``LIMITS`` and PERF.md, which gives the readings each was
set from.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference
from .reference import audio as ref_audio
from .reference import hashdrop, loader
from .reference import waveglow as ref_wg
from .reference.model import Ref, train_steps

LIMITS = {"mel": 0.03, "post": 0.035, "wav": 0.0018, "frames": 0, "bytes": 0,
          "loss1": 0.01, "out1": 0.05, "change_med": 0.05}
TRAIN_CHECKS = ("loss1", "out1", "change_med")
SERVE_CHECKS = ("mel", "post", "wav", "frames", "bytes")
EMOTIONS = ("neu", "sad", "ang", "hap")     # manifest emotion labels 0..3


def normalize_ratios(n, s, h, a) -> list:
    """The API's emotion weights, normalised to sum 1 and rounded to two
    decimals (the reference app's ``/api``)."""
    sigma = n + s + h + a
    if sigma:
        return [round(x / sigma * 100) / 100 for x in (n, s, h, a)]
    return [1.0, 0.0, 0.0, 0.0]


def seed_stream(seed: int, n: int) -> list:
    """The synthesizer's first ``n`` per-call seeds (its CPU generator)."""
    g = torch.Generator().manual_seed(seed)
    return [int(torch.randint(0, 2 ** 31 - 1, (), generator=g)) for _ in range(n)]


def centroids(ref: Ref, manifest: list, hp: dict, device) -> dict:
    """Per-emotion mean latent of the manifest's clips."""
    zs = {e: [] for e in range(4)}
    with torch.no_grad():
        for path, _text, _spk, emo in manifest:
            mel = ref_audio.mel_spectrogram(ref_audio.read_wav(path), hp, device)
            _, mu, _ = ref.vae(mel[None])
            zs[int(emo)].append(mu[0])
    zdim = hp["z_latent_dim"]
    return {EMOTIONS[e]: (torch.stack(v).mean(0) if v else torch.zeros(zdim, device=device))
            for e, v in zs.items()}


def _served_style(ref: Ref, s: dict, cents: dict, hp: dict, device):
    if s["kind"] == "get":
        mel = ref_audio.mel_spectrogram(ref_audio.read_wav(s["ref"]), hp, device)
        style, _, _ = ref.vae(mel[None])
        return style[0]
    r = s["ratios"]            # [neu, sad, hap, ang]
    z = r[0] * cents["neu"] + r[1] * cents["sad"] + r[2] * cents["hap"] + r[3] * cents["ang"]
    return ref.style_from_z(z)


@torch.no_grad()
def _reference_outputs(ref: Ref, s: dict, cents: dict, hp: dict, device):
    """(mel (T, n_mel), residual (T, n_mel), gate (T,)) of one request,
    teacher-forced on its served frames."""
    ids = torch.as_tensor(loader.tokens(s["text"], hp), device=device)[None]
    memory = ref.encoder(ids, torch.tensor([ids.shape[1]], device=device))
    memory = memory + _served_style(ref, s, cents, hp, device)[None, None]
    frames = torch.as_tensor(s["mel"][0].T, device=device)[None]              # (1, T, n_mel)
    T, P = frames.shape[1], hp["prenet_dim"]
    masks = [torch.stack([hashdrop.keep(s["decode_seed"], t, layer, [s["row"]], P, device)[0]
                          for t in range(T)])[None] for layer in range(2)]
    mel, gate, _ = ref.decoder(memory, frames, None, masks)
    residual = ref.postnet(frames.transpose(1, 2))[0].T
    return mel[0], residual, gate[0]


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@torch.no_grad()
def serve_numbers(sd: dict, wg_sd: dict, wg_cfg: dict, hp: dict, samples: list,
                  manifest: list, device, quant=None) -> dict:
    """The serving numbers over ``samples``.  With ``quant`` the control:
    the reference at that precision in the program's place, judged against
    the float32 reference on the same served inputs."""
    reference.setup()
    ref = Ref(sd, hp)
    cents = centroids(ref, manifest, hp, device)
    ctl = Ref(sd, hp, quant) if quant else None
    ctl_cents = centroids(ctl, manifest, hp, device) if ctl else None
    out = {"mel": 0.0, "post": 0.0, "wav": 0.0, "frames": 0}
    for s in samples:
        mel_r, res_r, gate_r = _reference_outputs(ref, s, cents, hp, device)
        served = torch.as_tensor(s["mel"][0].T, device=device)
        served_post = torch.as_tensor(s["mel_post"][0].T, device=device)
        if ctl is not None:
            mel_c, res_c, _ = _reference_outputs(ctl, s, ctl_cents, hp, device)
            got_mel, got_post = mel_c, served + res_c
        else:
            got_mel, got_post = served, served_post
        out["mel"] = max(out["mel"], _rel(got_mel, mel_r))
        out["post"] = max(out["post"], _rel(got_post, served + res_r))
        fired = torch.nonzero(torch.sigmoid(gate_r) > hp["gate_threshold"])
        stop = int(fired[0, 0]) + 1 if len(fired) else hp["max_decoder_steps"]
        out["frames"] += int(s["n"] != stop * hp["n_frames_per_step"])
        T = served_post.shape[0]
        bucket = hp["mel_bucket_size"]
        pad = -(-T // bucket) * bucket - T
        mel_p = torch.nn.functional.pad(served_post.T[None], (0, pad), value=float(np.log(1e-5)))
        wav_r = ref_wg.to_pcm16(ref_wg.infer(wg_sd, wg_cfg, mel_p, s["vocode_seed"])[
            0, :T * hp["hop_length"]].cpu().numpy())
        if ctl is not None:
            got = ref_wg.to_pcm16(ref_wg.infer(wg_sd, wg_cfg, mel_p, s["vocode_seed"],
                                               quant=quant)[0, :T * hp["hop_length"]]
                                  .cpu().numpy())
        else:
            got = s["wav"]
        if got.shape != wav_r.shape:
            out["wav"] = max(out["wav"], 1.0)
        else:
            out["wav"] = max(out["wav"], float(np.abs(got.astype(np.int64) - wav_r).max())
                             / 32767.0)
    return out


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """|‖prog‖ - ‖ref‖| of each leaf of ``names``, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = {k: float(ref[k].double().norm()) for k in names}
    med = float(np.median(list(norms.values()))) if norms else 0.0
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in names}


def _worst(gaps: dict, n: int = 4) -> list:
    return sorted(((round(v, 6), k) for k, v in gaps.items()), reverse=True)[:n]


def train_numbers(sd: dict, batches: list, hp: dict, seed: int, prog: dict, device,
                  quant=None) -> dict:
    """The training numbers.  ``prog`` holds the program's ``losses`` of
    steps 1-3, ``grad`` (Adam's first moment after step 1, over 1 - beta1)
    and ``params`` after step 3 ({name: tensor}).  With ``quant`` the
    control's numbers: the reference at that precision in the program's
    place."""
    reference.setup()
    losses, g1, p3, out1 = train_steps(sd, batches, hp, seed, device)
    if quant is not None:
        c_losses, c_g1, c_p3, c_out1 = train_steps(sd, batches, hp, seed, device, quant)
        prog = {"losses": c_losses, "grad": c_g1, "params": c_p3, "out1": c_out1}
    names = sorted(g1)
    gnorm = {k: float(g1[k].double().norm()) for k in names}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in names if gnorm[k] >= 1e-3 * med]
    d_ref = {k: p3[k] - sd[k].float() for k in moved}
    d_prog = {k: prog["params"][k].float() - sd[k].float() for k in moved}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses))
    grad, change = leaf_gaps(prog["grad"], g1, names), leaf_gaps(d_prog, d_ref, moved)
    return {"loss": loss_gap, "loss1": abs(prog["losses"][0] - losses[0]) / abs(losses[0]),
            "out1": (_rel(prog["out1"].float(), out1) if prog["out1"].shape == out1.shape
                     else 1.0),
            "grad": max(grad.values()), "change": max(change.values()),
            "grad_med": float(np.median(list(grad.values()))),
            "change_med": float(np.median(list(change.values()))),
            "worst_grad": _worst(grad), "worst_change": _worst(change),
            "ref_losses": losses, "left_out": [k for k in names if k not in moved]}


def checks(numbers: dict, keys) -> dict:
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in keys}
