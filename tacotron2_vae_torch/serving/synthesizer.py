"""Serving-layer Synthesizer: text + style conditioning -> waveform.

Counterpart of the JAX package's ``serving/synthesizer.py`` (reference
``Synthesizer``, synthesizer.py:46-168): ``load(checkpoint_path)`` then
``synthesize(text, path, condition_on_ref, ref_audio, ratios)``.  Style
paths: a reference wav through the VAE-GST encoder (its log-mel from kernel
K2 on the card), a mix of per-emotion latent centroids (precomputed from a
``path|text|speaker|emotion`` manifest and cached to ``.npz`` beside the
checkpoint), and interpolation between two centroids.  The decoder loop runs
as kernel K1 on the card for batches of 1 to 8 rows.

Runs on CUDA unless ``device="cpu"`` is given; without a card it raises.
``load``'s ``vocoder_path`` names a WaveGlow or BigVGAN file, which
``vocoders.load_vocoder`` tells apart, held in ``vocoder``; without one (or
with ``vocoder = None``), Griffin-Lim.  It vocodes the postnet mel
(``vocode_prepostnet=True`` for the reference's pre-postnet mel);
``vocoder_dtype = torch.bfloat16`` runs WaveGlow's WaveNet convolutions on
bf16 operands.  The benchmark wraps ``synthesize_batch``,
``synthesize_mel_batch`` and ``vocode`` on the instance (``synthesize_batch``
reaches the other two through ``self``), sets ``vocoder_dtype`` and reads
``bigvgan``.

While ``utils.profiling`` records, a batch's work is in spans:
``batch.styles`` (each reference clip's ``style.ref``: wav read, K2, VAE),
``mel`` (``mel.text``, then ``Tacotron2.infer``'s ``mel.encoder``,
``mel.decode`` and ``mel.postnet``, then ``mel.fetch``, the copies to the
host), and per item ``vocode`` and ``wav.write``, each with its request id.
BigVGAN's own span and counter: ``vocoders``.

    python -m tacotron2_vae_torch.serving.synthesizer --load_path ckpt.pt \\
        --text "..." [--ref_audio ref.wav | --ratios 1,0,0,0]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import warnings
from typing import Sequence

import numpy as np
import torch

from ..config import create_hparams
from ..convert import from_jax_params
from ..dsp import TacotronSTFT, load_wav, save_wav
from ..models.tacotron2 import Tacotron2, compute_dtype
from ..ops.layers import linear, set_cudnn_flags
from ..text import text_to_sequence
from ..utils import profiling
from . import vocoders


class Synthesizer:
    def __init__(self, hparams=None, device=None):
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Synthesizer runs on a CUDA card and none is "
                               "available; pass device='cpu' to run on the CPU")
        hp = hparams or create_hparams()
        self.hparams = hp = hp.replace(sampling_rate=16000, max_decoder_steps=600)
        set_cudnn_flags(hp)
        self.stft = TacotronSTFT(hp.filter_length, hp.hop_length, hp.win_length,
                                 hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                                 hp.mel_fmax, device=self.device)
        self.model = None
        self.vocoder = None
        self.vocoder_dtype = None
        self.centroids_loaded = False
        self._gen = torch.Generator().manual_seed(hp.seed)

    def _seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self._gen))

    @property
    def bigvgan(self):
        """The loaded BigVGAN generator module, or None."""
        return self.vocoder.module if isinstance(self.vocoder, vocoders.BigVGAN) else None

    # ------------------------------------------------------------------

    def load_mel(self, path: str):
        audio, sr = load_wav(path)
        if sr != self.hparams.sampling_rate:
            raise ValueError(f"{sr} SR doesn't match target {self.hparams.sampling_rate} SR")
        return self.stft.mel_spectrogram(audio[None] / self.hparams.max_wav_value)

    def load(self, checkpoint_path: str, vocoder_path: str | None = None,
             centroid_filelist: str | None = None):
        """Load model weights, a vocoder (optional: ``vocoders.load_vocoder``)
        and per-emotion centroids.  The checkpoint is a pickle of the JAX
        package's numpy params (``{"params", "model_state"}``, as
        ``tools/convert_torch_ckpt.py`` writes) or a reference torch
        checkpoint (a state_dict, or a dict holding one under
        ``"state_dict"``)."""
        model = Tacotron2(self.hparams)
        model.load_state_dict(_load_state_dict(checkpoint_path, self.hparams))
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.vocoder = (vocoders.load_vocoder(vocoder_path, self.hparams, self.device)
                        if vocoder_path else None)
        if centroid_filelist is None:
            centroid_filelist = os.path.join(
                "web", "static", "uploads", "koemo_spk_emo_all_test.txt")
        n = 0
        if os.path.exists(centroid_filelist):
            n = self._load_centroids(checkpoint_path, centroid_filelist)
            if n == 0:
                warnings.warn(f"Centroid filelist {centroid_filelist!r} exists but none "
                              "of its wav paths could be read: emotion centroids are "
                              "ZERO.", stacklevel=2)
        else:
            warnings.warn(f"Centroid filelist not found: {centroid_filelist!r}. Emotion "
                          "centroids are ZERO: the ratio/interpolation style paths "
                          "emit the prior-mean style.", stacklevel=2)
            z = np.zeros(self.hparams.z_latent_dim, np.float32)
            self.neu = self.sad = self.ang = self.hap = z
        self.centroids_loaded = n > 0

    def _embed_mels(self, mels) -> list:
        """VAE latents for a list of (n_mel, T) numpy mels: 16 clips per call,
        zero-padded along time to a multiple of 128 (exact under padding via
        ``mel_lengths``); the raw-reshape layout embeds clip by clip."""
        vae = self.model.vae_gst
        dtype = compute_dtype(self.hparams)
        if self.hparams.ref_enc_raw_reshape:
            return [vae(torch.as_tensor(m, device=self.device)[None], dtype=dtype,
                        raw_reshape=True)[3][0].cpu().numpy() for m in mels]
        batch, bucket = 16, 128
        order = sorted(range(len(mels)), key=lambda i: mels[i].shape[1])
        zs = [None] * len(mels)
        for i in range(0, len(order), batch):
            idx = order[i:i + batch]
            pad_t = -(-max(mels[j].shape[1] for j in idx) // bucket) * bucket
            buf = np.zeros((batch, self.hparams.n_mel_channels, pad_t), np.float32)
            lens = np.ones((batch,), np.int64)  # pad rows: length-1 dummies
            for row, j in enumerate(idx):
                buf[row, :, :mels[j].shape[1]] = mels[j]
                lens[row] = mels[j].shape[1]
            with torch.no_grad():
                z = vae(torch.from_numpy(buf).to(self.device), dtype=dtype,
                        mel_lengths=torch.from_numpy(lens).to(self.device))[3]
            z = z.cpu().numpy()
            for row, j in enumerate(idx):
                zs[j] = z[row]
        return zs

    def _load_centroids(self, checkpoint_path: str, filelist: str) -> int:
        """Per-emotion latent centroids, cached to .npz beside the checkpoint
        under a content fingerprint; unreadable entries are skipped.  Returns
        the number of clips embedded."""
        from ..dsp.stft import featurize_wavs_chunked

        hp = self.hparams
        base = os.path.dirname(os.path.abspath(checkpoint_path))
        tag = os.path.basename(filelist).rsplit("_", 1)[-1].split(".")[0]
        prefix = os.path.basename(checkpoint_path) + "_"
        suffix = "_" + tag + ".npz"
        npz_path = os.path.join(base, prefix + _ckpt_fingerprint(checkpoint_path) + suffix)
        zs = emotions = None
        if os.path.exists(npz_path):
            try:
                with np.load(npz_path) as d:
                    zs, emotions = d["zs"], d["emotions"]
            except (OSError, ValueError, KeyError):
                zs = emotions = None
        if zs is None:
            with open(filelist, encoding="utf-8") as f:
                entries = [line.strip().split("|") for line in f if line.strip()]
            audios, emotions, skipped = [], [], 0
            min_len = hp.filter_length // 2 + 1
            for audio_path, _text, _spk, emotion in entries:
                try:
                    audio, sr = load_wav(audio_path)
                    if sr != hp.sampling_rate or len(audio) < min_len:
                        raise ValueError("wrong rate or shorter than the STFT pad")
                except (OSError, ValueError):
                    skipped += 1
                    continue
                audios.append(audio / hp.max_wav_value)
                emotions.append(int(emotion))
            zs = self._embed_mels(featurize_wavs_chunked(self.stft, audios)) if audios else []
            if skipped:
                warnings.warn(f"Centroid precompute: skipped {skipped}/{len(entries)} "
                              f"unreadable wavs from {filelist!r}.", stacklevel=2)
            if not zs:
                self.neu = self.sad = self.ang = self.hap = np.zeros(hp.z_latent_dim,
                                                                     np.float32)
                return 0
            zs, emotions = np.stack(zs), np.asarray(emotions)
            np.savez(npz_path, zs=zs, emotions=emotions)
            # evict superseded fingerprints of this checkpoint + manifest
            pat = glob.escape(os.path.join(base, prefix)) + "*" + glob.escape(suffix)
            for old in glob.glob(pat):
                mid = os.path.basename(old)[len(prefix):-len(suffix)]
                if old != npz_path and mid and all(c in "0123456789abcdef" for c in mid):
                    try:
                        os.unlink(old)
                    except OSError:
                        pass

        def centroid(e):
            sel = zs[emotions == e]
            return sel.mean(axis=0) if len(sel) else np.zeros(hp.z_latent_dim, np.float32)

        # emotion labels [neu, sad, ang, hap] (reference synthesizer.py:102-105)
        self.neu, self.sad, self.ang, self.hap = (centroid(0), centroid(1),
                                                  centroid(2), centroid(3))
        return int(len(zs))

    # ------------------------------------------------------------------

    def _style(self, z):
        fc3 = self.model.vae_gst.fc3
        z = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
        return linear(z, fc3.weight, fc3.bias)

    @torch.no_grad()
    def style_from_ref(self, ref_audio: str):
        """Style embedding (E,) from a reference wav."""
        mel = self.load_mel(ref_audio)
        style, *_ = self.model.vae_gst(mel, dtype=compute_dtype(self.hparams),
                                       raw_reshape=self.hparams.ref_enc_raw_reshape)
        return style[0]

    def style_from_ratios(self, ratios: Sequence[float]):
        """Style embedding from emotion ratios [neu, sad, hap, ang]."""
        if not self.centroids_loaded:
            warnings.warn("emotion ratios given but no centroids are loaded: the "
                          "ratios have no effect.", stacklevel=2)
        return self._style(ratios[0] * self.neu + ratios[1] * self.sad
                           + ratios[2] * self.hap + ratios[3] * self.ang)

    def interpolate(self, emotion_a: str, emotion_b: str, alpha: float):
        """Style embedding between two emotion centroids (e.g. 'neu', 'sad')."""
        if not self.centroids_loaded:
            warnings.warn("interpolate() called but no centroids are loaded: "
                          "interpolation has no effect.", stacklevel=2)
        za, zb = getattr(self, emotion_a), getattr(self, emotion_b)
        return self._style((1.0 - alpha) * za + alpha * zb)

    # ------------------------------------------------------------------

    def _ids(self, text: str) -> np.ndarray:
        hp = self.hparams
        return np.asarray(text_to_sequence(text, list(hp.text_cleaners),
                                           symbol_type=hp.symbol_type), np.int64)

    def synthesize_mel(self, text: str, style):
        """text + style (E,) -> (mel, mel_postnet, gate, align, n_frames)."""
        return self.synthesize_mel_batch([text], [style])[0]

    def synthesize_mel_batch(self, texts: Sequence[str], styles):
        """Batched text + style -> per-item (mel, mel_post, gate, align, n).

        Texts pad to one bucketed length (masks make the padding exact) and
        the batch pads to the next of {1, 2, 4, 8} rows with length-1
        dummies; on the card one launch of kernel K1 decodes the batch."""
        with profiling.span("mel"):
            return self._mel_batch(texts, styles)

    def _mel_batch(self, texts, styles):
        hp = self.hparams
        with profiling.span("mel.text"):
            seqs = [self._ids(t) for t in texts]
            B = len(seqs)
            bucket = max(hp.text_bucket_size, 1)
            S = -(-max(len(s) for s in seqs) // bucket) * bucket
            Bp = 1
            while Bp < B:
                Bp *= 2
            buf = np.zeros((Bp, S), np.int64)
            lens = np.ones((Bp,), np.int64)
            for i, s in enumerate(seqs):
                buf[i, :len(s)] = s
                lens[i] = len(s)
            style_mat = torch.zeros((Bp, hp.E), dtype=torch.float32, device=self.device)
            for i, s in enumerate(styles):
                style_mat[i] = torch.as_tensor(s, dtype=torch.float32, device=self.device)
            text = torch.from_numpy(buf).to(self.device)
            text_lengths = torch.from_numpy(lens).to(self.device)
        mel, mel_post, gate, align, lengths = self.model.infer(
            text, style_mat, seed=self._seed(), max_steps=hp.max_decoder_steps,
            text_lengths=text_lengths)
        with profiling.span("mel.fetch"):
            mel, mel_post = mel.cpu().numpy(), mel_post.cpu().numpy()
            gate, align = gate.cpu().numpy(), align.cpu().numpy()
            lengths = lengths.cpu().numpy()
        r = hp.n_frames_per_step
        out = []
        for i in range(B):
            n = int(lengths[i])
            n_steps = (n + r - 1) // r
            out.append((mel[i:i + 1, :, :n], mel_post[i:i + 1, :, :n],
                        gate[i:i + 1, :n_steps], align[i:i + 1, :n_steps], n))
        return out

    def synthesize_batch(self, requests, vocode_prepostnet: bool = False):
        """(text, path, condition_on_ref, ref_audio, ratios) requests -> the
        written wav paths: one batched mel synthesis, per-item vocoding."""
        rids = profiling.current_rids() or [None] * len(requests)
        styles = []
        with profiling.span("batch.styles"):
            for (_text, _path, cond, ref, ratios), rid in zip(requests, rids):
                if not cond:
                    styles.append(self.style_from_ratios(ratios or [1.0, 0.0, 0.0, 0.0]))
                    continue
                with profiling.span("style.ref", rid=rid):
                    styles.append(self.style_from_ref(ref))
        items = self.synthesize_mel_batch([r[0] for r in requests], styles)
        for (_text, path, *_), (mel, mel_post, *_), rid in zip(requests, items, rids):
            with profiling.span("vocode", rid=rid):
                wav = self.vocode(mel if vocode_prepostnet else mel_post)
            with profiling.span("wav.write", rid=rid):
                save_wav(path, wav, self.hparams.sampling_rate)
        return [r[1] for r in requests]

    @torch.no_grad()
    def vocode(self, mel: np.ndarray, sigma: float = 0.666) -> np.ndarray:
        """mel (1, n_mel, T) -> waveform by the loaded vocoder, or by
        Griffin-Lim when none is loaded (``vocoders``)."""
        vocoder = self.vocoder or vocoders.GriffinLim(self.stft, self.hparams)
        return vocoder(mel, self._seed, sigma, self.vocoder_dtype)

    def synthesize(self, text: str, path: str, condition_on_ref: bool,
                   ref_audio: str | None, ratios: Sequence[float] | None,
                   vocode_prepostnet: bool = False) -> str:
        """Full text -> wav pipeline (reference synthesizer.py:112-168)."""
        return self.synthesize_batch([(text, path, condition_on_ref, ref_audio, ratios)],
                                     vocode_prepostnet)[0]


# --- checkpoint loading --------------------------------------------------------


def _ckpt_fingerprint(path: str) -> str:
    """Max mtime_ns and summed size over the checkpoint file or directory."""
    mtime, size = 0, 0
    files = ([os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs]
             if os.path.isdir(path) else [path])
    for p in files:
        try:
            st = os.stat(p)
        except OSError:
            continue
        mtime, size = max(mtime, st.st_mtime_ns), size + st.st_size
    return f"{mtime:x}{size:x}"


def _load_state_dict(path: str, hp) -> dict:
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory: Orbax checkpoints need JAX; "
                         "convert one to a params pickle first")
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"\x80\x04" or path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        return from_jax_params(blob["params"], blob["model_state"], hp)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob.get("state_dict", blob)


def _str2bool(v) -> bool:
    return v if isinstance(v, bool) else str(v).lower() in ("yes", "true", "t", "1")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--load_path", required=True)
    parser.add_argument("--vocoder_path", "--waveglow_path", dest="vocoder_path", default=None,
                        help="a WaveGlow pickle or .pt, or a BigVGAN generator checkpoint")
    parser.add_argument("--sample_path", default="samples")
    parser.add_argument("--text", required=True)
    parser.add_argument("--ref_audio", default=None)
    parser.add_argument("--ratios", default="1,0,0,0", help="neu,sad,hap,ang emotion mix")
    parser.add_argument("--is_korean", default=True, type=_str2bool)
    config = parser.parse_args(argv)
    os.makedirs(config.sample_path, exist_ok=True)
    hp = None if config.is_korean else create_hparams(
        "text_cleaners=['english_cleaners'],n_symbols=65")
    synth = Synthesizer(hp)
    synth.load(config.load_path, config.vocoder_path)
    out = os.path.join(config.sample_path, "synth.wav")
    synth.synthesize(config.text, out, condition_on_ref=config.ref_audio is not None,
                     ref_audio=config.ref_audio,
                     ratios=[float(x) for x in config.ratios.split(",")])
    print(out)


if __name__ == "__main__":
    main()
