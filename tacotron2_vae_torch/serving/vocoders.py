"""The Synthesizer's vocoders: a (1, n_mel, T) numpy log-mel -> samples.

``load_vocoder`` alone tells the file kinds apart: a pickle holds the JAX
package's WaveGlow params (``"waveglow"``, float16 cast to float32; maybe a
``"config"``); a torch checkpoint holding ``"generator"`` is BigVGAN's in
its published layout, its config the ``"config"`` entry or the
``config.json`` beside it; any other is a reference NVIDIA WaveGlow.
Without a file the Synthesizer vocodes by ``GriffinLim``.

``vocoder(mel, draw_seed, sigma, dtype)``: ``draw_seed()`` draws the next
seed of the Synthesizer's stream, once a call for WaveGlow and Griffin-Lim,
never for BigVGAN.  The neural vocoders pad the mel with log-silence to a
multiple of ``mel_bucket_size`` frames (as the JAX package pads it) and
return T * hop_length samples, Griffin-Lim (T - 1) * hop_length.  ``sigma``
and ``dtype`` (float32 by default, or torch.bfloat16 WaveNet convolutions)
are WaveGlow's; BigVGAN refuses a dtype other than float32.  BigVGAN's
generator is the span ``vocode.bigvgan`` (a CUDA event pair on a card,
placed on the host clock, and the padded mel's ``frames``) and the counter
``bigvgan.audio_samples``; it and kernel K9 are imported only when a
BigVGAN file is loaded.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ..convert import (from_bigvgan_checkpoint, from_jax_waveglow, from_reference_waveglow,
                       read_torch_checkpoint)
from ..dsp import griffin_lim
from ..dsp.stft import dynamic_range_decompression
from ..models import waveglow as waveglow_model
from ..utils import profiling


def load_vocoder(path: str, hp, device):
    """The vocoder in the file at ``path`` (see the module note), on
    ``device`` in eval mode without gradients."""
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        return WaveGlow(from_jax_waveglow(blob["waveglow"]), blob.get("config"), hp, device)
    blob = read_torch_checkpoint(path)
    if isinstance(blob, dict) and "generator" in blob:
        return BigVGAN(blob, path, hp, device)
    return WaveGlow(from_reference_waveglow(blob), None, hp, device)


class _Bucketed:
    """A neural vocoder (``module`` and its weights, frozen on ``device``):
    the padded mel in, T * hop_length samples out."""

    def __init__(self, module, state_dict, hp, device):
        module.load_state_dict(state_dict)
        self.module = module.to(device).eval().requires_grad_(False)
        self.device = torch.device(device)
        self.bucket, self.hop = max(hp.mel_bucket_size, 1), hp.hop_length

    def __call__(self, mel, draw_seed, sigma, dtype) -> np.ndarray:
        T = mel.shape[2]
        mel_p = torch.from_numpy(np.pad(
            np.asarray(mel, np.float32),
            ((0, 0), (0, 0), (0, -(-T // self.bucket) * self.bucket - T)),
            constant_values=np.log(1e-5))).to(self.device)
        wav = self.generate(mel_p, T * self.hop, draw_seed, sigma, dtype)
        return wav[0, :T * self.hop].cpu().numpy()


class WaveGlow(_Bucketed):
    """WaveGlow's ``infer``, its noise from a device generator seeded from
    the stream, its flows' inverse weights computed once at load; ``config``
    (a dict) wins over the default at the model's mel count."""

    def __init__(self, state_dict, config, hp, device):
        cfg = waveglow_model.WaveGlowConfig(**(config or {"n_mel_channels": hp.n_mel_channels}))
        super().__init__(waveglow_model.WaveGlow(cfg), state_dict, hp, device)
        self.w_inv = self.module.inverse_weights()

    def generate(self, mel_p, n_samples, draw_seed, sigma, dtype):
        gen = torch.Generator(device=self.device).manual_seed(draw_seed())
        return self.module.infer(mel_p, sigma, gen, dtype, self.w_inv)


class BigVGAN(_Bucketed):
    """BigVGAN's generator: deterministic, float32 only."""

    def __init__(self, blob, path, hp, device):
        from ..models.bigvgan import BigVGAN as Generator, BigVGANConfig

        cfg = blob.get("config")
        if cfg is None:
            cfg_path = os.path.join(os.path.dirname(os.path.abspath(path)), "config.json")
            if not os.path.exists(cfg_path):
                raise ValueError(f"the BigVGAN checkpoint {path!r} has no config: put its "
                                 f"config.json beside it")
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        cfg = BigVGANConfig.from_dict(cfg)
        if (cfg.num_mels, cfg.hop_size) != (hp.n_mel_channels, hp.hop_length):
            raise ValueError(f"BigVGAN takes {cfg.num_mels} mels at hop {cfg.hop_size}; "
                             f"the model makes {hp.n_mel_channels} at hop {hp.hop_length}")
        super().__init__(Generator(cfg), from_bigvgan_checkpoint(blob), hp, device)

    def generate(self, mel_p, n_samples, draw_seed, sigma, dtype):
        if dtype not in (None, torch.float32):
            raise ValueError(f"BigVGAN runs in float32, not {dtype}")
        with profiling.span("vocode.bigvgan"):
            events = None
            if profiling.recording() and mel_p.is_cuda:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            wav = self.module(mel_p)
            if events is not None:
                events[1].record()
                profiling.annotate(device_events=events)
            profiling.annotate(frames=int(mel_p.shape[2]))
        profiling.count("bigvgan.audio_samples", n_samples)
        return wav


class GriffinLim:
    """30 iterations on the magnitudes through the pseudo-inverse of
    ``stft``'s filterbank, the initial phases seeded from the stream."""

    def __init__(self, stft, hp):
        self.stft, self.hp = stft, hp

    def __call__(self, mel, draw_seed, sigma, dtype) -> np.ndarray:
        hp, fb = self.hp, self.stft.mel_basis
        mel_lin = dynamic_range_decompression(torch.as_tensor(mel, device=fb.device))[0]
        mag = torch.clamp(torch.linalg.pinv(fb) @ mel_lin, min=0.0)
        gen = torch.Generator(device=fb.device).manual_seed(draw_seed())
        wav = griffin_lim(mag[None], hp.filter_length, hp.hop_length, hp.win_length,
                          n_iters=30, generator=gen)
        return wav[0].cpu().numpy()
