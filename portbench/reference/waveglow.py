"""WaveGlow's inverse (NVIDIA ``glow.py``: ``WaveGlow.infer``) in plain
PyTorch: mel upsampling by a transposed convolution, squeeze into groups,
``n_flows`` flows of an affine coupling with a WaveNet conditioner and an
invertible 1x1 mixing, early outputs every ``n_early_every`` flows.
Weights under the names of NVIDIA's module tree (weight norm folded)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def audio_channels(cfg: dict) -> list:
    chans, c = [], cfg["n_group"]
    for k in range(cfg["n_flows"]):
        if k % cfg["n_early_every"] == 0 and k > 0:
            c -= cfg["n_early_size"]
        chans.append(c)
    return chans


def _wn(sd, k, x0, cond, cfg, q):
    p = f"WN.{k}."
    nc, L = cfg["n_channels"], cfg["n_layers"]

    def conv(x, name, dil=1):
        w = sd[p + name + ".weight"]
        return F.conv1d(q(x), q(w), sd[p + name + ".bias"], dilation=dil,
                        padding=(w.shape[-1] - 1) * dil // 2)

    x = conv(x0, "start")
    cond_all = conv(cond, "cond_layer")
    out = 0
    for i in range(L):
        a = conv(x, f"in_layers.{i}", 2 ** i)
        c = cond_all[:, i * 2 * nc:(i + 1) * 2 * nc]
        acts = torch.tanh(a[:, :nc] + c[:, :nc]) * torch.sigmoid(a[:, nc:] + c[:, nc:])
        rs = conv(acts, f"res_skip_layers.{i}")
        if i < L - 1:
            x = x + rs[:, :nc]
            rs = rs[:, nc:]
        out = out + rs
    out = conv(out, "end")
    h = out.shape[1] // 2
    return out[:, :h], out[:, h:]


@torch.no_grad()
def infer(sd: dict, cfg: dict, mel: torch.Tensor, seed: int, sigma: float = 0.666,
          quant=None) -> torch.Tensor:
    """mel (B, n_mel, T_mel) -> audio (B, T_mel * stride), with
    z = sigma * randn((B, n_group, T)) from a generator on mel's device
    seeded with ``seed``."""
    from .model import quantizer

    q = quantizer(quant)
    k_up, s = cfg["upsample_kernel"], cfg["upsample_stride"]
    up = F.conv_transpose1d(mel, sd["upsample.weight"], sd["upsample.bias"], stride=s)
    up = up[:, :, :up.shape[2] - (k_up - s)]
    B, M, Tu = up.shape
    g = cfg["n_group"]
    T = Tu // g
    cond = up[:, :, :T * g].reshape(B, M, T, g).permute(0, 1, 3, 2).reshape(B, M * g, T)
    gen = torch.Generator(device=mel.device).manual_seed(seed)
    z = sigma * torch.randn((B, g, T), generator=gen, device=mel.device)
    chans = audio_channels(cfg)
    early = [k for k in range(cfg["n_flows"]) if k % cfg["n_early_every"] == 0 and k > 0]
    parts = list(torch.split(z, [cfg["n_early_size"]] * len(early) + [chans[-1]], dim=1))
    x = parts.pop()
    for k in reversed(range(cfg["n_flows"])):
        h = chans[k] // 2
        x0, x1 = x[:, :h], x[:, h:]
        b, log_s = _wn(sd, k, x0, cond, cfg, q)
        x = torch.cat([x0, (x1 - b) * torch.exp(-log_s)], 1)
        w_inv = torch.linalg.inv(sd[f"convinv.{k}.conv.weight"][:, :, 0].double()).float()
        x = F.conv1d(x, w_inv[:, :, None])
        if k in early:
            x = torch.cat([parts.pop(), x], 1)
    return x.transpose(1, 2).reshape(B, -1)


def to_pcm16(audio: np.ndarray) -> np.ndarray:
    """A float waveform as the 16-bit samples of a peak-normalised wav."""
    audio = np.asarray(audio, np.float32)
    peak = np.max(np.abs(audio)) if audio.size else 0.0
    if peak > 1.0:
        audio = audio / peak
    return (audio * 32767.0).astype(np.int16)
