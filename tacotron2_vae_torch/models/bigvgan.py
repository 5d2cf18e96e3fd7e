"""BigVGAN generator (mel -> waveform) in PyTorch.

Lee et al., "BigVGAN: A Universal Neural Vocoder with Large-Scale Training"
(arXiv:2206.04658); NVIDIA's ``bigvgan_22khz_80band`` configuration is
``BigVGANConfig()``.  ``conv_pre`` (k 7), then per stage i a transposed
convolution (``ups.{i}.0``: C/2^i -> C/2^(i+1), kernel k_i, stride u_i,
padding (k_i - u_i)/2; no activation before it) and the mean of one
``AMPBlock1`` per resblock kernel size; then ``activation_post``,
``conv_post`` (k 7) and tanh.  An AMPBlock1 of kernel k adds, for each
dilation d, ``conv2(A2(conv1_d(A1(x))))`` to x, each A its own anti-aliased
SnakeBeta (``Activation1d``: ``ops.aa_snake``, kernel K9 on the card).
Only the generator: no discriminators, no training.

The module tree carries the published names once weight norm is folded
(``convert.from_bigvgan_checkpoint``): ``conv_pre``, ``ups.{i}.0``,
``resblocks.{n}.convs1.{j}`` / ``convs2.{j}``,
``resblocks.{n}.activations.{m}.act.alpha`` / ``.beta``,
``...upsample.filter``, ``...downsample.lowpass.filter``,
``activation_post.*``, ``conv_post``.

Numerics: float32 with cuDNN's TF32 off (``ops.layers.no_tf32``), as the
configuration states.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
from torch import nn

from ..ops.aa_snake import TAPS, aa_snake
from ..ops.layers import no_tf32


@dataclass(frozen=True)
class BigVGANConfig:
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    num_mels: int = 80
    hop_size: int = 256

    def __post_init__(self):
        if self.activation != "snakebeta" or not self.snake_logscale:
            raise ValueError("the port's BigVGAN takes activation 'snakebeta' with "
                             "snake_logscale true")
        if math.prod(self.upsample_rates) != self.hop_size:
            raise ValueError(f"the upsample rates {self.upsample_rates} do not multiply to "
                             f"hop_size {self.hop_size}")

    @classmethod
    def from_dict(cls, d: dict) -> "BigVGANConfig":
        """The published config.json's keys (others, such as the training
        and discriminator settings, are ignored)."""
        if d.get("resblock", "1") != "1":
            raise ValueError("the port's BigVGAN takes AMPBlock1 (resblock '1')")
        kw = {}
        for f in fields(cls):
            if f.name in d:
                v = d[f.name]
                kw[f.name] = (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                              if isinstance(v, list) else v)
        return cls(**kw)

    def stage_channels(self) -> list[int]:
        return [self.upsample_initial_channel // 2 ** (i + 1)
                for i in range(len(self.upsample_rates))]


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> torch.Tensor:
    """BigVGAN's anti-aliasing low-pass (alias_free_torch/filter.py): a
    Kaiser-windowed sinc, normalised to sum 1, shaped (1, 1, kernel_size)."""
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    beta = (0.1102 * (a - 8.7) if a > 50.0 else
            0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0 else 0.0)
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    time = torch.arange(-half, half) + 0.5 if even else torch.arange(kernel_size) - half
    arg = 2 * cutoff * time
    sinc = torch.where(arg == 0, torch.ones_like(arg), torch.sin(math.pi * arg) / (math.pi * arg))
    filt = 2 * cutoff * window * sinc
    return (filt / filt.sum()).reshape(1, 1, kernel_size)


class _Filter(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("filter", kaiser_sinc_filter1d(0.25, 0.3, TAPS))


class SnakeBeta(nn.Module):
    """Per-channel log-scale exponents ``alpha``, ``beta`` (published init: 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation1d(nn.Module):
    """Down(SnakeBeta(Up(x))) at ratio 2 with 12-tap filters: kernel K9."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.upsample = _Filter()
        self.downsample = nn.Module()
        self.downsample.lowpass = _Filter()

    def forward(self, x):
        return aa_snake(x, self.act.alpha, self.act.beta, self.upsample.filter,
                        self.downsample.lowpass.filter)


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size * d - d) // 2) for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilations)
        self.activations = nn.ModuleList(Activation1d(channels)
                                         for _ in range(2 * len(dilations)))

    def forward(self, x):
        acts = self.activations
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            x = x + c2(acts[2 * j + 1](c1(acts[2 * j](x))))
        return x


class BigVGAN(nn.Module):
    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ModuleList([nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), k, u,
                                              padding=(k - u) // 2)])
            for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            AMPBlock1(ch, k, d) for ch in cfg.stage_channels()
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        ch = cfg.stage_channels()[-1]
        self.activation_post = Activation1d(ch)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        """mel (B, num_mels, T) -> waveform (B, T * hop_size) in (-1, 1)."""
        nk = len(self.cfg.resblock_kernel_sizes)
        with no_tf32():
            x = self.conv_pre(mel.float())
            for i, up in enumerate(self.ups):
                x = up[0](x)
                xs = None
                for j in range(nk):
                    r = self.resblocks[i * nk + j](x)
                    xs = r if xs is None else xs + r
                x = xs / nk
            x = self.conv_post(self.activation_post(x))
        return torch.tanh(x)[:, 0]
