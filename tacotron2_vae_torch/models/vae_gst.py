"""VAE-GST style encoder: CoordConv reference encoder + GRU + VAE heads.

Counterpart of the JAX package's ``models/vae_gst.py`` (reference
``VAE_GST``/``ReferenceEncoder``/``CoordConv2d``, modules.py:8-85,
CoordConv.py:37-74).  State_dict names: ``ref_encoder.convs.0.conv`` (the
CoordConv), ``ref_encoder.convs.{i}``, ``ref_encoder.bns.{i}``,
``ref_encoder.gru``, ``fc1``/``fc2``/``fc3``.  Eval mode: z = mu; train
mode: batch-statistics BN and z = mu + eps * exp(logvar / 2).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layers import batchnorm, conv2d, linear
from ..ops.rnn import gru_scan


def conv_out_len(L: int, n_convs: int, kernel=3, stride=2, pad=1) -> int:
    for _ in range(n_convs):
        L = (L - kernel + 2 * pad) // stride + 1
    return L


class CoordConv2d(nn.Module):
    """Reference CoordConv2d container (rank 2, with_r): ``conv`` sees the
    input plus x, y and r coordinate channels."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = nn.Conv2d(in_ch + 3, out_ch, 3, stride=2, padding=1)


class ReferenceEncoder(nn.Module):
    def __init__(self, hp):
        super().__init__()
        filters = [1] + list(hp.ref_enc_filters)
        K = len(hp.ref_enc_filters)
        self.convs = nn.ModuleList(
            [CoordConv2d(filters[0], filters[1])]
            + [nn.Conv2d(filters[i], filters[i + 1], 3, stride=2, padding=1)
               for i in range(1, K)]
        )
        self.bns = nn.ModuleList([nn.BatchNorm2d(f) for f in hp.ref_enc_filters])
        out_freq = conv_out_len(hp.n_mel_channels, K)
        self.gru = nn.GRU(hp.ref_enc_filters[-1] * out_freq, hp.E // 2,
                          batch_first=True)


def add_coords_2d(x, lengths=None):
    """Append normalised row/col/radius channels (NHWC), rows normalised by
    each item's own valid height when ``lengths`` is given (rows past it
    are zeroed)."""
    B, H, W, _ = x.shape
    dev = x.device
    rows = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None, None]
    cols = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :, None]
    if lengths is None:
        rows = rows / max(H - 1, 1) * 2.0 - 1.0
    else:
        den = torch.clamp(lengths - 1, min=1).float()
        rows = rows / den[:, None, None, None] * 2.0 - 1.0
    cols = cols / max(W - 1, 1) * 2.0 - 1.0
    rows = rows.expand(B, H, W, 1)
    cols = cols.expand(B, H, W, 1)
    r = torch.sqrt((rows - 0.5) ** 2 + (cols - 0.5) ** 2)
    out = torch.cat([x.float(), rows, cols, r], dim=-1)
    if lengths is not None:
        valid = (torch.arange(H, device=dev)[None, :] < lengths[:, None])
        out = torch.where(valid[:, :, None, None], out, torch.zeros_like(out))
    return out


def _zero_rows(x, valid_len):
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < valid_len[:, None]
    return torch.where(valid[:, :, None, None], x, torch.zeros_like(x))


class VAE_GST(nn.Module):
    def __init__(self, hp):
        super().__init__()
        self.ref_encoder = ReferenceEncoder(hp)
        self.fc1 = nn.Linear(hp.ref_enc_gru_size, hp.z_latent_dim)
        self.fc2 = nn.Linear(hp.ref_enc_gru_size, hp.z_latent_dim)
        self.fc3 = nn.Linear(hp.z_latent_dim, hp.E)

    def reference_encoder(self, mel, *, dtype=None, raw_reshape=False,
                          mel_lengths=None, train=False):
        """mel (B, n_mels, T) -> (B, E//2) final GRU state.

        ``raw_reshape`` reproduces the reference's raw-memory
        ``view(N, 1, -1, n_mels)`` input layout (for converted upstream
        checkpoints); the default is the true (time, frequency) transpose.
        ``mel_lengths`` makes zero-padded batches exact per item: invalid
        rows are re-zeroed after every level and the GRU freezes past each
        item's length."""
        enc = self.ref_encoder
        if raw_reshape:
            if mel_lengths is not None:
                raise ValueError(
                    "mel_lengths masking is undefined for the raw_reshape "
                    "compat layout (time is scrambled across image rows)")
            x = mel.reshape(mel.shape[0], -1, mel.shape[1])[..., None]
        else:
            x = mel.transpose(1, 2)[..., None]  # (B, T, n_mels, 1)
        valid_len = None
        if mel_lengths is not None:
            valid_len = torch.as_tensor(mel_lengths, device=mel.device).long()
            x = _zero_rows(x, valid_len)
        for i, (conv, bn) in enumerate(zip(enc.convs, enc.bns)):
            if i == 0:
                x = add_coords_2d(x, lengths=valid_len)
                conv = conv.conv
            x = conv2d(x, conv.weight, conv.bias, dtype=dtype)
            x = torch.relu(batchnorm(x, bn, train=train))
            if valid_len is not None:
                valid_len = (valid_len - 1) // 2 + 1
                x = _zero_rows(x, valid_len)
        B, T, Fq, C = x.shape
        # channel-major flatten, as the reference's NCHW -> (N, T, C, F) view
        x = x.transpose(2, 3).reshape(B, T, C * Fq)
        _, h_final = gru_scan(x, enc.gru, lengths=valid_len, dtype=dtype)
        return h_final

    def forward(self, mel, *, dtype=None, raw_reshape=False, mel_lengths=None,
                train=False, generator=None):
        """mel (B, n_mels, T) -> (style_embed, mu, logvar, z).

        Eval: z = mu.  Train: z = mu + eps * exp(0.5 * logvar) with eps
        standard normal from ``generator`` (modules.py:16-22)."""
        enc = self.reference_encoder(mel, dtype=dtype, raw_reshape=raw_reshape,
                                     mel_lengths=mel_lengths, train=train)
        mu = linear(enc, self.fc1.weight, self.fc1.bias)
        logvar = linear(enc, self.fc2.weight, self.fc2.bias)
        z = mu
        if train:
            dev = mu.device if generator is None else generator.device
            eps = torch.randn(mu.shape, generator=generator, device=dev).to(mu.device)
            z = mu + eps * torch.exp(0.5 * logvar)
        style = linear(z, self.fc3.weight, self.fc3.bias)
        return style, mu, logvar, z
