"""Transcript encoder: 3 x (conv5 + BN + ReLU [+ dropout]) -> BiLSTM.

Counterpart of the JAX package's ``models/encoder.py`` (reference
``Encoder``, model.py:151-203) with the reference state_dict names
``convolutions.{i}.0.conv`` / ``convolutions.{i}.1`` / ``lstm``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layers import ConvNorm, batchnorm, col_conv1d, dropout
from ..parallel import tp
from ..ops.rnn import bilstm

DROP_RATE = 0.5  # reference model.py:11


class Encoder(nn.Module):
    def __init__(self, hp):
        super().__init__()
        dim = hp.encoder_embedding_dim
        self.convolutions = nn.ModuleList([
            nn.Sequential(ConvNorm(dim, dim, hp.encoder_kernel_size),
                          nn.BatchNorm1d(dim))
            for _ in range(hp.encoder_n_convolutions)
        ])
        self.lstm = nn.LSTM(dim, dim // 2, 1, batch_first=True,
                            bidirectional=True)

    def forward(self, x, lengths=None, *, dtype=None, mask_conv_inputs=False,
                train=False, generator=None):
        """x (B, T, D) embedded text -> (B, T, D).

        ``mask_conv_inputs`` zeroes padded positions before every conv, so
        a bucket-padded sequence gives the unpadded run's valid outputs.
        ``train`` normalises with batch statistics (updating the running
        ones) and applies dropout 0.5 after every ReLU, drawn from
        ``generator``; training masks no conv input, as the reference lets
        pad leak into the receptive field (JAX ``encoder.apply``).  Under
        a model axis each conv writes this rank's channels, normalised and
        dropped on their own, and the row's are gathered before the next."""
        mask = None
        if mask_conv_inputs and lengths is not None:
            mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                    < lengths[:, None])[..., None]
        for block in self.convolutions:
            conv, bn = block[0].conv, block[1]
            if mask is not None:
                x = torch.where(mask, x, torch.zeros_like(x))
            x = col_conv1d(x, conv.weight, conv.bias, dtype=dtype)
            x = torch.relu(batchnorm(x, bn, train=train))
            x = tp.gather(dropout(x, DROP_RATE, generator, enabled=train, col_dim=-1), -1)
        return bilstm(x, self.lstm, lengths, dtype=dtype)
