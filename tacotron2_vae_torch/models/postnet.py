"""Postnet: 5 x (conv5 + BN [+ tanh] [+ dropout]) residual mel refiner.

Counterpart of the JAX package's ``models/postnet.py`` (reference
``Postnet``, model.py:105-148); state_dict names ``convolutions.{i}.0.conv``
and ``convolutions.{i}.1``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layers import ConvNorm, batchnorm, col_conv1d, dropout
from ..parallel import tp

DROP_RATE = 0.5


class Postnet(nn.Module):
    def __init__(self, hp):
        super().__init__()
        n = hp.postnet_n_convolutions
        dims = ([hp.n_mel_channels] + [hp.postnet_embedding_dim] * (n - 1)
                + [hp.n_mel_channels])
        self.convolutions = nn.ModuleList([
            nn.Sequential(ConvNorm(dims[i], dims[i + 1], hp.postnet_kernel_size),
                          nn.BatchNorm1d(dims[i + 1]))
            for i in range(n)
        ])

    def forward(self, mel, *, dtype=None, train=False, generator=None):
        """mel (B, n_mel, T) -> residual (B, n_mel, T) in the compute dtype.

        ``train`` uses batch statistics and applies dropout 0.5 after every
        layer, the last (linear) one included (reference model.py:146).
        Under a model axis each conv writes this rank's channels and the
        row's are gathered before the next, as in the encoder."""
        x = mel.transpose(1, 2)
        n = len(self.convolutions)
        for i, block in enumerate(self.convolutions):
            conv, bn = block[0].conv, block[1]
            x = batchnorm(col_conv1d(x, conv.weight, conv.bias, dtype=dtype), bn, train=train)
            if i < n - 1:
                x = torch.tanh(x)
            x = tp.gather(dropout(x, DROP_RATE, generator, enabled=train, col_dim=-1), -1)
        return x.transpose(1, 2)
