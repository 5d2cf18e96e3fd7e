"""Layers: linear, conv1d, conv2d, batchnorm, dropout, embedding.

Activations keep the JAX package's layouts at these functions (linear:
(..., in); conv1d: (B, T, C) NWC; conv2d: (B, H, W, C) NHWC) so the port
and the reference compare like with like; weights are the PyTorch module
parameters (Linear (out, in), Conv1d (out, in, k), Conv2d (out, in, kh, kw)).

Mixed precision follows the JAX package: with a compute ``dtype`` the
operands are rounded to it and every product accumulates in fp32
(``preferred_element_type=float32``).  Products run in fp32 on the rounded
values, which gives the same sums; float32 matmuls are full precision unless
a caller turns TF32 on, and conv2d turns cuDNN's TF32 off for its call.

The parameter containers ``LinearNorm`` and ``ConvNorm`` carry the
reference's state_dict names (``linear_layer``, ``conv``).

Tensor parallelism (``parallel/tp.py``): ``col_linear``, ``col_conv1d``
and ``col_conv2d`` take this rank's output-feature slice of a weight (and
bias) and a whole input, and return this rank's output features;
``col_embedding`` looks up this rank's columns of the table and gathers
the row's; ``row_linear`` takes this rank's contraction slice of a weight
and a whole input, and returns the whole output.  Outside a scope with a
model axis they are the plain layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh, tp


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to the compute dtype and return fp32 (the operand of an fp32-
    accumulated product); identity on fp32 when ``dtype`` is None."""
    if dtype is None or dtype == torch.float32:
        return x.float()
    return x.to(dtype).float()


class LinearNorm(nn.Module):
    """Reference ``LinearNorm`` container: ``linear_layer`` = nn.Linear."""

    def __init__(self, in_dim, out_dim, bias=True):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim, bias=bias)


class ConvNorm(nn.Module):
    """Reference ``ConvNorm`` container: ``conv`` = nn.Conv1d ('same' pad)."""

    def __init__(self, in_ch, out_ch, kernel_size, bias=True):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=bias)


def linear(x, w, b=None, dtype=None):
    """x (..., in) @ w(out, in)^T with fp32 accumulation, + fp32 bias."""
    y = torch.matmul(cast(x, dtype), cast(w, dtype).t())
    if b is not None:
        y = y + b.float()
    return y


def conv1d(x, w, b=None, dtype=None):
    """'Same'-padded stride-1 conv: x (B, T, C_in) -> (B, T, C_out).

    K shifted products accumulated in fp32, the bias added in the same fp32
    epilogue, then one cast to the compute dtype (JAX ``layers.conv1d``)."""
    K = w.shape[-1]
    pad_l = (K - 1) // 2
    T = x.shape[1]
    xp = F.pad(cast(x, dtype), (0, 0, pad_l, K - 1 - pad_l))
    wc = cast(w, dtype)
    y = None
    for k in range(K):
        term = torch.matmul(xp[:, k:k + T], wc[:, :, k].t())
        y = term if y is None else y + term
    if b is not None:
        y = y + b.float()
    return y if dtype is None else y.to(dtype)


def conv2d(x, w, b=None, stride=(2, 2), padding=(1, 1), dtype=None):
    """x (B, H, W, C_in) NHWC -> (B, H', W', C_out); fp32 accumulation."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(cast(x, dtype).permute(0, 3, 1, 2), cast(w, dtype),
                     stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    return y if dtype is None else y.to(dtype)


def batchnorm(x, bn: nn.BatchNorm1d, eps=None, train: bool = False,
              momentum: float = 0.1):
    """Batchnorm over the last (channel) axis of ``x``; the statistics are
    fp32 and the output keeps ``x``'s dtype.

    Eval mode normalises with the running statistics.  Train mode (JAX
    ``layers.batchnorm(train=True)``) normalises with the batch's one-pass
    statistics ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)`` and updates the
    module's running buffers in place (momentum 0.1, unbiased variance);
    ``nn.BatchNorm``'s own forward is not used, its variance differs.
    Inside a data-parallel scope the statistics are those of the global
    batch (``parallel.mesh.batch_stats``)."""
    eps = bn.eps if eps is None else eps
    xf = x.float()
    if train:
        mean, var, unbiased = mesh.batch_stats(xf, tuple(range(x.ndim - 1)))
        with torch.no_grad():
            bn.running_mean.mul_(1 - momentum).add_(momentum * mean)
            bn.running_var.mul_(1 - momentum).add_(momentum * unbiased)
    else:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    inv = torch.rsqrt(var + eps) * bn.weight.float()
    y = (xf - mean) * inv + bn.bias.float()
    return y.to(x.dtype)


def dropout(x, rate: float, generator=None, enabled: bool = True, batch_dim: int = 0,
            col_dim: int | None = None):
    """Inverted dropout with an explicit generator (off when not enabled);
    inside a scope the mask is drawn at the global batch's shape along
    ``batch_dim`` and cut to this rank's rows, and, where ``x`` holds this
    rank's slice of the features along ``col_dim``, at the full width and
    cut to its columns."""
    if not enabled or rate == 0.0:
        return x
    keep = 1.0 - rate
    dev = x.device if generator is None else generator.device
    if col_dim is None:
        draw = mesh.rand_rows(x.shape, batch_dim, generator, dev)
    else:
        draw = mesh.rand_cols(x.shape, batch_dim, col_dim % x.ndim, generator, dev)
    mask = (draw < keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def embedding(table, ids):
    return F.embedding(ids.long(), table)


def col_linear(x, w, b=None, dtype=None):
    return linear(tp.copy(x), w, b, dtype)


def row_linear(x, w, b=None, dtype=None):
    """``linear`` with w (out, in / model): the partial products summed
    over the row, then the bias."""
    y = tp.reduce(linear(tp.scatter(x, -1), w, dtype=dtype))
    return y if b is None else y + b.float()


def col_conv1d(x, w, b=None, dtype=None):
    return conv1d(tp.copy(x), w, b, dtype)


def col_conv2d(x, w, b=None, dtype=None):
    return conv2d(tp.copy(x), w, b, dtype=dtype)


def col_embedding(table, ids):
    return tp.gather(embedding(table, ids), -1)
