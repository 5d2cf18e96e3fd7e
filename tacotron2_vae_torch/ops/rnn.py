"""Recurrent cells and scans (LSTM, BiLSTM, GRU) in plain PyTorch.

Gate order and bias placement are PyTorch's (LSTM i,f,g,o with bi+bh; GRU
r,z,n with the hidden bias inside the reset product), so reference
checkpoints load as they are.  Each function takes the module's weight
tensors in PyTorch layout ((4H, in), (4H, H), ...).  Variable lengths follow
``pack_padded_sequence``: padded steps do not update the state and emit
zeros; the backward direction scans the reversed sequence, whose padded
steps come first and keep the zero initial state.  The LSTM recurrence
itself is ``encoder_lstm.lstm_dirs`` (kernels K7/K8 on CUDA).
"""

from __future__ import annotations

import torch

from . import encoder_lstm
from .layers import linear


def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh, dtype=None):
    """One LSTM step. x (B, D), h/c (B, H) fp32 -> (h', c')."""
    gates = (linear(x, w_ih, dtype=dtype) + linear(h, w_hh, dtype=dtype)
             + b_ih.float() + b_hh.float())
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_scan(xs, w_ih, w_hh, b_ih, b_hh, lengths=None, reverse=False,
              dtype=None):
    """Unidirectional LSTM over (B, T, D) -> (B, T, H) outputs."""
    return _scan_dirs(xs, [(w_ih, w_hh, b_ih, b_hh, reverse)], lengths, dtype)[0]


def bilstm(xs, lstm: torch.nn.LSTM, lengths=None, dtype=None):
    """Bidirectional single-layer LSTM: (B, T, D) -> (B, T, 2H)."""
    fwd, bwd = _scan_dirs(xs, [
        (lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0, lstm.bias_hh_l0, False),
        (lstm.weight_ih_l0_reverse, lstm.weight_hh_l0_reverse, lstm.bias_ih_l0_reverse,
         lstm.bias_hh_l0_reverse, True)], lengths, dtype)
    return torch.cat([fwd, bwd], dim=-1)


def _scan_dirs(xs, dirs, lengths, dtype):
    """Run the directions ``dirs`` = [(w_ih, w_hh, b_ih, b_hh, reverse)]
    together: one input product a direction, then the recurrence of every
    direction in one call (``encoder_lstm.lstm_dirs``: K7/K8 on CUDA);
    returns one (B, T, H) output per direction, in time order."""
    reverse = [rev for *_, rev in dirs]
    gx = torch.stack([linear(xs.flip(1) if rev else xs, d[0], dtype=dtype)
                      for d, rev in zip(dirs, reverse)])
    w_hh = torch.stack([d[1] for d in dirs])
    bias = torch.stack([d[2].float() + d[3].float() for d in dirs])
    outs = encoder_lstm.lstm_dirs(gx, w_hh, bias, lengths, reverse, dtype)
    return [out.flip(1) if rev else out for rev, out in zip(reverse, outs)]


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh, dtype=None):
    """One GRU step, PyTorch gate order (r, z, n) and bias placement."""
    gi = linear(x, w_ih, b_ih, dtype=dtype)
    gh = linear(h, w_hh, b_hh, dtype=dtype)
    ir, iz, in_ = gi.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h.float()


def gru_scan(xs, gru: torch.nn.GRU, lengths=None, dtype=None):
    """GRU over (B, T, D); returns (outputs (B, T, H), final state (B, H)),
    the state frozen past each item's length."""
    B, T, _ = xs.shape
    H = gru.weight_hh_l0.shape[1]
    h = xs.new_zeros((B, H), dtype=torch.float32)
    outs = []
    for t in range(T):
        h_new = gru_cell(xs[:, t], h, gru.weight_ih_l0, gru.weight_hh_l0,
                         gru.bias_ih_l0, gru.bias_hh_l0, dtype=dtype)
        if lengths is not None:
            h_new = torch.where((t < lengths)[:, None], h_new, h)
        h = h_new
        outs.append(h)
    return torch.stack(outs, dim=1), h
