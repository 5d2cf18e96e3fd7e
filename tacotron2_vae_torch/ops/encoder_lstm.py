"""Encoder LSTM recurrence: kernels K7 (forward) and K8 (backward).

``lstm_dirs`` runs the recurrence of the transcript encoder's BiLSTM
(``ops/rnn.py`` ``bilstm``, and ``lstm_scan`` with one direction) over all
T steps, every direction at once, after the input projections: gx (D, B, T,
4H), each direction in its own time order (a reversed direction's sequence
is reversed); w_hh (D, 4H, H); bias (D, 4H) = b_ih + b_hh; outputs (D, B,
T, H).  Gate order and casting points are the JAX scan's
(``tacotron2_vae_tpu/ops/rnn.py``): the hidden product's operands rounded to
the stream ``dtype`` and summed in float32, h and c float32.  Pack-padded
lengths: a step outside its row's length keeps the state and emits zeros;
a reversed direction's padded steps come first.

On a CUDA tensor the forward is one launch of K7 and, under autograd, the
backward one launch of K8 (``csrc/encoder_lstm.cu``), then one product for
dw_hh and a sum for the bias; shapes the kernels do not take raise.  On a
CPU tensor the same ``torch.autograd.Function`` runs the plain twins below
(``lstm_fwd_plain``, a step at a time, and ``lstm_bwd_plain``, its reverse).
Launches are counted in ``lstm_fwd.launches`` and ``lstm_bwd.launches`` and,
while ``utils.profiling`` records, in the counters ``encoder_lstm.fwd`` and
``encoder_lstm.bwd``.

Gradients round where autograd of the loop rounds them: the recurrent
gradient ``cast(dg w_hh)`` and dw_hh (the cast of w_hh) to the stream dtype;
gx's and the bias's are float32.  dw_hh reads h before each step from the
outputs (the step before's output, zero first), which holds because lengths
make every direction's valid steps one contiguous run.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build
from .layers import cast

SIZES = (16, 32, 64, 128, 256)  # hidden sizes the kernels take (8 CTAs of H/8 units)
CLUSTER = 8                 # CTAs of a (direction, row tile): kCL in the source
# The stream dtypes' codes in the C entry points (the C side refuses any other)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def valid_mask(T, lengths, reverse, device):
    """(D, T, B, 1) bool: step t of direction d lies inside its row's
    length (a reversed direction counts from the sequence's end); None
    without lengths."""
    if lengths is None:
        return None
    t = torch.arange(T, device=device)
    return torch.stack([((T - 1 - t if rev else t)[:, None] < lengths[None, :])[..., None]
                        for rev in reverse])


# ------------------------------------------------------------- plain twins


def lstm_fwd_plain(gx, w_hh, bias, valid, dtype=None):
    """The recurrence one step at a time: one batched hidden product and one
    set of gate ops a step serve every direction.  valid: ``valid_mask``'s.
    Returns (out (D, B, T, H), the gates before their activations (D, B, T,
    4H), the cell state after each step (D, B, T, H)), all float32."""
    D, B, T, _ = gx.shape
    H = w_hh.shape[2]
    wh = cast(w_hh, dtype).transpose(1, 2)              # (D, H, 4H), cast once
    h = gx.new_zeros((D, B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs, gates, cells = [], [], []
    for t in range(T):
        g = gx[:, :, t] + torch.bmm(cast(h, dtype), wh) + bias[:, None]
        sg = torch.sigmoid(g)
        c_new = sg[..., H:2 * H] * c + sg[..., :H] * torch.tanh(g[..., 2 * H:3 * H])
        h_new = sg[..., 3 * H:] * torch.tanh(c_new)
        if valid is not None:
            h = torch.where(valid[:, t], h_new, h)
            c = torch.where(valid[:, t], c_new, c)
            outs.append(torch.where(valid[:, t], h_new, 0.0))
        else:
            h, c = h_new, c_new
            outs.append(h_new)
        gates.append(g)
        cells.append(c)
    return tuple(torch.stack(x, dim=2) for x in (outs, gates, cells))


def lstm_bwd_plain(dout, gates, cells, w_hh, valid, dtype=None):
    """Reverse-time backward of ``lstm_fwd_plain`` from its residuals:
    dout (D, B, T, H) -> the gates' gradient (D, B, T, 4H), which is gx's."""
    D, B, T, H = dout.shape
    wh = cast(w_hh, dtype)                              # (D, 4H, H)
    dh = dout.new_zeros((D, B, H))
    dc = torch.zeros_like(dh)
    dgs = [None] * T
    for t in reversed(range(T)):
        i, f, o = (torch.sigmoid(gates[:, :, t, k * H:(k + 1) * H]) for k in (0, 1, 3))
        gg = torch.tanh(gates[:, :, t, 2 * H:3 * H])
        c_prev = cells[:, :, t - 1] if t else torch.zeros_like(dc)
        tc = torch.tanh(cells[:, :, t])
        dhn = dh + dout[:, :, t]
        dct = dc + dhn * o * (1 - tc * tc)
        dg = torch.cat([dct * gg * i * (1 - i), dct * c_prev * f * (1 - f),
                        dct * i * (1 - gg * gg), dhn * tc * o * (1 - o)], dim=-1)
        if valid is None:
            dc, dh = dct * f, 0.0
        else:  # outside the length the state passes through the step untouched
            v = valid[:, t]
            dg = torch.where(v, dg, 0.0)
            dc, dh = torch.where(v, dct * f, dc), torch.where(v, 0.0, dh)
        dgs[t] = dg
        dh = dh + cast(torch.bmm(dg, wh), dtype)
    return torch.stack(dgs, dim=2)


def weight_grads(dg, out, dtype=None):
    """(dw_hh (D, 4H, H), dbias (D, 4H)) from the gates' gradient and the
    outputs: h before each step is the output of the step before."""
    D, B, T, G4 = dg.shape
    h_prev = F.pad(out, (0, 0, 1, 0))[:, :, :T]
    dw = torch.bmm(dg.reshape(D, B * T, G4).transpose(1, 2),
                   cast(h_prev, dtype).reshape(D, B * T, -1))
    return cast(dw, dtype), dg.sum((1, 2))


# ---------------------------------------------------------------- wrappers


def _ptr(x):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _fn(sym, n_int, n_ptr):
    fn = getattr(_build.load("encoder_lstm"), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * n_int + [ctypes.c_void_p] * n_ptr
    return fn


def _args(x, w, lengths, reverse):
    """(D, B, T, H, the reverse bits, int32 lengths) after the checks the
    kernels need; x is gx or dout, (D, B, T, ...) float32."""
    D, B, T = x.shape[:3]
    H = w.shape[2]
    if w.dtype not in DTYPES:
        raise ValueError(f"stream dtype must be one of {list(DTYPES)}, got {w.dtype}")
    if H not in SIZES or w.shape != (D, 4 * H, H) or D not in (1, 2) or len(reverse) != D:
        raise ValueError(f"the encoder LSTM kernels take 1 or 2 directions of H in {SIZES}; "
                         f"got w_hh {tuple(w.shape)} for {D} directions")
    if B < 1 or T < 1:
        raise ValueError(f"empty recurrence: B={B}, T={T}")
    lens = None if lengths is None else lengths.to(device=x.device, dtype=torch.int32)
    if lens is not None and lens.shape != (B,):
        raise ValueError(f"lengths must be (B,) = ({B},)")
    for name, t in (("x", x), ("w_hh", w), ("lengths", lens)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"the recurrence's activations are float32, got {x.dtype}")
    return D, B, T, H, sum(1 << d for d, rev in enumerate(reverse) if rev), lens


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _run_fwd(gx, w, bias, lengths, reverse, save):
    D, B, T, H, rev, lens = _args(gx, w, lengths, reverse)
    if bias.shape != (D, 4 * H) or bias.dtype != torch.float32 or not bias.is_contiguous():
        raise ValueError(f"bias must be contiguous (D, 4H) = {(D, 4 * H)} float32")
    out = torch.empty(D, B, T, H, dtype=torch.float32, device=gx.device)
    g = torch.empty_like(gx) if save else None
    c = torch.empty_like(out) if save else None
    err = _fn("t2v_encoder_lstm_fwd", 6, 8)(
        DTYPES[w.dtype], D, B, T, H, rev, _ptr(gx), _ptr(w), _ptr(bias), _ptr(lens),
        _ptr(out), _ptr(g), _ptr(c), _stream(gx.device))
    _build.check(err, "t2v_encoder_lstm_fwd")
    return out, g, c


def _run_bwd(dout, gates, cells, w, lengths, reverse):
    D, B, T, H, rev, lens = _args(dout, w, lengths, reverse)
    for name, x, n in (("gates", gates, 4 * H), ("cells", cells, H)):
        if x.shape != (D, B, T, n) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {(D, B, T, n)} float32")
    dg = torch.empty_like(gates)
    err = _fn("t2v_encoder_lstm_bwd", 6, 7)(
        DTYPES[w.dtype], D, B, T, H, rev, _ptr(w), _ptr(lens), _ptr(dout), _ptr(gates),
        _ptr(cells), _ptr(dg), _stream(dout.device))
    _build.check(err, "t2v_encoder_lstm_bwd")
    return dg


def _plain_dtype(w):
    return None if w.dtype == torch.float32 else w.dtype


def lstm_fwd(gx, w, bias, lengths=None, reverse=(False,), save=True):
    """Forward recurrence (K7 on CUDA, the twin on the CPU): w (D, 4H, H) in
    the stream dtype; returns (out, gates, cells), the last two None unless
    ``save`` (the residuals of ``lstm_bwd``)."""
    if gx.is_cuda:
        out = _run_fwd(gx, w, bias, lengths, reverse, save)
        lstm_fwd.launches += 1
        profiling.count("encoder_lstm.fwd")
        return out
    if gx.device.type != "cpu":
        raise ValueError(f"lstm_fwd runs on CUDA or CPU, not {gx.device}")
    valid = valid_mask(gx.shape[2], lengths, reverse, gx.device)
    out, g, c = lstm_fwd_plain(gx, w, bias, valid, _plain_dtype(w))
    return (out, g, c) if save else (out, None, None)


def lstm_bwd(dout, gates, cells, w, lengths=None, reverse=(False,)):
    """Reverse-time backward (K8 on CUDA, the twin on the CPU): the gates'
    gradient (D, B, T, 4H)."""
    if dout.is_cuda:
        dg = _run_bwd(dout, gates, cells, w, lengths, reverse)
        lstm_bwd.launches += 1
        profiling.count("encoder_lstm.bwd")
        return dg
    if dout.device.type != "cpu":
        raise ValueError(f"lstm_bwd runs on CUDA or CPU, not {dout.device}")
    valid = valid_mask(dout.shape[2], lengths, reverse, dout.device)
    return lstm_bwd_plain(dout, gates, cells, w, valid, _plain_dtype(w))


lstm_fwd.launches = 0
lstm_bwd.launches = 0


class _Recurrence(torch.autograd.Function):
    """The recurrence with K8 (or its twin) as its backward."""

    @staticmethod
    def forward(ctx, gx, w_hh, bias, lengths, reverse, dtype):
        w = w_hh.detach().to(dtype or torch.float32).contiguous()
        out, gates, cells = lstm_fwd(gx.contiguous(), w, bias.contiguous(), lengths, reverse)
        ctx.save_for_backward(out, gates, cells, w, lengths)
        ctx.reverse, ctx.dtype = reverse, dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        out, gates, cells, w, lengths = ctx.saved_tensors
        dg = lstm_bwd(dout.contiguous(), gates, cells, w, lengths, ctx.reverse)
        dw, db = weight_grads(dg, out, ctx.dtype)
        return dg, dw, db, None, None, None


def lstm_dirs(gx, w_hh, bias, lengths=None, reverse=(False,), dtype=None):
    """Outputs (D, B, T, H) of D directions, each in its own time order (see
    the module docstring); differentiable in gx, w_hh and bias."""
    reverse = tuple(bool(r) for r in reverse)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (gx, w_hh, bias)):
        return _Recurrence.apply(gx, w_hh, bias, lengths, reverse, dtype)
    w = w_hh.to(dtype or torch.float32).contiguous()
    return lstm_fwd(gx.contiguous(), w, bias.contiguous(), lengths, reverse, save=False)[0]
