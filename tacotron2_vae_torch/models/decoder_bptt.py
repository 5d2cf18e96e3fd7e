"""Teacher-forced decoder with the hand-written BPTT (``use_custom_bptt``).

Counterpart of the JAX package's ``models/decoder_bptt.py``.  ``ScanCore``
is a ``torch.autograd.Function`` around the decoder recurrence: its forward
runs kernel K3 on a CUDA tensor (the plain twin on the CPU) and saves the
slim residuals; its backward runs kernel K4 over them, which carries only
activation gradients in reverse time, and then, outside the kernel as the
JAX package does, turns the per-step streams into weight gradients: two
large products ``dW = X^T dG`` for the LSTM weights, the bias sums, the
memory gradient, and the location-conv weight gradient from the F-wide
``dloc`` stream.  On a CUDA tensor the kernels always run; shapes they do
not take raise.

Under a mesh's model axis the prenet output and the memory keys are
gathered before ``ScanCore``, which runs on every rank of the row with the
whole weights (the query projection's gathered) and the data rank's rows,
as the JAX ``_shard_mapped_scan_core``; the mel and gate projections after
it are row-parallel (``Decoder.project``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..ops import teacher_fwd as tf
from ..parallel import mesh
from .decoder import group_frames, ungroup_mel

_F32_MIN = float(np.finfo(np.float32).min)
PARAM_NAMES = ("attn_w", "attn_b", "dec_w", "dec_b", "query_w", "loc_w", "loc_dense_w", "v")


def loc_conv_weight_grad(w_prev, w_cum, dloc, K: int):
    """Gradient of the location conv wrt its (K, 2, F) weight:
    dW[k, c, f] = sum_{n, s} feats[n, s + k - pad, c] * dloc[n, s, f], with
    w_prev, w_cum (N, S) and dloc (N, S, F); float32 sums."""
    pad = (K - 1) // 2
    S = dloc.shape[1]
    d = dloc.float()
    out = []
    for x in (w_prev, w_cum):
        xp = torch.nn.functional.pad(x.float(), (pad, K - 1 - pad))
        out.append(torch.einsum("nks,nsf->kf", xp.unfold(1, S, 1), d))
    return torch.stack(out, dim=1)


def weight_grad(x, dg):
    """x^T dg over the flattened (T*B) rows, both in the stream dtype, with
    exact products and float32 sums and result (the JAX package's ``_cdot``
    with ``preferred_element_type=float32``): on the card a bf16 or float16
    product with a float32 output, elsewhere a float32 product of the same
    values."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x.t(), dg, out_dtype=torch.float32)
    return x.float().t() @ dg.float()


class ScanCore(torch.autograd.Function):
    """(scan weights, prenet_seq, memory, pmem, add_mask, masks) ->
    (h_dec, ctx, w), each (T, B, ·) float32.

    Weights in the JAX layout: attn_w (P+E+H, 4H), attn_b (4H), dec_w
    (H+E+H, 4H), dec_b (4H), query_w (H, A), loc_w (K, 2, F), loc_dense_w
    (F, A), v (A,).  ``dtype`` is the stream dtype of the LSTM products.
    add_mask and the dropout masks get no gradient."""

    @staticmethod
    def forward(ctx, attn_w, attn_b, dec_w, dec_b, query_w, loc_w, loc_dense_w, v,
                prenet_seq, memory, pmem, add_mask, m1, m2, m3, m4, dtype):
        params = dict(zip(PARAM_NAMES, (attn_w, attn_b, dec_w, dec_b, query_w, loc_w,
                                        loc_dense_w, v)))
        w = tf.pack(params, dtype)
        masks = None if m1 is None else tuple(m.contiguous() for m in (m1, m2, m3, m4))
        pn = prenet_seq.detach().float().contiguous()
        mem = memory.detach().float().contiguous()
        pm = pmem.detach().float().contiguous()
        add = add_mask.detach().float().contiguous()
        ys, resids = tf.teacher_fwd(w, pn, mem, pm, add, masks)
        ctx.w, ctx.masks, ctx.v_shape = w, masks, v.shape
        ctx.save_for_backward(pn, mem, pm, *ys, *resids)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_dec, dctx, dw):
        pn, mem, pm, *rest = ctx.saved_tensors
        ys, resids = tuple(rest[:3]), tuple(rest[3:])
        dys = tuple(torch.zeros_like(y) if d is None else d.float().contiguous()
                    for d, y in zip((dh_dec, dctx, dw), ys))
        grads = scan_backward(ctx.w, pn, mem, pm, ctx.masks, ys, resids, dys)
        return (*grads[:7], grads[7].reshape(ctx.v_shape), *grads[8:],
                None, None, None, None, None, None)


def scan_backward(w, pn, mem, pm, masks, ys, resids, dys, bwd=None):
    """Gradients of the recurrence from its residuals: the reverse-time
    BPTT (``bwd``, default ``teacher_fwd.teacher_bwd``: K4 on CUDA), then,
    outside it, the weight gradients.  Returns the gradients of (attn_w,
    attn_b, dec_w, dec_b, query_w, loc_w, loc_dense_w, v, prenet_seq,
    memory, pmem)."""
    h_dec, ctx_seq, w_seq = ys
    h_att = resids[4]
    T, B, S = w_seq.shape
    K = w["loc_w"].shape[0]
    sdt = w["attn_w"].dtype
    zero = torch.zeros_like(w_seq[:1])
    w_prev = torch.cat([zero, w_seq[:-1]])
    w_cum_prev = torch.cat([zero, torch.cumsum(w_seq, 0)[:-1]]).contiguous()
    (dg_att, dg_dec, dpn, dctx_tot, dloc, dv, dwq, dwld,
     dpmem) = (bwd or tf.teacher_bwd)(w, mem, pm, masks, dys, ys, resids, w_cum_prev)

    def prev(x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]])

    def rows(x):
        return x.to(sdt).reshape(T * B, -1)

    x_att = rows(torch.cat([pn, prev(ctx_seq), prev(h_att)], -1))
    x_dec = rows(torch.cat([h_att, ctx_seq, prev(h_dec)], -1))
    dga, dgd = dg_att.reshape(T * B, -1), dg_dec.reshape(T * B, -1)
    d_wloc = loc_conv_weight_grad(w_prev.reshape(T * B, S).to(sdt),
                                  w_cum_prev.reshape(T * B, S).to(sdt),
                                  dloc.reshape(T * B, S, -1), K)
    return (weight_grad(x_att, dga), dga.float().sum(0), weight_grad(x_dec, dgd),
            dgd.float().sum(0), dwq, d_wloc, dwld, dv,
            dpn, torch.einsum("tbs,tbe->bse", w_seq, dctx_tot), dpmem)


def scan_params(dec) -> dict:
    """The decoder module's recurrence weights in the JAX layout (views and
    concatenations of the parameters, so gradients reach them; the query
    projection whole under a model axis)."""
    att = dec.attention_layer
    loc = att.location_layer
    a, d = dec.attention_rnn, dec.decoder_rnn
    return {
        "attn_w": torch.cat([a.weight_ih, a.weight_hh], 1).t(),
        "attn_b": a.bias_ih + a.bias_hh,
        "dec_w": torch.cat([d.weight_ih, d.weight_hh], 1).t(),
        "dec_b": d.bias_ih + d.bias_hh,
        "query_w": dec.query_weight().t(),
        "loc_w": loc.location_conv.conv.weight.permute(2, 1, 0),
        "loc_dense_w": loc.location_dense.linear_layer.weight.t(),
        "v": att.v.linear_layer.weight[0],
    }


def dropout_masks(T, B, H, keep, dtype, generator, device):
    """Pre-scaled (bernoulli(keep) / keep) dropout mask in ``dtype``, drawn
    in bulk from ``generator`` (batch axis 1; at the global batch's shape
    inside a data-parallel scope).  ``keep`` is rounded to ``dtype`` on the
    device: a tensor made from a host value would be a blocking copy."""
    dev = device if generator is None else generator.device
    draw = mesh.rand_rows((T, B, H), 1, generator, dev) < keep
    return draw.to(device=device, dtype=dtype) / torch.full((), keep, dtype=dtype,
                                                            device=device)


def teacher_forced(dec, memory, mels, memory_lengths, hp, *, train: bool,
                   generator=None, dtype=None, prenet_dropout_enabled: bool = True):
    """Teacher-forced decoding through ``ScanCore`` (JAX
    ``decoder_bptt.teacher_forced``).  ``dtype`` is the stream dtype of the
    recurrence and of the output projections (None: float32).

    Returns (mel (B, n_mel, T), gate (B, T/r), alignments (B, T/r, S))."""
    B, S, _ = memory.shape
    n_mel, r = hp.n_mel_channels, hp.n_frames_per_step
    T = mels.shape[2] // r
    groups = group_frames(mels, r)
    dec_in = torch.cat([groups.new_zeros(B, 1, r * n_mel), groups[:, :-1]], 1)
    prenet_seq = dec.prenet_train(dec_in, generator, prenet_dropout_enabled,
                                  dtype).transpose(0, 1)
    pmem = dec.process_memory(memory)
    if memory_lengths is not None:
        valid = torch.arange(S, device=memory.device)[None, :] < memory_lengths[:, None]
        add_mask = torch.where(valid, 0.0, _F32_MIN)
    else:
        add_mask = torch.zeros(B, S, device=memory.device)
    sdt = dtype or torch.float32
    H = hp.attention_rnn_dim
    masks = (None,) * 4
    if train and (hp.p_attention_dropout > 0 or hp.p_decoder_dropout > 0):
        keep_a, keep_d = 1.0 - hp.p_attention_dropout, 1.0 - hp.p_decoder_dropout
        masks = tuple(dropout_masks(T, B, n, keep, sdt, generator, memory.device)
                      for n, keep in ((H, keep_a), (H, keep_a), (hp.decoder_rnn_dim, keep_d),
                                      (hp.decoder_rnn_dim, keep_d)))
    p = scan_params(dec)
    h_dec, ctx, w = ScanCore.apply(*(p[k] for k in PARAM_NAMES), prenet_seq, memory, pmem,
                                   add_mask, *masks, sdt)
    mel_out, gate_out = dec.project(torch.cat([h_dec, ctx], -1), dtype)
    return ungroup_mel(mel_out, n_mel, r), gate_out.t(), w.transpose(0, 1)
