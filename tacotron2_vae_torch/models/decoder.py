"""Autoregressive attention decoder (location-sensitive attention + 2 LSTMs).

Counterpart of the JAX package's ``models/decoder.py`` (reference
``Decoder``/``Attention``/``LocationLayer``/``Prenet``, model.py:12-464):
autoregressive inference and the plain-autograd teacher-forced forward
(``teacher_forced``, the ``use_custom_bptt=False`` path; the hand-written
BPTT path is ``models/decoder_bptt.py``).  State_dict names follow the
reference: ``prenet.layers.{i}``, ``attention_rnn``,
``attention_layer.{query_layer,memory_layer,v,location_layer.{location_conv,
location_dense}}``, ``decoder_rnn``, ``linear_projection``, ``gate_layer``.

``Decoder.infer`` on a CUDA tensor runs kernel K1 (``ops/decoder_loop``) for
every B from 1 to 8 and raises beyond; on the CPU it runs the plain loop
below.  Prenet dropout stays on at inference (reference model.py:101); its
bits come from the kernel's counter hash keyed on a seed, so the plain loop
and the kernel draw the same masks.

Under a mesh's model axis (training only) the prenet and the memory
projection are column-parallel (each rank's output features, gathered),
the query projection's slices are gathered into the whole weight, the
recurrence runs whole on every rank of the row, and the mel and gate
projections are row-parallel over the 1536-wide ``[h_dec, context]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops import decoder_loop as _dl
from ..ops.decoder_loop import ungroup_mel  # noqa: F401  (JAX decoder.ungroup_mel)
from ..ops.layers import (ConvNorm, LinearNorm, col_linear, conv1d, dropout, linear,
                          row_linear)
from ..ops.rnn import lstm_cell
from ..parallel import tp

PRENET_DROP = 0.5  # reference model.py:11,101


def group_frames(mels, r: int):
    """(B, n_mel, T) -> (B, T//r, r*n_mel) frame groups (T divisible by r)."""
    B, n_mel, T = mels.shape
    if T % r:
        raise ValueError(f"mel length T={T} must be a multiple of n_frames_per_step={r} "
                         "(data.dataset.collate pads to this)")
    return mels.transpose(1, 2).reshape(B, T // r, r * n_mel)


class Prenet(nn.Module):
    def __init__(self, in_dim, sizes):
        super().__init__()
        dims = [in_dim] + list(sizes)
        self.layers = nn.ModuleList(
            [LinearNorm(i, o, bias=False) for i, o in zip(dims[:-1], dims[1:])])


class LocationLayer(nn.Module):
    def __init__(self, n_filters, kernel_size, attention_dim):
        super().__init__()
        self.location_conv = ConvNorm(2, n_filters, kernel_size, bias=False)
        self.location_dense = LinearNorm(n_filters, attention_dim, bias=False)


class Attention(nn.Module):
    def __init__(self, rnn_dim, embedding_dim, attention_dim, n_filters,
                 kernel_size):
        super().__init__()
        self.query_layer = LinearNorm(rnn_dim, attention_dim, bias=False)
        self.memory_layer = LinearNorm(embedding_dim, attention_dim, bias=False)
        self.v = LinearNorm(attention_dim, 1, bias=False)
        self.location_layer = LocationLayer(n_filters, kernel_size, attention_dim)


class DecoderState(NamedTuple):
    h_att: torch.Tensor
    c_att: torch.Tensor
    h_dec: torch.Tensor
    c_dec: torch.Tensor
    attn_w: torch.Tensor
    attn_w_cum: torch.Tensor
    context: torch.Tensor


class Decoder(nn.Module):
    def __init__(self, hp):
        super().__init__()
        enc = hp.encoder_embedding_dim
        n_out = hp.n_mel_channels * hp.n_frames_per_step
        self.hp = hp
        self.prenet = Prenet(n_out, [hp.prenet_dim, hp.prenet_dim])
        self.attention_rnn = nn.LSTMCell(hp.prenet_dim + enc, hp.attention_rnn_dim)
        self.attention_layer = Attention(
            hp.attention_rnn_dim, enc, hp.attention_dim,
            hp.attention_location_n_filters, hp.attention_location_kernel_size)
        self.decoder_rnn = nn.LSTMCell(hp.attention_rnn_dim + enc, hp.decoder_rnn_dim)
        self.linear_projection = LinearNorm(hp.decoder_rnn_dim + enc, n_out)
        self.gate_layer = LinearNorm(hp.decoder_rnn_dim + enc, 1)
        self._packed = {}

    # -- plain path -----------------------------------------------------

    def prenet_forward(self, x, *, seed: int, step: int, dropout_enabled=True,
                       dtype=None):
        """2 x (linear -> ReLU -> dropout 0.5), dropout from the hash."""
        for layer_i, layer in enumerate(self.prenet.layers):
            x = torch.relu(linear(x, layer.linear_layer.weight, dtype=dtype))
            if dropout_enabled:
                x = x * _dl.dropout_keep(seed, step, layer_i, x.shape[0],
                                         x.shape[1], x.device) * 2.0
        return x

    def prenet_train(self, x, generator=None, dropout_enabled=True, dtype=None):
        """2 x (linear -> ReLU -> dropout 0.5) with dropout drawn from
        ``generator`` (the teacher-forced prenet over all frames); under a
        model axis each layer's features are this rank's, their mask drawn
        at the full width, and the row's are gathered."""
        for layer in self.prenet.layers:
            x = torch.relu(col_linear(x, layer.linear_layer.weight, dtype=dtype))
            x = dropout(x, PRENET_DROP, generator, enabled=dropout_enabled, col_dim=-1)
            x = tp.gather(x, -1)
        return x

    def process_memory(self, memory, dtype=None):
        """memory (B, S, E) -> its attention keys (B, S, A)."""
        w = self.attention_layer.memory_layer.linear_layer.weight
        return tp.gather(col_linear(memory, w, dtype=dtype), -1)

    def query_weight(self):
        """The query projection's whole (A, H) weight."""
        return tp.gather(self.attention_layer.query_layer.linear_layer.weight, 0)

    def project(self, hidden_ctx, dtype=None):
        """[h_dec, context] (..., D + E) -> (mel frames (..., r * n_mel),
        gate logits (...,))."""
        proj, gate = self.linear_projection.linear_layer, self.gate_layer.linear_layer
        return (row_linear(hidden_ctx, proj.weight, proj.bias, dtype=dtype),
                row_linear(hidden_ctx, gate.weight, gate.bias, dtype=dtype)[..., 0])

    def _attend(self, h_att, memory, processed_memory, attn_w, attn_w_cum,
                mask, dtype=None, query_w=None):
        att = self.attention_layer
        if query_w is None:
            query_w = att.query_layer.linear_layer.weight
        q = linear(h_att, query_w, dtype=dtype)
        loc_feats = torch.stack([attn_w, attn_w_cum], dim=-1)          # (B, S, 2)
        loc = conv1d(loc_feats, att.location_layer.location_conv.conv.weight,
                     dtype=dtype)
        loc = linear(loc, att.location_layer.location_dense.linear_layer.weight,
                     dtype=dtype)                                      # (B, S, A)
        energies = linear(torch.tanh(q[:, None, :] + loc + processed_memory),
                          att.v.linear_layer.weight, dtype=dtype)[..., 0]
        if mask is not None:
            energies = torch.where(mask, energies,
                                   float(np.finfo(np.float32).min))
        weights = torch.softmax(energies, dim=1)
        context = torch.bmm(weights[:, None, :], memory.float())[:, 0]
        return context, weights

    def decode_step(self, state: DecoderState, prenet_out, memory,
                    processed_memory, mask, dtype=None, train=False, generator=None,
                    query_w=None):
        """One decoder step (reference Decoder.decode); ``train`` applies
        dropout to h and c of both LSTMs."""
        hp = self.hp
        cell = self.attention_rnn
        h_att, c_att = lstm_cell(torch.cat([prenet_out, state.context], -1),
                                 state.h_att, state.c_att, cell.weight_ih,
                                 cell.weight_hh, cell.bias_ih, cell.bias_hh, dtype)
        if train:
            h_att = dropout(h_att, hp.p_attention_dropout, generator)
            c_att = dropout(c_att, hp.p_attention_dropout, generator)
        context, attn_w = self._attend(h_att, memory, processed_memory,
                                       state.attn_w, state.attn_w_cum, mask, dtype, query_w)
        cell = self.decoder_rnn
        h_dec, c_dec = lstm_cell(torch.cat([h_att, context], -1), state.h_dec,
                                 state.c_dec, cell.weight_ih, cell.weight_hh,
                                 cell.bias_ih, cell.bias_hh, dtype)
        if train:
            h_dec = dropout(h_dec, hp.p_decoder_dropout, generator)
            c_dec = dropout(c_dec, hp.p_decoder_dropout, generator)
        return DecoderState(h_att, c_att, h_dec, c_dec, attn_w,
                            state.attn_w_cum + attn_w, context)

    def initial_state(self, memory) -> DecoderState:
        B, S, E = memory.shape
        hp = self.hp

        def z(*s):
            return torch.zeros(s, dtype=torch.float32, device=memory.device)

        return DecoderState(z(B, hp.attention_rnn_dim), z(B, hp.attention_rnn_dim),
                            z(B, hp.decoder_rnn_dim), z(B, hp.decoder_rnn_dim),
                            z(B, S), z(B, S), z(B, E))

    def teacher_forced(self, memory, mels, memory_lengths=None, *, train: bool,
                       generator=None, dtype=None, prenet_dropout_enabled=True):
        """Teacher-forced decoding with plain autograd (JAX
        ``decoder.teacher_forced``): prenet over [go, frames[:-1]], one
        decode step per r-frame group, the mel/gate projections after the
        loop.  Returns (mel (B, n_mel, T), gate (B, T/r), alignments
        (B, T/r, S))."""
        hp = self.hp
        B, S, _ = memory.shape
        n_mel, r = hp.n_mel_channels, hp.n_frames_per_step
        groups = group_frames(mels, r)
        dec_in = torch.cat([groups.new_zeros(B, 1, r * n_mel), groups[:, :-1]], 1)
        prenet_out = self.prenet_train(dec_in, generator, prenet_dropout_enabled, dtype)
        processed = self.process_memory(memory, dtype)
        query_w = self.query_weight()
        mask = None
        if memory_lengths is not None:
            mask = torch.arange(S, device=memory.device)[None, :] < memory_lengths[:, None]
        state = self.initial_state(memory)
        h_dec, ctx, align = [], [], []
        for t in range(groups.shape[1]):
            state = self.decode_step(state, prenet_out[:, t], memory, processed, mask,
                                     dtype, train=train, generator=generator,
                                     query_w=query_w)
            h_dec.append(state.h_dec)
            ctx.append(state.context)
            align.append(state.attn_w)
        hidden_ctx = torch.cat([torch.stack(h_dec), torch.stack(ctx)], -1)  # (Tg, B, .)
        mel_out, gate_out = self.project(hidden_ctx, dtype)
        return ungroup_mel(mel_out, n_mel, r), gate_out.t(), torch.stack(align, 1)

    def packed(self, dtype):
        """Kernel weight packing, cached until any parameter changes."""
        key = (dtype, tuple((p.data_ptr(), p._version) for p in self.parameters()))
        if key not in self._packed:
            self._packed = {key: _dl.pack_weights(self, dtype)}
        return self._packed[key]

    @torch.no_grad()
    def infer(self, memory, *, seed: int, max_steps=None, gate_threshold=None,
              dtype=None, prenet_dropout_enabled=True, memory_lengths=None):
        """Autoregressive inference with gate early exit.

        Returns (mel (B, n_mel, max_steps*r), gate (B, max_steps),
        alignments (B, max_steps, S), lengths (B,) in frames); rows emit
        zeros after their gate fired; ``max_steps`` counts steps of r
        frames."""
        hp = self.hp
        B, S, _ = memory.shape
        n_mel, r = hp.n_mel_channels, hp.n_frames_per_step
        max_steps = max_steps or hp.max_decoder_steps
        gate_threshold = gate_threshold or hp.gate_threshold
        mask = None
        if memory_lengths is not None:
            mask = (torch.arange(S, device=memory.device)[None, :]
                    < memory_lengths[:, None])
        mem_w = self.attention_layer.memory_layer.linear_layer.weight

        if memory.is_cuda:
            if B > _dl.MAX_ROWS:
                raise ValueError(
                    f"decode on CUDA serves at most {_dl.MAX_ROWS} rows, got {B}")
            kw = self.packed(dtype or torch.float32)
            return _dl.decode_loop(
                kw, memory, linear(memory, mem_w), mask, max_steps=max_steps,
                gate_threshold=float(gate_threshold), seed=seed,
                dropout_on=prenet_dropout_enabled, r=r)

        processed_memory = linear(memory, mem_w, dtype=dtype)
        dev = memory.device
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        state = self.initial_state(memory)
        mel_buf = z(max_steps, B, r * n_mel)
        gate_buf = z(max_steps, B)
        align_buf = z(max_steps, B, S)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        prev = z(B, r * n_mel)
        proj, gate = self.linear_projection.linear_layer, self.gate_layer.linear_layer
        t = 0
        while t < max_steps and not bool(finished.all()):
            pn = self.prenet_forward(prev, seed=seed, step=t,
                                     dropout_enabled=prenet_dropout_enabled,
                                     dtype=dtype)
            state = self.decode_step(state, pn, memory, processed_memory, mask, dtype)
            hidden_ctx = torch.cat([state.h_dec, state.context], -1)
            mel_t = linear(hidden_ctx, proj.weight, proj.bias, dtype=dtype)
            gate_t = linear(hidden_ctx, gate.weight, gate.bias, dtype=dtype)[:, 0]
            active = ~finished
            mel_buf[t] = torch.where(active[:, None], mel_t, 0.0)
            gate_buf[t] = torch.where(active, gate_t, 0.0)
            align_buf[t] = torch.where(active[:, None], state.attn_w, 0.0)
            finished = finished | (torch.sigmoid(gate_t) > gate_threshold)
            prev = mel_t
            t += 1
        return _dl.finish(mel_buf, gate_buf, align_buf, t, float(gate_threshold), r)

