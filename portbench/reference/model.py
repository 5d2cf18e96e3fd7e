"""Tacotron2-VAE in plain PyTorch: transcript encoder, VAE reference
encoder, location-sensitive attention decoder (teacher-forced), postnet,
and the loss (Tacotron2-VAE's ``loss_function.py``).

Weights come in a dict ``sd`` keyed by the benchmark's state-dict names
(Tacotron2's own module names).  Activations are float32.  Every matrix
and convolution operand goes through ``q`` (float32: unchanged; the
control: float8 e4m3 with a per-tensor scale).

Semantics that the serving and training paths of the model fix, and that
this file follows: batch normalisation in training uses the batch's
one-pass statistics ``E[x^2] - E[x]^2``; dropout masks are ``draw <
keep`` of ``torch.rand`` draws taken in the order encoder (3), VAE
noise (``torch.randn``), prenet (2), recurrent dropout of h and c of both
LSTMs (4, time-major), postnet (5); the backward LSTM direction starts
at each item's last valid step; padded attention positions get float32's
lowest value before the softmax.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

F32_MIN = float(np.finfo(np.float32).min)


def quantizer(quant):
    """The operand rounding: None (float32) or "fp8"."""
    if quant is None:
        return lambda x: x
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")

    return _Fp8.apply


class _Fp8(torch.autograd.Function):
    """Rounding to float8 e4m3 with a per-tensor scale; the gradient passes
    straight through (nothing is saved for the backward)."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


class Ref:
    """The reference model on one set of weights."""

    def __init__(self, sd: dict, hp: dict, quant=None):
        self.sd, self.hp, self.q = sd, hp, quantizer(quant)

    # -- layers -------------------------------------------------------

    def lin(self, x, name, bias=True):
        y = self.q(x) @ self.q(self.sd[name + ".weight"]).t()
        b = self.sd.get(name + ".bias") if bias else None
        return y if b is None else y + b

    def conv1d(self, x, name):
        """'same' conv over (B, C, T)."""
        w = self.sd[name + ".weight"]
        return F.conv1d(self.q(x), self.q(w), self.sd.get(name + ".bias"),
                        padding=(w.shape[-1] - 1) // 2)

    def bn(self, x, name, train):
        """Batchnorm over dim 1 of (B, C, ...)."""
        axes = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        if train:
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        else:
            mean, var = self.sd[name + ".running_mean"], self.sd[name + ".running_var"]
        inv = torch.rsqrt(var + 1e-5) * self.sd[name + ".weight"]
        return (x - mean.reshape(shape)) * inv.reshape(shape) + self.sd[name + ".bias"].reshape(shape)

    def lstm_cell(self, x, h, c, name, sfx=""):
        sd, q = self.sd, self.q
        g = (q(x) @ q(sd[f"{name}.weight_ih{sfx}"]).t() + q(h) @ q(sd[f"{name}.weight_hh{sfx}"]).t()
             + sd[f"{name}.bias_ih{sfx}"] + sd[f"{name}.bias_hh{sfx}"])
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c

    @staticmethod
    def dropout(x, draw, rate):
        keep = 1.0 - rate
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))

    # -- encoder ------------------------------------------------------

    def bilstm(self, x, lengths):
        """(B, S, D) -> (B, S, 2H); padded steps neither update nor emit."""
        B, S, _ = x.shape
        H = self.sd["encoder.lstm.weight_hh_l0"].shape[1]
        outs = []
        for sfx, order in (("_l0", range(S)), ("_l0_reverse", range(S - 1, -1, -1))):
            h = x.new_zeros(B, H)
            c = x.new_zeros(B, H)
            out = [None] * S
            for t in order:
                hn, cn = self.lstm_cell(x[:, t], h, c, "encoder.lstm", sfx)
                valid = (t < lengths)[:, None]
                h, c = torch.where(valid, hn, h), torch.where(valid, cn, c)
                out[t] = torch.where(valid, hn, torch.zeros_like(hn))
            outs.append(torch.stack(out, 1))
        return torch.cat(outs, -1)

    def encoder(self, ids, lengths, train=False, draws=None):
        x = self.sd["transcript_embedding.weight"][ids]                    # (B, S, D)
        for i in range(3):
            y = self.conv1d(x.transpose(1, 2), f"encoder.convolutions.{i}.0.conv")
            x = torch.relu(self.bn(y, f"encoder.convolutions.{i}.1", train)).transpose(1, 2)
            if train:
                x = self.dropout(x, draws(x.shape), 0.5)
        return self.bilstm(x, lengths)

    # -- VAE reference encoder ------------------------------------------

    def ref_encoder(self, mel, train=False):
        """mel (B, n_mel, T) -> final GRU state (B, E/2)."""
        x = mel.transpose(1, 2)[:, None]                                  # (B, 1, T, n_mel)
        B, _, H, W = x.shape
        rows = (torch.arange(H, device=x.device, dtype=torch.float32) / max(H - 1, 1) * 2 - 1)
        cols = (torch.arange(W, device=x.device, dtype=torch.float32) / max(W - 1, 1) * 2 - 1)
        rows, cols = rows[:, None].expand(H, W), cols[None, :].expand(H, W)
        r = torch.sqrt((rows - 0.5) ** 2 + (cols - 0.5) ** 2)
        coords = torch.stack([rows, cols, r])[None].expand(B, 3, H, W)
        x = torch.cat([x, coords], 1)
        n = sum(1 for k in self.sd if k.startswith("vae_gst.ref_encoder.bns.")
                and k.endswith(".running_mean"))
        for i in range(n):
            name = "vae_gst.ref_encoder.convs.0.conv" if i == 0 else f"vae_gst.ref_encoder.convs.{i}"
            x = F.conv2d(self.q(x), self.q(self.sd[name + ".weight"]), self.sd[name + ".bias"],
                         stride=2, padding=1)
            x = torch.relu(self.bn(x, f"vae_gst.ref_encoder.bns.{i}", train))
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * Fq)
        sd, q, pre = self.sd, self.q, "vae_gst.ref_encoder.gru"
        h = x.new_zeros(B, sd[pre + ".weight_hh_l0"].shape[1])
        for t in range(T):
            gi = q(x[:, t]) @ q(sd[pre + ".weight_ih_l0"]).t() + sd[pre + ".bias_ih_l0"]
            gh = q(h) @ q(sd[pre + ".weight_hh_l0"]).t() + sd[pre + ".bias_hh_l0"]
            ir, iz, i_n = gi.chunk(3, -1)
            hr, hz, hn = gh.chunk(3, -1)
            rg, zg = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
            h = (1 - zg) * torch.tanh(i_n + rg * hn) + zg * h
        return h

    def vae(self, mel, train=False, eps=None):
        """-> (style (B, E), mu, logvar); eval takes z = mu."""
        enc = self.ref_encoder(mel, train)
        mu, logvar = self.lin(enc, "vae_gst.fc1"), self.lin(enc, "vae_gst.fc2")
        z = mu if eps is None else mu + eps(mu.shape) * torch.exp(0.5 * logvar)
        return self.lin(z, "vae_gst.fc3"), mu, logvar

    def style_from_z(self, z):
        return self.lin(z, "vae_gst.fc3")

    # -- decoder ------------------------------------------------------

    def prenet(self, frames_in, masks):
        """(B, T, n_mel) -> (B, T, P); ``masks`` = two (B, T, P) keep masks."""
        x = frames_in
        for i in range(2):
            x = torch.relu(self.lin(x, f"decoder.prenet.layers.{i}.linear_layer", bias=False))
            x = x * masks[i] * 2.0
        return x

    def decoder(self, memory, frames, lengths, prenet_masks, lstm_masks=None):
        """Teacher-forced decoding: step t reads frame t - 1 (zeros at t = 0)
        of ``frames`` (B, T, n_mel).  ``lstm_masks``: four (T, B, H)
        pre-scaled masks of h_att, c_att, h_dec, c_dec, or None.  Returns
        (mel (B, T, n_mel), gate (B, T), alignments (B, T, S))."""
        B, S, E = memory.shape
        T = frames.shape[1]
        frames_in = torch.cat([frames.new_zeros(B, 1, frames.shape[2]), frames[:, :-1]], 1)
        pn = self.prenet(frames_in, prenet_masks)
        att = "decoder.attention_layer"
        pm = self.lin(memory, att + ".memory_layer.linear_layer", bias=False)
        add = torch.zeros(B, S, device=memory.device)
        if lengths is not None:
            valid = torch.arange(S, device=memory.device)[None] < lengths[:, None]
            add = torch.where(valid, 0.0, F32_MIN)
        Ha = self.sd["decoder.attention_rnn.weight_hh"].shape[1]
        Hd = self.sd["decoder.decoder_rnn.weight_hh"].shape[1]
        z = memory.new_zeros
        h_att, c_att, h_dec, c_dec = z(B, Ha), z(B, Ha), z(B, Hd), z(B, Hd)
        w_prev, w_cum, ctx = z(B, S), z(B, S), z(B, E)
        wl = self.sd[att + ".location_layer.location_conv.conv.weight"]

        def steps(t0, t1, h_att, c_att, h_dec, c_dec, w_prev, w_cum, ctx, memory, pm):
            hs, cs, ws = [], [], []
            for t in range(t0, t1):
                h_att, c_att = self.lstm_cell(torch.cat([pn[:, t], ctx], -1), h_att, c_att,
                                              "decoder.attention_rnn")
                if lstm_masks is not None:
                    h_att, c_att = h_att * lstm_masks[0][t], c_att * lstm_masks[1][t]
                qv = self.lin(h_att, att + ".query_layer.linear_layer", bias=False)
                loc = F.conv1d(self.q(torch.stack([w_prev, w_cum], 1)), self.q(wl),
                               padding=(wl.shape[-1] - 1) // 2).transpose(1, 2)
                loc = self.lin(loc, att + ".location_layer.location_dense.linear_layer",
                               bias=False)
                e = self.lin(torch.tanh(qv[:, None] + loc + pm), att + ".v.linear_layer",
                             bias=False)[..., 0] + add
                w = torch.softmax(e, dim=1)
                ctx = torch.bmm(w[:, None], memory)[:, 0]
                w_cum = w_cum + w
                w_prev = w
                h_dec, c_dec = self.lstm_cell(torch.cat([h_att, ctx], -1), h_dec, c_dec,
                                              "decoder.decoder_rnn")
                if lstm_masks is not None:
                    h_dec, c_dec = h_dec * lstm_masks[2][t], c_dec * lstm_masks[3][t]
                hs.append(h_dec)
                cs.append(ctx)
                ws.append(w)
            return (h_att, c_att, h_dec, c_dec, w_prev, w_cum, ctx, torch.stack(hs, 1),
                    torch.stack(cs, 1), torch.stack(ws, 1))

        # with gradients, chunks of steps are recomputed in the backward
        # (activation checkpointing: no random draw happens inside)
        chunk = 64 if torch.is_grad_enabled() else T
        state = (h_att, c_att, h_dec, c_dec, w_prev, w_cum, ctx)
        hs, cs, ws = [], [], []
        for t0 in range(0, T, chunk):
            args = (t0, min(T, t0 + chunk), *state, memory, pm)
            if chunk < T:
                out = torch.utils.checkpoint.checkpoint(steps, *args, use_reentrant=False)
            else:
                out = steps(*args)
            state = out[:7]
            hs.append(out[7])
            cs.append(out[8])
            ws.append(out[9])
        hs, cs, ws = torch.cat(hs, 1), torch.cat(cs, 1), torch.cat(ws, 1)
        hc = torch.cat([hs, cs], -1)
        mel = self.lin(hc, "decoder.linear_projection.linear_layer")
        gate = self.lin(hc, "decoder.gate_layer.linear_layer")[..., 0]
        return mel, gate, ws

    def postnet(self, mel, train=False, draws=None):
        """mel (B, n_mel, T) -> residual (B, n_mel, T)."""
        x = mel
        n = sum(1 for k in self.sd if k.startswith("postnet.convolutions.")
                and k.endswith(".0.conv.weight"))
        for i in range(n):
            x = self.bn(self.conv1d(x, f"postnet.convolutions.{i}.0.conv"),
                        f"postnet.convolutions.{i}.1", train)
            if i < n - 1:
                x = torch.tanh(x)
            if train:
                x = self.dropout(x.transpose(1, 2), draws(x.transpose(1, 2).shape),
                                 0.5).transpose(1, 2)
        return x


def kl_weight(step: int, hp: dict) -> float:
    """Tacotron2-VAE's logistic KL anneal, in float32."""
    f32 = np.float32
    upper, k, x0 = f32(hp["anneal_upper"]), f32(hp["anneal_k"]), f32(hp["anneal_x0"])
    return float(upper / (upper + np.exp(-k * (f32(step) - x0))))


def train_loss(ref: Ref, batch: dict, step: int, gen: torch.Generator):
    """One training forward and its loss; random draws from ``gen`` in the
    model's order.  Returns (total loss, postnet mel)."""
    hp = ref.hp
    dev = gen.device

    def rand(shape):
        return torch.rand(tuple(shape), generator=gen, device=dev)

    def randn(shape):
        return torch.randn(tuple(shape), generator=gen, device=dev)

    text, lengths, mel = batch["text"], batch["input_lengths"], batch["mel"]
    out_len = batch["output_lengths"]
    transcript = ref.encoder(text, lengths, train=True, draws=rand)
    style, mu, logvar = ref.vae(mel, train=True, eps=randn)
    memory = transcript + style[:, None]
    B, _, T = mel.shape
    P = hp["prenet_dim"]
    pre = [(rand((B, T, P)) < 0.5).float() for _ in range(2)]
    Ha, Hd = hp["attention_rnn_dim"], hp["decoder_rnn_dim"]
    ka, kd = 1.0 - hp["p_attention_dropout"], 1.0 - hp["p_decoder_dropout"]
    masks = [(rand((T, B, n)) < k).float() / k for n, k in ((Ha, ka), (Ha, ka), (Hd, kd), (Hd, kd))]
    mel_out, gate, _ = ref.decoder(memory, mel.transpose(1, 2), lengths, pre, masks)
    mel_out = mel_out.transpose(1, 2)
    mel_post = mel_out + ref.postnet(mel_out, train=True, draws=rand)
    valid = (torch.arange(T, device=mel.device)[None] < out_len[:, None])
    mel_out = torch.where(valid[:, None], mel_out, 0.0)
    mel_post = torch.where(valid[:, None], mel_post, 0.0)
    gate = torch.where(valid, gate, 1e3)
    mel_loss = torch.mean((mel_out - mel) ** 2) + torch.mean((mel_post - mel) ** 2)
    g, tg = gate.reshape(-1), batch["gate"].reshape(-1)
    gate_loss = torch.mean(torch.clamp(g, min=0.0) - g * tg + torch.log1p(torch.exp(-g.abs())))
    kl = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    recon = mel_loss + gate_loss
    return recon + kl_weight(step, hp) * kl, mel_post


def train_steps(sd: dict, batches: list, hp: dict, seed: int, device, quant=None):
    """Adam steps of Tacotron2-VAE's recipe from ``sd``, one per batch:
    global-norm clip to ``grad_clip_thresh``, L2 weight decay added to the
    clipped gradient, Adam (0.9, 0.999, 1e-8), random draws from one
    generator on ``device`` seeded with ``seed``.  Returns (losses, the
    first step's gradient as Adam takes it, the parameters after the last
    step, the first step's postnet mel), the middle two as {name: tensor}.
    Buffers (batchnorm statistics) are not parameters."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in sd.items()
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    buffers = {k: v for k, v in sd.items() if k not in params}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    lr, wd, clip = hp["learning_rate"], hp["weight_decay"], hp["grad_clip_thresh"]
    losses, first_grad, out1 = [], None, None
    for step, batch in enumerate(batches):
        ref = Ref({**params, **buffers}, hp, quant)
        total, mel_post = train_loss(ref, batch, step, gen)
        if out1 is None:
            out1 = mel_post.detach()
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params.values())]
        losses.append(float(total.detach()))
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = torch.clamp(norm, min=clip) / clip
        k = step + 1
        with torch.no_grad():
            taken = {}
            for (name, p), g in zip(params.items(), grads):
                g = g / scale + wd * p
                taken[name] = g
                m[name].mul_(0.9).add_(g, alpha=0.1)
                v[name].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (v[name].sqrt() / math.sqrt(1 - 0.999 ** k)).add_(1e-8)
                p.addcdiv_(m[name], denom, value=-lr / (1 - 0.9 ** k))
            if first_grad is None:
                first_grad = taken
    return losses, first_grad, {k: p.detach() for k, p in params.items()}, out1
