"""Tacotron2-VAE top-level model: teacher-forced forward and inference.

Counterpart of the JAX package's ``models/tacotron2.py`` (reference
``Tacotron2``, model.py:467-547): symbol embedding -> transcript encoder ->
(+ broadcast style embedding) -> attention decoder -> postnet residual.
The module tree carries the reference state_dict names, so an upstream
checkpoint's ``state_dict`` loads as it is.  ``speaker_embedding`` and
``emotion_embedding`` exist for checkpoint parity and, as in the
reference, take no part in the forward pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..ops.layers import LinearNorm, col_embedding, embedding
from ..utils import profiling
from .decoder import Decoder
from .encoder import Encoder
from .postnet import Postnet
from .vae_gst import VAE_GST


def compute_dtype(hp):
    """The hparams' compute dtype as a torch dtype, None for float32."""
    return None if hp.compute_dtype == "float32" else getattr(torch, hp.compute_dtype)


class Tacotron2Output(NamedTuple):
    """Reference output list order (model.py:546)."""

    mel_outputs: torch.Tensor          # (B, n_mel, T)
    mel_outputs_postnet: torch.Tensor  # (B, n_mel, T)
    gate_outputs: torch.Tensor         # (B, T/r)
    alignments: torch.Tensor           # (B, T/r, S)
    mu: torch.Tensor                   # (B, z)
    logvar: torch.Tensor               # (B, z)
    z: torch.Tensor                    # (B, z)
    emotions: torch.Tensor             # pass-through one-hots


def _mask_outputs(mel, mel_postnet, gate, output_lengths):
    """Zero padded mel frames and set padded gate logits to 1e3 (reference
    parse_output, model.py:509-520); with r > 1 a step is padded iff its
    first frame is past the length."""
    if output_lengths is None:
        return mel, mel_postnet, gate
    T = mel.shape[2]
    r = T // gate.shape[1]
    dev = mel.device
    valid = (torch.arange(T, device=dev)[None, :] < output_lengths[:, None])[:, None, :]
    valid_step = (torch.arange(gate.shape[1], device=dev) * r)[None, :] < output_lengths[:, None]
    return (torch.where(valid, mel, 0.0), torch.where(valid, mel_postnet, 0.0),
            torch.where(valid_step, gate, 1e3))


def scan_dtype(hp, B: int, S: int, on_cuda: bool):
    """Stream dtype of the teacher-forced recurrence (``decoder_scan_dtype``).

    "auto" takes the compute dtype when it is not float32 and either the
    recurrence kernels run (the custom BPTT on a CUDA tensor) or B*S >= 2048,
    the JAX package's rule with "the kernels engage" read as "on the card"."""
    if hp.decoder_scan_dtype == "auto":
        use = hp.compute_dtype != "float32" and (
            B * S >= 2048 or (hp.use_custom_bptt and on_cuda))
        return getattr(torch, hp.compute_dtype) if use else None
    return None if hp.decoder_scan_dtype == "float32" else getattr(torch, hp.decoder_scan_dtype)


class Tacotron2(nn.Module):
    def __init__(self, hp):
        super().__init__()
        self.hp = hp
        self.transcript_embedding = nn.Embedding(hp.n_symbols, hp.symbols_embedding_dim)
        self.speaker_embedding = LinearNorm(hp.n_speakers, hp.speaker_embedding_dim)
        self.emotion_embedding = LinearNorm(hp.n_emotions, hp.emotion_embedding_dim)
        self.encoder = Encoder(hp)
        self.decoder = Decoder(hp)
        self.postnet = Postnet(hp)
        self.vae_gst = VAE_GST(hp)

    def forward(self, batch: dict, *, train: bool, generator=None,
                prenet_dropout_enabled: bool = True) -> Tacotron2Output:
        """Teacher-forced forward (reference model.py:522-547, JAX
        ``tacotron2.forward``).

        batch: text (B, S) int, input_lengths (B,), mel (B, n_mel, T),
        output_lengths (B,), emotions (B, n_emotions).  ``train`` turns on
        batch-statistics batchnorm (updating the running statistics),
        dropout, recurrent dropout and VAE sampling, all drawn from
        ``generator``; the prenet's dropout follows
        ``prenet_dropout_enabled`` in both modes (reference model.py:101).
        Inside a scope whose grid has a model axis the model holds this
        rank's slices (``parallel.mesh.shard_module``) and computes the
        whole output on every rank of the row."""
        from . import decoder_bptt

        hp = self.hp
        dtype = compute_dtype(hp)
        text, lengths, mel = batch["text"], batch["input_lengths"], batch["mel"]
        with profiling.span("fwd.encoder"):
            embedded = col_embedding(self.transcript_embedding.weight, text)
            transcript = self.encoder(embedded, lengths, dtype=dtype, train=train,
                                      generator=generator)
        with profiling.span("fwd.vae"):
            prosody, mu, logvar, z = self.vae_gst(
                mel, dtype=dtype, raw_reshape=getattr(hp, "ref_enc_raw_reshape", False),
                train=train, generator=generator)
        B, S = text.shape
        with profiling.span("fwd.decoder"):
            memory = transcript + prosody[:, None, :]
            if hp.use_custom_bptt:
                mel_out, gate_out, align = decoder_bptt.teacher_forced(
                    self.decoder, memory, mel, lengths, hp, train=train, generator=generator,
                    dtype=scan_dtype(hp, B, S, memory.is_cuda),
                    prenet_dropout_enabled=prenet_dropout_enabled)
            else:
                mel_out, gate_out, align = self.decoder.teacher_forced(
                    memory, mel, lengths, train=train, generator=generator, dtype=dtype,
                    prenet_dropout_enabled=prenet_dropout_enabled)
        with profiling.span("fwd.postnet"):
            mel_post = mel_out + self.postnet(mel_out, dtype=dtype, train=train,
                                              generator=generator)
            if hp.mask_padding:
                mel_out, mel_post, gate_out = _mask_outputs(mel_out, mel_post, gate_out,
                                                            batch.get("output_lengths"))
        emotions = batch.get("emotions")
        if emotions is None:
            emotions = mel.new_zeros(B, 0)
        return Tacotron2Output(mel_out, mel_post, gate_out, align, mu, logvar, z, emotions)

    @torch.no_grad()
    def infer(self, text, style_embed, *, seed: int, max_steps=None,
              gate_threshold=None, prenet_dropout_enabled=True, text_lengths=None):
        """Token ids (B, S) + style (B, E) or (E,) -> (mel, mel_postnet, gate,
        alignments, lengths).  ``text_lengths`` masks the encoder and the
        attention over bucket padding."""
        hp = self.hp
        dtype = compute_dtype(hp)
        with profiling.span("mel.encoder"):
            embedded = embedding(self.transcript_embedding.weight, text)
            transcript = self.encoder(embedded, text_lengths, dtype=dtype,
                                      mask_conv_inputs=True)
            if style_embed.ndim == 1:
                style_embed = style_embed[None]
            memory = transcript + style_embed[:, None, :].float()
        with profiling.span("mel.decode"):
            mel, gate, align, lengths = self.decoder.infer(
                memory, seed=seed, max_steps=max_steps, gate_threshold=gate_threshold,
                dtype=dtype, prenet_dropout_enabled=prenet_dropout_enabled,
                memory_lengths=text_lengths)
        with profiling.span("mel.postnet"):
            residual = self.postnet(mel, dtype=dtype)
            mel_post = mel + residual
        return mel, mel_post, gate, align, lengths


_GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0, "sigmoid": 1.0}


def _xavier(t, gain, fan_in, fan_out, g):
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    t.uniform_(-a, a, generator=g)


def _fanin(t, fan_in, g):
    k = 1.0 / math.sqrt(fan_in)
    t.uniform_(-k, k, generator=g)


@torch.no_grad()
def init_weights(model: Tacotron2, generator: torch.Generator) -> Tacotron2:
    """Random weights with the JAX package's initialisers (xavier-uniform
    with the reference gains, PyTorch fan-in uniform for RNNs, VAE heads and
    reference-encoder convs, the ±√3·√(2/(n+d)) embedding), drawn in a
    fixed order from ``generator`` on the CPU and copied to the model."""
    g = generator
    gains = {"speaker_embedding": "tanh", "emotion_embedding": "tanh",
             "decoder.attention_layer.query_layer": "tanh",
             "decoder.attention_layer.memory_layer": "tanh",
             "decoder.attention_layer.location_layer.location_dense": "tanh",
             "decoder.gate_layer": "sigmoid"}
    n_post = len(model.postnet.convolutions)
    for i in range(len(model.encoder.convolutions)):
        gains[f"encoder.convolutions.{i}.0"] = "relu"
    for i in range(n_post - 1):
        gains[f"postnet.convolutions.{i}.0"] = "tanh"

    for name, mod in model.named_modules():
        cpu = {n: torch.empty(p.shape) for n, p in mod.named_parameters(recurse=False)}
        if not cpu:
            continue
        owner = name.rsplit(".", 1)[0] if name.endswith((".linear_layer", ".conv")) else name
        if isinstance(mod, nn.Embedding):
            n, d = mod.weight.shape
            v = math.sqrt(3.0) * math.sqrt(2.0 / (n + d))
            cpu["weight"].uniform_(-v, v, generator=g)
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            cpu["weight"].fill_(1.0)
            cpu["bias"].zero_()
        elif isinstance(mod, (nn.LSTM, nn.LSTMCell, nn.GRU)):
            H = mod.hidden_size
            for t in cpu.values():
                _fanin(t, H, g)
        elif name.startswith("vae_gst"):  # reference-encoder convs, fc heads
            fan_in = cpu["weight"][0].numel()
            for t in cpu.values():
                _fanin(t, fan_in, g)
        else:  # LinearNorm / ConvNorm: xavier weight, zero bias
            w = cpu["weight"]
            k = w[0, 0].numel() if w.ndim == 3 else 1
            _xavier(w, _GAINS[gains.get(owner, "linear")], w.shape[1] * k,
                    w.shape[0] * k, g)
            if "bias" in cpu:
                cpu["bias"].zero_()
        for n, p in mod.named_parameters(recurse=False):
            p.copy_(cpu[n])
    for mod in model.modules():
        if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model
