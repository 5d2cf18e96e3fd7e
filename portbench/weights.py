"""Random weights from the run's seed, made on the device in one draw.

The shapes and names are those of the model's state dicts (read from its
modules built on the ``meta`` device, which allocates nothing).  Every
value comes from one ``torch.randn`` of a generator on the device seeded
with the run's seed, scaled per tensor:

* Tacotron2-VAE: Xavier-normal weights with Tacotron2's gains (tanh for
  the attention's projections, the location dense layer and the postnet's
  first four convolutions, ReLU for the encoder's, sigmoid for the gate),
  zero biases; recurrent weights and biases N(0, 1 / (3 H)), the spread
  of PyTorch's default uniform; the VAE's convolutions and heads
  N(0, 1 / (3 fan_in)); the symbol table N(0, 2 / (n + d)); batchnorm the
  identity.  Assumed: the gate bias is -10, so that no request stops
  before the decoder's step cap.  The weights are rounded to bfloat16
  values (the model computes in bfloat16, and the checkpoint is stored so).
* WaveGlow: N(0, 0.05^2) convolutions with zero biases, each coupling's
  ``end`` N(0, 0.01^2) (a zero ``end`` would make every coupling the
  identity; at 0.01 the flow is not chaotic), a random orthogonal 1x1
  mixing per flow; rounded to float16 values (the stored vocoder).
"""

from __future__ import annotations

import math

import torch

_TANH = ("decoder.attention_layer.query_layer", "decoder.attention_layer.memory_layer",
         "decoder.attention_layer.location_layer.location_dense", "speaker_embedding",
         "emotion_embedding")


def _shapes(module) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}


def tacotron2_shapes(hp) -> dict:
    from tacotron2_vae_torch.models.tacotron2 import Tacotron2

    with torch.device("meta"):
        return _shapes(Tacotron2(hp))


def waveglow_shapes(cfg) -> dict:
    from tacotron2_vae_torch.models.waveglow import WaveGlow

    with torch.device("meta"):
        return _shapes(WaveGlow(cfg))


def _gain(name: str, n_post: int) -> float:
    if name.startswith(_TANH) or any(name.startswith(f"postnet.convolutions.{i}.")
                                     for i in range(n_post - 1)):
        return 5.0 / 3.0
    if name.startswith("encoder.convolutions."):
        return math.sqrt(2.0)
    return 1.0


def _tacotron2_std(name: str, shape: tuple, n_post: int) -> float | None:
    """Standard deviation of a tensor, or None for a constant."""
    if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
        return None
    parts = name.split(".")
    if parts[-2] in ("1",) or "bns." in name:          # batchnorm weight / bias
        return None
    if name == "transcript_embedding.weight":
        return math.sqrt(2.0 / (shape[0] + shape[1]))
    if "lstm" in name or "_rnn." in name or ".gru." in name:
        H = shape[-1] if "weight_hh" in name else shape[0] // (3 if ".gru." in name else 4)
        return 1.0 / math.sqrt(3.0 * H)
    if name.startswith("vae_gst"):
        fan_in = math.prod(shape[1:]) if name.endswith("weight") else None
        return 1.0 / math.sqrt(3.0 * (fan_in or 1)) if fan_in else 0.02
    if name.endswith("bias"):
        return None
    k = shape[2] if len(shape) == 3 else 1
    return _gain(name, n_post) * math.sqrt(2.0 / (shape[1] * k + shape[0] * k))


def _constant(name: str, shape: tuple, device) -> torch.Tensor:
    if name.endswith(("running_var",)) or (name.endswith("weight") and
                                           (name.split(".")[-2] == "1" or "bns." in name)):
        return torch.ones(shape, device=device)
    if name == "decoder.gate_layer.linear_layer.bias":
        return torch.full(shape, -10.0, device=device)
    return torch.zeros(shape, device=device)


def tacotron2(hp, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} holding bfloat16 values."""
    shapes = tacotron2_shapes(hp)
    n_post = hp.postnet_n_convolutions
    stds = {k: _tacotron2_std(k, s, n_post) for k, (s, _) in shapes.items()}
    total = sum(math.prod(s) for k, (s, _) in shapes.items() if stds[k] is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, (s, dt) in shapes.items():
        if not dt.is_floating_point:
            out[k] = torch.zeros(s, dtype=dt, device=device)
        elif stds[k] is None:
            out[k] = _constant(k, s, device)
        else:
            n = math.prod(s)
            out[k] = (flat[off:off + n].reshape(s) * stds[k]).to(torch.bfloat16).float()
            off += n
    return out


def waveglow(cfg, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} holding float16 values."""
    shapes = waveglow_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, (s, _) in shapes.items():
        n = math.prod(s)
        x = flat[off:off + n].reshape(s)
        off += n
        if k.startswith("convinv."):
            q, r = torch.linalg.qr(x[:, :, 0].double())
            x = (q * torch.sign(torch.diagonal(r)))[:, :, None].float()
        elif ".end." in k:
            x = x * 0.01
        elif k.endswith("bias"):
            x = torch.zeros_like(x)
        else:
            x = x * 0.05
        out[k] = x.to(torch.float16).float()
    return out
