"""Weight bridge between the JAX package's parameter pytrees and the port.

``from_jax_params(params, model_state, hp)`` turns the JAX package's numpy
pytree (what ``tools/convert_torch_ckpt.py`` and the JAX trainer's pickles
hold) into a ``state_dict`` for ``models.tacotron2.Tacotron2`` with the
reference names; ``to_jax_params`` is its inverse.  ``from_jax_waveglow``
and ``to_jax_waveglow`` do the same for ``models.waveglow.WaveGlow``, and
``from_reference_waveglow`` reads an NVIDIA WaveGlow checkpoint (a state
dict, or a whole pickled model) by folding its weight norm;
``from_bigvgan_checkpoint`` reads a BigVGAN generator checkpoint in its
published layout the same way.  Layouts:

  linear   JAX w (in, out)            <-> torch weight (out, in)
  conv1d   JAX w (K, in, out)         <-> torch weight (out, in, K)
  conv2d   JAX w (kh, kw, in, out)    <-> torch weight (out, in, kh, kw)
  convT1d  JAX w (K, in, out)         <-> torch weight (in, out, K)
  1x1 flow JAX w (c, c), x @ w        <-> torch weight (c, c, 1) = w^T
  LSTM/GRU JAX wi (in, 4H|3H), wh     <-> torch weight_ih (4H|3H, in), weight_hh
  BN       scale/bias + mean/var      <-> weight/bias + running_mean/running_var
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _conv1d(sd, name, p):
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["w"]), (2, 1, 0)))
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _conv2d(sd, name, p):
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _bn(sd, name, p, s):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _rnn(sd, name, p, suffix=""):
    sd[f"{name}.weight_ih{suffix}"] = _t(np.asarray(p["wi"]).T)
    sd[f"{name}.weight_hh{suffix}"] = _t(np.asarray(p["wh"]).T)
    sd[f"{name}.bias_ih{suffix}"] = _t(p["bi"])
    sd[f"{name}.bias_hh{suffix}"] = _t(p["bh"])


def from_jax_params(params, model_state, hp=None) -> dict:
    """JAX (params, model_state) -> port/reference state_dict."""
    sd = {"transcript_embedding.weight": _t(params["embedding"]["table"])}
    _lin(sd, "speaker_embedding.linear_layer", params["speaker_embedding"])
    _lin(sd, "emotion_embedding.linear_layer", params["emotion_embedding"])
    enc = params["encoder"]
    for i, (cp, bp) in enumerate(zip(enc["convs"], enc["bns"])):
        _conv1d(sd, f"encoder.convolutions.{i}.0.conv", cp)
        _bn(sd, f"encoder.convolutions.{i}.1", bp, model_state["encoder"]["bns"][i])
    _rnn(sd, "encoder.lstm", enc["lstm"]["fwd"], "_l0")
    _rnn(sd, "encoder.lstm", enc["lstm"]["bwd"], "_l0_reverse")

    dec = params["decoder"]
    for i, lp in enumerate(dec["prenet"]):
        _lin(sd, f"decoder.prenet.layers.{i}.linear_layer", lp)
    _rnn(sd, "decoder.attention_rnn", dec["attention_rnn"])
    att = dec["attention"]
    a = "decoder.attention_layer"
    _lin(sd, f"{a}.query_layer.linear_layer", att["query"])
    _lin(sd, f"{a}.memory_layer.linear_layer", att["memory"])
    _lin(sd, f"{a}.v.linear_layer", att["v"])
    _conv1d(sd, f"{a}.location_layer.location_conv.conv", att["loc_conv"])
    _lin(sd, f"{a}.location_layer.location_dense.linear_layer", att["loc_dense"])
    _rnn(sd, "decoder.decoder_rnn", dec["decoder_rnn"])
    _lin(sd, "decoder.linear_projection.linear_layer", dec["proj"])
    _lin(sd, "decoder.gate_layer.linear_layer", dec["gate"])

    post = params["postnet"]
    for i, (cp, bp) in enumerate(zip(post["convs"], post["bns"])):
        _conv1d(sd, f"postnet.convolutions.{i}.0.conv", cp)
        _bn(sd, f"postnet.convolutions.{i}.1", bp, model_state["postnet"]["bns"][i])

    vae = params["vae_gst"]
    for i, (cp, bp) in enumerate(zip(vae["convs"], vae["bns"])):
        name = "vae_gst.ref_encoder.convs.0.conv" if i == 0 else f"vae_gst.ref_encoder.convs.{i}"
        _conv2d(sd, name, cp)
        _bn(sd, f"vae_gst.ref_encoder.bns.{i}", bp, model_state["vae_gst"]["bns"][i])
    _rnn(sd, "vae_gst.ref_encoder.gru", vae["gru"], "_l0")
    for k in ("fc1", "fc2", "fc3"):
        _lin(sd, f"vae_gst.{k}", vae[k])
    return sd


# ---------------------------------------------------------------- inverse


def _n(sd, key) -> np.ndarray:
    return sd[key].detach().cpu().float().numpy()


def _lin_inv(sd, name):
    p = {"w": _n(sd, f"{name}.weight").T.copy()}
    if f"{name}.bias" in sd:
        p["b"] = _n(sd, f"{name}.bias")
    return p


def _conv1d_inv(sd, name):
    p = {"w": np.transpose(_n(sd, f"{name}.weight"), (2, 1, 0)).copy()}
    if f"{name}.bias" in sd:
        p["b"] = _n(sd, f"{name}.bias")
    return p


def _conv2d_inv(sd, name):
    p = {"w": np.transpose(_n(sd, f"{name}.weight"), (2, 3, 1, 0)).copy()}
    if f"{name}.bias" in sd:
        p["b"] = _n(sd, f"{name}.bias")
    return p


def _bn_inv(sd, name):
    return ({"scale": _n(sd, f"{name}.weight"), "bias": _n(sd, f"{name}.bias")},
            {"mean": _n(sd, f"{name}.running_mean"), "var": _n(sd, f"{name}.running_var")})


def _rnn_inv(sd, name, suffix=""):
    return {"wi": _n(sd, f"{name}.weight_ih{suffix}").T.copy(),
            "wh": _n(sd, f"{name}.weight_hh{suffix}").T.copy(),
            "bi": _n(sd, f"{name}.bias_ih{suffix}"),
            "bh": _n(sd, f"{name}.bias_hh{suffix}")}


def _stack(sd, prefix):
    convs, bns, states = [], [], []
    i = 0
    while f"{prefix}.{i}.0.conv.weight" in sd:
        convs.append(_conv1d_inv(sd, f"{prefix}.{i}.0.conv"))
        bp, bs = _bn_inv(sd, f"{prefix}.{i}.1")
        bns.append(bp)
        states.append(bs)
        i += 1
    return convs, bns, states


def to_jax_params(state_dict) -> tuple[dict, dict]:
    """Port/reference state_dict -> JAX (params, model_state) numpy pytree."""
    sd = state_dict
    enc_convs, enc_bns, enc_state = _stack(sd, "encoder.convolutions")
    post_convs, post_bns, post_state = _stack(sd, "postnet.convolutions")
    ref_convs, ref_bns, ref_state = [], [], []
    i = 0
    while (f"vae_gst.ref_encoder.convs.{i}.weight" in sd
           or f"vae_gst.ref_encoder.convs.{i}.conv.weight" in sd):
        name = (f"vae_gst.ref_encoder.convs.{i}.conv"
                if f"vae_gst.ref_encoder.convs.{i}.conv.weight" in sd
                else f"vae_gst.ref_encoder.convs.{i}")
        ref_convs.append(_conv2d_inv(sd, name))
        bp, bs = _bn_inv(sd, f"vae_gst.ref_encoder.bns.{i}")
        ref_bns.append(bp)
        ref_state.append(bs)
        i += 1
    a = "decoder.attention_layer"
    params = {
        "embedding": {"table": _n(sd, "transcript_embedding.weight")},
        "speaker_embedding": _lin_inv(sd, "speaker_embedding.linear_layer"),
        "emotion_embedding": _lin_inv(sd, "emotion_embedding.linear_layer"),
        "encoder": {"convs": enc_convs, "bns": enc_bns,
                    "lstm": {"fwd": _rnn_inv(sd, "encoder.lstm", "_l0"),
                             "bwd": _rnn_inv(sd, "encoder.lstm", "_l0_reverse")}},
        "decoder": {
            "prenet": [_lin_inv(sd, f"decoder.prenet.layers.{i}.linear_layer")
                       for i in range(2)],
            "attention_rnn": _rnn_inv(sd, "decoder.attention_rnn"),
            "attention": {
                "query": _lin_inv(sd, f"{a}.query_layer.linear_layer"),
                "memory": _lin_inv(sd, f"{a}.memory_layer.linear_layer"),
                "v": _lin_inv(sd, f"{a}.v.linear_layer"),
                "loc_conv": _conv1d_inv(sd, f"{a}.location_layer.location_conv.conv"),
                "loc_dense": _lin_inv(sd, f"{a}.location_layer.location_dense.linear_layer"),
            },
            "decoder_rnn": _rnn_inv(sd, "decoder.decoder_rnn"),
            "proj": _lin_inv(sd, "decoder.linear_projection.linear_layer"),
            "gate": _lin_inv(sd, "decoder.gate_layer.linear_layer"),
        },
        "postnet": {"convs": post_convs, "bns": post_bns},
        "vae_gst": {"convs": ref_convs, "bns": ref_bns,
                    "gru": _rnn_inv(sd, "vae_gst.ref_encoder.gru", "_l0"),
                    "fc1": _lin_inv(sd, "vae_gst.fc1"),
                    "fc2": _lin_inv(sd, "vae_gst.fc2"),
                    "fc3": _lin_inv(sd, "vae_gst.fc3")},
    }
    model_state = {"encoder": {"bns": enc_state}, "postnet": {"bns": post_state},
                   "vae_gst": {"bns": ref_state}}
    return params, model_state


# --------------------------------------------------------------- WaveGlow


def from_jax_waveglow(tree) -> dict:
    """JAX WaveGlow params (``models/waveglow.py`` ``init``, numpy or float16
    leaves) -> the port's (NVIDIA-named) state_dict, in float32."""
    up = tree["upsample"]
    sd = {"upsample.weight": _t(np.transpose(np.asarray(up["w"]), (1, 2, 0))),
          "upsample.bias": _t(up["b"])}
    for k, flow in enumerate(tree["flows"]):
        wn = flow["wn"]
        for name, key in (("start", "start"), ("end", "end"), ("cond_layer", "cond")):
            _conv1d(sd, f"WN.{k}.{name}", wn[key])
        for i, p in enumerate(wn["in"]):
            _conv1d(sd, f"WN.{k}.in_layers.{i}", p)
        for i, p in enumerate(wn["res_skip"]):
            _conv1d(sd, f"WN.{k}.res_skip_layers.{i}", p)
        sd[f"convinv.{k}.conv.weight"] = _t(np.asarray(flow["inv_conv"]["w"]).T[:, :, None])
    return sd


def to_jax_waveglow(state_dict) -> dict:
    """The port's WaveGlow state_dict -> JAX WaveGlow params (numpy), the
    inverse of ``from_jax_waveglow``."""
    sd = state_dict
    flows, k = [], 0
    while f"convinv.{k}.conv.weight" in sd:
        n_layers = sum(1 for key in sd if key.startswith(f"WN.{k}.in_layers.")
                       and key.endswith(".weight"))
        wn = {"start": _conv1d_inv(sd, f"WN.{k}.start"), "end": _conv1d_inv(sd, f"WN.{k}.end"),
              "cond": _conv1d_inv(sd, f"WN.{k}.cond_layer"),
              "in": [_conv1d_inv(sd, f"WN.{k}.in_layers.{i}") for i in range(n_layers)],
              "res_skip": [_conv1d_inv(sd, f"WN.{k}.res_skip_layers.{i}")
                           for i in range(n_layers)]}
        w = _n(sd, f"convinv.{k}.conv.weight")[:, :, 0].T.copy()
        flows.append({"inv_conv": {"w": w}, "wn": wn})
        k += 1
    return {"upsample": {"w": np.transpose(_n(sd, "upsample.weight"), (2, 0, 1)).copy(),
                         "b": _n(sd, "upsample.bias")},
            "flows": flows}


def fold_weight_norm(sd) -> dict:
    """Fold ``weight_g``/``weight_v`` pairs into plain ``weight``s (the norm
    is over every axis but the first, as ``torch.nn.utils.weight_norm``)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            base = k[:-len("weight_g")]
            g = np.asarray(v, np.float32)
            w = np.asarray(sd[base + "weight_v"], np.float32)
            norm = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
            out[base + "weight"] = g * w / norm
        elif not k.endswith("weight_v"):
            out[k] = v
    return out


def read_torch_checkpoint(path: str):
    """``torch.load`` of a reference checkpoint.  A whole pickled WaveGlow
    model names NVIDIA's ``glow`` module; stub classes stand in for it while
    unpickling (unpickling calls no ``__init__``)."""
    stub = types.ModuleType("glow")
    for cls in ("WaveGlow", "WN", "Invertible1x1Conv", "WaveGlowLoss"):
        setattr(stub, cls, type(cls, (torch.nn.Module,), {}))
    added = sys.modules.setdefault("glow", stub) is stub
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        if added:
            del sys.modules["glow"]


def _waveglow_state(blob) -> dict:
    """The state dict of an NVIDIA WaveGlow checkpoint: a plain state dict,
    ``{"state_dict": ...}``, or a whole pickled model (``{"model": ...}``)."""
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    elif isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return blob.state_dict() if hasattr(blob, "state_dict") else blob


def _folded(sd: dict) -> dict:
    sd = {k: v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    return {k: _t(v) for k, v in fold_weight_norm(sd).items()}


def from_reference_waveglow(checkpoint) -> dict:
    """NVIDIA WaveGlow checkpoint (a path, or what ``read_torch_checkpoint``
    read from one) -> the port's state_dict in float32.  The names are the
    same; weight norm is folded."""
    if isinstance(checkpoint, str):
        checkpoint = read_torch_checkpoint(checkpoint)
    return _folded(_waveglow_state(checkpoint))


def from_bigvgan_checkpoint(blob) -> dict:
    """A BigVGAN generator checkpoint as published (``{"generator":
    state_dict}``, or the state dict itself) -> the state dict of
    ``models.bigvgan.BigVGAN`` in float32: each ``weight_g``/``weight_v``
    pair folded into a ``weight``; the SnakeBeta ``alpha``/``beta`` and the
    anti-aliasing ``filter`` buffers as stored."""
    return _folded(blob.get("generator", blob))
