"""A plain reference of BigVGAN's generator: plain ``torch``, float32, TF32 off.

Written from the published model (Lee et al., arXiv:2206.04658; NVIDIA's
BigVGAN ``bigvgan.py`` / ``models.py``, ``activations.py`` and
``alias_free_torch/``) and the layout of its published checkpoints: the
generator's state dict, as ``{"generator": state_dict}`` holds it, with
weight norm as ``*.weight_g`` / ``*.weight_v`` pairs, which this file folds
itself.  It imports nothing of the port and no JAX, and uses no kernel:
``activation1d`` is the published ``Activation1d`` (``UpSample1d``,
``SnakeBeta``, ``DownSample1d``) operation by operation.

Departures from the source, each without effect on the result:
* the forward is functions over the state dict, not modules;
* both anti-aliasing filters are computed here (``kaiser_sinc_filter1d``,
  the published function) rather than read from the checkpoint's
  ``*.filter`` buffers, which hold the same values: the checkpoint's copies
  are thereby checked too;
* the output is (B, samples), the published (B, 1, samples) squeezed;
* ``layout`` lists the published checkpoint's names and shapes from the
  config alone (the published modules' constructor arguments), so that
  weights drawn in it are the published generator's whatever a port holds;
* ``quant`` ("bfloat16" or "tf32") computes every convolution at a lower
  precision, for the controls that a limit has to catch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TAPS = 12


def setup():
    """Full float32 products and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> torch.Tensor:
    """alias_free_torch/filter.py: a Kaiser-windowed sinc low-pass, summing
    to 1, shaped (1, 1, kernel_size)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    if even:
        time = torch.arange(-half_size, half_size) + 0.5
    else:
        time = torch.arange(kernel_size) - half_size
    x = 2 * cutoff * time
    sinc = torch.where(x == 0, torch.tensor(1.0), torch.sin(math.pi * x) / (math.pi * x))
    filter_ = 2 * cutoff * window * sinc
    filter_ /= filter_.sum()
    return filter_.view(1, 1, kernel_size)


def layout(cfg: dict) -> dict:
    """{name: shape} of the published generator's state dict with weight
    norm (``weight_v``, ``weight_g``, ``bias`` of each convolution; each
    ``Activation1d``'s ``act.alpha``, ``act.beta``, ``upsample.filter``,
    ``downsample.lowpass.filter``), module by module in the published
    order (``weight_v``, ``weight_g``, ``bias`` within a convolution): a
    Conv1d weight is (out, in, k), a ConvTranspose1d's (in, out, k), and
    weight norm's g keeps the first axis."""
    out = {}

    def conv(name, shape, n_out):
        out[name + ".weight_v"] = shape
        out[name + ".weight_g"] = (shape[0], 1, 1)
        out[name + ".bias"] = (n_out,)

    def activation(name, ch):
        out[name + ".act.alpha"] = out[name + ".act.beta"] = (ch,)
        out[name + ".upsample.filter"] = out[name + ".downsample.lowpass.filter"] = (1, 1, TAPS)

    c0 = cfg["upsample_initial_channel"]
    conv("conv_pre", (c0, cfg["num_mels"], 7), c0)
    for i, k in enumerate(cfg["upsample_kernel_sizes"]):
        conv(f"ups.{i}.0", (c0 // 2 ** i, c0 // 2 ** (i + 1), k), c0 // 2 ** (i + 1))
    nk = len(cfg["resblock_kernel_sizes"])
    for i in range(len(cfg["upsample_rates"])):
        ch = c0 // 2 ** (i + 1)
        for j, (kr, d) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                        cfg["resblock_dilation_sizes"])):
            prefix = f"resblocks.{i * nk + j}"
            for conv_set in ("convs1", "convs2"):
                for m in range(len(d)):
                    conv(f"{prefix}.{conv_set}.{m}", (ch, ch, kr), ch)
            for m in range(2 * len(d)):
                activation(f"{prefix}.activations.{m}", ch)
    ch = c0 // 2 ** len(cfg["upsample_rates"])
    activation("activation_post", ch)
    conv("conv_post", (1, ch, 7), 1)
    return out


def weight(sd: dict, name: str) -> torch.Tensor:
    """torch.nn.utils.weight_norm's weight: g * v / ||v||, the norm over
    every axis but the first."""
    g, v = sd[name + ".weight_g"].float(), sd[name + ".weight_v"].float()
    return v * (g / v.norm(dim=tuple(range(1, v.ndim)), keepdim=True))


def activation1d(x: torch.Tensor, sd: dict, prefix: str) -> torch.Tensor:
    """Activation1d(SnakeBeta, alpha_logscale=True): UpSample1d(2, 12),
    SnakeBeta, DownSample1d(2, 12)."""
    C = x.shape[1]
    filt = kaiser_sinc_filter1d(0.25, 0.3, TAPS).to(x.device)
    # UpSample1d: pad = 12 // 2 - 1 = 5; pad_left = pad_right = 5 * 2 + 5 = 15
    x = F.pad(x, (5, 5), mode="replicate")
    x = 2 * F.conv_transpose1d(x, filt.expand(C, -1, -1), stride=2, groups=C)
    x = x[..., 15:-15]
    # SnakeBeta: x + 1 / (beta + 1e-9) * sin(x * alpha)^2, alpha and beta log-scale
    alpha = torch.exp(sd[prefix + ".act.alpha"].float())[None, :, None]
    beta = torch.exp(sd[prefix + ".act.beta"].float())[None, :, None]
    x = x + (1.0 / (beta + 0.000000001)) * torch.pow(torch.sin(x * alpha), 2)
    # DownSample1d: LowPassFilter1d(stride 2), replicate pad 5 left, 6 right
    x = F.pad(x, (5, 6), mode="replicate")
    return F.conv1d(x, filt.expand(C, -1, -1), stride=2, groups=C)


def _q(quant):
    if quant == "bfloat16":
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


def _conv(sd, name, x, quant, **kw):
    q = _q(quant)
    return F.conv1d(q(x), q(weight(sd, name)), sd[name + ".bias"].float(), **kw)


def amp_block1(x, sd, prefix, kernel_size, dilations, quant):
    for j, d in enumerate(dilations):
        xt = activation1d(x, sd, f"{prefix}.activations.{2 * j}")
        xt = _conv(sd, f"{prefix}.convs1.{j}", xt, quant, dilation=d,
                   padding=(kernel_size * d - d) // 2)
        xt = activation1d(xt, sd, f"{prefix}.activations.{2 * j + 1}")
        xt = _conv(sd, f"{prefix}.convs2.{j}", xt, quant, padding=(kernel_size - 1) // 2)
        x = xt + x
    return x


@torch.no_grad()
def infer(sd: dict, cfg: dict, mel: torch.Tensor, quant=None) -> torch.Tensor:
    """mel (B, num_mels, T) -> waveform (B, T * prod(upsample_rates)):
    BigVGAN.forward on the generator's state dict ``sd`` (weight norm as
    stored) and the published config ``cfg``."""
    if quant == "tf32":
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=False, deterministic=False, allow_tf32=True):
            return infer(sd, cfg, mel)
    q = _q(quant)
    x = _conv(sd, "conv_pre", mel.float(), quant, padding=3)
    nk = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        name = f"ups.{i}.0"
        x = F.conv_transpose1d(q(x), q(weight(sd, name)), sd[name + ".bias"].float(),
                               stride=u, padding=(k - u) // 2)
        xs = None
        for j, (kr, d) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                        cfg["resblock_dilation_sizes"])):
            r = amp_block1(x, sd, f"resblocks.{i * nk + j}", kr, d, quant)
            xs = r if xs is None else xs + r
        x = xs / nk
    x = activation1d(x, sd, "activation_post")
    x = _conv(sd, "conv_post", x, quant, padding=3)
    return torch.tanh(x)[:, 0]
