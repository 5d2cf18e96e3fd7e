"""WaveGlow vocoder (flow-based mel -> waveform) in PyTorch.

Counterpart of the JAX package's ``models/waveglow.py`` (arXiv:1811.00002):
squeeze the audio into groups of 8, 12 flows of [invertible 1x1 conv +
affine coupling with a non-causal WaveNet conditioner], 2 channels output
early every 4 flows, and a ConvTranspose1d mel upsampler.  ``forward``
(audio -> z, training) and ``inverse`` / ``infer`` (z -> audio, serving,
``sigma=0.666`` as the reference synthesizer).

The module tree carries NVIDIA ``glow.py``'s names (``upsample``,
``WN.{k}.start/end/cond_layer/in_layers.{i}/res_skip_layers.{i}``,
``convinv.{k}.conv``), so a reference state dict loads once its weight norm
is folded (``convert.from_reference_waveglow``).

Layouts at the public functions are the JAX package's: audio (B, samples),
mel (B, n_mel, T_mel), z (B, T, n_group), each log_s (B, T, n_half).
Inside, activations are channel-first (B, C, T) for ``F.conv1d``.

Numerics.  Float32 runs every convolution through cuDNN in full float32:
cuDNN's default TF32 keeps ~3 decimal digits, so the vocoder's own calls
run under ``torch.backends.cudnn.flags(allow_tf32=False)`` (the process's
setting is restored after each call).  With ``dtype=torch.bfloat16`` the
WaveNet convolutions round where the JAX ``_conv1d`` rounds: a 1x1
convolution takes bf16 operands into a float32 product and output (on the
card a bf16 product with a float32 output), the dilated convolution's
output is rounded to bf16 and the float32 bias added after; the upsampler,
the 1x1 flow mixing and the coupling stay float32.  Without a Pallas kernel
in the JAX model, the convolutions here are cuDNN/cuBLAS calls.

Training on a (data, model) grid (``make_waveglow_train_step`` with a
``parallel.mesh.Grid``, the JAX ``make_waveglow_parallel_train_step``):
the data ranks' losses are means over equal shards of the batch, so their
mean is the global loss; the model axis splits what ``mesh.waveglow_spec``
names (``shard_module``), Megatron's pattern on the WaveNet stack: the
upsampler and the layers that write the hidden channels (``start``,
``cond_layer``, ``in_layers``) keep this rank's output channels, and the
gate pairs channel c with nc + c, so a rank holds the same slice of both
halves; the layers that read them (``res_skip_layers``, ``end``) keep its
input channels and sum their partial products over the row.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import cast
from ..parallel import mesh, tp


@dataclass(frozen=True)
class WaveGlowConfig:
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    # WN (WaveNet conditioner)
    n_layers: int = 8
    n_channels: int = 256
    kernel_size: int = 3
    # mel upsampler
    upsample_kernel: int = 1024
    upsample_stride: int = 256

    def audio_channels(self) -> list[int]:
        """Audio channel count entering each flow (forward direction)."""
        chans, c = [], self.n_group
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                c -= self.n_early_size
            chans.append(c)
        return chans

    @property
    def n_remaining_channels(self) -> int:
        return self.audio_channels()[-1]

    def emits_early(self, k: int) -> bool:
        return k % self.n_early_every == 0 and k > 0


class WN(nn.Module):
    """Non-causal WaveNet conditioner of one flow (NVIDIA ``glow.WN``)."""

    def __init__(self, n_in: int, cfg: WaveGlowConfig):
        super().__init__()
        nc, k = cfg.n_channels, cfg.kernel_size
        self.start = nn.Conv1d(n_in, nc, 1)
        self.end = nn.Conv1d(nc, 2 * n_in, 1)
        self.cond_layer = nn.Conv1d(cfg.n_mel_channels * cfg.n_group, 2 * nc * cfg.n_layers, 1)
        self.in_layers = nn.ModuleList(
            nn.Conv1d(nc, 2 * nc, k, dilation=2 ** i, padding=(k - 1) * 2 ** i // 2)
            for i in range(cfg.n_layers))
        self.res_skip_layers = nn.ModuleList(
            nn.Conv1d(nc, 2 * nc if i < cfg.n_layers - 1 else nc, 1)
            for i in range(cfg.n_layers))


class Invertible1x1Conv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv1d(c, c, 1, bias=False)


class WaveGlow(nn.Module):
    def __init__(self, cfg: WaveGlowConfig = WaveGlowConfig()):
        super().__init__()
        self.cfg = cfg
        m = cfg.n_mel_channels
        self.upsample = nn.ConvTranspose1d(m, m, cfg.upsample_kernel,
                                           stride=cfg.upsample_stride)
        chans = cfg.audio_channels()
        self.WN = nn.ModuleList(WN(c // 2, cfg) for c in chans)
        self.convinv = nn.ModuleList(Invertible1x1Conv(c) for c in chans)

    def forward(self, audio, mel):
        """Training direction: (audio (B, samples), mel (B, n_mel, T_mel)) ->
        (z (B, T, n_group), [log_s (B, T, n_half)] per flow, [log_det_W]
        per flow with log_det_W = B * T * log|det W| (NVIDIA glow.py))."""
        cfg = self.cfg
        with _full_fp32():
            x = squeeze_audio(audio.float(), cfg.n_group)
            T = x.shape[2]
            mel_up = self.upsample_mel(mel)
            cond = tp.copy(squeeze_mel(mel_up[:, :, :T * cfg.n_group], cfg.n_group)[:, :, :T])
            out_z, log_s_all, log_det_all = [], [], []
            for k in range(cfg.n_flows):
                if cfg.emits_early(k):
                    out_z.append(x[:, :cfg.n_early_size])
                    x = x[:, cfg.n_early_size:]
                w = self.convinv[k].conv.weight
                x = F.conv1d(x, w)
                log_det_all.append(x.shape[0] * x.shape[2] * torch.linalg.slogdet(w[:, :, 0])[1])
                n_half = x.shape[1] // 2
                x0, x1 = x[:, :n_half], x[:, n_half:]
                b, log_s = _wn(self.WN[k], x0, cond, cfg)
                x1 = x1 * torch.exp(log_s) + b
                log_s_all.append(log_s.transpose(1, 2))
                x = torch.cat([x0, x1], 1)
            out_z.append(x)
            z = torch.cat(out_z, 1).transpose(1, 2)
        return z, log_s_all, log_det_all

    def upsample_mel(self, mel):
        """mel (B, n_mel, T) -> (B, n_mel, T * stride): the transposed conv,
        its tail of kernel - stride samples trimmed (NVIDIA glow.py)."""
        k, s = self.cfg.upsample_kernel, self.cfg.upsample_stride
        with _full_fp32():
            y = tp.gather(F.conv_transpose1d(mel.float(), self.upsample.weight,
                                             self.upsample.bias, stride=s), 1)
        return y[:, :, :y.shape[2] - (k - s)]

    def cond_from_mel(self, mel):
        """mel (B, n_mel, T_mel) -> conditioning (B, n_mel * n_group, T)."""
        return squeeze_mel(self.upsample_mel(mel), self.cfg.n_group)

    def inverse_weights(self) -> list[torch.Tensor]:
        """The inverse of every flow's 1x1 mixing matrix; compute once and
        pass to ``inverse``/``infer`` where the weights do not change."""
        return [torch.linalg.inv(c.conv.weight[:, :, 0].detach()) for c in self.convinv]

    def inverse(self, z, mel, dtype=None, w_inv=None):
        """Deterministic z (B, T, n_group) -> audio (B, T * n_group); z's
        channels are ``forward``'s: early outputs in emission order, then
        the remaining channels."""
        cond = self.cond_from_mel(mel)
        T = min(cond.shape[2], z.shape[1])
        x = self._inverse_flows(z[:, :T].float().transpose(1, 2), cond[:, :, :T], dtype, w_inv)
        return unsqueeze_audio(x)

    def infer(self, mel, sigma: float = 0.666, generator=None, dtype=None, w_inv=None):
        """Serving direction: mel (B, n_mel, T_mel) -> waveform (B, samples),
        z ~ sigma * N(0, 1) drawn from ``generator``.  ``dtype`` selects the
        WaveNet convolutions' type (float32 by default, or torch.bfloat16)."""
        cond = self.cond_from_mel(mel)
        B, _, T = cond.shape
        z = torch.randn((B, self.cfg.n_group, T), generator=generator, device=cond.device)
        return unsqueeze_audio(self._inverse_flows(sigma * z, cond, dtype, w_inv))

    def _inverse_flows(self, z, cond, dtype, w_inv):
        """z (B, n_group, T) channel-first -> audio (B, n_group, T)."""
        cfg = self.cfg
        dtype = None if dtype in (None, torch.float32) else dtype
        w_inv = self.inverse_weights() if w_inv is None else w_inv
        chans = cfg.audio_channels()
        sizes = [cfg.n_early_size for k in range(cfg.n_flows) if cfg.emits_early(k)]
        parts = list(torch.split(z, sizes + [cfg.n_remaining_channels], dim=1))
        x = parts.pop()
        with _full_fp32():
            for k in reversed(range(cfg.n_flows)):
                n_half = chans[k] // 2
                x0, x1 = x[:, :n_half], x[:, n_half:]
                b, log_s = _wn(self.WN[k], x0, cond, cfg, dtype)
                x = torch.cat([x0, (x1 - b) * torch.exp(-log_s)], 1)
                x = F.conv1d(x, w_inv[k][:, :, None])
                if cfg.emits_early(k):
                    x = torch.cat([parts.pop(), x], 1)
        return x


def _full_fp32():
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _conv(conv: nn.Conv1d, x, dtype=None, bias: bool = True):
    """A WaveNet convolution of channel-first x, rounded as the JAX
    ``_conv1d`` rounds in ``dtype`` (see the module note); the bias is
    added last, when ``bias``."""
    w = conv.weight
    if dtype is None:
        y = F.conv1d(x, w, padding=conv.padding, dilation=conv.dilation)
    elif w.shape[2] == 1:
        if x.is_cuda:
            w2, xd = w[:, :, 0].to(dtype), x.to(dtype)
            y = torch.stack([torch.mm(w2, xb, out_dtype=torch.float32) for xb in xd])
        else:
            y = F.conv1d(cast(x, dtype), cast(w, dtype))
    elif x.is_cuda:
        y = F.conv1d(x.to(dtype), w.to(dtype), padding=conv.padding,
                     dilation=conv.dilation).float()
    else:
        y = F.conv1d(cast(x, dtype), cast(w, dtype), padding=conv.padding,
                     dilation=conv.dilation).to(dtype).float()
    return y + conv.bias[:, None] if bias else y


def _row_conv(conv: nn.Conv1d, x, dtype=None):
    """A 1x1 convolution of this rank's input channels: the partial
    products summed over the row, then the bias."""
    return tp.reduce(_conv(conv, x, dtype, bias=False)) + conv.bias[:, None]


def _wn(wn: WN, audio_0, cond, cfg: WaveGlowConfig, dtype=None):
    """(b, log_s), each (B, n_half, T), of one flow's conditioner.  Under a
    model axis ``cond`` went through ``tp.copy`` and the hidden channels
    each layer writes are this rank's ``n`` of each gate half."""
    nc = cfg.n_channels
    n = wn.in_layers[0].weight.shape[0] // 2
    x = tp.gather(_conv(wn.start, tp.copy(audio_0), dtype), 1)
    cond_all = _conv(wn.cond_layer, cond, dtype)
    output = None
    for i in range(cfg.n_layers):
        a = _conv(wn.in_layers[i], tp.copy(x), dtype)
        c = cond_all[:, i * 2 * n:(i + 1) * 2 * n]
        acts = torch.tanh(a[:, :n] + c[:, :n]) * torch.sigmoid(a[:, n:] + c[:, n:])
        rs = _row_conv(wn.res_skip_layers[i], acts, dtype)
        if i < cfg.n_layers - 1:
            x = x + rs[:, :nc]
            rs = rs[:, nc:]
        output = rs if output is None else output + rs
    out = _row_conv(wn.end, tp.scatter(output, 1), dtype)
    n_half = out.shape[1] // 2
    return out[:, :n_half], out[:, n_half:]


def squeeze_mel(mel_up, n_group: int):
    """(B, n_mel, T * n_group) -> (B, n_mel * n_group, T): channel m * n_group
    + g holds mel_up[m, t * n_group + g] (torch unfold + permute order)."""
    B, M, T_up = mel_up.shape
    T = T_up // n_group
    x = mel_up[:, :, :T * n_group].reshape(B, M, T, n_group)
    return x.permute(0, 1, 3, 2).reshape(B, M * n_group, T)


def squeeze_audio(audio, n_group: int):
    """(B, samples) -> (B, n_group, T)."""
    B, n = audio.shape
    T = n // n_group
    return audio[:, :T * n_group].reshape(B, T, n_group).transpose(1, 2)


def unsqueeze_audio(x):
    """(B, n_group, T) -> (B, T * n_group)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def init_weights(model: WaveGlow, generator: torch.Generator, scale: float = 0.05,
                 end_scale: float = 0.0) -> WaveGlow:
    """Random weights as the JAX ``init``: N(0, scale^2) convolutions with
    zero biases, a zero ``end`` (every coupling is the identity at init) and
    a random orthogonal 1x1 mixing matrix per flow, drawn from ``generator``
    on the CPU and copied to the model.  ``end_scale > 0`` draws ``end``'s
    weight and bias from N(0, end_scale^2) instead, so that a random model
    exercises its WaveNets (checks and timings of an untrained model)."""
    mixing = {id(inv.conv) for inv in model.convinv}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d)) and id(mod) not in mixing:
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * scale)
                mod.bias.zero_()
        for wn in model.WN:
            for p in (wn.end.weight, wn.end.bias):
                p.copy_(torch.randn(p.shape, generator=generator) * end_scale)
        for inv in model.convinv:
            c = inv.conv.weight.shape[0]
            q, r = torch.linalg.qr(torch.randn((c, c), generator=generator, dtype=torch.float64))
            inv.conv.weight.copy_((q * torch.sign(torch.diagonal(r)))[:, :, None])
    return model


def waveglow_loss(z, log_s_list, log_det_w_list, sigma: float = 1.0):
    """Flow negative log-likelihood (NVIDIA WaveGlowLoss): sum(z^2) /
    (2 sigma^2) - sum(log_s) - sum(log_det_W), over z's element count."""
    loss = torch.sum(z * z) / (2.0 * sigma * sigma)
    for log_s in log_s_list:
        loss = loss - torch.sum(log_s)
    for log_det in log_det_w_list:
        loss = loss - log_det
    return loss / z.numel()


def make_waveglow_train_step(model: WaveGlow, optimizer: torch.optim.Optimizer,
                             sigma: float = 1.0, clip: float | None = None,
                             grid: mesh.Grid | None = None):
    """``step(audio, mel) -> {"loss", "grad_norm", "updated"}`` (device
    scalars; the step never waits for the card), one update of ``model``
    by ``optimizer``, a fused Adam, on the flow NLL.  ``clip`` clips the
    gradients to that global norm first (the JAX CLI's
    ``optax.clip_by_global_norm``).  A loss or gradient norm that is not
    finite skips the whole update on the device (parameters and Adam's
    state stay as they were), as the JAX step does: one poisoned update
    turns the weights to NaN for good.

    On a ``grid`` each rank passes its data index's rows of the global
    batch (equal shares, so the mean of the ranks' losses is the global
    one) and ``model`` holds its slices (``mesh.shard_module`` with
    ``mesh.waveglow_spec``); the gradients and the loss are averaged over
    the column, and the norm is the logical tree's, so the clip and the
    skip agree on every rank."""
    if not optimizer.defaults.get("fused"):
        raise ValueError("the WaveGlow step skips a non-finite update on the device through "
                         "a fused optimizer: pass torch.optim.Adam(..., fused=True)")
    params = list(model.parameters())
    sharded = mesh.sharded_parameters(model)
    data = grid.data if grid is not None else 1

    def step(audio, mel):
        optimizer.zero_grad(set_to_none=True)
        with mesh.scope(grid):
            loss = waveglow_loss(*model(audio, mel), sigma)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        loss = loss.detach().reshape(1)
        if data > 1:
            mesh.all_reduce_flat(grads + [loss], grid.data_group)
            torch._foreach_div_(grads, data)
            loss = loss / data
        loss = loss[0]
        norm = mesh.global_norm(grads, sharded, grid)
        ok = torch.isfinite(loss) & torch.isfinite(norm)
        optimizer.grad_scale = (None if clip is None
                                else torch.clamp(norm, min=clip) / clip)
        optimizer.found_inf = (~ok).float()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss, "grad_norm": norm, "updated": ok}

    return step
