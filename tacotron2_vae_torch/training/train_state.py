"""Train state and the train / eval steps (JAX ``training/train_state.py``).

The optimizer follows the reference's torch Adam + clip_grad_norm loop
(train.py:171-175, 204-232) as the JAX package chains it: global-norm clip
to ``grad_clip_thresh`` (optax's ``thresh / max(norm, thresh)``; PyTorch's
``clip_grad_norm_`` adds 1e-6 and is not used) -> L2 weight decay added to
the gradient -> Adam (0.9, 0.999, 1e-8) -> step of -lr.  It is
``torch.optim.Adam(fused=True)``, whose kernel divides the gradients by a
device scalar (``grad_scale``: ``max(norm, thresh) / thresh``, the clip)
and leaves every parameter, moment and step count untouched when a device
flag (``found_inf``) is set.  A parameter the forward does not use (the
speaker and emotion embeddings) gets a zero gradient, so weight decay moves
it as optax moves it.

The step never waits for the card: its metrics are device tensors, and the
clip and the non-finite skip are decided on the device, as JAX's
``jnp.where(ok, new, old)``.  A non-finite loss or gradient norm leaves the
parameters, Adam's moments and step count, and the batchnorm running
statistics (snapshotted before the forward) as they were; the iteration
count still advances.  On a (data, model) grid (``parallel.mesh``) the
step computes what one process computes on the global batch: the
gradients are summed over the data ranks of the rank's column, whether the
model axis splits them or not (a whole weight's gradient is already equal
across a row); the global norm is the logical tree's, each whole weight
counted once and the split ones' squares summed over the row; so the clip
and the skip are decided from one loss and one norm, alike on every rank,
and a rank whose slice alone overflows makes every rank skip.

``fp16_run`` (JAX ``train_state.py:54-211``, reference
fp16_optimizer.py:51-383) computes in float16 (``compute_dtype`` and the
recurrence's stream type) and trains through a loss scaler
(``training/loss_scaler.py``): the loss is back-propagated times the
scale, the gradients are divided by it before their global norm, and a
step whose loss or norm is not finite is skipped and halves the scale.
The scaler's state is on the device (``TrainState.scaler``), so the step
still never waits for the card.

While ``utils.profiling`` records, a train step is a ``step`` span whose
children are ``step.forward`` (the model's ``fwd.encoder``, ``fwd.vae``,
``fwd.decoder`` and ``fwd.postnet``), ``step.loss``, ``step.backward``
(each once a micro-batch) and ``step.optimizer`` (the norm, the clip,
Adam and the batchnorm restore); they time the host's dispatch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.tacotron2 import Tacotron2, init_weights
from ..parallel import mesh
from ..utils import profiling
from .loss import tacotron2_vae_loss
from .loss_scaler import DynamicLossScaler, ScalerState

AUX_KEYS = ("recon_loss", "mel_loss", "gate_loss", "kl_loss")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None is the card, which must exist."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA card and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


@dataclass
class TrainState:
    model: Tacotron2
    optimizer: torch.optim.Optimizer
    step: int = 0
    scaler: ScalerState | None = None  # fp16_run only: the loss scale and its count
    grid: mesh.Grid | None = None      # with a model axis the model holds its slices

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(model, hp, learning_rate=None) -> torch.optim.Adam:
    lr = hp.learning_rate if learning_rate is None else learning_rate
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=hp.weight_decay, fused=True)


def make_loss_scaler(hp) -> DynamicLossScaler | None:
    """fp16_run's scaler (reference loss_scaler.py): dynamic by default
    (init 2^32, /2 on overflow with floor 1, x2 every 1000 clean steps);
    ``dynamic_loss_scaling=False`` is the static scale of 1 (reference
    fp16_optimizer.py default static_loss_scale=1.0), expressed as the JAX
    package expresses it: a dynamic scaler whose scale never moves off its
    floor."""
    if not hp.fp16_run:
        return None
    if hp.dynamic_loss_scaling:
        return DynamicLossScaler()
    return DynamicLossScaler(init_scale=1.0, scale_factor=1.0, scale_window=2 ** 31)


def run_hparams(hp):
    """The hparams a run computes with: ``fp16_run`` means float16 compute."""
    return hp.replace(compute_dtype="float16") if hp.fp16_run else hp


def create_train_state(hp, device=None, learning_rate=None, seed=None,
                       grid: mesh.Grid | None = None) -> TrainState:
    """A model with random weights from ``seed`` (default ``hp.seed``) on
    ``device`` (default the card), a fresh optimizer and, under
    ``fp16_run``, a fresh loss scaler; the model computes in float16 then.
    With a ``grid`` that has a model axis the model keeps this rank's
    slices of the weights ``mesh.tacotron2_spec`` splits (cut on the host
    from the one logical initialisation), and so does Adam."""
    hp = run_hparams(hp)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(hp.seed if seed is None else seed)
    model = init_weights(Tacotron2(hp), gen)
    if grid is not None and grid.model > 1:
        mesh.shard_module(model, mesh.tacotron2_spec, grid)
    model = model.to(dev)
    scaler = make_loss_scaler(hp)
    return TrainState(model, make_optimizer(model, hp, learning_rate),
                      scaler=scaler.init(dev) if scaler is not None else None, grid=grid)


def batch_to_device(batch, device) -> dict:
    """A ``data.dataset.Batch`` (or a dict of arrays) as tensors on ``device``."""
    items = batch.asdict() if hasattr(batch, "asdict") else batch
    out = {}
    for k, v in items.items():
        v = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        out[k] = v.to(device, torch.long if k in ("text", "input_lengths", "output_lengths")
                      else torch.float32)
    return out


def _split(batch: dict, accum: int) -> list[dict]:
    B = batch["text"].shape[0]
    if B % accum:
        raise ValueError(f"batch dim {B} not divisible by grad_accum_steps={accum}")
    return [{k: v[i * (B // accum):(i + 1) * (B // accum)] for k, v in batch.items()}
            for i in range(accum)]


def optimizer_update(ts: TrainState, hp, loss) -> tuple[torch.Tensor, torch.Tensor]:
    """Clip the gradients to ``grad_clip_thresh`` by their global norm and
    take one Adam step, unless the loss (a device scalar or a float) or the
    norm is not finite.  Parameters without a gradient get a zero one.
    Returns (norm, stepped) as device scalars; nothing waits for the card.
    The fused kernel reads a gradient as laid out like its parameter, so a
    gradient with other strides is made contiguous first."""
    params = list(ts.model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif not p.grad.is_contiguous():
            p.grad = p.grad.contiguous()
    norm = mesh.global_norm([p.grad for p in params], mesh.sharded_parameters(ts.model),
                            ts.grid)
    ok = torch.isfinite(norm)
    if isinstance(loss, torch.Tensor):
        ok = ok & torch.isfinite(loss)
    elif not math.isfinite(loss):
        ok = torch.zeros_like(ok)
    opt = ts.optimizer
    opt.grad_scale = torch.clamp(norm, min=hp.grad_clip_thresh) / hp.grad_clip_thresh
    opt.found_inf = (~ok).float()
    opt.step()
    return norm, ok


def _float_buffers(model) -> list[torch.Tensor]:
    return [b for b in model.buffers() if b.is_floating_point()]


def _restore_unless(ok, buffers: list[torch.Tensor], saved: torch.Tensor) -> None:
    """``buffers`` keep their values where ``ok``, else take ``saved`` (a
    flat snapshot of them), in three kernels."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    if buffers:
        kept = torch.where(ok, _flatten_dense_tensors(buffers), saved)
        torch._foreach_copy_(buffers, _unflatten_dense_tensors(kept, buffers))


def make_train_step(hp, grid: mesh.Grid | None = None):
    """Returns ``train_step(ts, batch, generator) -> metrics``, which
    updates ``ts`` in place.  The metrics are device scalars (``loss``,
    ``grad_norm``, the ``AUX_KEYS`` and ``updated``) and ``kl_weight`` (a
    float); reading them is the caller's choice and the step never waits.

    With ``grad_accum_steps = a > 1`` the batch splits into ``a``
    micro-batches under one update whose gradient matches the big batch:
    mel and gate terms are means, while the KL is a sum over the batch, so
    each micro-batch's KL is weighted by ``a`` before the 1/a average;
    batchnorm running statistics chain through the micro-batches.  On a
    ``grid`` of ``w`` data ranks the same rule spans them: each
    back-propagates ``recon + kl_weight * w * a * kl`` of its rows, the
    gradients and the metrics are summed over the column in one
    all-reduce, and the gradient is divided by ``w * a``; the metrics are
    those of the global batch, alike on every rank.

    Under ``fp16_run`` each rank back-propagates that loss times the
    scale, the gradients are divided by the scale before their norm (JAX
    ``train_state.py:177-183``: a norm of the scaled gradients can overflow
    float32 where the unscaled one would not, and skip a sound step), the
    scaler updates on the device with the step's overflow flag, and the
    metrics add ``loss_scale``, the scale the step used."""
    scaler = make_loss_scaler(hp)
    accum = max(1, int(getattr(hp, "grad_accum_steps", 1)))
    world = grid.data if grid is not None else 1

    def train_step(ts: TrainState, batch, generator=None):
        with profiling.span("step"):
            return _step(ts, batch, generator)

    def _step(ts: TrainState, batch, generator):
        model, opt = ts.model, ts.optimizer
        scale = ts.scaler.scale if scaler is not None else None
        if not isinstance(batch, dict):
            batch = batch_to_device(batch, ts.device)
        buffers = _float_buffers(model)
        saved = torch.cat([b.reshape(-1) for b in buffers]) if buffers else None
        opt.zero_grad(set_to_none=True)
        sums = None
        with mesh.scope(grid):
            for micro in (_split(batch, accum) if accum > 1 else (batch,)):
                with profiling.span("step.forward"):
                    out = model(micro, train=True, generator=generator)
                with profiling.span("step.loss"):
                    _, aux = tacotron2_vae_loss(out, micro["mel"], micro["gate"], ts.step, hp)
                    kl_weight = aux["kl_weight"]
                    loss = aux["recon_loss"] + kl_weight * (accum * world) * aux["kl_loss"]
                    part = torch.stack([aux[k].detach() for k in AUX_KEYS])
                    sums = part if sums is None else sums + part
                with profiling.span("step.backward"):
                    (loss if scale is None else loss * scale).backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if world > 1:
            # the gradients and the metric sums in one flat all-reduce
            mesh.all_reduce_flat(grads + [sums], grid.data_group)
            torch._foreach_div_(grads, world * accum)
        elif accum > 1:
            torch._foreach_div_(grads, accum)
        if scale is not None:
            # Eager PyTorch stores each gradient once, so the overflow check
            # (the norm below) and the optimizer read the same values: what
            # JAX's optimization_barrier ensures at train_state.py:178-183.
            torch._foreach_div_(grads, scale)
        # recon, mel and gate are means of the ranks' and micro-batches'
        # means; the KL is a sum over the batch
        n = world * accum
        aux = {k: sums[i] / n if n > 1 and k != "kl_loss" else sums[i]
               for i, k in enumerate(AUX_KEYS)}
        total = aux["recon_loss"] + kl_weight * aux["kl_loss"]
        with profiling.span("step.optimizer"):
            grad_norm, ok = optimizer_update(ts, hp, total)
            if saved is not None:
                _restore_unless(ok, buffers, saved)
            opt.zero_grad(set_to_none=True)
        ts.step += 1
        metrics = {"loss": total.detach(), "grad_norm": grad_norm, "updated": ok,
                   "kl_weight": kl_weight}
        metrics.update(aux)
        if scaler is not None:
            ts.scaler = scaler.update(ts.scaler, ~ok)
            metrics["loss_scale"] = scale
        return metrics

    return train_step


def make_eval_step(hp):
    """``eval_step(ts, batch, generator) -> (total, aux, out)``: eval-mode
    forward and loss (reference train.py:122-147): running batchnorm
    statistics, no dropout or VAE sampling, but the prenet's dropout stays
    on as in the reference's eval (model.py:101).  The model computes in
    the type it was made with (float16 under ``fp16_run``).  Every rank
    computes the whole batch; with a model axis over its row."""

    @torch.no_grad()
    def eval_step(ts: TrainState, batch, generator=None):
        if not isinstance(batch, dict):
            batch = batch_to_device(batch, ts.device)
        with mesh.scope(ts.grid.row() if ts.grid is not None else None):
            out = ts.model(batch, train=False, generator=generator)
        total, aux = tacotron2_vae_loss(out, batch["mel"], batch["gate"], ts.step, hp)
        return total, aux, out

    return eval_step
