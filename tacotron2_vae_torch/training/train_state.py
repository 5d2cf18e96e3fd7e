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
count still advances.  In a data-parallel run (``parallel.mesh``) the step
computes what one process computes on the global batch, and the skip is
decided from the all-reduced loss and norm, alike on every rank.
``fp16_run`` (the dynamic loss scaler) is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.tacotron2 import Tacotron2, init_weights
from ..parallel import mesh
from .loss import tacotron2_vae_loss

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

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(model, hp, learning_rate=None) -> torch.optim.Adam:
    lr = hp.learning_rate if learning_rate is None else learning_rate
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=hp.weight_decay, fused=True)


def create_train_state(hp, device=None, learning_rate=None, seed=None) -> TrainState:
    """A model with random weights from ``seed`` (default ``hp.seed``) on
    ``device`` (default the card) and a fresh optimizer."""
    if hp.fp16_run:
        raise NotImplementedError("fp16_run (dynamic loss scaling) is not ported yet")
    gen = torch.Generator().manual_seed(hp.seed if seed is None else seed)
    model = init_weights(Tacotron2(hp), gen).to(resolve_device(device))
    return TrainState(model, make_optimizer(model, hp, learning_rate))


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


def global_norm(tensors) -> torch.Tensor:
    """The global L2 norm of ``tensors`` as a device scalar (float32)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


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
    norm = global_norm([p.grad for p in params])
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


def make_train_step(hp, dp: mesh.DataParallel | None = None):
    """Returns ``train_step(ts, batch, generator) -> metrics``, which
    updates ``ts`` in place.  The metrics are device scalars (``loss``,
    ``grad_norm``, the ``AUX_KEYS`` and ``updated``) and ``kl_weight`` (a
    float); reading them is the caller's choice and the step never waits.

    With ``grad_accum_steps = a > 1`` the batch splits into ``a``
    micro-batches under one update whose gradient matches the big batch:
    mel and gate terms are means, while the KL is a sum over the batch, so
    each micro-batch's KL is weighted by ``a`` before the 1/a average;
    batchnorm running statistics chain through the micro-batches.  With
    ``dp`` (world ``w``) the same rule spans the ranks: each back-propagates
    ``recon + kl_weight * w * a * kl`` of its rows, the gradients and the
    metrics are summed over the ranks in one all-reduce, and the gradient
    is divided by ``w * a``; the metrics are those of the global batch."""
    if hp.fp16_run:
        raise NotImplementedError("fp16_run (dynamic loss scaling) is not ported yet")
    accum = max(1, int(getattr(hp, "grad_accum_steps", 1)))
    world = dp.world if dp is not None else 1

    def train_step(ts: TrainState, batch, generator=None):
        model, opt = ts.model, ts.optimizer
        if not isinstance(batch, dict):
            batch = batch_to_device(batch, ts.device)
        buffers = _float_buffers(model)
        saved = torch.cat([b.reshape(-1) for b in buffers]) if buffers else None
        opt.zero_grad(set_to_none=True)
        sums = None
        with mesh.scope(dp):
            for micro in (_split(batch, accum) if accum > 1 else (batch,)):
                out = model(micro, train=True, generator=generator)
                _, aux = tacotron2_vae_loss(out, micro["mel"], micro["gate"], ts.step, hp)
                kl_weight = aux["kl_weight"]
                (aux["recon_loss"] + kl_weight * (accum * world) * aux["kl_loss"]).backward()
                part = torch.stack([aux[k].detach() for k in AUX_KEYS])
                sums = part if sums is None else sums + part
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if world > 1:
            # the gradients and the metric sums in one flat all-reduce
            mesh.all_reduce_flat(grads + [sums])
            torch._foreach_div_(grads, world * accum)
        elif accum > 1:
            torch._foreach_div_(grads, accum)
        # recon, mel and gate are means of the ranks' and micro-batches'
        # means; the KL is a sum over the batch
        n = world * accum
        aux = {k: sums[i] / n if n > 1 and k != "kl_loss" else sums[i]
               for i, k in enumerate(AUX_KEYS)}
        total = aux["recon_loss"] + kl_weight * aux["kl_loss"]
        grad_norm, ok = optimizer_update(ts, hp, total)
        if saved is not None:
            _restore_unless(ok, buffers, saved)
        opt.zero_grad(set_to_none=True)
        ts.step += 1
        metrics = {"loss": total.detach(), "grad_norm": grad_norm, "updated": ok,
                   "kl_weight": kl_weight}
        metrics.update(aux)
        return metrics

    return train_step


def make_eval_step(hp):
    """``eval_step(ts, batch, generator) -> (total, aux, out)``: eval-mode
    forward and loss (reference train.py:122-147): running batchnorm
    statistics, no dropout or VAE sampling, but the prenet's dropout stays
    on as in the reference's eval (model.py:101)."""

    @torch.no_grad()
    def eval_step(ts: TrainState, batch, generator=None):
        if not isinstance(batch, dict):
            batch = batch_to_device(batch, ts.device)
        out = ts.model(batch, train=False, generator=generator)
        total, aux = tacotron2_vae_loss(out, batch["mel"], batch["gate"], ts.step, hp)
        return total, aux, out

    return eval_step
