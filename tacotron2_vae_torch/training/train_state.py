"""Train state and the train / eval steps (JAX ``training/train_state.py``).

The optimizer follows the reference's torch Adam + clip_grad_norm loop
(train.py:171-175, 204-232) as the JAX package chains it: global-norm clip
to ``grad_clip_thresh`` (optax's ``thresh / max(norm, thresh)``; PyTorch's
``clip_grad_norm_`` adds 1e-6 and is not used) -> L2 weight decay added to
the gradient -> Adam (0.9, 0.999, 1e-8) -> step of -lr, i.e.
``torch.optim.Adam(weight_decay=...)`` after the hand-written clip.  A
parameter the forward does not use (the speaker and emotion embeddings)
gets a zero gradient, so weight decay moves it as optax moves it.

A non-finite loss or gradient norm skips the update: the parameters, Adam's
moments and step count, and the batchnorm running statistics (snapshotted
before the forward) are left as they were; the iteration count still
advances.  ``fp16_run`` (the dynamic loss scaler) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.tacotron2 import Tacotron2, init_weights
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
                            weight_decay=hp.weight_decay)


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
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def optimizer_update(ts: TrainState, hp, loss: float) -> tuple[float, bool]:
    """Clip the gradients to ``grad_clip_thresh`` by their global norm and
    take one Adam step, unless the loss or the norm is not finite.
    Parameters without a gradient get a zero one.  Returns (norm, stepped)."""
    params = list(ts.model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    grad_norm = float(global_norm(grads))
    ok = bool(np.isfinite(loss) and np.isfinite(grad_norm))
    if ok:
        torch._foreach_mul_(grads, hp.grad_clip_thresh / max(grad_norm, hp.grad_clip_thresh))
        ts.optimizer.step()
    return grad_norm, ok


def make_train_step(hp):
    """Returns ``train_step(ts, batch, generator) -> metrics`` (floats),
    which updates ``ts`` in place.

    With ``grad_accum_steps = a > 1`` the batch splits into ``a``
    micro-batches under one update whose gradient matches the big batch:
    mel and gate terms are means, while the KL is a sum over the batch, so
    each micro-batch's KL is weighted by ``a`` before the 1/a average;
    batchnorm running statistics chain through the micro-batches."""
    if hp.fp16_run:
        raise NotImplementedError("fp16_run (dynamic loss scaling) is not ported yet")
    accum = max(1, int(getattr(hp, "grad_accum_steps", 1)))

    def train_step(ts: TrainState, batch, generator=None):
        model, opt = ts.model, ts.optimizer
        if not isinstance(batch, dict):
            batch = batch_to_device(batch, ts.device)
        buffers = [b.detach().clone() for b in model.buffers()]
        opt.zero_grad(set_to_none=True)
        if accum == 1:
            out = model(batch, train=True, generator=generator)
            total, aux = tacotron2_vae_loss(out, batch["mel"], batch["gate"], ts.step, hp)
            total.backward()
        else:
            sums = {k: 0.0 for k in AUX_KEYS}
            for micro in _split(batch, accum):
                out = model(micro, train=True, generator=generator)
                _, aux_m = tacotron2_vae_loss(out, micro["mel"], micro["gate"], ts.step, hp)
                (aux_m["recon_loss"] + aux_m["kl_weight"] * accum * aux_m["kl_loss"]).backward()
                for k in AUX_KEYS:
                    sums[k] = sums[k] + aux_m[k].detach()
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
            aux = {k: sums[k] / accum for k in ("recon_loss", "mel_loss", "gate_loss")}
            aux["kl_loss"], aux["kl_weight"] = sums["kl_loss"], aux_m["kl_weight"]
            total = aux["recon_loss"] + aux["kl_weight"] * aux["kl_loss"]
        loss = float(total.detach())
        grad_norm, ok = optimizer_update(ts, hp, loss)
        if not ok:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
        opt.zero_grad(set_to_none=True)
        ts.step += 1
        metrics = {"loss": loss, "grad_norm": grad_norm, "updated": ok}
        metrics.update({k: float(torch.as_tensor(v).detach()) for k, v in aux.items()})
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
