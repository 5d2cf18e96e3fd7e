"""Loss scalers, static and dynamic (JAX ``training/loss_scaler.py``).

Reference ``loss_scaler.py:3-80`` and the fp16 optimizer it serves
(fp16_optimizer.py): the loss is multiplied by a scale before the
backward, the gradients divided by it after, and a step whose gradients
overflowed is skipped.  ``fp16_run`` trains with ``DynamicLossScaler``:
2^32 at the start, halved on every overflow down to 1, doubled after
``scale_window`` clean steps in a row.  Its state is two device tensors
and its update is ``torch.where`` on the device, so a train step never
waits for the card to decide it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossScaler:
    """Static loss scaler (reference loss_scaler.py:3-32)."""

    def __init__(self, scale: float = 1.0):
        self.loss_scale = float(scale)

    def scale_loss(self, loss):
        return loss * self.loss_scale

    def unscale_grads(self, grads):
        inv = 1.0 / self.loss_scale
        return [g * inv for g in grads]

    @staticmethod
    def has_overflow(grads) -> bool:
        """Whether any gradient holds an inf or a NaN (waits for the card)."""
        return not bool(torch.isfinite(sum(g.float().abs().sum() for g in grads)))

    def update_scale(self, overflow: bool) -> None:
        pass


class ScalerState(NamedTuple):
    scale: torch.Tensor                # float32 scalar
    iters_since_rescale: torch.Tensor  # int32 scalar


class DynamicLossScaler:
    """Dynamic scaler: x``scale_factor`` every ``scale_window`` clean steps,
    /``scale_factor`` on overflow with a floor of 1 (reference
    loss_scaler.py:35-80)."""

    def __init__(self, init_scale: float = 2 ** 32, scale_factor: float = 2.0,
                 scale_window: int = 1000):
        self.init_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def init(self, device=None) -> ScalerState:
        return ScalerState(torch.tensor(self.init_scale, dtype=torch.float32, device=device),
                           torch.zeros((), dtype=torch.int32, device=device))

    def update(self, state: ScalerState, overflow: torch.Tensor) -> ScalerState:
        """The next state after a step whose gradients overflowed or not
        (``overflow`` a bool device tensor); nothing waits for the card.
        The window is compared in int64, as it may exceed int32's range."""
        count = state.iters_since_rescale + 1
        grew = count.long() >= self.scale_window
        scale = torch.where(overflow, torch.clamp(state.scale / self.scale_factor, min=1.0),
                            torch.where(grew, state.scale * self.scale_factor, state.scale))
        count = torch.where(overflow | grew, torch.zeros_like(count), count)
        return ScalerState(scale, count)


def scaled_value_and_grad(loss_fn, scale, inputs=None):
    """The value of ``loss_fn`` and its gradients, taken of ``scale *
    loss_fn`` and divided by ``scale`` again, with the overflow flag
    (JAX ``scaled_value_and_grad``):

        (value, aux), grads, overflow = scaled_value_and_grad(f, state.scale)(x)

    ``loss_fn`` returns a scalar tensor or (scalar, aux).  The gradients
    are with respect to ``inputs`` (a list of tensors) when given, else to
    the first argument (a tensor or a list of tensors), as JAX's
    ``argnums=0``.  ``overflow`` is a bool device tensor: the sum of the
    gradients' magnitudes is not finite."""

    def wrapped(*args, **kwargs):
        out = loss_fn(*args, **kwargs)
        val, aux = out if isinstance(out, tuple) else (out, None)
        wrt = inputs if inputs is not None else args[0]
        single = isinstance(wrt, torch.Tensor)
        wrt = [wrt] if single else list(wrt)
        grads = torch.autograd.grad(val * scale, wrt, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g / scale for g, w in zip(grads, wrt)]
        total = sum(g.float().abs().sum() for g in grads)
        overflow = ~torch.isfinite(total)
        val = val.detach()
        value = (val, aux) if isinstance(out, tuple) else val
        return value, grads[0] if single else grads, overflow

    return wrapped
