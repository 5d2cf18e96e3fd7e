"""Checkpoints in the port's own format (``torch.save``).

The payload of the JAX package's ``training/checkpoint.py`` (reference
train.py:92-119): iteration, learning rate, the model's ``state_dict``
(parameters and batchnorm running statistics, reference names) and the
optimizer state, at ``output_dir/checkpoint_{iteration}``.  Orbax
directories written by the JAX trainer need JAX and are not read.
"""

from __future__ import annotations

import os

import torch

from .train_state import TrainState


def save_checkpoint(ts: TrainState, learning_rate: float, output_dir: str,
                    iteration: int | None = None) -> str:
    iteration = ts.step if iteration is None else iteration
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint_{iteration}"))
    torch.save({"iteration": int(iteration), "learning_rate": float(learning_rate),
                "state_dict": ts.model.state_dict(),
                "optimizer": ts.optimizer.state_dict()}, path)
    return path


def _load(path: str, ts: TrainState) -> dict:
    return torch.load(path, map_location=ts.device, weights_only=True)


def load_checkpoint(path: str, ts: TrainState) -> tuple[TrainState, int, float]:
    """Full resume: weights, optimizer and iteration (reference
    train.py:100-110); ``ts.step`` becomes the saved iteration."""
    payload = _load(path, ts)
    ts.model.load_state_dict(payload["state_dict"])
    ts.optimizer.load_state_dict(payload["optimizer"])
    ts.step = int(payload["iteration"])
    return ts, ts.step, float(payload["learning_rate"])


def warm_start(path: str, ts: TrainState) -> TrainState:
    """Load the model weights only and keep a fresh optimizer (train.py:92-97)."""
    ts.model.load_state_dict(_load(path, ts)["state_dict"])
    return ts


def latest_checkpoint(output_dir: str) -> str | None:
    if not os.path.isdir(output_dir):
        return None
    best, best_iter = None, -1
    for name in os.listdir(output_dir):
        if name.startswith("checkpoint_"):
            try:
                it = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if it > best_iter:
                best, best_iter = os.path.join(output_dir, name), it
    return best
