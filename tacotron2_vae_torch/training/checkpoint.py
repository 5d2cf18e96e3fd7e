"""Checkpoints in the port's own format (``torch.save``).

The payload of the JAX package's ``training/checkpoint.py`` (reference
train.py:92-119): iteration, learning rate, the model's ``state_dict``
(parameters and batchnorm running statistics, reference names) and the
optimizer state, at ``output_dir/checkpoint_{iteration}``; under
``fp16_run`` also the loss scaler's (scale, count) (JAX
``checkpoint.py:36-75``), restored on resume, while a checkpoint saved
without it keeps the fresh scaler of the state it is loaded into.  Orbax
directories written by the JAX trainer need JAX and are not read.  In a
data-parallel run rank 0 writes and every rank then meets at a barrier
(``training.train``); every rank loads on resume, onto its own card.

A checkpoint holds the logical state: under a mesh's model axis every rank
of the row gathers the split parameters, running statistics and Adam
moments (``logical_state``) and rank 0 writes them, so one process and
``Synthesizer`` load it; a rank loads a checkpoint, from one process or
from any grid, by cutting its own slices.
"""

from __future__ import annotations

import os

import torch

from ..parallel import mesh
from .loss_scaler import ScalerState
from .train_state import TrainState


def logical_state(ts: TrainState) -> dict:
    """{"state_dict", "optimizer"}: the model's and Adam's logical state
    (every rank of a row calls it under a model axis)."""
    return {"state_dict": mesh.logical_state_dict(ts.model, ts.grid),
            "optimizer": mesh.logical_optimizer_state(ts.optimizer, ts.model, ts.grid)}


def save_checkpoint(ts: TrainState, learning_rate: float, output_dir: str,
                    iteration: int | None = None, state: dict | None = None) -> str:
    """Write ``checkpoint_{iteration}``; ``state`` is ``logical_state(ts)``
    when the caller has it."""
    iteration = ts.step if iteration is None else iteration
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint_{iteration}"))
    state = logical_state(ts) if state is None else state
    payload = {"iteration": int(iteration), "learning_rate": float(learning_rate),
               "state_dict": state["state_dict"], "optimizer": state["optimizer"]}
    if ts.scaler is not None:
        payload["scaler"] = [t.detach().cpu() for t in ts.scaler]
    torch.save(payload, path)
    return path


def _load(path: str, ts: TrainState) -> dict:
    return torch.load(path, map_location=ts.device, weights_only=True)


def _load_model(ts: TrainState, state_dict: dict) -> None:
    ts.model.load_state_dict(mesh.local_state_dict(state_dict, ts.model, ts.grid))


def load_checkpoint(path: str, ts: TrainState) -> tuple[TrainState, int, float]:
    """Full resume: weights, optimizer, iteration (reference
    train.py:100-110) and, when both the checkpoint and ``ts`` have one, the
    loss scaler; ``ts.step`` becomes the saved iteration."""
    payload = _load(path, ts)
    _load_model(ts, payload["state_dict"])
    ts.optimizer.load_state_dict(mesh.local_optimizer_state(payload["optimizer"], ts.model,
                                                            ts.grid))
    ts.step = int(payload["iteration"])
    if ts.scaler is not None and payload.get("scaler") is not None:
        ts.scaler = ScalerState(*(saved.to(ts.device, old.dtype)
                                  for saved, old in zip(payload["scaler"], ts.scaler)))
    return ts, ts.step, float(payload["learning_rate"])


def warm_start(path: str, ts: TrainState) -> TrainState:
    """Load the model weights only and keep a fresh optimizer (train.py:92-97)."""
    _load_model(ts, _load(path, ts)["state_dict"])
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
