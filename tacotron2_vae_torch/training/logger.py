"""Training logs: TensorBoard events and CSV sidecars (JAX
``training/logger.py``, reference ``Tacotron2Logger``, logger.py:8-57).

With tensorboardX importable the logger writes the reference's training
scalars (``training.loss``, ``grad.norm``, ``learning.rate``,
``duration``, ``kl_div``, ``kl_weight``, ``recon_loss``), the validation
loss and its components, a histogram of every parameter (tagged by its
path in the JAX package's parameter tree, ``convert.to_jax_params``), and,
with matplotlib importable, the alignment, target and predicted mel, gate
and latent-scatter images of one validation row.  ``metrics.csv`` (one row
per training iteration) and ``val_metrics.csv`` (one per validation) are
written always, with the JAX package's columns; ``duration`` is the wall
time per step between two metric fetches.  In a data-parallel run only
rank 0 keeps a logger.
"""

from __future__ import annotations

import os

import numpy as np

from .. import convert
from ..utils import plotting


def _summary_writer(logdir: str):
    """A tensorboardX ``SummaryWriter`` on ``logdir``, or None without it."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu()
    return np.asarray(x)


class Tacotron2Logger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.writer = _summary_writer(logdir)
        self._train_csv = os.path.join(logdir, "metrics.csv")
        self._val_csv = os.path.join(logdir, "val_metrics.csv")
        for path, header in ((self._train_csv, "iteration,loss,grad_norm,learning_rate,"
                              "duration,kl_div,kl_weight,recon_loss\n"),
                             (self._val_csv, "iteration,loss,recon_loss,kl_div\n")):
            if not os.path.exists(path):
                with open(path, "w") as f:
                    f.write(header)

    def log_training(self, reduced_loss, grad_norm, learning_rate, duration, kl_div,
                     kl_weight, recon_loss, iteration):
        if self.writer is not None:
            for tag, value in (("training.loss", reduced_loss), ("grad.norm", grad_norm),
                               ("learning.rate", learning_rate), ("duration", duration),
                               ("kl_div", kl_div), ("kl_weight", kl_weight),
                               ("recon_loss", recon_loss)):
                self.writer.add_scalar(tag, float(value), iteration)
        with open(self._train_csv, "a") as f:
            f.write(f"{iteration},{float(reduced_loss):.6f},{float(grad_norm):.6f},"
                    f"{float(learning_rate):.8f},{float(duration):.4f},{float(kl_div):.6f},"
                    f"{float(kl_weight):.6f},{float(recon_loss):.6f}\n")

    def log_validation(self, reduced_loss, params, outputs, targets, iteration,
                       components=None):
        """``params``: the model's ``state_dict``; ``outputs``: a
        ``Tacotron2Output`` of the last validation batch; ``targets``: its
        (mel, gate).  ``components``: the validation means of
        ``recon_loss`` and ``kl_loss``."""
        components = components or {}
        recon = float(components.get("recon_loss", float("nan")))
        kl = float(components.get("kl_loss", float("nan")))
        with open(self._val_csv, "a") as f:
            f.write(f"{iteration},{float(reduced_loss):.6f},{recon:.6f},{kl:.6f}\n")
        w = self.writer
        if w is None:
            return
        w.add_scalar("validation.loss", float(reduced_loss), iteration)
        if components:
            w.add_scalar("validation.recon_loss", recon, iteration)
            w.add_scalar("validation.kl_div", kl, iteration)
        if params is not None:
            self._histograms(convert.to_jax_params(params)[0], iteration)
        if outputs is None or not plotting.available():
            return
        mel_target, gate_target = (_numpy(x) for x in targets)
        idx = 0
        for tag, image in (
                ("alignment", plotting.plot_alignment_to_numpy(
                    _numpy(outputs.alignments[idx]).T)),
                ("mel_target", plotting.plot_spectrogram_to_numpy(mel_target[idx])),
                ("mel_predicted", plotting.plot_spectrogram_to_numpy(
                    _numpy(outputs.mel_outputs_postnet[idx]))),
                ("gate", plotting.plot_gate_outputs_to_numpy(
                    gate_target[idx], _sigmoid(_numpy(outputs.gate_outputs[idx]))))):
            w.add_image(tag, image, iteration, dataformats="HWC")
        emotions = _numpy(outputs.emotions)
        if emotions.size and emotions.ndim == 2:
            w.add_image("latent_mu", plotting.plot_scatter(_numpy(outputs.mu),
                                                           emotions.argmax(axis=1)),
                        iteration, dataformats="HWC")

    def _histograms(self, tree, iteration, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                self._histograms(v, iteration, f"{path}.{k}" if path else k)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                self._histograms(v, iteration, f"{path}.{i}")
        else:
            self.writer.add_histogram(path, np.asarray(tree), iteration)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))
