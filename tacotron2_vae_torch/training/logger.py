"""Training logs as CSV files (the JAX ``Tacotron2Logger``'s sidecars).

``metrics.csv`` holds one row per training iteration and
``val_metrics.csv`` one per validation, with the JAX package's columns.
TensorBoard scalars, histograms and plots are not ported yet.
"""

from __future__ import annotations

import os


class Tacotron2Logger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
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
        with open(self._train_csv, "a") as f:
            f.write(f"{iteration},{float(reduced_loss):.6f},{float(grad_norm):.6f},"
                    f"{float(learning_rate):.8f},{float(duration):.4f},{float(kl_div):.6f},"
                    f"{float(kl_weight):.6f},{float(recon_loss):.6f}\n")

    def log_validation(self, reduced_loss, iteration, components=None):
        components = components or {}
        recon = float(components.get("recon_loss", float("nan")))
        kl = float(components.get("kl_loss", float("nan")))
        with open(self._val_csv, "a") as f:
            f.write(f"{iteration},{float(reduced_loss):.6f},{recon:.6f},{kl:.6f}\n")
