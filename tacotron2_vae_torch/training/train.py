"""Training entry point (CLI of the JAX ``training/train.py``, reference
train.py:253-285), on one device:

    python -m tacotron2_vae_torch.training.train -o OUT -l LOG \\
        [-c CKPT] [--warm_start] [--hparams a=1,b=2] [--device cpu]

Every step fetches its metrics and prints ``Train loss {it} {loss} Grad
Norm {g} {s}s/it``; every ``iters_per_checkpoint`` iterations the averaged
validation loss is printed and a checkpoint is written; ``-c`` resumes
from one (the iteration count continues).  Runs on the card unless
``--device cpu``.  Not ported yet: multi-device parallelism, TensorBoard.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from ..config import create_hparams
from ..data.dataset import DataLoader, TextMelDataset
from .checkpoint import load_checkpoint, save_checkpoint, warm_start as warm_start_fn
from .logger import Tacotron2Logger
from .train_state import create_train_state, make_eval_step, make_train_step, resolve_device


def prepare_dataloaders(hp, device):
    """Train and validation loaders.  With ``hp.fixed_batch_shapes`` every
    train batch is padded to the train set's longest text and mel, rounded
    up to the buckets (JAX ``training/train.py:45-57``); validation batches
    keep their own bucketed lengths."""
    trainset = TextMelDataset(hp.training_files, hp, device=device)
    valset = TextMelDataset(hp.validation_files, hp, shuffle=False, device=device)
    fixed = None
    if getattr(hp, "fixed_batch_shapes", False):
        max_s, max_t = trainset.max_lengths()
        fixed = (math.ceil(max_s / hp.text_bucket_size) * hp.text_bucket_size,
                 math.ceil(max_t / hp.mel_bucket_size) * hp.mel_bucket_size)
    return (DataLoader(trainset, hp.batch_size, hp, shuffle=True, fixed_lengths=fixed),
            DataLoader(valset, hp.batch_size, hp, shuffle=False, drop_last=False))


def validate(eval_step, ts, val_loader, generator):
    """Mean total loss over the validation set and the mean recon / KL.
    The prenet's dropout stays on (reference model.py:101) and draws fresh
    noise for every batch from ``generator``."""
    losses, recons, kls = [], [], []
    for batch in val_loader.epoch(0):
        total, aux, _ = eval_step(ts, batch, generator)
        losses.append(float(total))
        recons.append(float(aux["recon_loss"]))
        kls.append(float(aux["kl_loss"]))
    if not losses:
        return float("nan"), {"recon_loss": float("nan"), "kl_loss": float("nan")}
    return float(np.mean(losses)), {"recon_loss": float(np.mean(recons)),
                                    "kl_loss": float(np.mean(kls))}


def train(output_directory, log_directory, checkpoint_path, warm_start, hp, device=None):
    """Train ``hp.epochs`` epochs; returns (train state, next iteration)."""
    dev = resolve_device(device)
    os.makedirs(output_directory, exist_ok=True)
    torch.manual_seed(hp.seed)
    generator = torch.Generator(device=dev).manual_seed(hp.seed)
    ts = create_train_state(hp, dev)
    learning_rate = hp.learning_rate
    iteration = 0
    if checkpoint_path:
        if warm_start:
            ts = warm_start_fn(checkpoint_path, ts)
        else:
            ts, iteration, saved_lr = load_checkpoint(checkpoint_path, ts)
            if hp.use_saved_learning_rate:
                learning_rate = saved_lr
                for group in ts.optimizer.param_groups:
                    group["lr"] = saved_lr
            iteration += 1
    train_step, eval_step = make_train_step(hp), make_eval_step(hp)
    train_loader, val_loader = prepare_dataloaders(hp, dev)
    epoch_offset = max(0, iteration // max(len(train_loader), 1))
    logger = (Tacotron2Logger(os.path.join(output_directory, log_directory))
              if log_directory else None)

    for epoch in range(epoch_offset, hp.epochs):
        print(f"Epoch: {epoch}", flush=True)
        for batch in train_loader.epoch(epoch):
            t0 = time.perf_counter()
            m = train_step(ts, batch, generator)
            dt = time.perf_counter() - t0
            if m["updated"]:
                print(f"Train loss {iteration} {m['loss']:.6f} Grad Norm "
                      f"{m['grad_norm']:.6f} {dt:.2f}s/it", flush=True)
                if logger:
                    logger.log_training(m["loss"], m["grad_norm"], learning_rate, dt,
                                        m["kl_loss"], m["kl_weight"], m["recon_loss"],
                                        iteration)
            else:
                print(f"Train loss {iteration} non-finite; update skipped", flush=True)
            if iteration % hp.iters_per_checkpoint == 0 and iteration > 0:
                val_loss, val_aux = validate(eval_step, ts, val_loader, generator)
                print(f"Validation loss {iteration}: {val_loss:.6f}", flush=True)
                if logger:
                    logger.log_validation(val_loss, iteration, val_aux)
                ckpt = save_checkpoint(ts, learning_rate, output_directory, iteration)
                print(f"Saved checkpoint: {ckpt}", flush=True)
            iteration += 1
    return ts, iteration


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--output_directory", type=str, required=True,
                        help="directory to save checkpoints")
    parser.add_argument("-l", "--log_directory", type=str, default="logs",
                        help="directory for the CSV logs, under the output directory")
    parser.add_argument("-c", "--checkpoint_path", type=str, default=None,
                        help="checkpoint path to resume from")
    parser.add_argument("--warm_start", action="store_true", help="load model weights only")
    parser.add_argument("--hparams", type=str, default=None,
                        help="comma separated name=value pairs")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    hp = create_hparams(args.hparams)
    train(args.output_directory, args.log_directory, args.checkpoint_path, args.warm_start,
          hp, device=args.device)


if __name__ == "__main__":
    main()
