"""Training entry point (CLI of the JAX ``training/train.py``, reference
train.py:253-285):

    python -m tacotron2_vae_torch.training.train -o OUT -l LOG \\
        [-c CKPT] [--warm_start] [--hparams a=1,b=2] [--device cpu]
    torchrun --nproc_per_node=N -m tacotron2_vae_torch.training.train -o OUT ...

The loop runs as the JAX package's does.  A background thread
(``data.prefetch``) assembles batches ``prefetch_depth`` ahead and copies
each to the card on a CUDA stream of its own; the train step never waits
for the card; its metrics stay on the device, and as each window of
``log_fetch_window`` steps closes they are copied to pinned host memory
without waiting.  The host waits for a window's copy, and logs it, when
the next window closes (at once for a window of 1), so ``Train loss {it}
{loss} Grad Norm {g} {s}s/it`` and the ``metrics.csv`` row of every
iteration appear exactly once, in order, up to two windows late.
``s/it`` (the CSV's ``duration``) is the wall time per step between two
fetches, data pipeline included.  Every ``iters_per_checkpoint``
iterations the queue is drained, the averaged validation loss printed and
a checkpoint written; ``-c`` resumes from one (the iteration count
continues).

Under torchrun each process is one rank of a (data, model) grid
(``parallel.mesh``; ``--hparams mesh_model=M`` splits the weights of
``mesh.tacotron2_spec`` over M ranks, the data axis takes the rest): the
ranks of one data index read that index's shard of every epoch, a batch
of ``batch_size // data``; batchnorm statistics and random draws are the
global batch's; one gradient all-reduce a step over the data ranks; rank
0 prints, logs and writes the logical checkpoints.  Runs on
the card unless ``--device cpu``.  The logs are TensorBoard events (with
tensorboardX) and CSV files (``training.logger``).  ``--hparams
fp16_run=True`` trains in float16 with the dynamic loss scaler; the
scaler is checkpointed and resumed with the rest.  While ``utils.profiling``
records, the loop's wait for the next batch is a ``loop.data`` span and its
metric copies and logging (``close_window``, ``drain``) are ``loop.log``.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from collections import deque

import numpy as np
import torch

from ..config import create_hparams
from ..data.dataset import DataLoader, TextMelDataset
from ..data.prefetch import prefetch
from ..ops.layers import set_cudnn_flags
from ..parallel import mesh
from ..utils import profiling
from .checkpoint import (load_checkpoint, logical_state, save_checkpoint,
                         warm_start as warm_start_fn)
from .logger import Tacotron2Logger
from .train_state import (create_train_state, make_eval_step, make_train_step,
                          resolve_device)

_LONG_KEYS = ("text", "input_lengths", "output_lengths")


def prepare_dataloaders(hp, device=None, shard: tuple[int, int] = (0, 1)):
    """Train and validation loaders.  ``shard=(rank, world)`` gives data
    rank ``rank`` of ``world`` (every model rank of its row alike) a
    disjoint 1/world slice of every epoch with a batch of
    ``hp.batch_size // world`` (the global batch stays ``hp.batch_size``).
    With ``hp.fixed_batch_shapes``, or more than one rank, every train
    batch is padded to the train set's longest text and mel, rounded up to
    the buckets (JAX ``training/train.py:32-59``), so every rank's batch
    has one shape; validation batches keep their own bucketed lengths."""
    rank, world = shard
    if world > 1 and hp.batch_size % world:
        raise ValueError(f"batch_size={hp.batch_size} not divisible by process count {world}")
    trainset = TextMelDataset(hp.training_files, hp, device=device)
    valset = TextMelDataset(hp.validation_files, hp, shuffle=False, device=device)
    fixed = None
    if world > 1 or getattr(hp, "fixed_batch_shapes", False):
        max_s, max_t = trainset.max_lengths()
        fixed = (math.ceil(max_s / hp.text_bucket_size) * hp.text_bucket_size,
                 math.ceil(max_t / hp.mel_bucket_size) * hp.mel_bucket_size)
    return (DataLoader(trainset, hp.batch_size // world, hp, shuffle=True, shard=shard,
                       fixed_lengths=fixed),
            DataLoader(valset, hp.batch_size, hp, shuffle=False, drop_last=False))


def device_copier(device):
    """(transform, receive) for ``prefetch``: ``transform`` runs in the
    worker thread and starts a batch's copy to ``device``; ``receive`` runs
    in the training thread and hands the batch over.

    On a card the worker pins each array and copies it with
    ``non_blocking=True`` on a CUDA stream of its own, then records an
    event; ``receive`` makes the training stream wait for that event and
    marks each tensor as used by it (``record_stream``), so the allocator
    does not reuse its memory while the step still reads it.  On the CPU
    both are plain conversions."""
    if device.type != "cuda":
        def host(batch):
            return {k: torch.from_numpy(np.asarray(v, np.int64 if k in _LONG_KEYS
                                                   else np.float32))
                    for k, v in batch.asdict().items()}, None
        return host, lambda item: item[0]
    stream = torch.cuda.Stream(device)

    def transform(batch):
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.asarray(v, np.int64 if k in _LONG_KEYS
                                                  else np.float32)).pin_memory()
                   .to(device, non_blocking=True)
                   for k, v in batch.asdict().items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def receive(item):
        batch, ready = item
        current = torch.cuda.current_stream(device)
        current.wait_event(ready)
        for t in batch.values():
            t.record_stream(current)
        return batch

    return transform, receive


def validate(eval_step, ts, val_loader, generator):
    """Mean total loss over the validation set, the mean recon / KL, and
    the last (batch, outputs), which the logger plots.  The prenet's
    dropout stays on (reference model.py:101) and draws fresh noise for
    every batch from ``generator``."""
    losses, recons, kls = [], [], []
    last = None
    for batch in val_loader.epoch(0):
        total, aux, out = eval_step(ts, batch, generator)
        losses.append(float(total))
        recons.append(float(aux["recon_loss"]))
        kls.append(float(aux["kl_loss"]))
        last = (batch, out)
    if not losses:
        return float("nan"), {"recon_loss": float("nan"), "kl_loss": float("nan")}, last
    return float(np.mean(losses)), {"recon_loss": float(np.mean(recons)),
                                    "kl_loss": float(np.mean(kls))}, last


# the columns of a queued step's metrics, fetched a window at a time
_FETCHED = ("loss", "grad_norm", "kl_loss", "recon_loss", "updated")
_END = object()


def train(output_directory, log_directory, checkpoint_path, warm_start, hp, device=None,
          backend: str | None = None):
    """Train ``hp.epochs`` epochs; returns (train state, next iteration).

    Under torchrun's environment the process joins the grid's groups
    first (``parallel.mesh.init_distributed``; ``backend`` overrides NCCL
    on a card)."""
    grid, dev = mesh.init_distributed(hp, device, backend)
    if grid is None:
        dev = resolve_device(device)
    set_cudnn_flags(hp)
    lead = grid is None or grid.rank == 0
    os.makedirs(output_directory, exist_ok=True)
    torch.manual_seed(hp.seed)
    generator = torch.Generator(device=dev).manual_seed(hp.seed)
    ts = create_train_state(hp, dev, grid=grid)
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
    if grid is not None:
        mesh.broadcast_module(ts.model, grid)
    train_step, eval_step = make_train_step(hp, grid), make_eval_step(hp)
    shard = (grid.data_index, grid.data) if grid is not None else (0, 1)
    train_loader, val_loader = prepare_dataloaders(hp, dev, shard=shard)
    epoch_offset = max(0, iteration // max(len(train_loader), 1))
    logger = (Tacotron2Logger(os.path.join(output_directory, log_directory))
              if log_directory and lead else None)
    to_device, receive = device_copier(dev)

    window = max(1, hp.log_fetch_window)
    open_rows: list = []        # (iteration, metrics on the device, kl_weight)
    in_flight: deque = deque()  # closed windows: (open_rows, host copy, copy done)
    last_log_t = time.perf_counter()

    def close_window():
        rows = torch.stack([r for _, r, _ in open_rows])
        done = None
        if dev.type == "cuda":
            rows_host = torch.empty(rows.shape, pin_memory=True)
            rows_host.copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            rows = rows_host
        in_flight.append((list(open_rows), rows, done))
        open_rows.clear()

    def drain(keep):
        """Log the closed windows, oldest first, until ``keep`` remain."""
        nonlocal last_log_t
        while len(in_flight) > keep:
            entries, rows, done = in_flight.popleft()
            if done is not None:
                done.synchronize()
            now = time.perf_counter()
            per_step = (now - last_log_t) / len(entries)
            last_log_t = now
            if not lead:
                continue
            for (it, _, kl_weight), (loss, grad_norm, kl, recon, updated) in zip(
                    entries, rows.numpy().tolist()):
                if updated:
                    print(f"Train loss {it} {loss:.6f} Grad Norm {grad_norm:.6f} "
                          f"{per_step:.2f}s/it", flush=True)
                    if logger:
                        logger.log_training(loss, grad_norm, learning_rate, per_step, kl,
                                            kl_weight, recon, it)
                else:
                    print(f"Train loss {it} non-finite; update skipped", flush=True)

    def drain_all():
        if open_rows:
            close_window()
        drain(0)

    for epoch in range(epoch_offset, hp.epochs):
        if lead:
            print(f"Epoch: {epoch}", flush=True)
        batches = prefetch(train_loader.epoch(epoch), depth=max(1, hp.prefetch_depth),
                           transform=to_device)
        while True:
            with profiling.span("loop.data"):
                item = next(batches, _END)
            if item is _END:
                break
            m = train_step(ts, receive(item), generator)
            open_rows.append((iteration, torch.stack([m[k].float() for k in _FETCHED]),
                              m["kl_weight"]))
            del m
            if len(open_rows) == window:
                with profiling.span("loop.log"):
                    close_window()
                    drain(0 if window == 1 else 1)
            if iteration % hp.iters_per_checkpoint == 0 and iteration > 0:
                with profiling.span("loop.log"):
                    drain_all()
                # every rank validates, so the ranks' generators stay alike
                val_loss, val_aux, last = validate(eval_step, ts, val_loader, generator)
                state = logical_state(ts)  # every rank: a row gathers its slices
                if lead:
                    print(f"Validation loss {iteration}: {val_loss:.6f}", flush=True)
                    if logger and last is not None:
                        vbatch, vout = last
                        logger.log_validation(val_loss, state["state_dict"], vout,
                                              (vbatch.mel, vbatch.gate), iteration,
                                              components=val_aux)
                    ckpt = save_checkpoint(ts, learning_rate, output_directory, iteration,
                                           state=state)
                    print(f"Saved checkpoint: {ckpt}", flush=True)
                mesh.barrier(grid)
                # validation and the save are not steps: leave them out of s/it
                last_log_t = time.perf_counter()
            iteration += 1
    drain_all()
    if logger:
        logger.close()
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
    # accepted as the reference's launcher passes them, and ignored: torchrun's
    # environment describes the process group
    parser.add_argument("--n_gpus", type=int, default=1)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--group_name", type=str, default="")
    parser.add_argument("--hparams", type=str, default=None,
                        help="comma separated name=value pairs")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    hp = create_hparams(args.hparams)
    try:
        train(args.output_directory, args.log_directory, args.checkpoint_path,
              args.warm_start, hp, device=args.device)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
