"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel/mesh.py`` on its ``data`` axis).

One process per card, launched by ``torchrun``; ``init_distributed`` reads
torchrun's environment and joins the process group (NCCL on the cards,
gloo on the CPU).  A train step inside ``scope(dp)`` then computes what one
process computes on the ranks' batches concatenated, as the JAX mesh step
does on its global batch:

- training-mode batchnorm normalises with the statistics of the global
  batch (``batch_stats``: one differentiable all-reduce of
  ``[sum x, sum x^2, count]``), so the running buffers stay identical on
  every rank;
- every random draw is made at the global batch's shape from a generator
  that every rank seeds alike, and each rank keeps its own rows
  (``rand_rows``);
- after the backward the gradients and the step's metrics are summed over
  the ranks in one flat all-reduce (``all_reduce_flat``), the scheme of the
  reference's own DDP (one bucket, after the backward).

The JAX mesh's ``model`` axis (tensor parallelism) is not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataParallel:
    """This process's place in a data-parallel run."""

    rank: int
    world: int


# The data-parallel place of the step running in this thread (``scope``);
# a context variable, so the loader's threads never see it.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_parallel", default=None)

# batch_stats uses the differentiable all-reduce of torch.distributed.nn,
# which newer releases mark deprecated in favour of a private module
warnings.filterwarnings("ignore", message=r"torch\.distributed\.nn\.functional\.all_reduce",
                        category=FutureWarning)


def check_mesh(hp, world: int) -> None:
    """The port trains on the ``data`` axis only: ``mesh_model`` must be 1
    and ``mesh_data`` -1 (every process) or the world size."""
    if hp.mesh_model > 1:
        raise NotImplementedError(
            f"mesh_model={hp.mesh_model}: the tensor-parallel ('model') axis is not "
            "ported; ROADMAP.md A queues it (the tp axis)")
    if hp.mesh_data not in (-1, None, world):
        raise ValueError(f"mesh_data={hp.mesh_data} must be -1 or the world size {world}")


def init_distributed(hp=None, device=None, backend: str | None = None
                     ) -> tuple[DataParallel | None, torch.device]:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  Returns (the rank's ``DataParallel``, or None
    without that environment, and the device it trains on).

    On a card each rank takes ``cuda:LOCAL_RANK`` (modulo the cards
    present) and NCCL, on the CPU gloo; ``backend`` overrides the choice
    (gloo lets two ranks share one card)."""
    dev = torch.device(device or "cuda")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if hp is not None:
        check_mesh(hp, world)
    if "WORLD_SIZE" not in os.environ:
        return None, dev
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("training runs on a CUDA card and none is available; "
                               "pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world)
    return DataParallel(rank, world), dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def scope(dp: DataParallel | None):
    """Within: batch statistics and random draws span the global batch
    (a no-op for None or a world of 1)."""
    token = _ACTIVE.set(dp if dp is not None and dp.world > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def rand_rows(shape, batch_dim: int, generator=None, device=None, normal: bool = False):
    """``torch.rand`` (``torch.randn`` when ``normal``) of ``shape`` on
    ``device``, drawn inside a data-parallel scope at the global batch's
    shape (``shape[batch_dim]`` times the world size) and cut to this
    rank's rows, so every rank draws what one process would."""
    draw = torch.randn if normal else torch.rand
    dp = _ACTIVE.get()
    if dp is None:
        return draw(tuple(shape), generator=generator, device=device)
    full = list(shape)
    full[batch_dim] *= dp.world
    rows = shape[batch_dim]
    return draw(tuple(full), generator=generator, device=device).narrow(
        batch_dim, dp.rank * rows, rows)


def batch_stats(xf: torch.Tensor, axes: tuple):
    """(mean, biased variance, unbiased variance, the last detached) of
    ``xf`` over ``axes``: the one-pass statistics ``E[x]`` and
    ``max(E[x^2] - E[x]^2, 0)``, over the global batch inside a
    data-parallel scope (one differentiable all-reduce of
    ``[sum x, sum x^2, count]``)."""
    dp = _ACTIVE.get()
    if dp is None:
        count = xf.numel() // xf.shape[-1]
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        return mean, var, var.detach() * (count / max(count - 1, 1))
    from torch.distributed.nn.functional import all_reduce

    C = xf.shape[-1]
    count = torch.full((1,), float(xf.numel() // C), device=xf.device)
    sums = all_reduce(torch.cat([xf.sum(axes), (xf * xf).sum(axes), count]))
    n = sums[2 * C]
    mean = sums[:C] / n
    var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
    n = n.detach()
    return mean, var, var.detach() * (n / torch.clamp(n - 1, min=1.0))


def all_reduce_flat(tensors: list[torch.Tensor]) -> None:
    """Sum ``tensors`` (same dtype) over the ranks in place through one
    flat buffer."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat)
    torch._foreach_copy_(tensors, _unflatten_dense_tensors(flat, tensors))


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
    for t in tensors:
        dist.broadcast(t, 0)


def barrier(dp: DataParallel | None) -> None:
    if dp is not None and dp.world > 1:
        dist.barrier()
