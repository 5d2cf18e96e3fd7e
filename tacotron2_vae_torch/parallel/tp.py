"""Tensor parallelism over the mesh's ``model`` axis: the conjugate autograd
pairs of Megatron-LM (arXiv:1909.08053), as ``torch.autograd.Function``s.

Every rank of a row (``mesh.Grid.model_group``) computes the same loss on
the same rows.  A column-parallel layer holds a slice of its output
features and reads its whole input; a row-parallel layer holds a slice of
its input features and its partial products are summed over the row.

- ``copy``: identity forward, all-reduce backward.  Before a
  column-parallel layer: each rank's slice of the layer sends back only
  its part of the input's gradient.
- ``reduce``: all-reduce forward, identity backward.  After a
  row-parallel product.  ``torch.distributed.nn``'s all-reduce would
  all-reduce the gradient again, and every rank uses the sum alike, so
  the gradient would come back ``model`` times too large.
- ``gather``: the row's slices concatenated along a dim forward, this
  rank's slice of the gradient backward (the rank's consumers of the
  whole tensor compute its whole gradient).
- ``scatter``: this rank's slice forward, the slices' gradients gathered
  backward (before a row-parallel product of a whole tensor).

Outside a ``mesh.scope`` whose grid has a model axis, all four return
their input.  The gather is an all-reduce of a zero buffer that holds the
rank's slice at its place, summed in float32 (exact: one term of each sum
is not zero), and so are the sums: gloo runs only broadcast, all-reduce
and barrier on CUDA tensors, and ranks sharing one card need gloo, so the
one path runs on every backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import mesh


def _row():
    grid = mesh.active()
    return grid if grid is not None and grid.model > 1 else None


def _sum(x: torch.Tensor, grid) -> torch.Tensor:
    y = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=grid.model_group)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, grid) -> torch.Tensor:
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * grid.model
    buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
    buf.narrow(dim, grid.model_index * n, n).copy_(x.detach())
    dist.all_reduce(buf, group=grid.model_group)
    return buf.to(x.dtype)


def _slice(x: torch.Tensor, dim: int, grid) -> torch.Tensor:
    n = x.shape[dim] // grid.model
    return x.narrow(dim, grid.model_index * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.grid), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return _sum(x, grid)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grid):
        ctx.dim, ctx.grid = dim, grid
        return _gather(x, dim, grid)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.grid), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grid):
        ctx.dim, ctx.grid = dim, grid
        return _slice(x, dim, grid)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.grid), None, None


def copy(x: torch.Tensor) -> torch.Tensor:
    grid = _row()
    return x if grid is None else _Copy.apply(x, grid)


def reduce(x: torch.Tensor) -> torch.Tensor:
    grid = _row()
    return x if grid is None else _Reduce.apply(x, grid)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    grid = _row()
    return x if grid is None else _Gather.apply(x, dim % x.ndim, grid)


def scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    grid = _row()
    return x if grid is None else _Scatter.apply(x, dim % x.ndim, grid)
