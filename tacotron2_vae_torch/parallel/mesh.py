"""The JAX package's ``parallel/mesh.py`` over ``torch.distributed``: a
(data, model) grid of processes.

One process per card, launched by ``torchrun``; ``init_distributed`` reads
torchrun's environment and joins the process group (NCCL on the cards,
gloo on the CPU).  Rank ``r`` of a ``data x model`` grid sits at data index
``r // model`` and model index ``r % model``, the place JAX's
``np.asarray(devices).reshape(data, model)`` gives device ``r``.  The model
ranks of one data index form its row (``Grid.model_group``), the data
ranks of one model index its column (``Grid.data_group``).

The data axis.  A train step inside ``scope(grid)`` computes what one
process computes on the rows' batches concatenated, as the JAX mesh step
does on its global batch:

- training-mode batchnorm normalises with the statistics of the global
  batch (``batch_stats``: one differentiable all-reduce of
  ``[sum x, sum x^2, count]`` over the column), so the running buffers stay
  identical on every data rank;
- every random draw is made at the global batch's shape from a generator
  that every rank seeds alike, and each rank keeps its data index's rows
  (``rand_rows``) and, on a feature axis the model axis shards, its model
  index's columns (``rand_cols``);
- after the backward the gradients and the step's metrics are summed over
  the column in one flat all-reduce (``all_reduce_flat``), the scheme of
  the reference's own DDP (one bucket, after the backward).

The model axis (tensor parallelism, ``parallel/tp.py``).  ``shard_module``
keeps on each rank only its model index's slice of every tensor its spec
names (``tacotron2_spec`` and ``waveglow_spec``, the JAX ``_param_spec``
and ``_waveglow_spec`` keyed by the port's state_dict names), so the
parameters and Adam's moments of those tensors take ``1/model`` of their
memory a rank.  ``logical_state_dict`` gathers them back (checkpoints hold
the logical state), ``local_state_dict`` cuts a logical state to a rank.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import re
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Grid:
    """This process's place in a (data, model) grid of ``world`` ranks."""

    rank: int
    world: int
    model: int = 1
    data_group: object = None   # the data ranks of this rank's column (None: the world)
    model_group: object = None  # the model ranks of this rank's row

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def row(self) -> "Grid":
        """This rank's row alone: the model axis without the data axis (a
        step on a batch every row computes whole, such as validation)."""
        return dataclasses.replace(self, rank=self.model_index, world=self.model,
                                   data_group=None)


# The grid of the step running in this thread (``scope``); a context
# variable, so the loader's threads never see it.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("grid", default=None)

# batch_stats uses the differentiable all-reduce of torch.distributed.nn,
# which newer releases mark deprecated in favour of a private module
warnings.filterwarnings("ignore", message=r"torch\.distributed\.nn\.functional\.all_reduce",
                        category=FutureWarning)


def active() -> Grid | None:
    """The grid of the enclosing ``scope``, None outside one."""
    return _ACTIVE.get()


# ------------------------------------------------------------ the model axis


@dataclass(frozen=True)
class Shard:
    """A tensor split over the model axis along ``dim``, which holds
    ``groups`` equal blocks; a rank keeps its slice of every block (one
    block: a contiguous slice)."""

    dim: int
    groups: int = 1


# (state_dict name, dim): the JAX ``_param_spec`` shards these weights; the
# biases, batchnorm affines and running statistics of the channels a
# column-parallel layer writes go with them
_TACOTRON2_RULES = tuple((re.compile(p), d) for p, d in (
    (r"transcript_embedding\.weight", 1),                       # (vocab, 512): the width
    (r"(encoder|postnet)\.convolutions\.\d+\.0\.conv\.(weight|bias)", 0),  # out channels
    (r"(encoder|postnet)\.convolutions\.\d+\.1\.(weight|bias|running_mean|running_var)", 0),
    (r"vae_gst\.ref_encoder\.convs\.\d+(\.conv)?\.(weight|bias)", 0),
    (r"vae_gst\.ref_encoder\.bns\.\d+\.(weight|bias|running_mean|running_var)", 0),
    (r"decoder\.prenet\.layers\.\d+\.linear_layer\.weight", 0),  # out features
    (r"decoder\.attention_layer\.(memory|query)_layer\.linear_layer\.weight", 0),  # attention dim
    (r"decoder\.(linear_projection|gate_layer)\.linear_layer\.weight", 1),  # the contraction
))


def tacotron2_spec(name: str) -> Shard | None:
    """How the model axis splits the Tacotron2 tensor ``name`` (None:
    replicated); the recurrent cells stay replicated, as in JAX."""
    for pattern, dim in _TACOTRON2_RULES:
        if pattern.fullmatch(name):
            return Shard(dim)
    return None


def waveglow_spec(name: str, n_layers: int) -> Shard | None:
    """The JAX ``_waveglow_spec`` on the port's WaveGlow names: the
    upsampler's output channels; the WaveNet layers that write the hidden
    channels (``start``, ``cond_layer``, ``in_layers``) column-parallel,
    with their biases; those that read them (``res_skip_layers``, ``end``)
    row-parallel; the 1x1 mixing and the other biases replicated.  The gate
    pairs channel c with channel nc + c, so ``in_layers`` and each layer's
    block of ``cond_layer`` split each half alike."""
    if name == "upsample.weight":
        return Shard(1)                  # ConvTranspose1d (in, out, k)
    if name == "upsample.bias" or re.fullmatch(r"WN\.\d+\.start\.(weight|bias)", name):
        return Shard(0)
    if re.fullmatch(r"WN\.\d+\.in_layers\.\d+\.(weight|bias)", name):
        return Shard(0, 2)
    if re.fullmatch(r"WN\.\d+\.cond_layer\.(weight|bias)", name):
        return Shard(0, 2 * n_layers)
    if re.fullmatch(r"WN\.\d+\.(res_skip_layers\.\d+|end)\.weight", name):
        return Shard(1)
    return None


def shard_index(size: int, shard: Shard, model: int, index: int) -> torch.Tensor:
    """The positions along ``shard.dim`` (of ``size``) that model index
    ``index`` keeps."""
    block = size // shard.groups
    n = block // model
    return torch.cat([torch.arange(g * block + index * n, g * block + (index + 1) * n)
                      for g in range(shard.groups)])


def check_widths(shapes: dict, spec, model: int) -> dict:
    """{name: Shard} of the tensors in ``shapes`` (name -> shape) that
    ``spec`` splits; ValueError, naming the tensor, where ``model`` does not
    divide a split width (JAX refuses the same placement)."""
    out = {}
    for name, shape in shapes.items():
        shard = spec(name)
        if shard is None:
            continue
        size = shape[shard.dim]
        if size % (shard.groups * model):
            raise ValueError(f"mesh_model={model} does not divide {name}'s width {size} "
                             f"(dim {shard.dim}" + (f", {shard.groups} blocks)"
                                                    if shard.groups > 1 else ")"))
        out[name] = shard
    return out


def shard_module(module: torch.nn.Module, spec, grid: Grid) -> torch.nn.Module:
    """Keep this rank's slice of every tensor ``spec`` splits (in place:
    the parameters stay the same objects, so build the optimizer after);
    ``module.tp_shards`` records {name: Shard}."""
    tensors = module.state_dict(keep_vars=True)
    shards = check_widths({k: v.shape for k, v in tensors.items()}, spec, grid.model)
    with torch.no_grad():
        for name, shard in shards.items():
            t = tensors[name]
            idx = shard_index(t.shape[shard.dim], shard, grid.model, grid.model_index)
            t.data = t.data.index_select(shard.dim, idx.to(t.device)).contiguous()
    module.tp_shards = shards
    return module


def gather_shard(x: torch.Tensor, shard: Shard, grid: Grid) -> torch.Tensor:
    """The logical tensor of this row's slices ``x`` (every rank of the row
    calls it): each rank writes its slice into a zero buffer, summed over
    the row in float32 (an all-reduce, which gloo also runs on CUDA
    tensors)."""
    shape = list(x.shape)
    shape[shard.dim] *= grid.model
    idx = shard_index(shape[shard.dim], shard, grid.model, grid.model_index).to(x.device)
    buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
    buf.index_copy_(shard.dim, idx, x.detach().float())
    dist.all_reduce(buf, group=grid.model_group)
    return buf.to(x.dtype)


def _shards(module) -> dict:
    return getattr(module, "tp_shards", {})


def logical_state_dict(module: torch.nn.Module, grid: Grid | None) -> dict:
    """``module``'s state_dict with every split tensor gathered (every rank
    of the row calls it)."""
    state = module.state_dict()
    for k, shard in _shards(module).items():
        state[k] = gather_shard(state[k], shard, grid)
    return state


def local_state_dict(state: dict, module: torch.nn.Module, grid: Grid | None) -> dict:
    """A logical state_dict cut to this rank's slices of ``module``'s split
    tensors."""
    shards = _shards(module)
    out = {}
    for k, v in state.items():
        if k in shards:
            s = shards[k]
            v = v.index_select(s.dim, shard_index(v.shape[s.dim], s, grid.model,
                                                  grid.model_index).to(v.device))
        out[k] = v
    return out


def _cut_moments(state: dict, module: torch.nn.Module, cut) -> dict:
    """A copy of an Adam state_dict (of ``module.parameters()``) with
    ``cut(tensor, shard)`` applied to the moments of every parameter the
    model axis splits (``Optimizer.state_dict`` holds the live per-
    parameter dicts, so they are copied, not changed)."""
    shards = _shards(module)
    names = [n for n, _ in module.named_parameters()]
    out = {"state": {}, "param_groups": state["param_groups"]}
    for i, entry in state["state"].items():
        entry = dict(entry)
        if names[i] in shards:
            for k in ("exp_avg", "exp_avg_sq"):
                entry[k] = cut(entry[k], shards[names[i]])
        out["state"][i] = entry
    return out


def logical_optimizer_state(optimizer, module: torch.nn.Module, grid: Grid | None) -> dict:
    """The optimizer's state_dict with the moments of split parameters
    gathered (every rank of the row calls it)."""
    return _cut_moments(optimizer.state_dict(), module,
                        lambda t, s: gather_shard(t, s, grid))


def local_optimizer_state(state: dict, module: torch.nn.Module, grid: Grid | None) -> dict:
    """A logical optimizer state_dict cut to this rank's slices."""
    return _cut_moments(state, module, lambda t, s: t.index_select(
        s.dim, shard_index(t.shape[s.dim], s, grid.model, grid.model_index).to(t.device)))


def sharded_parameters(module: torch.nn.Module) -> list[bool]:
    """For each of ``module.parameters()``: whether the model axis splits it."""
    shards = _shards(module)
    return [name in shards for name, _ in module.named_parameters()]


# ------------------------------------------------------------------ set-up


def check_mesh(hp, world: int) -> None:
    """``mesh_model`` must divide the world size and every width that
    ``tacotron2_spec`` splits; ``mesh_data`` is -1 (the rest) or the world
    size over ``mesh_model``."""
    model = hp.mesh_model or 1
    if model < 1 or world % model:
        raise ValueError(f"mesh_model={model} does not divide the world size {world}")
    if hp.mesh_data not in (-1, None, world // model):
        raise ValueError(f"mesh_data={hp.mesh_data} must be -1 or the world size {world} "
                         f"over mesh_model={model}")
    if model > 1:
        from ..models.tacotron2 import Tacotron2

        with torch.device("meta"):
            shapes = {k: v.shape for k, v in Tacotron2(hp).state_dict().items()}
        check_widths(shapes, tacotron2_spec, model)


def init_distributed(hp=None, device=None, backend: str | None = None,
                     model: int | None = None) -> tuple[Grid | None, torch.device]:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and build the grid's row and column groups.  Returns
    (the rank's ``Grid``, or None without that environment, and the
    device it trains on).  The model axis is ``model``, else
    ``hp.mesh_model``, else 1.

    On a card each rank takes ``cuda:LOCAL_RANK`` (modulo the cards
    present) and NCCL, on the CPU gloo; ``backend`` overrides the choice
    (gloo lets two ranks share one card)."""
    dev = torch.device(device or "cuda")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if model is None:
        model = (hp.mesh_model or 1) if hp is not None else 1
    if hp is not None:
        check_mesh(hp, world)
    elif world % model:
        raise ValueError(f"mesh_model={model} does not divide the world size {world}")
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
    data_group = model_group = None
    if model > 1:
        # every rank creates every group, in one order
        data = world // model
        for i in range(data):
            group = dist.new_group(list(range(i * model, (i + 1) * model)))
            if i == rank // model:
                model_group = group
        if data > 1:
            for j in range(model):
                group = dist.new_group(list(range(j, world, model)))
                if j == rank % model:
                    data_group = group
    return Grid(rank, world, model, data_group, model_group), dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def scope(grid: Grid | None):
    """Within: batch statistics and random draws span the global batch,
    and the tensor-parallel ops (``parallel.tp``) communicate over the
    rows (a no-op for None or a world of 1)."""
    token = _ACTIVE.set(grid if grid is not None and grid.world > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


# ------------------------------------------------------------- the data axis


def _draw(shape, generator, device, normal):
    return (torch.randn if normal else torch.rand)(tuple(shape), generator=generator,
                                                   device=device)


def rand_rows(shape, batch_dim: int, generator=None, device=None, normal: bool = False):
    """``torch.rand`` (``torch.randn`` when ``normal``) of ``shape`` on
    ``device``, drawn inside a scope at the global batch's shape
    (``shape[batch_dim]`` times the data axis) and cut to this rank's
    data index's rows, so every rank draws what one process would."""
    grid = _ACTIVE.get()
    if grid is None or grid.data == 1:
        return _draw(shape, generator, device, normal)
    full = list(shape)
    full[batch_dim] *= grid.data
    rows = shape[batch_dim]
    return _draw(full, generator, device, normal).narrow(batch_dim, grid.data_index * rows,
                                                        rows)


def rand_cols(shape, batch_dim: int, col_dim: int, generator=None, device=None,
              normal: bool = False):
    """``rand_rows`` of a tensor whose ``col_dim`` the model axis splits:
    drawn at the full width too, and cut to this rank's contiguous
    columns."""
    grid = _ACTIVE.get()
    if grid is None or grid.model == 1:
        return rand_rows(shape, batch_dim, generator, device, normal)
    full = list(shape)
    full[batch_dim] *= grid.data
    full[col_dim] *= grid.model
    rows, cols = shape[batch_dim], shape[col_dim]
    return (_draw(full, generator, device, normal)
            .narrow(batch_dim, grid.data_index * rows, rows)
            .narrow(col_dim, grid.model_index * cols, cols))


def batch_stats(xf: torch.Tensor, axes: tuple):
    """(mean, biased variance, unbiased variance, the last detached) of
    ``xf`` over ``axes``: the one-pass statistics ``E[x]`` and
    ``max(E[x^2] - E[x]^2, 0)``, over the global batch inside a scope (one
    differentiable all-reduce of ``[sum x, sum x^2, count]`` over the data
    ranks of this rank's column; the channels are this rank's own)."""
    grid = _ACTIVE.get()
    if grid is None or grid.data == 1:
        count = xf.numel() // xf.shape[-1]
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        return mean, var, var.detach() * (count / max(count - 1, 1))
    from torch.distributed.nn.functional import all_reduce

    C = xf.shape[-1]
    count = torch.full((1,), float(xf.numel() // C), device=xf.device)
    group = dist.group.WORLD if grid.data_group is None else grid.data_group
    sums = all_reduce(torch.cat([xf.sum(axes), (xf * xf).sum(axes), count]), group=group)
    n = sums[2 * C]
    mean = sums[:C] / n
    var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
    n = n.detach()
    return mean, var, var.detach() * (n / torch.clamp(n - 1, min=1.0))


def global_norm(tensors, sharded=None, grid: Grid | None = None) -> torch.Tensor:
    """The global L2 norm of ``tensors`` as a device scalar (float32).
    Where ``sharded`` flags tensors that are this rank's slices over
    ``grid``'s model axis, the norm is the logical tree's (optax
    ``global_norm``): their squares are summed over the row, the others
    counted once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if grid is None or grid.model == 1 or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms))
    whole = [n for n, s in zip(norms, sharded) if not s]
    split = torch.stack([n for n, s in zip(norms, sharded) if s]).square().sum()
    dist.all_reduce(split, group=grid.model_group)
    return torch.sqrt(split + (torch.stack(whole).square().sum() if whole else 0.0))


def all_reduce_flat(tensors: list[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` (same dtype) over ``group`` (default: every rank)
    in place through one flat buffer."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(tensors, _unflatten_dense_tensors(flat, tensors))


def broadcast_module(module: torch.nn.Module, grid: Grid) -> None:
    """Each column's first rank's parameters and buffers on every rank of
    the column (its slices, where the model axis splits them)."""
    if grid.data == 1:
        return
    tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
    for t in tensors:
        dist.broadcast(t, grid.model_index, group=grid.data_group)


def barrier(grid: Grid | None) -> None:
    if grid is not None and grid.world > 1:
        dist.barrier()
