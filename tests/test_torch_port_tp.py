"""Port: the mesh's tensor-parallel ``model`` axis for Tacotron2
(``parallel/mesh.py``, ``parallel/tp.py``).

Ranks run as real processes over gloo on the CPU, launched by torchrun
through ``tools/multihost_dryrun.py`` or the train CLI; every subprocess
has its own timeout of at most 120 s.

- the spec: at the default widths, on shapes only, every leaf the JAX
  ``_param_spec`` splits over ``model`` is split on the same logical dim in
  the port and no other weight is; a split bias or batchnorm tensor
  belongs to a column-parallel layer's output channels;
- the four conjugate ops forward and backward, and the ``model``-fold
  gradient of ``torch.distributed.nn``'s all-reduce in the place of
  ``reduce``;
- train mode with dropout, recurrent dropout and VAE sampling on, 2 steps
  at 1x2 and 2x2 (and at 1x2 through the plain-autograd decoder,
  ``use_custom_bptt=False``) against one process on the global batch, held to the
  data-parallel limits (tests/test_torch_port_parallel.py): loss and norm
  rtol 1e-5, gradients 1e-5 of the largest, parameters 1e-5 where the
  gradient is above 1e-4 of the largest and 2 * steps * lr elsewhere,
  running statistics 1e-4.  Found on the CPU: loss 1e-7 relative,
  gradients 3.5e-6 absolute (largest ~4);
- 2x2 against the JAX ``make_parallel_train_step`` on a data=2, model=2
  CPU mesh with the draws patched on both sides: loss 1e-4, parameters
  atol 1e-4 where the gradient is signal (tests/test_train.py:323-333);
- each rank stores 1/model of every split parameter and of its Adam moments;
- fp16_run at 1x2 with an inf planted in one rank's gradient slice: both
  ranks skip the step and halve the scale;
- checkpoints: written at 1x2, they load in one process and in
  ``Synthesizer(device='cpu')`` and resume at 1x2 and in one process
  alike; a one-process checkpoint resumes at 1x2;
- ``mesh_model`` that does not divide the world size or a split width
  raises ValueError, naming the width's tensor.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tacotron2_vae_torch import convert
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.parallel import mesh
from tacotron2_vae_torch.tools import multihost_dryrun as mh
from _torch_port_common import child_env
from _torch_port_common import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
DROPOUT = "p_attention_dropout=0.1,p_decoder_dropout=0.1"


def _start(target, args, n):
    """``target`` (a module or script) over ``n`` torchrun ranks, or as one
    plain process for n=1, started."""
    cmd = [sys.executable, *target, *args]
    if n > 1:
        cmd[1:1] = ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={n}"]
    return subprocess.Popen(cmd, cwd=ROOT, env=child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc):
    """A started run's stdout, once it exits 0 within ``TIMEOUT``."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


def _run(target, args, n):
    return _wait(_start(target, args, n))


def _dryruns(stdout):
    return [json.loads(line[len("DRYRUN "):]) for line in stdout.splitlines()
            if line.startswith("DRYRUN ")]


def _batch(path, B=4, S=12, T=32, seed=0):
    rng = np.random.RandomState(seed)
    out_lens = np.array([T, T - 5, T - 9, T - 14][:B], np.int32)
    batch = {"text": rng.randint(1, 60, (B, S)).astype(np.int32),
             "input_lengths": np.array([S, S - 2, S - 5, S - 7][:B], np.int32),
             "mel": (rng.randn(B, 80, T) * 0.5 - 2.0).astype(np.float32),
             "output_lengths": out_lens,
             "gate": (np.arange(T)[None] >= out_lens[:, None] - 1).astype(np.float32),
             "speakers": np.ones((B, 1), np.float32),
             "emotions": np.eye(4, dtype=np.float32)[rng.randint(0, 4, B)]}
    np.savez(path, **batch)
    return batch


def _grid_start(tmp, grid, extra=(), hparams=DROPOUT, script=None):
    """The dryrun's batch mode on a (data, model) grid, 2 steps, started;
    (the process, where rank 0 saves)."""
    data, model = grid
    dest = os.path.join(tmp, f"out_{data}x{model}.pt")
    spec = ",".join(s for s in (hparams, f"mesh_model={model}" if model > 1 else "") if s)
    args = ["--batch", os.path.join(tmp, "batch.npz"), "--device", "cpu", "--out", dest,
            "--steps", "2", *(["--hparams", spec] if spec else []), *extra]
    target = [script] if script else ["-m", "tacotron2_vae_torch.tools.multihost_dryrun"]
    return _start(target, args, data * model), dest


def _grid_wait(started, n):
    """(rank 0's saved result, every rank's DRYRUN line) of a started run."""
    proc, dest = started
    lines = _dryruns(_wait(proc))
    assert len(lines) == n
    return torch.load(dest, weights_only=True), lines


def _grid_run(tmp, grid, **kw):
    return _grid_wait(_grid_start(tmp, grid, **kw), grid[0] * grid[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, 1x2 and 2x2 on the same batch, train mode, 2 steps,
    started at once."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    _batch(os.path.join(tmp, "batch.npz"))
    started = {grid: _grid_start(tmp, grid) for grid in ((1, 1), (1, 2), (2, 2))}
    return {grid: _grid_wait(s, grid[0] * grid[1]) for grid, s in started.items()}


# ------------------------------------------------------------------ the spec


def _jax_tree_paths(tree, path=""):
    from tacotron2_vae_tpu.parallel.mesh import _tree_paths

    return dict(_tree_paths(tree, path))


def _marked(tree, spec_fn):
    """The JAX tree with every leaf zero, except that a leaf split over
    'model' holds 1 + its index along the split axis; and {path: axis}."""
    axes = {}
    for path, leaf in _jax_tree_paths(tree).items():
        spec = spec_fn(path, leaf)
        if "model" in tuple(spec):
            axes[path] = tuple(spec).index("model")

    def build(t, path=""):
        if isinstance(t, dict):
            return {k: build(v, path + "/" + k) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, f"{path}[{i}]") for i, v in enumerate(t)]
        out = np.zeros(t.shape, np.float32)
        if path in axes:
            shape = [1] * len(t.shape)
            shape[axes[path]] = t.shape[axes[path]]
            out += np.arange(1, t.shape[axes[path]] + 1, dtype=np.float32).reshape(shape)
        return out

    return build(tree), axes


def _split_dim(t):
    """The dim along which the marks of ``t`` run (None: all zero)."""
    if not torch.any(t != 0):
        return None
    for d in range(t.ndim):
        shape = [1] * t.ndim
        shape[d] = t.shape[d]
        want = torch.arange(1, t.shape[d] + 1, dtype=t.dtype).reshape(shape).expand(t.shape)
        if torch.equal(t, want):
            return d
    raise AssertionError(f"marks run along no single dim: {tuple(t.shape)}")


_OWNERS = ((r"(encoder|postnet)\.convolutions\.(\d+)\.(0\.conv\.bias|1\.\w+)",
            r"\1.convolutions.\2.0.conv.weight"),
           (r"vae_gst\.ref_encoder\.(bns\.0\.\w+|convs\.0\.conv\.bias)",
            "vae_gst.ref_encoder.convs.0.conv.weight"),
           (r"vae_gst\.ref_encoder\.(?:bns|convs)\.(\d+)\.\w+",
            r"vae_gst.ref_encoder.convs.\1.weight"))


def _owner(name):
    for pattern, repl in _OWNERS:
        if re.fullmatch(pattern, name):
            return re.sub(pattern, repl, name)
    raise AssertionError(f"{name} is split but belongs to no column-parallel layer")


def test_spec_splits_what_the_jax_spec_splits():
    import jax

    from tacotron2_vae_tpu.config import create_hparams as jax_hparams
    from tacotron2_vae_tpu.models import tacotron2 as jt
    from tacotron2_vae_tpu.parallel.mesh import _param_spec

    params, state = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), jax_hparams()))
    marked, axes = _marked(params, _param_spec)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), state)
    sd = convert.from_jax_params(marked, zeros, create_hparams())
    assert len(axes) >= 10
    port = {k: mesh.tacotron2_spec(k) for k in sd}
    for name, t in sd.items():
        if t.ndim >= 2:
            want = _split_dim(t)
            got = port[name].dim if port[name] else None
            assert got == want, (name, got, want)
    found = {k for k, t in sd.items() if t.ndim >= 2 and port[k]}
    assert len(found) == len(axes), (sorted(found), sorted(axes))
    for name, shard in port.items():
        if shard is not None and sd[name].ndim == 1:
            owner = _owner(name)
            assert port[owner] == mesh.Shard(0) and _split_dim(sd[owner]) == 0, name
            assert sd[name].shape[0] == sd[owner].shape[0], name


def test_waveglow_spec_splits_what_the_jax_spec_splits():
    import jax

    from tacotron2_vae_tpu.models import waveglow as jwg
    from tacotron2_vae_tpu.parallel.mesh import _waveglow_spec

    cfg = jwg.WaveGlowConfig()
    params = jax.eval_shape(lambda: jwg.init(jax.random.PRNGKey(0), cfg))
    marked, axes = _marked(params, _waveglow_spec)
    sd = convert.from_jax_waveglow(marked)
    port = {k: mesh.waveglow_spec(k, cfg.n_layers) for k in sd}
    for name, t in sd.items():
        if t.ndim >= 2:
            got = port[name].dim if port[name] else None
            assert got == _split_dim(t), name
    assert sum(1 for k, t in sd.items() if t.ndim >= 2 and port[k]) == len(axes)
    for name, shard in port.items():
        if shard is not None and sd[name].ndim == 1:
            owner = port[name[:-len("bias")] + "weight"]
            assert name.endswith(".bias") and owner is not None, name
            out_dim = 1 if name.startswith("upsample") else 0
            assert owner.dim == out_dim and owner.groups == shard.groups, name
    # the gate pairs channel c with nc + c: a rank keeps both halves' slice
    nc = cfg.n_channels
    idx = mesh.shard_index(2 * nc, port["WN.0.in_layers.0.weight"], 2, 1)
    assert idx.tolist() == list(range(nc // 2, nc)) + list(range(nc + nc // 2, 2 * nc))


# ------------------------------------------------------- the conjugate ops

OPS = '''import json
import sys
import torch
from torch.distributed.nn.functional import all_reduce
from tacotron2_vae_torch.parallel import mesh, tp

grid, _ = mesh.init_distributed(None, "cpu", model=2)
r = grid.model_index
x = torch.arange(12.0).reshape(3, 4)
w = torch.arange(12.0).reshape(3, 4) / 10
out = {}
with mesh.scope(grid):
    a = x.clone().requires_grad_()
    y = tp.copy(a)
    (y * (r + 1)).sum().backward()
    out["copy"] = [torch.equal(y, x), a.grad.tolist()]
    a = x.clone().requires_grad_()
    y = tp.reduce(a * (r + 1))
    y.sum().backward()
    out["reduce"] = [y.tolist(), a.grad.tolist()]
    a = x.clone().requires_grad_()
    y = all_reduce(a * (r + 1))
    y.sum().backward()
    out["dist_nn"] = [y.tolist(), a.grad.tolist()]
    a = x[:, 2 * r:2 * r + 2].clone().requires_grad_()
    y = tp.gather(a, 1)
    (y * w).sum().backward()
    out["gather"] = [torch.equal(y, x), a.grad.tolist()]
    a = x.clone().requires_grad_()
    y = tp.scatter(a, -1)
    (y * (r + 1)).sum().backward()
    out["scatter"] = [y.tolist(), a.grad.tolist()]
a = x.clone().requires_grad_()
outside = [tp.copy(a), tp.reduce(a), tp.gather(a, 1), tp.scatter(a, 1)]
out["outside"] = all(torch.equal(t, x) for t in outside)
sys.stdout.write("DRYRUN " + json.dumps({"rank": grid.rank, **out}) + "\\n")
sys.stdout.flush()
mesh.shutdown()
'''


def test_conjugate_ops_forward_and_backward(tmp_path):
    script = tmp_path / "ops.py"
    script.write_text(OPS)
    x = np.arange(12.0).reshape(3, 4)
    w = x / 10
    for got in _dryruns(_run([str(script)], [], 2)):
        r = got["rank"]
        assert got["copy"][0] and np.allclose(got["copy"][1], 3.0)           # 1 + 2
        assert np.allclose(got["reduce"][0], 3 * x) and np.allclose(got["reduce"][1], r + 1)
        # dist.nn all-reduces the gradient again: model (2) times reduce's
        assert np.allclose(got["dist_nn"][0], 3 * x)
        assert np.allclose(got["dist_nn"][1], 2 * (r + 1))
        assert got["gather"][0] and np.allclose(got["gather"][1], w[:, 2 * r:2 * r + 2])
        assert np.allclose(got["scatter"][0], x[:, 2 * r:2 * r + 2])
        assert np.allclose(got["scatter"][1], np.repeat([[1.0, 1.0, 2.0, 2.0]], 3, 0))
        assert got["outside"]


# -------------------------------------------------- Tacotron2 on the grid


def _compare(one, got, steps=2, lr=None):
    lr = create_hparams().learning_rate if lr is None else lr
    assert got["metrics"]["updated"] == one["metrics"]["updated"] == [True] * steps
    np.testing.assert_allclose(got["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], one["metrics"]["grad_norm"],
                               rtol=1e-5)
    scales = [max(float(g.abs().max()) for g in grads.values()) for grads in one["grads"]]
    for s, scale in enumerate(scales):
        for name, g in one["grads"][s].items():
            assert got["grads"][s][name].shape == g.shape, name
            err = float((got["grads"][s][name] - g).abs().max())
            assert err <= 1e-5 * scale, (s, name, err)
    for name, want in one["state_dict"].items():
        have = got["state_dict"][name]
        assert have.shape == want.shape, name
        if not want.is_floating_point():
            assert torch.equal(have, want), name
            continue
        if name not in one["grads"][0]:  # batchnorm running statistics
            assert float((have - want).abs().max()) <= 1e-4, name
            continue
        signal = torch.ones_like(want, dtype=torch.bool)
        for s, scale in enumerate(scales):
            signal &= one["grads"][s][name].abs() >= 1e-4 * scale
        err = (have - want).abs()
        assert float(torch.where(signal, err, 0.0).max()) <= 1e-5, name
        assert float(err.max()) <= 2 * steps * lr, name


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_grid_matches_one_process_on_the_global_batch(runs, grid):
    one, _ = runs[(1, 1)]
    got, lines = runs[grid]
    assert {(r["world"], r["model"], r["rows"]) for r in lines} == {
        (grid[0] * grid[1], grid[1], 4 // grid[0])}
    assert all(r["loss"] == lines[0]["loss"] for r in lines)  # every rank, one loss
    _compare(one, got)


def test_plain_decoder_path_on_the_grid_matches_one_process(tmp_path):
    """``use_custom_bptt=False``: the teacher-forced loop in plain autograd
    with the gathered query weight and the row-parallel projections."""
    tmp = str(tmp_path)
    _batch(os.path.join(tmp, "batch.npz"))
    plain = DROPOUT + ",use_custom_bptt=False"
    started = {grid: _grid_start(tmp, grid, hparams=plain) for grid in ((1, 1), (1, 2))}
    one, two = (_grid_wait(started[g], g[0] * g[1])[0] for g in ((1, 1), (1, 2)))
    _compare(one, two)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_each_rank_stores_its_share_of_the_split_parameters(runs, grid):
    _, (one,) = runs[(1, 1)]
    _, lines = runs[grid]
    hp = create_hparams(mh.TINY)
    with torch.device("meta"):
        from tacotron2_vae_torch.models.tacotron2 import Tacotron2

        model = Tacotron2(hp)
    split = sum(p.numel() * 4 * 3 for n, p in model.named_parameters()
                if mesh.tacotron2_spec(n))
    whole = one["bytes"] - split
    assert split > 0.3 * one["bytes"] and one["split_bytes"] == 0
    for r in lines:
        assert r["split_bytes"] * grid[1] == split
        assert r["bytes"] == whole + split // grid[1]


RANDOM_OFF = '''import sys
import torch

def _kept(*size, generator=None, device=None, **kw):
    # a draw of zeros keeps every dropout unit and zeroes the VAE noise
    return torch.zeros(*size, device=device)

torch.rand = torch.randn = _kept
from tacotron2_vae_torch.tools.multihost_dryrun import main
main(sys.argv[1:])
'''


def test_two_by_two_matches_the_jax_mesh_step(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from tacotron2_vae_tpu.config import create_hparams as jax_hparams
    from tacotron2_vae_tpu.parallel import (make_mesh, make_parallel_train_step,
                                            shard_batch, shard_train_state)
    from tacotron2_vae_tpu.training.train_state import create_train_state

    tmp = str(tmp_path)
    batch = _batch(os.path.join(tmp, "batch.npz"))
    hpj, hp = jax_hparams(mh.TINY), create_hparams(mh.TINY)
    ts = create_train_state(jax.random.PRNGKey(0), hpj)
    params0 = jax.tree_util.tree_map(np.asarray, ts.params)
    state0 = jax.tree_util.tree_map(np.asarray, ts.model_state)
    init = os.path.join(tmp, "init.pt")
    torch.save({k: torch.as_tensor(v) for k, v in
                convert.from_jax_params(params0, state0, hp).items()}, init)
    script = os.path.join(tmp, "rank.py")
    with open(script, "w") as f:
        f.write(RANDOM_OFF)
    started = _grid_start(tmp, (2, 2), extra=("--init", init), hparams="", script=script)

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    grid = make_mesh(devices=jax.devices()[:4], data=2, model=2)
    ts = shard_train_state(ts, grid)
    step = make_parallel_train_step(hpj, grid)
    losses = []
    for i in range(2):
        ts, m = step(ts, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, grid),
                     jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    port, _ = _grid_wait(started, 4)
    np.testing.assert_allclose(port["metrics"]["loss"], losses, atol=1e-4, rtol=0)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, ts.params),
                                   jax.tree_util.tree_map(np.asarray, ts.model_state), hp)
    scales = [max(float(g.abs().max()) for g in grads.values()) for grads in port["grads"]]
    for name, g0 in port["grads"][0].items():
        signal = torch.ones_like(g0, dtype=torch.bool)
        for s, scale in enumerate(scales):
            signal &= port["grads"][s][name].abs() >= 1e-4 * scale
        err = (port["state_dict"][name] - torch.as_tensor(np.asarray(want[name]))).abs()
        assert float(torch.where(signal, err, 0.0).max()) <= 1e-4, name
        assert float(err.max()) <= 2 * 2 * hp.learning_rate, name


INF_IN_ONE_SHARD = '''import sys
import torch
from tacotron2_vae_torch.parallel import mesh
from tacotron2_vae_torch.training import loss_scaler, train_state

# from a scale float16 holds (2^7), so that only the plant makes a step skip
train_state.make_loss_scaler = lambda hp: loss_scaler.DynamicLossScaler(init_scale=128.0)

_norm = mesh.global_norm
calls = []

def planted(tensors, sharded=None, grid=None):
    # the first step: an inf in rank 1's slice of the first split gradient
    if not calls and grid is not None and grid.model_index == 1:
        tensors[list(sharded).index(True)].view(-1)[0] = float("inf")
    calls.append(1)
    return _norm(tensors, sharded, grid)

mesh.global_norm = planted
from tacotron2_vae_torch.tools.multihost_dryrun import main
main(sys.argv[1:])
'''


def test_fp16_run_skips_on_every_rank_when_one_slice_overflows(tmp_path):
    tmp = str(tmp_path)
    _batch(os.path.join(tmp, "batch.npz"))
    script = os.path.join(tmp, "rank.py")
    with open(script, "w") as f:
        f.write(INF_IN_ONE_SHARD)
    _, lines = _grid_run(tmp, (1, 2), hparams="fp16_run=True", script=script)
    for r in lines:
        assert r["updated"] == [False, True], r
        assert r["grad_norm"][0] == float("inf") and np.isfinite(r["grad_norm"][1])
        assert r["loss_scale"] == [128.0, 64.0], r


# ------------------------------------------------------------ checkpoints


def _train_cli(workdir, out, n, extra_hparams, resume=None):
    """The train CLI on the corpus over ``n`` ranks, started."""
    args = ["-o", out, "-l", "", "--device", "cpu", "--hparams",
            ",".join([mh.TINY, mh.CORPUS, f"training_files={workdir}/train.txt",
                      f"validation_files={workdir}/train.txt", extra_hparams])]
    if resume:
        args += ["-c", resume]
    return _start(["-m", "tacotron2_vae_torch.training.train"], args, n)


def _losses(proc):
    return [float(m.group(1)) for m in re.finditer(r"Train loss \d+ (\S+) ", _wait(proc))]


def test_checkpoints_cross_between_the_grid_and_one_process(tmp_path):
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer
    from tacotron2_vae_torch.training.checkpoint import load_checkpoint
    from tacotron2_vae_torch.training.train_state import create_train_state

    work = str(tmp_path)
    mh.make_corpus(work)
    every = "iters_per_checkpoint=2,epochs=2"
    _losses(_train_cli(work, os.path.join(work, "tp"), 2, every + ",mesh_model=2"))
    ckpt = os.path.join(work, "tp", "checkpoint_2")
    hp = create_hparams(mh.TINY)
    payload = torch.load(ckpt, weights_only=True)
    ts, it, _ = load_checkpoint(ckpt, create_train_state(hp, "cpu"))
    assert it == 2
    for k, v in ts.model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k
    for s in ts.optimizer.state.values():
        assert s["exp_avg"].shape == s["exp_avg_sq"].shape
    synth = Synthesizer(hp, device="cpu")
    synth.load(ckpt, centroid_filelist=os.path.join(work, "none.txt"))
    for k, v in synth.model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k
    # the 1x2 checkpoint resumes alike at 1x2 and in one process
    more = "iters_per_checkpoint=4,epochs=3"
    one = _train_cli(work, os.path.join(work, "one"), 1, more, resume=ckpt)
    two = _train_cli(work, os.path.join(work, "tp2"), 2, more + ",mesh_model=2", resume=ckpt)
    one, two = _losses(one), _losses(two)
    assert len(one) == len(two) == 4
    np.testing.assert_allclose(two, one, rtol=1e-5)
    # and a one-process checkpoint resumes at 1x2
    back = os.path.join(work, "one", "checkpoint_4")
    last = "iters_per_checkpoint=100,epochs=4"
    one = _train_cli(work, os.path.join(work, "one2"), 1, last, resume=back)
    two = _train_cli(work, os.path.join(work, "tp3"), 2, last + ",mesh_model=2", resume=back)
    one, two = _losses(one), _losses(two)
    assert len(one) == len(two) == 4
    np.testing.assert_allclose(two, one, rtol=1e-5)


# --------------------------------------------------------------- refusals


def test_mesh_model_must_divide_the_world_and_the_split_widths():
    with pytest.raises(ValueError, match="world size 3"):
        mesh.check_mesh(create_hparams("mesh_model=2"), 3)
    with pytest.raises(ValueError, match="world size"):
        mesh.check_mesh(create_hparams("mesh_data=3"), 2)
    with pytest.raises(ValueError, match=r"transcript_embedding\.weight's width 512"):
        mesh.check_mesh(create_hparams("mesh_model=3"), 3)
    with pytest.raises(ValueError, match=r"prenet\.layers\.0\.linear_layer\.weight's width 6"):
        mesh.check_mesh(create_hparams(mh.TINY + ",prenet_dim=6,mesh_model=4"), 4)
    for spec, world in (("mesh_model=2", 2), ("mesh_model=2,mesh_data=2", 4),
                        ("mesh_data=2", 2), ("mesh_data=-1", 2), (mh.TINY + ",mesh_model=2", 8)):
        mesh.check_mesh(create_hparams(spec), world)
