"""Port: data parallelism over torch.distributed (``parallel/mesh.py``).

Ranks run as real processes over gloo on the CPU, launched by torchrun
through ``tools/multihost_dryrun.py``; every subprocess has its own
timeout of at most 120 s.

- two ranks, train mode with dropout, recurrent dropout and VAE sampling
  on, two steps, match one process on the two ranks' batches concatenated:
  the same draws (made at the global batch's shape), global batchnorm
  statistics, the KL summed and the mel/gate terms meaned over the global
  batch.  Found on the CPU: loss and gradient norm within 6e-7 relative,
  each gradient within 6e-6 of the step's largest gradient, parameters
  within 5e-7 wherever the gradient is above 1e-4 of the largest.  Held at:
  loss and norm rtol 1e-5; gradients 1e-5 of the largest; parameters 1e-5
  there, and elsewhere (gradients at rounding noise, which Adam normalises
  into steps of up to lr of either sign) 2 * steps * lr; running statistics
  1e-4 (they hold the noisy conv biases);
- with every random draw patched to the identity (masks kept) or to zero
  (VAE noise) on both sides, in the test, two ranks of the port match the
  JAX package's ``make_parallel_train_step`` on a 2-device CPU mesh: loss
  1e-4, parameters atol 1e-4 (the JAX test's own limits,
  tests/test_train.py:222-225) wherever the gradient is above rounding
  noise, and 2 * steps * lr elsewhere, as above.  Found: loss 3.8e-6,
  parameters 3.9e-7 there and 2.1e-3 elsewhere.

The model axis has its own tests (tests/test_torch_port_tp.py).
"""

import os
import subprocess
import sys

import numpy as np
import torch

from tacotron2_vae_torch import convert
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.tools import multihost_dryrun as mh
from _torch_port_common import child_env
from _torch_port_common import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


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


def _ranks(target, args, n=2):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", *target, *args]
    out = subprocess.run(cmd, cwd=ROOT, env=child_env(), capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("DRYRUN ") == n, out.stdout
    return out.stdout


def _run_batch(tmp, args, n, script=None):
    """The dryrun's batch mode over ``n`` ranks (1: one plain process);
    rank 0's saved result."""
    dest = os.path.join(tmp, f"out{n}.pt")
    full = ["--batch", os.path.join(tmp, "batch.npz"), "--device", "cpu", "--out", dest,
            *args]
    target = [script] if script else ["-m", "tacotron2_vae_torch.tools.multihost_dryrun"]
    if n == 1:
        out = subprocess.run([sys.executable, *target, *full], cwd=ROOT, env=child_env(),
                             capture_output=True, text=True, timeout=TIMEOUT)
        assert out.returncode == 0, out.stderr[-3000:]
    else:
        _ranks(target, full, n)
    return torch.load(dest, weights_only=True)


def test_two_ranks_match_one_process_on_the_concatenated_batch(tmp_path):
    tmp = str(tmp_path)
    _batch(os.path.join(tmp, "batch.npz"))
    steps, lr = 2, create_hparams().learning_rate
    args = ["--steps", str(steps), "--hparams", "p_attention_dropout=0.1,p_decoder_dropout=0.1"]
    one = _run_batch(tmp, args, 1)
    two = _run_batch(tmp, args, 2)
    assert two["metrics"]["world"] == 2 and two["metrics"]["rows"] == 2
    assert one["metrics"]["updated"] == two["metrics"]["updated"] == [True] * steps
    np.testing.assert_allclose(two["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(two["metrics"]["grad_norm"], one["metrics"]["grad_norm"],
                               rtol=1e-5)
    scales = [max(float(g.abs().max()) for g in grads.values()) for grads in one["grads"]]
    for s, scale in enumerate(scales):
        for name, g in one["grads"][s].items():
            err = float((two["grads"][s][name] - g).abs().max())
            assert err <= 1e-5 * scale, (s, name, err)
    for name, want in one["state_dict"].items():
        got = two["state_dict"][name]
        if not want.is_floating_point():
            assert torch.equal(got, want), name
            continue
        if name not in one["grads"][0]:  # batchnorm running statistics
            assert float((got - want).abs().max()) <= 1e-4, name
            continue
        # Adam normalises each element's gradient: where it is rounding noise
        # (a conv bias before batchnorm has a true gradient of 0) it moves by
        # up to lr a step with either sign; elsewhere it agrees to 1e-5
        signal = torch.ones_like(want, dtype=torch.bool)
        for s, scale in enumerate(scales):
            signal &= one["grads"][s][name].abs() >= 1e-4 * scale
        err = (got - want).abs()
        assert float(torch.where(signal, err, 0.0).max()) <= 1e-5, name
        assert float(err.max()) <= 2 * steps * lr, name


RANDOM_OFF = '''import sys
import torch

def _kept(*size, generator=None, device=None, **kw):
    # a draw of zeros keeps every dropout unit and zeroes the VAE noise
    return torch.zeros(*size, device=device)

torch.rand = torch.randn = _kept
from tacotron2_vae_torch.tools.multihost_dryrun import main
main(sys.argv[1:])
'''


def test_two_ranks_match_the_jax_mesh_step(tmp_path, monkeypatch):
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
    port = _run_batch(tmp, ["--steps", "2", "--init", init], 2, script=script)

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    mesh2 = make_mesh(devices=jax.devices()[:2], data=2, model=1)
    ts = shard_train_state(ts, mesh2)
    step = make_parallel_train_step(hpj, mesh2)
    losses = []
    for i in range(2):
        ts, m = step(ts, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh2),
                     jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(port["metrics"]["loss"], losses, atol=1e-4, rtol=0)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, ts.params),
                                   jax.tree_util.tree_map(np.asarray, ts.model_state), hp)
    # as above, Adam moves an element whose gradient is rounding noise by up
    # to lr a step either way; the port's gradients say which those are
    scales = [max(float(g.abs().max()) for g in grads.values()) for grads in port["grads"]]
    for name, g0 in port["grads"][0].items():
        signal = torch.ones_like(g0, dtype=torch.bool)
        for s, scale in enumerate(scales):
            signal &= port["grads"][s][name].abs() >= 1e-4 * scale
        err = (port["state_dict"][name] - torch.as_tensor(np.asarray(want[name]))).abs()
        assert float(torch.where(signal, err, 0.0).max()) <= 1e-4, name
        assert float(err.max()) <= 2 * 2 * hp.learning_rate, name
