"""Port: the training loop on the CPU (no JAX counterpart needed).

- a non-finite loss skips the update: parameters, Adam's moments and step
  count, and the batchnorm running statistics are left as they were;
- ``grad_accum_steps=2`` gives the big batch's gradient (the KL weighted by
  the number of micro-batches), checked with the forward in eval mode so
  batchnorm statistics and dropout draws do not differ: atol 1e-6 relative
  to the largest gradient;
- the CLI trains 3 steps on synthetic wavs, writes a checkpoint and ``-c``
  resumes the iteration count;
- the training entry points default to the card and raise without one;
- ``collate`` matches the JAX package's (same padding and gate targets);
- one optimizer update from the same gradients (clip -> weight decay ->
  Adam -> -lr) matches optax's chain of the JAX package, two steps so
  Adam's moments take part: atol 1e-6;
- importing the port, training and data modules included, imports no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_common import TINY, build, n
from tacotron2_vae_torch import convert
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.data import dataset as ds
from tacotron2_vae_torch.training import train as tr
from tacotron2_vae_torch.training.train_state import (TrainState, create_train_state,
                                                      make_optimizer, make_train_step,
                                                      optimizer_update)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(hp, B=4, S=12, T=24, seed=0):
    rng = np.random.RandomState(seed)
    out_lens = np.array([T, T - 4, T - 8, T - 12][:B])
    return {"text": torch.from_numpy(rng.randint(1, hp.n_symbols, (B, S))),
            "input_lengths": torch.tensor([S, S - 1, S - 3, S - 5][:B]),
            "mel": torch.from_numpy((rng.randn(B, 80, T) - 3).astype(np.float32)),
            "output_lengths": torch.from_numpy(out_lens),
            "gate": torch.from_numpy((np.arange(T)[None] >= out_lens[:, None] - 1)
                                     .astype(np.float32))}


def _state_snapshot(ts):
    params = [p.detach().clone() for p in ts.model.parameters()]
    bufs = [b.detach().clone() for b in ts.model.buffers()]
    opt = {i: {k: v.clone() for k, v in s.items()} for i, s in
           enumerate(ts.optimizer.state[p] for p in ts.model.parameters())}
    return params, bufs, opt


def test_nonfinite_loss_skips_the_update():
    hp = create_hparams(TINY)
    ts = create_train_state(hp, "cpu")
    step = make_train_step(hp)
    gen = torch.Generator().manual_seed(0)
    assert step(ts, _batch(hp), gen)["updated"]
    before = _state_snapshot(ts)
    bad = _batch(hp, seed=1)
    bad["mel"][0, 0, 0] = float("nan")
    m = step(ts, bad, gen)
    assert not m["updated"] and not np.isfinite(m["loss"]) and ts.step == 2
    after = _state_snapshot(ts)
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)
    for i, s in before[2].items():
        for k, v in s.items():
            assert torch.equal(v, after[2][i][k]), k  # moments and step count


def _captured_grads(hp, batch):
    ts = create_train_state(hp, "cpu", seed=3)
    forward = ts.model.forward
    ts.model.forward = lambda b, train, generator=None: forward(
        b, train=False, prenet_dropout_enabled=False)
    grads = []
    ts.optimizer.step = lambda: grads.append([p.grad.clone() for p in ts.model.parameters()])
    m = make_train_step(hp)(ts, batch)
    return m, grads[0]


def test_grad_accum_matches_big_batch():
    kl = ",anneal_function='logistic',anneal_x0=0,anneal_k=1.0,grad_clip_thresh=1e6"
    hp1 = create_hparams(TINY + kl)
    hp2 = create_hparams(TINY + kl + ",grad_accum_steps=2")
    batch = _batch(hp1)
    m1, g1 = _captured_grads(hp1, batch)
    m2, g2 = _captured_grads(hp2, batch)
    assert m1["kl_weight"] > 0.1 and m1["kl_loss"] > 0
    np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-5)
    np.testing.assert_allclose(m2["kl_loss"], m1["kl_loss"], rtol=1e-5)
    for a, b in zip(g2, g1):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-6 * max(scale, 1.0)


def _write_corpus(tmp, n, name, seed):
    rng = np.random.RandomState(seed)
    path = os.path.join(tmp, f"{name}.txt")
    texts = ["안녕하세요.", "감사합니다, 또 만나요.", "반갑습니다."]
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            wav = os.path.join(tmp, f"{name}{i}.wav")
            x = 0.3 * np.sin(2 * np.pi * (150 + 20 * i) * np.arange(int(16000 * (0.5 + 0.05 * i)))
                             / 16000) + 0.01 * rng.randn(int(16000 * (0.5 + 0.05 * i)))
            wavfile.write(wav, 16000, (x * 32767).astype(np.int16))
            f.write(f"{wav}|{texts[i % 3]}|0|{i % 4}\n")
    return path


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    tmp = str(tmp_path)
    train_list = _write_corpus(tmp, 12, "train", 0)
    val_list = _write_corpus(tmp, 3, "val", 1)
    hparams = (TINY + f",training_files='{train_list}',validation_files='{val_list}'"
               ",batch_size=4,iters_per_checkpoint=2,text_bucket_size=8,mel_bucket_size=8")
    out = os.path.join(tmp, "out")
    tr.main(["-o", out, "-l", "logs", "--device", "cpu", "--hparams", hparams + ",epochs=1"])
    assert os.path.exists(os.path.join(out, "checkpoint_2"))
    tr.main(["-o", out, "-l", "logs", "--device", "cpu", "-c", os.path.join(out, "checkpoint_2"),
             "--hparams", hparams + ",epochs=2"])
    text = capsys.readouterr().out
    assert "Train loss 0 " in text and "Train loss 3 " in text and "Train loss 5 " in text
    assert "Validation loss 4:" in text
    with open(os.path.join(out, "logs", "metrics.csv")) as f:
        iters = [int(line.split(",")[0]) for line in f.readlines()[1:]]
    assert iters == [0, 1, 2, 3, 4, 5]
    assert os.path.exists(os.path.join(out, "checkpoint_4"))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    hp = create_hparams(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(hp)
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.TacotronSTFT()
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.main(["-o", "unused_out"])


def test_collate_matches_jax():
    from tacotron2_vae_tpu.data import dataset as jds

    rng = np.random.RandomState(0)
    items = [(rng.randint(1, 60, n).astype(np.int32), rng.randn(80, t).astype(np.float32),
              np.eye(1, dtype=np.float32)[0], np.eye(4, dtype=np.float32)[i % 4])
             for i, (n, t) in enumerate([(7, 30), (12, 17), (9, 41)])]
    for r in (1, 2):
        got = ds.collate(items, r, text_bucket=8, mel_bucket=16)
        want = jds.collate(items, r, text_bucket=8, mel_bucket=16)
        for k, v in want.asdict().items():
            np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)


def test_import_leaves_jax_out_with_training_modules():
    code = (
        "import pkgutil, sys, importlib, tacotron2_vae_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "need = {'tacotron2_vae_torch.training.train', 'tacotron2_vae_torch.training.train_state',\n"
        "        'tacotron2_vae_torch.data.dataset', 'tacotron2_vae_torch.models.decoder_bptt',\n"
        "        'tacotron2_vae_torch.ops.teacher_fwd', 'tacotron2_vae_torch.profile_train'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tacotron2_vae_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_optimizer_update_matches_optax():
    import jax
    import jax.numpy as jnp
    import optax

    from tacotron2_vae_tpu.training.train_state import make_optimizer as jax_optimizer

    hpj, hp, params, state, model = build(",weight_decay=1e-3,grad_clip_thresh=0.5")
    model.requires_grad_(True)
    ts = TrainState(model, make_optimizer(model, hp))
    opt = jax_optimizer(hpj)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = opt.init(jp)
    rng = np.random.RandomState(1)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), jp)
        updates, opt_state = opt.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        sd_grads = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, grads), state, hp)
        for name, p in model.named_parameters():
            p.grad = sd_grads[name].clone()
        norm, ok = optimizer_update(ts, hp, 1.0)
        assert ok and norm > hp.grad_clip_thresh  # the clip is exercised
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), state, hp)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p), n(want[name]), atol=1e-6, rtol=0, err_msg=name)
