"""Port: the train step never waits for the card, and the windowed metric fetch.

- inside one CPU train step ``Tensor.item``, ``__float__``, ``__bool__``,
  ``tolist``, ``numpy`` and ``cpu`` raise (patched in the test), and the
  step still completes and updates the parameters: it reads nothing back
  from the device, on the card the same code queues without waiting;
- ``train()`` with ``log_fetch_window=5`` over 3 epochs of 2 iterations
  writes ``metrics.csv`` iterations 0..5 exactly once, in order (the
  window outlasts an epoch; tests/test_data.py holds the JAX loop to the
  same);
- windows of 1 and 16, prefetch on, give identical CSV losses and norms;
- the ``duration`` column is the wall time per step, the data pipeline
  included: with a loader slowed by 0.5 s a batch the logged durations of
  4 steps sum to at least 4 x 0.5 s, though the steps alone take less.
"""

import csv
import os
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_common import TINY
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.data import dataset as ds
from tacotron2_vae_torch.training import train as tr
from tacotron2_vae_torch.training.train_state import create_train_state, make_train_step

SYNCS = ("item", "__float__", "__bool__", "tolist", "numpy", "cpu")


def _batch(hp, B=4, S=12, T=24, seed=0):
    rng = np.random.RandomState(seed)
    out_lens = np.array([T, T - 4, T - 8, T - 12][:B])
    return {"text": torch.from_numpy(rng.randint(1, hp.n_symbols, (B, S))),
            "input_lengths": torch.tensor([S, S - 1, S - 3, S - 5][:B]),
            "mel": torch.from_numpy((rng.randn(B, 80, T) - 3).astype(np.float32)),
            "output_lengths": torch.from_numpy(out_lens),
            "gate": torch.from_numpy((np.arange(T)[None] >= out_lens[:, None] - 1)
                                     .astype(np.float32))}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_makes_no_host_sync(monkeypatch, accum):
    hp = create_hparams(TINY + f",grad_accum_steps={accum}")
    ts = create_train_state(hp, "cpu")
    step = make_train_step(hp)
    gen = torch.Generator().manual_seed(0)
    batch = _batch(hp)
    step(ts, batch, gen)  # the first step creates Adam's state
    before = [p.detach().clone() for p in ts.model.parameters()]

    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"host sync: Tensor.{name}")
        return raiser

    with monkeypatch.context() as m:
        for name in SYNCS:
            m.setattr(torch.Tensor, name, refuse(name))
        metrics = step(ts, batch, gen)
    assert isinstance(metrics["loss"], torch.Tensor) and bool(metrics["updated"])
    assert np.isfinite(float(metrics["loss"])) and ts.step == 2
    assert any(not torch.equal(a, p) for a, p in zip(before, ts.model.parameters()))


def _corpus(tmp, n=4):
    rng = np.random.RandomState(0)
    path = os.path.join(tmp, "train.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            wav = os.path.join(tmp, f"utt{i}.wav")
            k = 4000 + 800 * i
            x = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * np.arange(k) / 16000)
                 + 0.01 * rng.randn(k))
            wavfile.write(wav, 16000, (x * 32767).astype(np.int16))
            f.write(f"{wav}|안녕하세요 반갑습니다|0|{i % 4}\n")
    return path


def _hp(tmp, **kw):
    flist = _corpus(tmp)
    hp = create_hparams(TINY + f",training_files='{flist}',validation_files='{flist}',"
                        "batch_size=2,epochs=3,iters_per_checkpoint=10000,"
                        "text_bucket_size=8,mel_bucket_size=16,anneal_function='constant'")
    return hp.replace(**kw)


def _rows(out):
    with open(os.path.join(out, "logs", "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_window_keeps_every_csv_row(tmp_path):
    out = str(tmp_path / "out")
    tr.train(out, "logs", None, False, _hp(str(tmp_path), log_fetch_window=5), device="cpu")
    assert [int(r["iteration"]) for r in _rows(out)] == [0, 1, 2, 3, 4, 5]


def test_window_sizes_give_identical_losses(tmp_path):
    rows = {}
    for window in (1, 16):
        out = str(tmp_path / f"out{window}")
        hp = _hp(str(tmp_path), log_fetch_window=window, prefetch_depth=2, num_workers=2)
        tr.train(out, "logs", None, False, hp, device="cpu")
        rows[window] = [(r["iteration"], r["loss"], r["grad_norm"], r["recon_loss"])
                        for r in _rows(out)]
    assert len(rows[1]) == 6 and rows[1] == rows[16]


def test_duration_covers_data_time(tmp_path, monkeypatch):
    make_batch = ds.DataLoader._make_batch

    def slow(self, chunk):
        time.sleep(0.5)
        return make_batch(self, chunk)

    monkeypatch.setattr(ds.DataLoader, "_make_batch", slow)
    out = str(tmp_path / "out")
    hp = _hp(str(tmp_path), log_fetch_window=1, num_workers=1, epochs=2)
    tr.train(out, "logs", None, False, hp, device="cpu")
    durations = [float(r["duration"]) for r in _rows(out)]
    # prefetch hides a batch's assembly behind the step before it, so one
    # step may log less, but the four steps span at least the 4 x 0.5 s of
    # data time (a duration of the step call alone sums to far less)
    assert len(durations) == 4 and sum(durations) >= 4 * 0.5, durations
