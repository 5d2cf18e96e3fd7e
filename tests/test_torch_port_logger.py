"""Port parity: the TensorBoard logger and its plots (``training/logger.py``,
``utils/plotting.py``).

- On the same values the port's event file holds what the JAX logger's
  does: the same scalar tags with the same values (exact), a histogram
  under each of the same tags (the JAX parameter tree's paths) with the
  same count, min, max and sum (rtol 1e-6), and images under the same
  tags; read with TensorBoard's own event reader.
- Each plot is the same RGB array as the JAX package's.
- Without tensorboardX, or without matplotlib (their imports made to
  fail), the CSV sidecars are still written, rows equal to the JAX
  logger's; without matplotlib there are scalars and histograms but no
  images.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port_common import build
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.training import logger as jlog
from tacotron2_vae_tpu.utils import plotting as jplot
from tacotron2_vae_torch.models.tacotron2 import Tacotron2Output
from tacotron2_vae_torch.training import logger as plog
from tacotron2_vae_torch.utils import plotting as pplot

TRAIN_ROWS = [(3.25, 1.5, 1e-3, 0.42, 12.5, 0.001, 3.1, 7), (2.75, 0.9, 1e-3, 0.40, 11.0,
                                                              0.002, 2.6, 8)]


def _outputs(hp, B=3, S=11, T=20, seed=0):
    """A ``Tacotron2Output`` of numpy arrays from the seed."""
    rng = np.random.RandomState(seed)
    align = rng.rand(B, T, S).astype(np.float32)
    return Tacotron2Output(
        mel_outputs=rng.randn(B, hp.n_mel_channels, T).astype(np.float32),
        mel_outputs_postnet=rng.randn(B, hp.n_mel_channels, T).astype(np.float32),
        gate_outputs=rng.randn(B, T).astype(np.float32),
        alignments=align / align.sum(-1, keepdims=True),
        mu=rng.randn(B, hp.z_latent_dim).astype(np.float32),
        logvar=rng.randn(B, hp.z_latent_dim).astype(np.float32),
        z=rng.randn(B, hp.z_latent_dim).astype(np.float32),
        emotions=np.eye(4, dtype=np.float32)[[0, 2, 1]])


def _targets(hp, B=3, T=20, seed=1):
    rng = np.random.RandomState(seed)
    gate = (np.arange(T)[None] >= np.array([T, T - 3, T - 7])[:B, None] - 1)
    return rng.randn(B, hp.n_mel_channels, T).astype(np.float32), gate.astype(np.float32)


def _torch(outputs):
    return Tacotron2Output(*(torch.from_numpy(x) for x in outputs))


def _log_both(tmp_path):
    """The same values through the JAX logger and the port's."""
    _, hp, params, _, model = build()
    out, targets = _outputs(hp), _targets(hp)
    loggers = {"jax": jlog.Tacotron2Logger(str(tmp_path / "jax")),
               "port": plog.Tacotron2Logger(str(tmp_path / "port"))}
    for row in TRAIN_ROWS:
        for lg in loggers.values():
            lg.log_training(*row)
    comps = {"recon_loss": 1.25, "kl_loss": 3.5}
    loggers["jax"].log_validation(2.5, params, out, targets, 8, components=comps)
    loggers["port"].log_validation(2.5, model.state_dict(), _torch(out),
                                   tuple(torch.from_numpy(x) for x in targets), 8,
                                   components=comps)
    for lg in loggers.values():
        lg.close()
    return {k: str(tmp_path / k) for k in loggers}


def _events(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(logdir, size_guidance={"scalars": 0, "histograms": 0, "images": 0})
    ea.Reload()
    return ea


def test_event_file_matches_the_jax_logger(tmp_path):
    dirs = _log_both(tmp_path)
    ej, ep = _events(dirs["jax"]), _events(dirs["port"])
    tj, tp = ej.Tags(), ep.Tags()
    assert sorted(tp["scalars"]) == sorted(tj["scalars"])
    assert "training.loss" in tp["scalars"] and "validation.kl_div" in tp["scalars"]
    for tag in tj["scalars"]:
        assert ([(e.step, e.value) for e in ep.Scalars(tag)]
                == [(e.step, e.value) for e in ej.Scalars(tag)]), tag
    assert sorted(tp["histograms"]) == sorted(tj["histograms"])
    assert "decoder.attention_rnn.wi" in tp["histograms"]
    for tag in tj["histograms"]:
        hj, hp_ = ej.Histograms(tag)[0].histogram_value, ep.Histograms(tag)[0].histogram_value
        assert hp_.num == hj.num, tag
        np.testing.assert_allclose([hp_.min, hp_.max, hp_.sum], [hj.min, hj.max, hj.sum],
                                   rtol=1e-6, err_msg=tag)
    assert sorted(tp["images"]) == sorted(tj["images"]) == sorted(
        ["alignment", "mel_target", "mel_predicted", "gate", "latent_mu"])
    for tag in tj["images"]:
        ij, ip = ej.Images(tag)[0], ep.Images(tag)[0]
        assert (ip.step, ip.width, ip.height) == (ij.step, ij.width, ij.height), tag


def test_csv_sidecars_match_the_jax_logger(tmp_path):
    dirs = _log_both(tmp_path)
    for name in ("metrics.csv", "val_metrics.csv"):
        with open(os.path.join(dirs["jax"], name)) as a, open(os.path.join(dirs["port"],
                                                                           name)) as b:
            assert b.read() == a.read(), name


def test_plots_equal_the_jax_plots():
    rng = np.random.RandomState(0)
    align = rng.rand(11, 20)
    spec = rng.randn(80, 20)
    gate_t, gate_o = (rng.rand(20) > 0.5).astype(np.float32), rng.rand(10)
    mus, labels = rng.randn(7, 4), np.array([0, 1, 2, 3, 0, 1, 2])
    for name, args in (("plot_alignment_to_numpy", (align,)),
                       ("plot_alignment_to_numpy", (align, "step 3")),
                       ("plot_spectrogram_to_numpy", (spec,)),
                       ("plot_gate_outputs_to_numpy", (gate_t, gate_o)),
                       ("plot_scatter", (mus, labels))):
        got, want = getattr(pplot, name)(*args), getattr(jplot, name)(*args)
        assert got.dtype == want.dtype == np.uint8 and got.shape[-1] == 3
        assert np.array_equal(got, want), name
    assert pplot.available()


@pytest.mark.parametrize("missing", [("tensorboardX",), ("matplotlib",),
                                     ("tensorboardX", "matplotlib")],
                         ids=["no_tensorboardx", "no_matplotlib", "neither"])
def test_csv_sidecars_without_optional_packages(tmp_path, monkeypatch, missing):
    for name in missing:
        monkeypatch.setitem(sys.modules, name, None)  # import name now raises ImportError
    _, hp, _, _, model = build()
    logdir = str(tmp_path / "port")
    lg = plog.Tacotron2Logger(logdir)
    assert (lg.writer is None) == ("tensorboardX" in missing)
    assert pplot.available() == ("matplotlib" not in missing)
    for row in TRAIN_ROWS:
        lg.log_training(*row)
    out, targets = _outputs(hp), _targets(hp)
    lg.log_validation(2.5, model.state_dict(), _torch(out),
                      tuple(torch.from_numpy(x) for x in targets), 8,
                      components={"recon_loss": 1.25, "kl_loss": 3.5})
    lg.close()
    with open(os.path.join(logdir, "metrics.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("iteration,loss") and [r.split(",")[0] for r in rows[1:]] == [
        "7", "8"]
    with open(os.path.join(logdir, "val_metrics.csv")) as f:
        assert f.read().splitlines()[1] == "8,2.500000,1.250000,3.500000"
    events = [f for f in os.listdir(logdir) if f.startswith("events.")]
    if "tensorboardX" in missing:
        assert not events
    else:
        tags = _events(logdir).Tags()
        assert "validation.loss" in tags["scalars"] and tags["histograms"]
        assert not tags["images"]
