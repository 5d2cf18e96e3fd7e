"""Port parity: ``tools/inference_demo.py`` against the JAX package's tool.

One params pickle of tiny width, read by both packages' ``Synthesizer``
(each side from its own copy, so neither reads the other's centroid
cache), and one synthetic filelist of four emotions.  ``latents``: mu and z
of every clip within atol 1e-5 and the labels equal.  ``ref``, ``interp``
and ``mix``: the mels each mode hands to ``vocode``, recorded on both
sides, within atol 1e-5 (float32; prenet dropout off on both sides,
because the two frameworks draw it from different streams, by wrapping
each model's ``infer``).  Both tools write the same files.
"""

import functools
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from _torch_port_common import TINY, build, load_jax_tool
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.config import create_hparams as jax_hparams
from tacotron2_vae_tpu.models import tacotron2 as jax_tacotron2
from tacotron2_vae_tpu.serving.synthesizer import Synthesizer as JaxSynthesizer
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.models.tacotron2 import Tacotron2
from tacotron2_vae_torch.serving.synthesizer import Synthesizer
from tacotron2_vae_torch.tools import inference_demo
from tacotron2_vae_torch.utils import plotting

ATOL = 1e-5
TEXT = "안녕하세요."


def _write(path, seconds, freq, seed):
    rng = np.random.RandomState(seed)
    x = 0.3 * np.sin(2 * np.pi * freq * np.arange(int(16000 * seconds)) / 16000)
    wavfile.write(path, 16000, ((x + 0.02 * rng.randn(len(x))) * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inference_demo")
    _, _, params, state, _ = build()
    filelist = tmp / "clips_test.txt"
    with open(filelist, "w", encoding="utf-8") as f:
        for i in range(8):
            _write(tmp / f"clip{i}.wav", 0.5 + 0.05 * i, 180 + 35 * i, i)
            f.write(f"{tmp / f'clip{i}.wav'}|{TEXT}|0|{i % 4}\n")
    _write(tmp / "ref.wav", 0.8, 260, 9)
    for side in ("port", "jax"):
        os.makedirs(tmp / side)
        with open(tmp / side / "checkpoint.pkl", "wb") as f:
            pickle.dump({"params": params, "model_state": state}, f)
    return tmp


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("inference_demo")


def _run(monkeypatch, jax_tool, files, mode, *extra):
    """Run both tools in ``mode``; returns {side: output directory}."""
    monkeypatch.setattr(inference_demo, "Synthesizer",
                        lambda device=None: Synthesizer(create_hparams(TINY), device=device))
    monkeypatch.setattr(jax_tool, "Synthesizer", lambda: JaxSynthesizer(jax_hparams(TINY)))
    outs = {}
    for side in ("port", "jax"):
        out = files / side / f"out_{mode}"
        shutil.rmtree(out, ignore_errors=True)
        args = [mode, "--checkpoint", str(files / side / "checkpoint.pkl"), "--filelist",
                str(files / "clips_test.txt"), "-o", str(out), *extra]
        if side == "port":
            inference_demo.main(args + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["inference_demo.py", *args])
            jax_tool.main()
        outs[side] = out
    return outs


def test_latents_match_jax(monkeypatch, jax_tool, files):
    outs = _run(monkeypatch, jax_tool, files, "latents")
    got, want = (np.load(outs[s] / "latents.npz") for s in ("port", "jax"))
    assert sorted(got.files) == sorted(want.files) == ["emotions", "mus", "zs"]
    assert got["mus"].shape == (8, 8) and np.isfinite(got["zs"]).all()
    np.testing.assert_allclose(got["mus"], want["mus"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["zs"], want["zs"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["emotions"], want["emotions"])
    np.testing.assert_array_equal(got["emotions"], [0, 1, 2, 3, 0, 1, 2, 3])
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"])) == \
        ["latents.npz", "scatter.png", "tsne.png"]


def test_latents_without_matplotlib_skip_the_images(monkeypatch, files, capsys):
    monkeypatch.setattr(plotting, "available", lambda: False)
    monkeypatch.setattr(inference_demo, "Synthesizer",
                        lambda device=None: Synthesizer(create_hparams(TINY), device=device))
    out = files / "port" / "out_no_plots"
    inference_demo.main(["latents", "--checkpoint", str(files / "port" / "checkpoint.pkl"),
                         "--filelist", str(files / "clips_test.txt"), "-o", str(out),
                         "--device", "cpu"])
    assert os.listdir(out) == ["latents.npz"]
    assert "skipped" in capsys.readouterr().out


@pytest.mark.parametrize("mode,extra,n_mels,names", [
    ("ref", ("--text", TEXT, "--ref_audio"), 1, ["ref_conditioned.wav"]),
    ("interp", ("--text", TEXT, "--from", "sad", "--to", "hap"), 4,
     sorted(f"interp_sad{r:.2f}_hap{1 - r:.2f}.wav" for r in (1.0, 0.64, 0.34, 0.0))),
    ("mix", ("--text", TEXT, "--ratios", "0.1,0.2,0.3,0.4"), 1, ["mix.wav"]),
])
def test_vocoded_mels_match_jax(monkeypatch, jax_tool, files, mode, extra, n_mels, names):
    if mode == "ref":
        extra = extra + (str(files / "ref.wav"),)
    recorded = {"port": [], "jax": []}

    def recorder(side):
        def vocode(self, mel, sigma=0.666):
            recorded[side].append(np.asarray(mel, np.float32))
            return np.zeros(mel.shape[2] * 256, np.float32)
        return vocode

    monkeypatch.setattr(Synthesizer, "vocode", recorder("port"))
    monkeypatch.setattr(JaxSynthesizer, "vocode", recorder("jax"))
    infer = Tacotron2.infer
    monkeypatch.setattr(Tacotron2, "infer", lambda self, *a, **k: infer(
        self, *a, **dict(k, prenet_dropout_enabled=False)))
    monkeypatch.setattr(jax_tacotron2, "infer",
                        functools.partial(jax_tacotron2.infer, prenet_dropout_enabled=False))
    outs = _run(monkeypatch, jax_tool, files, mode, *extra)
    assert len(recorded["port"]) == len(recorded["jax"]) == n_mels
    for got, want in zip(recorded["port"], recorded["jax"]):
        assert got.shape == want.shape and got.shape[1] == 80
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"])) == names


def test_cli_wants_a_card_unless_told_otherwise(files):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_demo.main(["mix", "--checkpoint", str(files / "port" / "checkpoint.pkl")])
