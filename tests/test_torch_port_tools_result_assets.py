"""Port parity: ``tools/make_result_assets.py`` against the JAX package's tool.

The emotion-conditional batches are the JAX tool's bit for bit: the 16
training batches from one ``RandomState(0)`` stream, the validation batch
from ``RandomState(777)`` and the 12 latent batches from
``RandomState(5000 + b)``.  The CLI at tiny width on the CPU writes every
file the JAX tool writes (its names read from the JAX tool's source), and
its summary has the JAX tool's keys; without matplotlib it writes the
series and latents only and says so; without a card and without
``--device`` it raises.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, TINY, load_jax_tool
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.config import create_hparams as jax_hparams
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.tools import make_result_assets
from tacotron2_vae_torch.utils import plotting

JAX_SOURCE = os.path.join(ROOT, "tools", "make_result_assets.py")


@pytest.fixture(scope="module")
def jax_tool():
    # the JAX tool imports tools/smoke_train.py as a top-level module
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return load_jax_tool("make_result_assets")
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
        sys.modules.pop("smoke_train", None)


def _jax_source():
    with open(JAX_SOURCE, encoding="utf-8") as f:
        return ast.parse(f.read())


def _jax_summary_keys():
    for node in ast.walk(_jax_source()):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "summary"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in the JAX tool")


def _jax_files():
    """Every file name the JAX tool writes: its .png constants and README.md."""
    names = {n.value for n in ast.walk(_jax_source())
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.endswith(".png") and not set("/ `") & set(n.value)}
    return names | {"README.md"}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("which", ["train", "val", "latent"])
def test_synth_batch_is_the_jax_tools(jax_tool, which):
    hpj, hp = jax_hparams("anneal_function='constant'"), create_hparams(
        "anneal_function='constant'")
    if which == "train":  # 16 batches from one stream
        want_rng, got_rng = np.random.RandomState(0), np.random.RandomState(0)
        pairs = [(jax_tool.synth_batch(want_rng, hpj, 3, 7),
                  make_result_assets.synth_batch(got_rng, hp, 3, 7)) for _ in range(16)]
    else:
        seeds = [777] if which == "val" else [5000 + b for b in range(12)]
        pairs = [(jax_tool.synth_batch(np.random.RandomState(s), hpj, 3, 7),
                  make_result_assets.synth_batch(np.random.RandomState(s), hp, 3, 7))
                 for s in seeds]
    for want, got in pairs:
        _assert_same(got, want)
    # the emotion tilt is on: one emotion's mel differs from the plain task's
    plain = make_result_assets._synth_batch(np.random.RandomState(777), hp, 3, 7)
    assert not np.array_equal(pairs[0][1]["mel"], plain["mel"])


def test_cli_writes_the_jax_tools_files(tmp_path, capsys):
    out = tmp_path / "res"
    summary = make_result_assets.main(["--steps", "25", "--batch", "2", "--seq", "8",
                                       "--hparams", TINY, "--device", "cpu",
                                       "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary and list(summary) == _jax_summary_keys()
    assert (summary["steps"], summary["batch"], summary["device"]) == (25, 2, "cpu")
    assert np.isfinite(summary["final_train_loss"]) and summary["final_val_loss"] is None
    files = set(os.listdir(out))
    assert _jax_files() <= files, _jax_files() - files
    assert files - _jax_files() == {"curves.json", "latents.npz"}
    curves = json.loads((out / "curves.json").read_text())
    assert curves["train"]["step"] == [25] and curves["val"] == {"step": [], "loss": []}
    assert curves["train"]["loss"] == [summary["final_train_loss"]]
    latents = np.load(out / "latents.npz")
    assert latents["mus"].shape == latents["zs"].shape == (12 * 2, 8)
    readme = (out / "README.md").read_text()
    assert "TPU" not in readme and '"device": "cpu"' in readme


def test_without_matplotlib_only_the_series_are_written(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(plotting, "available", lambda: False)
    out = tmp_path / "res"
    make_result_assets.main(["--steps", "25", "--batch", "2", "--seq", "8",
                             "--hparams", TINY, "--device", "cpu", "--out", str(out)])
    assert sorted(os.listdir(out)) == ["README.md", "curves.json", "latents.npz"]
    assert "skipped: no matplotlib" in capsys.readouterr().out


def test_out_defaults_to_res_torch_not_the_jax_assets():
    args = make_result_assets.parse_args([])
    assert args.out == os.path.join(ROOT, "res_torch")


def test_cli_wants_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_result_assets.main(["--steps", "25", "--out", str(tmp_path)])
