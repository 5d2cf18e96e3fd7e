"""Port parity: ``tools/curves_run.py`` against the JAX package's tool.

With the corpus shrunk on both modules (``TRAIN_SENTS``, ``VAL_SENTS``),
``make_corpus`` writes the same wavs byte for byte and the same filelists
up to the workdir.  ``_hparams`` gives the JAX tool's value for every
hparam, at the default depth and at a ``T2V_STEPS_TARGET`` (which the port
reads at each call).  ``_read_csv``, ``_ema`` and ``_cap`` (the last nested
in the JAX tool's ``run_assets``, taken from its source) agree on a CSV of
a resumed run whose iteration ranges overlap.  ``all`` at tiny width on the
CPU, with a tiny WaveGlow export and decodes cut to 48 steps, writes
``metrics.csv``, a checkpoint, the assets summary with the JAX tool's keys
and the four recipes' files; the
output defaults are not the JAX package's committed directories; without a
card and without ``--device`` the tool raises.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_common import ROOT, TINY, load_jax_tool
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_torch.models.tacotron2 import Tacotron2
from tacotron2_vae_torch.models.waveglow import WaveGlow, WaveGlowConfig
from tacotron2_vae_torch.tools import curves_run, train_waveglow

JAX_SOURCE = os.path.join(ROOT, "tools", "curves_run.py")


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("curves_run")


def _jax_function_source(name):
    """The source of the JAX tool's function ``name``, nested ones included."""
    with open(JAX_SOURCE, encoding="utf-8") as f:
        src = f.read()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            lines = ast.get_source_segment(src, node).splitlines()
            indent = len(lines[0]) - len(lines[0].lstrip())
            return "\n".join(line[indent:] for line in lines), node
    raise AssertionError(f"no {name} in the JAX tool")


def _jax_summary_keys():
    _src, node = _jax_function_source("run_assets")
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Dict)
                and getattr(sub.targets[0], "id", None) == "summary"):
            return [k.value for k in sub.value.keys]
    raise AssertionError("no summary dict in run_assets")


def test_corpus_is_the_jax_tools(tmp_path, monkeypatch, jax_tool):
    for mod in (curves_run, jax_tool):
        monkeypatch.setattr(mod, "TRAIN_SENTS", 2)
        monkeypatch.setattr(mod, "VAL_SENTS", 1)
    got = curves_run.make_corpus(str(tmp_path / "port"))
    want = jax_tool.make_corpus(str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax" / "corpus"))
    assert len(names) == 12 and sorted(os.listdir(tmp_path / "port" / "corpus")) == names
    for name in names:
        assert ((tmp_path / "port" / "corpus" / name).read_bytes()
                == (tmp_path / "jax" / "corpus" / name).read_bytes()), name
    for g, w in zip(got, want):
        with open(g, encoding="utf-8") as f:
            g_text = f.read().replace(str(tmp_path / "port"), "W")
        with open(w, encoding="utf-8") as f:
            w_text = f.read().replace(str(tmp_path / "jax"), "W")
        assert g_text == w_text and g_text.count("\n") in (8, 4)


@pytest.mark.parametrize("target", [None, "100"], ids=["default", "env"])
def test_hparams_are_the_jax_tools(monkeypatch, jax_tool, target):
    if target is None:
        monkeypatch.delenv("T2V_STEPS_TARGET", raising=False)
        assert curves_run.steps_target() == jax_tool.STEPS_TARGET == 16032
    else:
        # the JAX tool reads the variable at import; the port at each call
        monkeypatch.setenv("T2V_STEPS_TARGET", target)
        monkeypatch.setattr(jax_tool, "STEPS_TARGET", 96)
        assert curves_run.steps_target() == 96
    got = curves_run._hparams("/w").values()
    want = jax_tool._hparams("/w").values()
    assert got == want
    assert got["epochs"] == curves_run.steps_target() // 8
    over = curves_run._hparams("/w", "iters_per_checkpoint=8").values()
    assert over == dict(want, iters_per_checkpoint=8)


def test_read_csv_ema_and_cap_are_the_jax_tools(tmp_path, jax_tool):
    rng = np.random.RandomState(0)
    header = "iteration,loss,grad_norm,learning_rate,duration,kl_div,kl_weight,recon_loss"
    rows = []
    # a run logs 0..9, dies, and the resumed run logs 6..14 again
    for it in list(range(10)) + list(range(6, 15)):
        vals = rng.rand(7)
        rows.append(f"{it}," + ",".join(f"{v:.6f}" for v in vals))
    path = tmp_path / "metrics.csv"
    path.write_text(header + "\n" + "\n".join(rows) + "\n")
    got, want = curves_run._read_csv(str(path)), jax_tool._read_csv(str(path))
    assert list(got) == list(want) == header.split(",")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["iteration"], np.arange(15))
    # the resumed run's rows win where the ranges overlap
    assert got["loss"][6] == float(rows[10].split(",")[1])
    assert curves_run._ema(got["loss"]) == jax_tool._ema(want["loss"])
    assert curves_run._ema(got["kl_div"], 0.5) == jax_tool._ema(want["kl_div"], 0.5)
    src, _ = _jax_function_source("_cap")
    ns = {"np": np}
    exec(src, ns)
    for series in (got["loss"], got["kl_div"][got["iteration"] > 2000],
                   np.array([np.nan, 1.0, np.inf, 3.0]), np.array([np.nan])):
        for factor in (1.6, 1.8):
            assert curves_run._cap(series, factor) == ns["_cap"](series, factor)
    assert curves_run._cap(np.array([np.nan]), 1.6) is None


def test_output_defaults_are_not_the_jax_assets():
    args = curves_run.parse_args(["all"])
    assert args.res == os.path.join(ROOT, "res_torch")
    assert args.samples == os.path.join(ROOT, "samples", "generated_torch")


def test_all_at_tiny_width_writes_every_stage(tmp_path, monkeypatch):
    # 16 training clips at B=4: one epoch of 4 steps
    monkeypatch.setattr(curves_run, "TRAIN_SENTS", 4)
    monkeypatch.setattr(curves_run, "VAL_SENTS", 4)
    monkeypatch.setenv("T2V_STEPS_TARGET", "8")
    cfg = WaveGlowConfig(n_flows=2, n_early_every=4, n_layers=1, n_channels=8)
    wg = WaveGlow(cfg)
    torch.manual_seed(0)
    with torch.no_grad():  # a zero `end` would make every coupling the identity
        for p in wg.parameters():
            p.normal_(0.0, 0.02)
    pkl = tmp_path / "waveglow.pkl"
    train_waveglow.export(wg.state_dict(), cfg, str(pkl), "float32")
    monkeypatch.setenv("T2V_WAVEGLOW", str(pkl))
    # the untrained tiny model never fires its gate: 48 decoder steps, not 600
    infer = Tacotron2.infer
    monkeypatch.setattr(Tacotron2, "infer", lambda self, *a, max_steps=None, **k: infer(
        self, *a, max_steps=48, **k))
    work, res, samples = tmp_path / "work", tmp_path / "res", tmp_path / "samples"
    report = curves_run.main(["all", "--workdir", str(work), "--res", str(res),
                              "--samples", str(samples), "--device", "cpu", "--hparams",
                              TINY + ",batch_size=4,iters_per_checkpoint=2"])
    assert report["stages"] == ["corpus", "train", "assets", "samples"]
    with open(work / "out" / "logs" / "metrics.csv") as f:
        assert [int(line.split(",")[0]) for line in f.readlines()[1:]] == list(range(4))
    assert report["checkpoints"] == ["checkpoint_2"]
    summary = report["assets"]
    assert list(summary) == _jax_summary_keys()
    assert (summary["steps"], summary["batch"], summary["checkpoint"]) == (4, 4, "checkpoint_2")
    assert summary["kl_postlag_max_ema"] is None  # the run ends before the priced region
    for k in ("final_train_loss_ema", "final_recon_loss_ema", "final_val_loss", "kl_final_ema"):
        assert np.isfinite(summary[k]), k
    assert {"trainingloss.png", "reconloss.png", "kldiv.png", "klweight.png", "validloss.png",
            "alignment.png", "mel_predicted.png", "mel_target.png", "gate.png", "scatter.png",
            "tsne.png", "README.md", "latents.npz", "curves.json"} == set(os.listdir(res))
    latents = np.load(res / "latents.npz")
    assert latents["zs"].shape == (16, 8) and np.isfinite(latents["zs"]).all()
    interp = [f"interp_sad{r:.2f}_hap{1 - r:.2f}.wav" for r in (1.0, 0.64, 0.34, 0.0)]
    assert report["samples"] == sorted(["README.md", "latents.npz", "scatter.png", "tsne.png",
                                        "ref_conditioned.wav", "mix.wav", *interp])
    for name in report["samples"]:
        if name.endswith(".wav"):
            sr, wav = wavfile.read(samples / name)
            assert sr == 16000 and wav.size and np.isfinite(wav.astype(np.float64)).all()
    readme = (samples / "README.md").read_text()
    assert "WaveGlow" in readme and "Copy synthesis" in readme and "TPU" not in readme
    assert "TPU" not in (res / "README.md").read_text()
    assert json.loads((res / "README.md").read_text().split("```json\n")[1].split("```")[0]) \
        == summary


def test_cli_wants_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        curves_run.main(["corpus", "--workdir", str(tmp_path)])
