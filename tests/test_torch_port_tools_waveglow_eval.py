"""Port parity: ``tools/waveglow_eval.py`` against the JAX package's tool.

At a tiny WaveGlow (2 flows of 1 layer, 8 channels, a random ``end`` so
the couplings count) on a few synthetic wavs:

* the held-out clips and NLL segments are the JAX tool's (the audio
  exactly, the segments' mels within 1e-4, K2's tolerance,
  tests/test_pallas_stft.py:36);
* ``_ms_stft_distance`` is identical;
* the NLL of weights saved as the port's ``waveglow_{step}`` files is
  within rtol 1e-5 of JAX ``wg.forward`` + ``waveglow_loss`` on the same
  weights and inputs (the inputs scaled so that the NLL is far above the
  report's 5 decimals);
* copy synthesis: the sigma=0 row (the deterministic inverse) within rtol
  1e-4 of the JAX tool's; the sigma=0.666 and Griffin-Lim rows are only
  finite, because their noise and starting phases come from each
  framework's own random stream (``torch.Generator`` against
  ``jax.random``);
* the CLI on ``train_waveglow``'s own checkpoints and export writes the
  JAX tool's report keys, refuses an Orbax directory and wants a card
  unless told otherwise.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_common import load_jax_tool
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.models import waveglow as jwg
from tacotron2_vae_torch import convert
from tacotron2_vae_torch.models.waveglow import WaveGlow, WaveGlowConfig
from tacotron2_vae_torch.tools import train_waveglow, waveglow_eval

CFG = dict(n_flows=2, n_group=8, n_early_every=2, n_early_size=2, n_layers=1, n_channels=8)
SECONDS = (0.45, 0.3, 0.7, 0.55, 0.2)


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("waveglow_eval")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A filelist of 16 kHz wavs, one 8 kHz wav among them (skipped by both
    tools), and one missing path."""
    tmp = tmp_path_factory.mktemp("wg_eval")
    rng = np.random.RandomState(0)
    lines = []
    for i, sec in enumerate(SECONDS):
        n = int(16000 * sec)
        x = 0.4 * np.sin(2 * np.pi * (150 + 45 * i) * np.arange(n) / 16000) + 0.05 * rng.randn(n)
        path = tmp / f"w{i}.wav"
        wavfile.write(path, 8000 if i == 1 else 16000, (x * 32767).astype(np.int16))
        lines.append(f"{path}|x|0|0")
    lines.append(f"{tmp / 'missing.wav'}|x|0|0")
    (tmp / "val.txt").write_text("\n".join(lines) + "\n")
    return tmp


def _jax_params(seed):
    cfg = jwg.WaveGlowConfig(**CFG)
    params = jax.tree_util.tree_map(np.asarray, jwg.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for flow in params["flows"]:
        flow["wn"]["end"]["w"] = (0.05 * rng.randn(*flow["wn"]["end"]["w"].shape)).astype(
            np.float32)
    return cfg, params


@pytest.fixture(scope="module")
def export(corpus):
    cfg, params = _jax_params(3)
    path = corpus / "export.pkl"
    with open(path, "wb") as f:
        pickle.dump({"waveglow": params, "config": cfg.__dict__}, f)
    return path, cfg, params


def test_clips_and_segments_are_the_jax_tools(jax_tool, corpus):
    flist = str(corpus / "val.txt")
    got = waveglow_eval._load_clips(flist, 16000, 3, max_secs=0.5)
    want = jax_tool._load_clips(flist, 16000, 3, max_secs=0.5)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    audio, mel = waveglow_eval._eval_segments(flist, 16000, 6400, 4, "cpu")
    want_audio, want_mel = jax_tool._eval_segments(flist, 16000, 6400, 4)
    assert audio.shape == (4, 6400) and mel.shape == (4, 80, 26)
    np.testing.assert_array_equal(audio.numpy(), np.asarray(want_audio))
    np.testing.assert_allclose(mel.numpy(), np.asarray(want_mel), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,m", [(9000, 9000), (9000, 7000), (300, 1500)])
def test_ms_stft_distance_is_the_jax_tools(jax_tool, n, m):
    rng = np.random.RandomState(n + m)
    ref, out = rng.randn(n).astype(np.float32), rng.randn(m).astype(np.float32)
    assert waveglow_eval._ms_stft_distance(ref, out) == jax_tool._ms_stft_distance(ref, out)
    assert waveglow_eval._ms_stft_distance(ref, ref) == (0.0, 0.0)


def test_heldout_nll_of_port_checkpoints_matches_jax(corpus, tmp_path):
    audio, mel = waveglow_eval._eval_segments(str(corpus / "val.txt"), 16000, 4096, 3, "cpu")
    audio = 10.0 * audio  # an NLL of order 1 to 10
    ckpts = tmp_path / "run"
    os.makedirs(ckpts)
    want = {}
    for step, seed in ((10, 5), (2, 4)):
        cfg, params = _jax_params(seed)
        torch.save({"step": step, "state_dict": convert.from_jax_waveglow(params)},
                   ckpts / f"waveglow_{step}")
        z, log_s, log_det = jwg.forward(params, jnp.asarray(audio.numpy()),
                                        jnp.asarray(mel.numpy()), cfg)
        want[step] = float(jwg.waveglow_loss(z, log_s, log_det, 1.0))
    (ckpts / "nll.csv").write_text("step,nll,steps_per_sec\n")
    (ckpts / "waveglow_30").write_bytes(b"not a checkpoint")
    rows = waveglow_eval.nll_sweep(str(ckpts), WaveGlowConfig(**CFG), audio, mel)
    assert [r["step"] for r in rows] == [2, 10, 30]
    assert rows[2]["nll"] is None and rows[2]["error"]
    for row in rows[:2]:
        assert abs(want[row["step"]]) > 1.0
        np.testing.assert_allclose(row["nll"], want[row["step"]], rtol=1e-5, atol=0)


def test_copy_synthesis_matches_jax_at_sigma_zero(jax_tool, corpus, export):
    _, cfg, params = export
    clips = waveglow_eval._load_clips(str(corpus / "val.txt"), 16000, 2, max_secs=0.5)
    net = WaveGlow(WaveGlowConfig(**CFG))
    net.load_state_dict(convert.from_jax_waveglow(params))
    got = waveglow_eval.copy_synthesis(net.eval(), clips, 16000)
    want = jax_tool.copy_synthesis(params, cfg, clips, 16000)
    assert set(got) == set(want) == {"waveglow_s0.666", "waveglow_s0", "griffin_lim"}
    for key in got:
        assert set(got[key]) == set(want[key]) == {"dlogmel", "sc", "logmag_l1"}
        assert all(np.isfinite(v) and v > 0 for v in got[key].values()), (key, got[key])
    for metric, value in want["waveglow_s0"].items():
        np.testing.assert_allclose(got["waveglow_s0"][metric], value, rtol=1e-4, atol=0,
                                   err_msg=metric)


def test_cli_reads_train_waveglow_output(corpus, export, tmp_path, capsys):
    flist = str(corpus / "val.txt")
    run = str(tmp_path / "run")
    train_waveglow.main(["--filelist", flist, "--output_dir", run, "--steps", "4",
                         "--checkpoint_every", "2", "--segment", "2048", "--batch", "2",
                         "--n_flows", "2", "--n_channels", "8", "--n_layers", "1",
                         "--export", str(tmp_path / "wg.pkl"), "--device", "cpu"])
    capsys.readouterr()
    out = tmp_path / "report.json"
    report = waveglow_eval.main(["--export", str(tmp_path / "wg.pkl"), "--ckpt_dir", run,
                                 "--filelist", flist, "--n_clips", "2", "--nll_segments", "3",
                                 "--segment", "4096", "--out", str(out),
                                 "--plot", str(tmp_path / "nll.png"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == report == json.loads(out.read_text())
    assert list(report) == ["export", "config", "filelist", "heldout_nll", "plot",
                            "copy_synthesis"]
    assert [r["step"] for r in report["heldout_nll"]] == [2, 4]
    assert all(np.isfinite(r["nll"]) for r in report["heldout_nll"])
    assert os.path.getsize(tmp_path / "nll.png") > 0
    for row in report["copy_synthesis"].values():
        assert all(np.isfinite(v) for v in row.values())


def test_cli_refuses_orbax_directories_and_wants_a_card(corpus, export, tmp_path):
    os.makedirs(tmp_path / "orbax" / "waveglow_100")
    args = ["--export", str(export[0]), "--ckpt_dir", str(tmp_path / "orbax"), "--filelist",
            str(corpus / "val.txt"), "--segment", "4096", "--nll_segments", "2"]
    with pytest.raises(SystemExit, match="Orbax"):
        waveglow_eval.main(args + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            waveglow_eval.main(args)
