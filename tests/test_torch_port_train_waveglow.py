"""Port: WaveGlow training on the (data, model) grid and its CLI
(``models/waveglow.py`` ``make_waveglow_train_step``,
``tools/train_waveglow.py``).

Ranks run as real processes over gloo on the CPU, launched by torchrun
through ``tools/multihost_dryrun.py --waveglow`` or the CLI; every
subprocess has its own timeout of at most 120 s.

- the mesh step at (2, 1), (1, 2) and (2, 2) against one process and
  against the JAX ``make_waveglow_parallel_train_step`` on that mesh, with
  the CLI's optimizer (a clip to global norm 0.5, which binds here, then
  Adam): loss rtol 1e-5, parameters atol 2e-6 / rtol 2e-5 after 2 steps
  (tests/test_waveglow.py:147-153), from the JAX tiny vocoder's weights
  with a random ``end``;
- a contiguous split of the gate's channels (the JAX layout, which pairs
  channel c with nc + c only on one rank) fails those limits;
- the CLI's ``SegmentSampler`` draws the JAX tool's stream: the same audio
  exactly, its mel within 1e-4;
- the CLI trains, checkpoints and resumes onto the uninterrupted run's
  state; the export-only call writes the checkpoint's weights; a float16
  export vocodes alike at sigma=0 in the port's and the JAX Synthesizer
  (atol 1e-5, rtol 1e-4, as tests/test_torch_port_serving.py); it trains
  at --mesh 1,2 under torchrun; it refuses an Orbax directory and a batch
  that does not split over the data axis.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tacotron2_vae_torch import convert
from _torch_port_common import child_env
from _torch_port_common import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
CFG = dict(n_mel_channels=80, n_flows=6, n_group=8, n_early_every=2, n_early_size=2,
           n_layers=2, n_channels=16)
CLIP, LR, STEPS = 0.5, 1e-4, 2  # LR: the dryrun's Adam
TINY_CLI = ["--n_flows", "2", "--n_channels", "8", "--n_layers", "1", "--segment", "2048"]


def _cmd(target, args, n=1):
    if n == 1:
        return [sys.executable, *target, *args]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={n}", *target, *args]


def _run(target, args, n=1, check=True, **env):
    out = subprocess.run(_cmd(target, args, n), cwd=ROOT, env=child_env(**env),
                         capture_output=True, text=True, timeout=TIMEOUT)
    if check:
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


# ---------------------------------------------------------- the mesh step


CONTIGUOUS = '''import sys
from tacotron2_vae_torch.parallel import mesh

_spec = mesh.waveglow_spec

def contiguous(name, n_layers):
    shard = _spec(name, n_layers)
    return mesh.Shard(shard.dim) if shard is not None else None

mesh.waveglow_spec = contiguous
from tacotron2_vae_torch.tools.multihost_dryrun import main
main(sys.argv[1:])
'''


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tiny vocoder's weights (a random ``end``), a batch, and the
    port's runs: one process, each grid, and (1, 2) with a contiguous
    gate split, started at once."""
    import jax

    from tacotron2_vae_tpu.models import waveglow as jwg

    tmp = str(tmp_path_factory.mktemp("wg_grid"))
    cfg = jwg.WaveGlowConfig(**CFG)
    params = jax.tree_util.tree_map(np.asarray, jwg.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(7)
    for flow in params["flows"]:  # a zero end makes every coupling the identity
        for k in ("w", "b"):
            flow["wn"]["end"][k] = (0.05 * rng.randn(*flow["wn"]["end"][k].shape)
                                    ).astype(np.float32)
    torch.save(convert.from_jax_waveglow(params), os.path.join(tmp, "init.pt"))
    B, frames = 8, 9
    audio = (rng.randn(B, frames * 256) * 0.1).astype(np.float32)
    mel = rng.randn(B, 80, frames).astype(np.float32)
    np.savez(os.path.join(tmp, "batch.npz"), audio=audio, mel=mel)
    script = os.path.join(tmp, "contiguous.py")
    with open(script, "w") as f:
        f.write(CONTIGUOUS)
    runs = {grid: None for grid in ((1, 1), (2, 1), (1, 2), (2, 2))}
    runs["split"] = script
    procs = {}
    for key, split in runs.items():
        data, model = (1, 2) if key == "split" else key
        args = ["--waveglow", "--batch", os.path.join(tmp, "batch.npz"), "--init",
                os.path.join(tmp, "init.pt"), "--device", "cpu", "--steps", str(STEPS),
                "--wg-config", json.dumps(CFG), "--clip", str(CLIP),
                "--mesh-model", str(model), "--out", os.path.join(tmp, f"{key}.pt")]
        target = [split] if split else ["-m", "tacotron2_vae_torch.tools.multihost_dryrun"]
        procs[key] = subprocess.Popen(_cmd(target, args, data * model), cwd=ROOT, env=child_env(),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    for key, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, (key, log[-3000:])
    port = {key: torch.load(os.path.join(tmp, f"{key}.pt"), weights_only=True)
            for key in runs}
    return port, cfg, params, audio, mel


def _jax_steps(cfg, params, audio, mel, grid):
    import jax
    import jax.numpy as jnp
    import optax

    from tacotron2_vae_tpu.parallel import (make_mesh, make_waveglow_parallel_train_step,
                                            shard_waveglow_state)

    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    mesh = make_mesh(devices=jax.devices()[:grid[0] * grid[1]], data=grid[0], model=grid[1])
    p, o = shard_waveglow_state(p, opt.init(p), mesh)
    step = make_waveglow_parallel_train_step(cfg, opt, mesh, 1.0)
    losses = []
    for _ in range(STEPS):
        o, p, loss = step(o, p, jnp.asarray(audio), jnp.asarray(mel))
        losses.append(float(loss))
    return losses, convert.from_jax_waveglow(jax.tree_util.tree_map(np.asarray, p))


def _close(got, want, what):
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=1e-5, err_msg=what)
    for name, w in want["state"].items():
        np.testing.assert_allclose(got["state_dict"][name].numpy(), w.numpy(), atol=2e-6,
                                   rtol=2e-5, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (2, 2)])
def test_waveglow_grid_matches_one_process_and_the_jax_mesh_step(setup, grid):
    port, cfg, params, audio, mel = setup
    one, got = port[(1, 1)], port[grid]
    assert one["metrics"]["grad_norm"][0] > CLIP  # the clip binds
    assert got["metrics"]["updated"] == [True] * STEPS
    assert got["metrics"]["rows"] == len(audio) // grid[0] and got["metrics"]["model"] == grid[1]
    _close(got, {"loss": one["metrics"]["loss"], "state": one["state_dict"]}, "one process")
    losses, state = _jax_steps(cfg, params, audio, mel, grid)
    _close(got, {"loss": losses, "state": state}, "JAX mesh step")


def test_a_contiguous_split_of_the_gate_fails(setup):
    port = setup[0]
    one, got = port[(1, 1)], port["split"]
    assert got["metrics"]["model"] == 2
    with pytest.raises(AssertionError):
        _close(got, {"loss": one["metrics"]["loss"], "state": one["state_dict"]}, "split")


# ----------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tacotron2_vae_torch.dsp.audio import save_wav

    tmp = tmp_path_factory.mktemp("wg_cli")
    rng = np.random.RandomState(0)
    lines = []
    for i, n in enumerate((1500, 4000, 6000)):  # the first is shorter than a segment
        p = tmp / f"w{i}.wav"
        save_wav(str(p), (0.1 * rng.randn(n)).astype(np.float32), 16000)
        lines.append(f"{p}|x|0|0")
    flist = tmp / "train.txt"
    flist.write_text("\n".join(lines) + "\n")
    return tmp, str(flist)


JAX_SAMPLER = '''import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location("jax_train_waveglow", sys.argv[1])
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
sampler = tool.SegmentSampler(sys.argv[2], 2048, 16000, seed=1237)
out = {}
for i in range(2):
    audio, mel = sampler.batch(3)
    out[f"audio{i}"], out[f"mel{i}"] = np.asarray(audio), np.asarray(mel)
np.savez(sys.argv[3], **out)
'''


def test_segment_sampler_draws_the_jax_stream(corpus, tmp_path):
    from tacotron2_vae_torch.tools.train_waveglow import SegmentSampler

    _, flist = corpus
    script, dest = tmp_path / "sampler.py", tmp_path / "jax.npz"
    script.write_text(JAX_SAMPLER)
    _run([str(script)], [os.path.join(ROOT, "tools", "train_waveglow.py"), flist, str(dest)],
         JAX_PLATFORMS="cpu")
    want = np.load(dest)
    sampler = SegmentSampler(flist, 2048, 16000, seed=1237, device="cpu")
    for i in range(2):
        audio = sampler.segments(3)
        mel = sampler.mel(audio)
        np.testing.assert_array_equal(audio, want[f"audio{i}"])
        assert mel.shape == want[f"mel{i}"].shape == (3, 80, 9)
        np.testing.assert_allclose(mel.numpy(), want[f"mel{i}"], atol=1e-4, rtol=0)


def _cli(args, n=1, check=True):
    return _run(["-m", "tacotron2_vae_torch.tools.train_waveglow"],
                [*TINY_CLI, "--device", "cpu", *args], n, check=check)


def test_cli_resumes_the_stream_exports_and_both_synthesizers_vocode(corpus, tmp_path):
    from _torch_port_common import TINY, build

    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer
    from tacotron2_vae_tpu.config import create_hparams as jax_hparams
    from tacotron2_vae_tpu.serving.synthesizer import Synthesizer as JaxSynthesizer

    _, flist = corpus
    common = ["--filelist", flist, "--batch", "2", "--lr", "0.01", "--checkpoint_every", "2"]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    out = _cli(["--output_dir", full, "--steps", "4", "--export", str(tmp_path / "wg16.pkl"),
                "--export_dtype", "float16", *common])
    assert json.loads(out.stdout.strip().splitlines()[-1])["steps"] == 4
    assert os.path.exists(os.path.join(full, "nll.csv"))
    assert json.load(open(os.path.join(full, "run_config.json")))["steps"] == 4
    _cli(["--output_dir", part, "--steps", "2", *common])
    _cli(["--output_dir", part, "--steps", "4", "--resume",
          os.path.join(part, "waveglow_2"), *common])
    a = torch.load(os.path.join(full, "waveglow_4"), weights_only=True)
    b = torch.load(os.path.join(part, "waveglow_4"), weights_only=True)
    assert a["step"] == b["step"] == 4
    for k, v in a["state_dict"].items():
        assert torch.equal(b["state_dict"][k], v), k
    for i, s in a["optimizer"]["state"].items():
        assert torch.equal(b["optimizer"]["state"][i]["exp_avg"], s["exp_avg"]), i
    # the export-only call writes the checkpoint's weights
    out = _cli(["--output_dir", str(tmp_path / "only"), "--steps", "0", "--resume",
                os.path.join(full, "waveglow_4"), "--export", str(tmp_path / "only.pkl"),
                *common])
    assert "exported only" in out.stdout
    with open(tmp_path / "only.pkl", "rb") as f:
        only = pickle.load(f)
    assert only["config"]["n_flows"] == 2 and only["config"]["n_channels"] == 8
    sd = convert.from_jax_waveglow(only["waveglow"])
    for k, v in a["state_dict"].items():
        assert torch.equal(sd[k], v), k
    # the float16 export vocodes alike in both packages' Synthesizers
    _, _, params, state, _ = build()
    ckpt = tmp_path / "t2.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump({"params": params, "model_state": state}, f)
    none = str(tmp_path / "none.txt")
    ours = Synthesizer(create_hparams(TINY), device="cpu")
    with pytest.warns(UserWarning, match="Centroid"):
        ours.load(str(ckpt), vocoder_path=str(tmp_path / "wg16.pkl"), centroid_filelist=none)
    ref = JaxSynthesizer(jax_hparams(TINY))
    with pytest.warns(UserWarning, match="Centroid"):
        ref.load(str(ckpt), str(tmp_path / "wg16.pkl"), centroid_filelist=none)
    assert ours.vocoder.module.cfg.n_flows == ref.waveglow_cfg.n_flows == 2
    mel = np.random.RandomState(2).randn(1, 80, 40).astype(np.float32)
    want = ref.vocode(mel, sigma=0.0)
    got = ours.vocode(mel, sigma=0.0)
    assert got.shape == want.shape == (40 * 256,)
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_cli_trains_on_a_grid_and_refuses_what_jax_refuses(corpus, tmp_path):
    _, flist = corpus
    common = ["--filelist", flist, "--steps", "2", "--checkpoint_every", "2"]
    out = _cli(["--output_dir", str(tmp_path / "grid"), "--batch", "2", "--mesh", "1,2",
                *common], n=2)
    assert "mesh: data=1 model=2" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1])["steps"] == 2
    saved = torch.load(tmp_path / "grid" / "waveglow_2", weights_only=True)
    assert saved["state_dict"]["WN.0.in_layers.0.weight"].shape == (16, 8, 3)  # logical
    bad = _cli(["--output_dir", str(tmp_path / "bad"), "--batch", "3", "--mesh", "2,1",
                *common], check=False)
    assert bad.returncode != 0 and "not divisible by data axis 2" in bad.stderr
    os.makedirs(tmp_path / "orbax_ckpt")
    bad = _cli(["--output_dir", str(tmp_path / "bad"), "--batch", "2", "--resume",
                str(tmp_path / "orbax_ckpt"), *common], check=False)
    assert bad.returncode != 0 and "Orbax" in bad.stderr
