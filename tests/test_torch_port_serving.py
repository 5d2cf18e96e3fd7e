"""Port: weight bridge, Synthesizer smoke on the CPU, CLI and import hygiene."""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_common import TINY, build, child_env, n
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_torch import convert
from tacotron2_vae_torch.models.waveglow import WaveGlowConfig
from tacotron2_vae_torch.serving import synthesizer as synth_mod
from tacotron2_vae_torch.serving import vocoders

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from convert_torch_ckpt import convert_tacotron2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny vocoder of tests/test_serving.py
WG_CFG_ARGS = dict(n_flows=4, n_group=8, n_early_every=2, n_early_size=2, n_layers=2,
                   n_channels=8)


def test_weight_bridge_round_trip():
    _, hp, params, state, model = build()
    sd = {k: v for k, v in model.state_dict().items()}
    p2, s2 = convert.to_jax_params(sd)
    flat, tree = jax.tree_util.tree_flatten((params, state))
    flat2, tree2 = jax.tree_util.tree_flatten((p2, s2))
    assert tree == tree2
    for a, b in zip(flat, flat2):
        np.testing.assert_array_equal(np.asarray(a), b)
    sd2 = convert.from_jax_params(p2, s2, hp)
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
    # agrees with the JAX package's own reference-checkpoint converter
    p3, s3 = convert_tacotron2({k: v.numpy() for k, v in sd.items()}, hp)
    for a, b in zip(jax.tree_util.tree_leaves((p3, s3)), flat2):
        np.testing.assert_array_equal(np.asarray(a), b)


def _write(path, seconds, freq, seed):
    rng = np.random.RandomState(seed)
    x = 0.3 * np.sin(2 * np.pi * freq * np.arange(int(16000 * seconds)) / 16000)
    x += 0.02 * rng.randn(len(x))
    wavfile.write(path, 16000, (x * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_synth")
    _, hp, params, state, model = build()
    pkl = tmp / "checkpoint_jax.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"params": params, "model_state": state}, f)
    pt = tmp / "checkpoint_ref.pt"
    torch.save({"state_dict": model.state_dict()}, pt)
    manifest = tmp / "manifest_test.txt"
    with open(manifest, "w", encoding="utf-8") as f:
        for i in range(6):
            _write(tmp / f"c{i}.wav", 0.6 + 0.1 * i, 200 + 50 * i, i)
            f.write(f"{tmp / f'c{i}.wav'}|안녕|0|{i % 4}\n")
        f.write(f"{tmp / 'missing.wav'}|안녕|0|1\n")
    _write(tmp / "ref.wav", 1.0, 300, 9)
    return tmp, hp, pkl, pt, manifest


def test_synthesizer_cpu_smoke(checkpoint):
    tmp, hp, pkl, pt, manifest = checkpoint
    from tacotron2_vae_torch.config import create_hparams

    synth = synth_mod.Synthesizer(create_hparams(TINY), device="cpu")
    with pytest.warns(UserWarning, match="skipped 1/7"):
        synth.load(str(pkl), centroid_filelist=str(manifest))
    assert synth.centroids_loaded
    npz = [p for p in os.listdir(tmp) if p.endswith("_test.npz")]
    assert len(npz) == 1
    paths = [
        synth.synthesize("안녕하세요.", str(tmp / "ref_out.wav"), True, str(tmp / "ref.wav"),
                         None),
        synth.synthesize("반갑습니다.", str(tmp / "ratio_out.wav"), False, None,
                         [0.2, 0.3, 0.4, 0.1]),
    ]
    style = synth.interpolate("neu", "sad", 0.5)
    assert style.shape == (hp.E,)
    mel, mel_post, gate, align, frames = synth.synthesize_mel("감사합니다.", style)
    assert mel_post.shape == (1, hp.n_mel_channels, frames) and np.isfinite(mel_post).all()
    wav = synth.vocode(mel_post)
    assert wav.shape == ((frames - 1) * hp.hop_length,) and np.isfinite(wav).all()
    reqs = [("하나.", str(tmp / "b0.wav"), True, str(tmp / "ref.wav"), None),
            ("둘셋넷.", str(tmp / "b1.wav"), False, None, [1, 0, 0, 0]),
            ("다섯.", str(tmp / "b2.wav"), False, None, None)]
    paths += synth.synthesize_batch(reqs)
    for p in paths:
        sr, data = wavfile.read(p)
        assert sr == 16000 and len(data) > 0
    # a second load of the pickle reads its .npz cache; the reference torch
    # checkpoint of the same weights embeds the clips anew to the same centroids
    for ckpt in (pkl, pt):
        again = synth_mod.Synthesizer(create_hparams(TINY), device="cpu")
        again.load(str(ckpt), centroid_filelist=str(manifest))
        np.testing.assert_allclose(again.sad, synth.sad, atol=1e-6)
    assert len([p for p in os.listdir(tmp) if p.endswith("_test.npz")]) == 2


def test_batch_rows_equal_single_rows(checkpoint):
    _, _, pkl, _, manifest = checkpoint
    from tacotron2_vae_torch.config import create_hparams

    synth = synth_mod.Synthesizer(create_hparams(TINY), device="cpu")
    synth.load(str(pkl), centroid_filelist=str(manifest))
    style = synth.style_from_ratios([0, 1, 0, 0])
    synth._seed = lambda: 11
    single = synth.synthesize_mel("반갑습니다.", style)
    # prenet dropout is keyed on the row, so compare row 0 with the single run
    batch = synth.synthesize_mel_batch(["반갑습니다.", "안녕."], [style, style])
    assert batch[0][4] == single[4]
    np.testing.assert_allclose(batch[0][1], single[1], atol=1e-5)


def _waveglow_pickle(path, dtype=np.float32, seed=1):
    """A self-describing WaveGlow pickle (``{"waveglow", "config"}``, as the
    JAX package's ``tools/train_waveglow.py --export`` writes) at the tiny
    config, with a random ``end`` so the couplings are not the identity."""
    from tacotron2_vae_tpu.models import waveglow as jwg

    cfg = jwg.WaveGlowConfig(**WG_CFG_ARGS)
    params = jax.tree_util.tree_map(np.asarray, jwg.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for flow in params["flows"]:
        flow["wn"]["end"]["w"] = 0.05 * rng.randn(*flow["wn"]["end"]["w"].shape)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), params)
    with open(path, "wb") as f:
        pickle.dump({"waveglow": params, "config": cfg.__dict__}, f)
    return params


def test_vocode_with_waveglow_and_synthesizer_needs_cuda(checkpoint):
    tmp, hp, pkl, _, manifest = checkpoint
    from tacotron2_vae_torch.config import create_hparams

    _waveglow_pickle(tmp / "wg.pkl")
    synth = synth_mod.Synthesizer(create_hparams(TINY), device="cpu")
    synth.load(str(pkl), vocoder_path=str(tmp / "wg.pkl"), centroid_filelist=str(manifest))
    mel = np.random.RandomState(0).randn(1, 80, 70).astype(np.float32)
    wav = synth.vocode(mel)
    assert wav.shape == (70 * hp.hop_length,) and np.isfinite(wav).all()
    assert not np.array_equal(wav, synth.vocode(mel))  # fresh noise per call
    out = synth.synthesize("안녕하세요.", str(tmp / "wg_out.wav"), False, None, [1, 0, 0, 0])
    sr, data = wavfile.read(out)
    assert sr == 16000 and len(data) % hp.hop_length == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            synth_mod.Synthesizer()
        with pytest.raises(RuntimeError, match="CUDA"):
            synth_mod.main(["--load_path", str(pkl), "--text", "안녕"])


def test_import_leaves_jax_out():
    code = (
        "import pkgutil, sys, importlib, tacotron2_vae_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tacotron2_vae_tpu'))]\n"
        "assert len(mods) > 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=child_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_module_tree_has_reference_names():
    _, _, _, _, model = build()
    keys = set(model.state_dict())
    for k in ("transcript_embedding.weight", "encoder.convolutions.0.0.conv.weight",
              "encoder.convolutions.2.1.running_var", "encoder.lstm.weight_ih_l0_reverse",
              "decoder.attention_rnn.weight_hh",
              "decoder.attention_layer.location_layer.location_conv.conv.weight",
              "decoder.gate_layer.linear_layer.bias", "postnet.convolutions.4.1.weight",
              "vae_gst.ref_encoder.convs.0.conv.weight", "vae_gst.ref_encoder.convs.5.bias",
              "vae_gst.ref_encoder.gru.bias_hh_l0", "vae_gst.fc3.weight",
              "speaker_embedding.linear_layer.weight"):
        assert k in keys, k
    assert n(model.decoder.prenet.layers[0].linear_layer.weight).shape == (32, 80)


def test_waveglow_pickle_config_wins_and_float16_is_cast(checkpoint):
    tmp, _, pkl, _, manifest = checkpoint
    from tacotron2_vae_torch.config import create_hparams

    params = _waveglow_pickle(tmp / "wg16.pkl", np.float16, seed=3)
    synth = synth_mod.Synthesizer(create_hparams(TINY), device="cpu")
    assert synth.vocoder is None
    synth.load(str(pkl), vocoder_path=str(tmp / "wg16.pkl"), centroid_filelist=str(manifest))
    assert isinstance(synth.vocoder, vocoders.WaveGlow)
    assert synth.vocoder.module.cfg == WaveGlowConfig(**WG_CFG_ARGS) != WaveGlowConfig()
    sd = synth.vocoder.module.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    w = params["flows"][1]["wn"]["in"][1]["w"]  # (k, in, out) float16
    np.testing.assert_array_equal(sd["WN.1.in_layers.1.weight"].numpy(),
                                  w.astype(np.float32).transpose(2, 1, 0))


def test_vocode_matches_jax_synthesizer(checkpoint):
    """sigma=0 makes both vocoders deterministic (their noise differs)."""
    tmp, _, pkl, _, manifest = checkpoint
    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_tpu.config import create_hparams as jax_hparams
    from tacotron2_vae_tpu.serving.synthesizer import Synthesizer as JaxSynthesizer

    _waveglow_pickle(tmp / "wg_parity.pkl", seed=4)
    ours = synth_mod.Synthesizer(create_hparams(TINY), device="cpu")
    ours.load(str(pkl), vocoder_path=str(tmp / "wg_parity.pkl"),
              centroid_filelist=str(manifest))
    ref = JaxSynthesizer(jax_hparams(TINY))
    ref.load(str(pkl), str(tmp / "wg_parity.pkl"), centroid_filelist=str(manifest))
    # 70 frames pad to 128 with log(1e-5): the padding reaches the last frames
    mel = np.random.RandomState(2).randn(1, 80, 70).astype(np.float32)
    want = ref.vocode(mel, sigma=0.0)
    got = ours.vocode(mel, sigma=0.0)
    assert got.shape == want.shape == (70 * 256,)
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_griffin_lim_without_a_vocoder(checkpoint):
    _, hp, pkl, _, manifest = checkpoint
    from tacotron2_vae_torch.config import create_hparams

    synth = synth_mod.Synthesizer(create_hparams(TINY), device="cpu")
    synth.load(str(pkl), centroid_filelist=str(manifest))
    assert synth.vocoder is None and synth.bigvgan is None
    mel = np.full((1, 80, 12), -4.0, np.float32)
    wav = synth.vocode(mel)
    # Griffin-Lim's istft gives (T - 1) hops; WaveGlow gives T
    assert wav.shape == (11 * hp.hop_length,) and np.isfinite(wav).all()
