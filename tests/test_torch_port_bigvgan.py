"""Port: the BigVGAN vocoder (``models/bigvgan.py``), kernel K9's twin
(``ops/aa_snake.py``), its checkpoint loading and its serving path.

On the CPU, at tiny widths (initial channel 32, two stages of rate 2,
resblock kernels 3 and 7: every mechanism of the published generator):
the generator against the plain reference ``_plain_bigvgan.py`` on seeded
weights in the published checkpoint layout (float32 on both sides with the
same operations up to summation order: atol 1e-5, where a missed
anti-aliasing filter or a wrong pad moves the output by far more than
1e-3, as the planted fault shows); K9's twin against the reference's
``Activation1d`` at L = 1, 7 and 64, edges included; the kernel's index
plan (tiles, halos, chunks, the edge overwrite), emulated in numpy, against
the twin at lengths around a tile's end; the weight-norm fold
against ``torch.nn.utils.weight_norm``; ``Synthesizer.load`` telling a
BigVGAN checkpoint from a WaveGlow pickle; one ``POST /api`` and one
``GET /generate`` through ``app.make_server`` whose wav bytes are the
reference's on the mel the app vocoded; the Synthesizer's vocoder seam
(``serving/vocoders.py``) for WaveGlow, BigVGAN and Griffin-Lim: what the
benchmark wraps and reads, the seeds each vocoder draws and the bytes it
writes, and no BigVGAN import until one is loaded.  Tests marked ``cuda`` hold K9 to
its twin on the card at the six stage widths of a 9.6 s request; they
import no JAX, so they run there with ``python -m pytest --noconftest``.
"""

import base64
import io
import json
import math
import os
import pickle
import re
import subprocess
import sys
import threading
import urllib.request
from urllib.parse import quote

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import _plain_bigvgan as ref
from _torch_port_common import child_env
from tacotron2_vae_torch import convert
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.dsp import griffin_lim, save_wav
from tacotron2_vae_torch.dsp.stft import dynamic_range_decompression
from tacotron2_vae_torch.models import waveglow as wg_model
from tacotron2_vae_torch.models.bigvgan import BigVGAN, BigVGANConfig, kaiser_sinc_filter1d
from tacotron2_vae_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_vae_torch.ops import aa_snake as k9
from tacotron2_vae_torch.serving import app as app_mod
from tacotron2_vae_torch.serving import vocoders
from tacotron2_vae_torch.serving.synthesizer import Synthesizer
from tacotron2_vae_torch.utils import profiling
from _torch_port_common import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("symbols_embedding_dim=64,encoder_embedding_dim=64,attention_rnn_dim=64,"
        "decoder_rnn_dim=64,prenet_dim=32,attention_dim=32,postnet_embedding_dim=64,"
        "E=64,ref_enc_gru_size=32,z_latent_dim=8,ref_enc_filters=[2,2,4,4,8,8],"
        "attention_location_n_filters=8,compute_dtype='float32'")
TINY_BV = {"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
           "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]], "activation": "snakebeta",
           "snake_logscale": True, "num_mels": 80, "hop_size": 4, "resblock": "1"}
# the app's vocoder: the same blocks at the model's hop of 256 samples
APP_BV = dict(TINY_BV, upsample_rates=[16, 16], upsample_kernel_sizes=[32, 32], hop_size=256)
# the published 22 kHz / 80-band config.json, with some of its training keys
PUBLISHED_BV = dict(TINY_BV, upsample_rates=[4, 4, 2, 2, 2, 2],
                    upsample_kernel_sizes=[8, 8, 4, 4, 4, 4], upsample_initial_channel=1536,
                    resblock_kernel_sizes=[3, 7, 11], resblock_dilation_sizes=[[1, 3, 5]] * 3,
                    hop_size=256, sampling_rate=22050, segment_size=8192,
                    mpd_reshapes=[2, 3, 5, 7, 11])


def checkpoint(cfg: dict, seed: int) -> dict:
    """``{"generator": state_dict}`` in the published layout (the
    reference's ``layout``, from the config alone): weight norm as weight_g
    (a row norm near 0.5; conv_pre's near 1) and weight_v, small biases,
    log-scale alpha and beta, the published filters."""
    g = torch.Generator().manual_seed(seed)
    filt = ref.kaiser_sinc_filter1d(0.25, 0.3, ref.TAPS)
    sd = {}
    for k, s in ref.layout(cfg).items():
        if k.endswith(".filter"):
            sd[k] = filt.clone()
        elif k.endswith((".alpha", ".beta")):
            sd[k] = 0.2 * torch.randn(s, generator=g)
        elif k.endswith(".bias"):
            sd[k] = 0.05 * torch.randn(s, generator=g)
        elif k.endswith(".weight_g"):
            sd[k] = (1.0 if k.startswith("conv_pre.") else 0.5) * (
                1.0 + 0.1 * torch.randn(s, generator=g))
        else:
            sd[k] = torch.randn(s, generator=g)
    return {"generator": sd}


def port_model(cfg: dict, blob: dict) -> BigVGAN:
    model = BigVGAN(BigVGANConfig.from_dict(cfg))
    model.load_state_dict(convert.from_bigvgan_checkpoint(blob))
    return model.eval().requires_grad_(False)


def mel_input(seed: int, B: int = 2, T: int = 9) -> torch.Tensor:
    return torch.randn(B, 80, T, generator=torch.Generator().manual_seed(seed)) - 4.0


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_matches_plain_reference(seed):
    blob = checkpoint(TINY_BV, seed)
    mel = mel_input(seed)
    got = port_model(TINY_BV, blob)(mel)
    want = ref.infer(blob["generator"], TINY_BV, mel)
    assert got.shape == want.shape == (2, 9 * 4)
    assert 0.01 < float(want.std()) and float(want.abs().max()) < 0.999   # neither flat nor clipped
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_planted_fault_snake_without_resampling_is_caught(monkeypatch):
    """The activation without its Up and Down (SnakeBeta alone) moves the
    output far past the comparison's 1e-5."""
    blob = checkpoint(TINY_BV, 0)
    mel = mel_input(0)

    def snake_alone(x, alpha, beta, up_filter, down_filter):
        a, b = torch.exp(alpha)[:, None], torch.exp(beta)[:, None]
        return x + 1.0 / (b + 1e-9) * torch.sin(x * a) ** 2
    monkeypatch.setattr("tacotron2_vae_torch.models.bigvgan.aa_snake", snake_alone)
    got = port_model(TINY_BV, blob)(mel)
    want = ref.infer(blob["generator"], TINY_BV, mel)
    assert float((got - want).abs().max()) > 1e-3


@pytest.mark.parametrize("L", [1, 7, 64])
def test_k9_twin_matches_reference_activation(L):
    g = torch.Generator().manual_seed(L)
    C = 5
    x = 3.0 * torch.randn(2, C, L, generator=g)
    sd = {"a.act.alpha": 0.3 * torch.randn(C, generator=g),
          "a.act.beta": 0.3 * torch.randn(C, generator=g)}
    filt = ref.kaiser_sinc_filter1d(0.25, 0.3, ref.TAPS)
    want = ref.activation1d(x, sd, "a")
    got = k9.aa_snake(x, sd["a.act.alpha"], sd["a.act.beta"], filt, filt)
    assert got.shape == want.shape == (2, C, L)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


def test_benchmark_reference_is_this_reference():
    """The benchmark's plain BigVGAN (what decides its cell's ``correct``
    on the card) is this file's, byte for byte."""
    with open(os.path.join(ROOT, "portbench", "reference", "bigvgan.py"), "rb") as f:
        bench = f.read()
    with open(os.path.join(ROOT, "tests", "_plain_bigvgan.py"), "rb") as f:
        assert bench == f.read()


def test_k9_constants_match_the_source_and_the_filters_the_reference():
    src = open(os.path.join(ROOT, "tacotron2_vae_torch", "csrc", "aa_snake.cu")).read()
    assert int(re.search(r"constexpr int kTaps = (\d+);", src).group(1)) == k9.TAPS
    assert torch.equal(kaiser_sinc_filter1d(0.25, 0.3, 12), ref.kaiser_sinc_filter1d(0.25, 0.3, 12))
    assert abs(float(ref.kaiser_sinc_filter1d(0.25, 0.3, 12).sum()) - 1.0) < 1e-6


def _k9_layout(x, alpha, beta, fu, fd):
    """K9's index plan (``csrc/aa_snake.cu``) in numpy, tile by tile: the x
    tile with its clamped halo in an array of the kernel's shared size,
    chunks of 8 activated samples from 12 loaded x values, the edge samples
    overwritten, 4 outputs a thread from 20 loaded samples at offset 3.
    NaN marks what was never written, so a read outside the plan shows."""
    C, L = x.shape
    src = open(os.path.join(ROOT, "tacotron2_vae_torch", "csrc", "aa_snake.cu")).read()
    T = int(re.search(r"constexpr int kTile = (\d+);", src).group(1))
    n_thr = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    a, ib = np.exp(alpha)[:, None], 1.0 / (np.exp(beta)[:, None] + 1e-9)
    y = np.full((C, L), np.nan)
    for t0 in range(0, L, T):
        nt = min(T, L - t0)
        xs = np.full((C, T + 20), np.nan)
        xs[:, :nt + 16] = x[:, np.clip(t0 - 6 + np.arange(nt + 16), 0, L - 1)]
        sp = np.full((C, 2 * T + 24), np.nan)
        n_s = 2 * nt + 12
        for q in range(-(-n_s // 8)):
            xv = xs[:, 4 * q:4 * q + 12]
            assert xv.shape[1] == 12
            for p in range(4):
                for r, taps, base in ((0, fu[1::2], p + 5), (1, fu[0::2], p + 6)):
                    u = 2 * sum(taps[k] * xv[:, base - k] for k in range(6))
                    sp[:, 3 + 8 * q + 2 * p + r] = u + ib[:, 0] * np.sin(u * a[:, 0]) ** 2
        ss = sp[:, 3:]
        lo, hi = 6 - 2 * t0, 2 * L - 1 - 2 * t0 + 6
        ss[:, :max(lo, 0)] = ss[:, [max(lo, 0)]]
        ss[:, hi + 1:n_s] = ss[:, [min(hi, n_s - 1)]]
        for k0 in range(0, min(nt, 4 * n_thr), 4):
            sv = sp[:, 2 * k0 + 4:2 * k0 + 24]
            assert sv.shape[1] == 20
            for p in range(min(4, nt - k0)):
                y[:, t0 + k0 + p] = sum(fd[j] * sv[:, 2 * p + j] for j in range(12))
    return y


@pytest.mark.parametrize("L", [1, 2, 7, 1023, 1025, 2050])
def test_k9_index_plan_matches_the_twin(L):
    """The kernel's tiles, halos, chunks and edge overwrite, emulated, give
    the twin's outputs at lengths that end a tile early, exactly or one past."""
    g = torch.Generator().manual_seed(L)
    x = 2.0 * torch.randn(1, 3, L, generator=g)
    alpha, beta = 0.3 * torch.randn(3, generator=g), 0.3 * torch.randn(3, generator=g)
    filt = ref.kaiser_sinc_filter1d(0.25, 0.3, ref.TAPS)
    want = k9.aa_snake_plain(x, alpha, beta, filt, filt)[0].double().numpy()
    f = filt.reshape(-1).double().numpy()
    got = _k9_layout(x[0].double().numpy(), alpha.double().numpy(), beta.double().numpy(), f, f)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_published_config_and_size():
    """The published 22 kHz / 80-band config.json (training keys ignored)
    gives ~112 M parameters; a config the port does not take is refused."""
    published = PUBLISHED_BV
    cfg = BigVGANConfig.from_dict(published)
    assert cfg == BigVGANConfig()
    with torch.device("meta"):
        n = sum(p.numel() for p in BigVGAN(cfg).parameters())
    assert 111e6 < n < 113e6
    for bad in ({"activation": "snake"}, {"resblock": "2"}, {"hop_size": 255}):
        with pytest.raises(ValueError):
            BigVGANConfig.from_dict(dict(published, **bad))


@pytest.mark.parametrize("cfg", [PUBLISHED_BV, TINY_BV, APP_BV], ids=["published", "tiny", "app"])
def test_port_holds_the_published_layout(cfg):
    """The port's BigVGAN has the published generator's names, order and
    widths once weight norm is folded: the reference's ``layout`` takes
    them from the config alone, so a wrong width in the port fails here
    and in the load of any checkpoint drawn in that layout."""
    want = {(k[:-len("_v")] if k.endswith(".weight_v") else k): s
            for k, s in ref.layout(cfg).items() if not k.endswith(".weight_g")}
    with torch.device("meta"):
        got = {k: tuple(v.shape) for k, v in
               BigVGAN(BigVGANConfig.from_dict(cfg)).state_dict().items()}
    assert list(got.items()) == list(want.items())


def test_weight_norm_fold_round_trip():
    """``from_bigvgan_checkpoint`` folds weight_g / weight_v as
    ``torch.nn.utils.weight_norm`` computes them (Conv1d: a norm per output
    channel; ConvTranspose1d: per input channel)."""
    torch.manual_seed(0)
    mods = {"conv_pre": torch.nn.Conv1d(6, 4, 7, padding=3),
            "ups.0.0": torch.nn.ConvTranspose1d(4, 2, 4, 2, padding=1)}
    sd, want = {}, {}
    for name, m in mods.items():
        m = torch.nn.utils.weight_norm(m)
        with torch.no_grad():
            m.weight_g.mul_(torch.rand_like(m.weight_g) + 0.5)
            m(torch.randn(1, m.in_channels, 5))              # recompute weight from g and v
        for k, v in m.state_dict().items():
            sd[f"{name}.{k}"] = v
        want[f"{name}.weight"] = m.weight.detach()
    got = convert.from_bigvgan_checkpoint({"generator": sd})
    assert set(got) == {"conv_pre.weight", "conv_pre.bias", "ups.0.0.weight", "ups.0.0.bias"}
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny Tacotron2 and the app's BigVGAN written as checkpoints; a
    Synthesizer that loaded them."""
    tmp = tmp_path_factory.mktemp("port_bigvgan")
    hp = create_hparams(TINY)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    ckpt = tmp / "tacotron2.pt"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    blob = checkpoint(APP_BV, 3)
    voc = tmp / "bigvgan"
    voc.mkdir()
    torch.save(blob, voc / "g_00000000")
    (voc / "config.json").write_text(json.dumps(APP_BV))
    s = Synthesizer(hp, device="cpu")
    with pytest.warns(UserWarning, match="not found"):
        s.load(str(ckpt), str(voc / "g_00000000"), centroid_filelist=str(tmp / "missing.txt"))
    s.hparams = s.hparams.replace(max_decoder_steps=12)   # short decodes for the tests
    return tmp, s, blob, ckpt


def test_load_tells_the_vocoders_apart(served, tmp_path):
    tmp, s, blob, ckpt = served
    assert s.bigvgan is s.vocoder.module and isinstance(s.vocoder, vocoders.BigVGAN)
    assert s.bigvgan.cfg == BigVGANConfig.from_dict(APP_BV)
    # the config inside the checkpoint serves as well as the file beside it
    torch.save(dict(blob, config=APP_BV), tmp_path / "with_config.pt")
    other = Synthesizer(create_hparams(TINY), device="cpu")
    with pytest.warns(UserWarning):
        other.load(str(ckpt), str(tmp_path / "with_config.pt"),
                   centroid_filelist=str(tmp_path / "missing.txt"))
    assert other.bigvgan is not None
    # no config at all is refused, as is a vocoder of another hop
    torch.save(blob, tmp_path / "alone.pt")
    with pytest.raises(ValueError, match="config.json"):
        other.load(str(ckpt), str(tmp_path / "alone.pt"))
    torch.save(dict(blob, config=TINY_BV), tmp_path / "hop4.pt")
    with pytest.raises(ValueError, match="hop"):
        other.load(str(ckpt), str(tmp_path / "hop4.pt"))


def test_vocode_records_its_span_and_counters(served):
    _, s, blob, _ = served
    mel = mel_input(5, B=1, T=70).numpy()
    profiling.start()
    wav = s.vocode(mel)
    rec = profiling.stop()
    assert wav.shape == (70 * 256,)
    spans = [d for d in rec["spans"] if d["name"] == "vocode.bigvgan"]
    assert len(spans) == 1 and spans[0]["frames"] == 128     # padded to the 64-frame bucket
    assert rec["counters"]["bigvgan.audio_samples"] == 70 * 256
    padded = np.pad(mel, ((0, 0), (0, 0), (0, 58)), constant_values=np.log(1e-5))
    want = ref.infer(blob["generator"], APP_BV, torch.from_numpy(padded))[0, :70 * 256]
    np.testing.assert_allclose(wav, want.numpy(), atol=1e-5)


def test_vocode_refuses_a_bigvgan_dtype_other_than_float32(served, monkeypatch):
    """BigVGAN runs in float32 only: a bf16 ``vocoder_dtype`` (WaveGlow's
    option) is refused rather than ignored."""
    _, s, _, _ = served
    monkeypatch.setattr(s, "vocoder_dtype", torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        s.vocode(mel_input(6, B=1, T=8).numpy())


def test_app_serves_bigvgan_wavs(served, tmp_path, monkeypatch):
    """``POST /api`` and ``GET /generate`` through the micro-batcher: the
    reply's samples are the reference's PCM16 on the mel the app vocoded."""
    _, s, blob, _ = served
    vocoded = []
    inner = s.vocode

    def vocode(mel, *args, **kwargs):
        vocoded.append(mel)
        return inner(mel, *args, **kwargs)
    monkeypatch.setattr(s, "vocode", vocode)
    monkeypatch.setattr(app_mod, "synthesizer", s)
    monkeypatch.setattr(app_mod, "_WEB", str(tmp_path / "web"))
    monkeypatch.setattr(app_mod, "_batcher", None)
    srv = app_mod.make_server(0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        body = json.dumps({"text": "안녕하세요.", "neu": 1, "sad": 0, "hap": 0,
                           "ang": 0}).encode()
        req = urllib.request.Request(f"{url}/api", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            replies = [base64.b64decode(json.loads(r.read())["data"])]
        with urllib.request.urlopen(f"{url}/generate?text={quote('반갑습니다.')}&n=1",
                                    timeout=300) as r:
            replies.append(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(vocoded) == 2
    for data, mel in zip(replies, vocoded):
        sr, got = wavfile.read(io.BytesIO(data))
        T = mel.shape[2]
        bucket = -(-T // 64) * 64
        padded = np.pad(mel, ((0, 0), (0, 0), (0, bucket - T)), constant_values=np.log(1e-5))
        wav = ref.infer(blob["generator"], APP_BV, torch.from_numpy(padded))[0, :T * 256]
        want = (wav.numpy() * 32767.0).astype(np.int16)
        assert sr == 16000 and got.dtype == np.int16 and got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1
        assert 0.01 < float(np.abs(got).max()) / 32767.0


@pytest.fixture(scope="module")
def vocoder_paths(served):
    """``Synthesizer.load``'s ``vocoder_path`` of each vocoder: the app's
    BigVGAN, a tiny WaveGlow pickle as ``tools/train_waveglow.py --export``
    writes it (its ``end`` random, so the couplings are not the identity),
    and none for Griffin-Lim."""
    tmp = served[0]
    cfg = wg_model.WaveGlowConfig(n_flows=4, n_group=8, n_early_every=2, n_early_size=2,
                                  n_layers=2, n_channels=8)
    wg = wg_model.init_weights(wg_model.WaveGlow(cfg), torch.Generator().manual_seed(5),
                               end_scale=0.05)
    path = tmp / "waveglow.pkl"
    with open(path, "wb") as f:
        pickle.dump({"waveglow": convert.to_jax_waveglow(wg.state_dict()),
                     "config": dict(cfg.__dict__)}, f)
    return {"waveglow": str(path), "bigvgan": str(tmp / "bigvgan" / "g_00000000"),
            "griffin_lim": None}


def _loaded(served, vocoder_path):
    tmp, _, _, ckpt = served
    s = Synthesizer(create_hparams(TINY), device="cpu")
    with pytest.warns(UserWarning, match="not found"):
        s.load(str(ckpt), vocoder_path, centroid_filelist=str(tmp / "missing.txt"))
    s.hparams = s.hparams.replace(max_decoder_steps=12)
    return s


def _requests(tmp_path, name, n):
    return [("하나둘.", str(tmp_path / f"{name}{i}.wav"), False, None, [1, 0, 0, 0])
            for i in range(n)]


def test_benchmark_contract_with_the_synthesizer(served, vocoder_paths, tmp_path,
                                                 monkeypatch):
    """What the benchmark (``portbench/``) relies on.
    - Wrapping ``synthesize_mel_batch`` and ``vocode`` on the instance sees
      every call ``synthesize_batch`` makes (``serve.py``'s ``Recorder``,
      which wraps ``synthesize_batch`` too; ``control.py``'s
      ``alter_answer``).
    - ``bigvgan`` is the loaded BigVGAN generator and None after a WaveGlow
      or no vocoder (``serve_bigvgan.py``; ``control_bigvgan.py``'s
      ``no_antialias`` patches its modules).
    - ``vocoder_dtype`` reaches WaveGlow's ``infer`` (``serve.py`` sets it;
      ``control.py``'s ``control_vocoder_bf16``).
    - BigVGAN refuses a bfloat16 ``vocoder_dtype`` (``serve_bigvgan.py``
      serves float32 alone)."""
    for kind in ("waveglow", "bigvgan"):
        s = _loaded(served, vocoder_paths[kind])
        calls = []
        inner_mel, inner_voc = s.synthesize_mel_batch, s.vocode

        def mel_batch(texts, styles, inner=inner_mel, calls=calls):
            calls.append("mel")
            return inner(texts, styles)

        def vocode(mel, *args, inner=inner_voc, calls=calls, **kwargs):
            calls.append("vocode")
            return inner(mel, *args, **kwargs)
        monkeypatch.setattr(s, "synthesize_mel_batch", mel_batch)
        monkeypatch.setattr(s, "vocode", vocode)
        s.synthesize_batch(_requests(tmp_path, kind, 2))
        assert calls == ["mel", "vocode", "vocode"], kind
    bv, wg = _loaded(served, vocoder_paths["bigvgan"]), _loaded(served, vocoder_paths["waveglow"])
    assert isinstance(bv.bigvgan, BigVGAN) and bv.bigvgan is bv.vocoder.module
    assert wg.bigvgan is None and _loaded(served, None).bigvgan is None
    dtypes = []
    inner_infer = wg.vocoder.module.infer

    def infer(mel, sigma, generator, dtype, w_inv):
        dtypes.append(dtype)
        return inner_infer(mel, sigma, generator, dtype, w_inv)
    monkeypatch.setattr(wg.vocoder.module, "infer", infer)
    mel = mel_input(7, B=1, T=10).numpy()
    wg.vocoder_dtype = torch.bfloat16
    assert np.isfinite(wg.vocode(mel)).all()
    assert dtypes == [torch.bfloat16]
    bv.vocoder_dtype = torch.bfloat16
    with pytest.raises(ValueError, match="float32"):
        bv.vocode(mel)


@pytest.mark.parametrize("kind,draws", [("waveglow", 1), ("bigvgan", 0), ("griffin_lim", 1)])
def test_vocoder_seed_draws_and_wav_bytes(served, vocoder_paths, tmp_path, monkeypatch, kind,
                                          draws):
    """``synthesize_batch`` writes the bytes of the vocoder's own generator
    called on the postnet mel (padded with log-silence to the 64-frame
    bucket for the neural two) with the seed the Synthesizer's stream gave
    it; after the decode's seed, BigVGAN draws none from the stream,
    WaveGlow and Griffin-Lim one."""
    s = _loaded(served, vocoder_paths[kind])
    seeds, mels = [], []
    inner_seed, inner_mel = s._seed, s.synthesize_mel_batch

    def seed():
        seeds.append(inner_seed())
        return seeds[-1]

    def mel_batch(texts, styles):
        items = inner_mel(texts, styles)
        mels.extend(item[1] for item in items)
        return items
    monkeypatch.setattr(s, "_seed", seed)
    monkeypatch.setattr(s, "synthesize_mel_batch", mel_batch)
    (path,) = s.synthesize_batch(_requests(tmp_path, kind, 1))
    assert len(seeds) == 1 + draws
    (mel,) = mels
    T, hp = mel.shape[2], s.hparams
    padded = torch.from_numpy(np.pad(mel, ((0, 0), (0, 0), (0, -(-T // 64) * 64 - T)),
                                     constant_values=np.log(1e-5)))
    with torch.no_grad():
        if kind == "bigvgan":
            wav = s.vocoder.module(padded)[0, :T * 256]
        elif kind == "waveglow":
            gen = torch.Generator().manual_seed(seeds[1])
            wav = s.vocoder.module.infer(padded, 0.666, gen)[0, :T * 256]
        else:
            fb = s.stft.mel_basis
            mag = torch.clamp(torch.linalg.pinv(fb) @ dynamic_range_decompression(
                torch.from_numpy(mel))[0], min=0.0)
            wav = griffin_lim(mag[None], hp.filter_length, hp.hop_length, hp.win_length,
                              n_iters=30, generator=torch.Generator().manual_seed(seeds[1]))[0]
    assert float(wav.abs().max()) > 1e-3
    save_wav(str(tmp_path / "want.wav"), wav.numpy(), hp.sampling_rate)
    with open(path, "rb") as got, open(tmp_path / "want.wav", "rb") as want:
        assert got.read() == want.read()


def test_serving_imports_no_bigvgan_for_a_waveglow(vocoder_paths):
    """Importing the app and loading a WaveGlow import neither BigVGAN's
    module nor kernel K9's wrapper."""
    code = ("import sys\n"
            "from tacotron2_vae_torch.config import create_hparams\n"
            "from tacotron2_vae_torch.serving import app, vocoders\n"
            "v = vocoders.load_vocoder(sys.argv[1], create_hparams(), 'cpu')\n"
            "assert isinstance(v, vocoders.WaveGlow), v\n"
            "bad = [m for m in sys.modules if m.endswith(('.bigvgan', '.aa_snake'))]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code, vocoder_paths["waveglow"]], cwd=ROOT,
                         env=child_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K9 has no CPU mode")
    return torch.device("cuda")


# (C, L) of each stage of a 9.6 s request (600 frames, padded to 640)
STAGES = [(768, 2560), (384, 10240), (192, 20480), (96, 40960), (48, 81920), (24, 163840)]


@pytest.mark.cuda
@pytest.mark.parametrize("C,L", STAGES + [(5, 1), (5, 7), (5, 64), (3, 1025)])
def test_k9_matches_twin_on_card(cuda_device, C, L):
    g = torch.Generator(device=cuda_device).manual_seed(C * 7 + L)
    x = 2.0 * torch.randn(1, C, L, generator=g, device=cuda_device)
    alpha = 0.3 * torch.randn(C, generator=g, device=cuda_device)
    beta = 0.3 * torch.randn(C, generator=g, device=cuda_device)
    filt = ref.kaiser_sinc_filter1d(0.25, 0.3, ref.TAPS).to(cuda_device)
    n0 = k9.aa_snake.launches
    got = k9.aa_snake(x, alpha, beta, filt, filt)
    torch.cuda.synchronize()
    assert k9.aa_snake.launches == n0 + 1
    want = k9.aa_snake_plain(x, alpha, beta, filt, filt)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-6 * max(scale, 1.0)
    assert math.isfinite(scale)
