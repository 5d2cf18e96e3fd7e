"""Port parity: the log-mel front end (plain rfft path, kernel K2's twin, the
bulk featurizer), Griffin-Lim pieces, and the text front end.

Mel tolerance is atol 1e-4 on log-mel values, as the JAX package's own
Pallas STFT test uses (tests/test_pallas_stft.py:36): a 1024-tap fp32 sum
in another order moves small magnitudes by ~1e-5 relative.  The JAX Pallas
kernel runs in the Pallas interpreter, monkeypatched as that test does.
"""

import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

import tacotron2_vae_tpu.ops.pallas.stft_mel as jsm
from _torch_port_common import n, t
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.dsp import TacotronSTFT as JaxSTFT
from tacotron2_vae_tpu.dsp import invert as jinv
from tacotron2_vae_tpu.text import text_to_sequence as jax_text_to_sequence
from tacotron2_vae_torch.dsp import TacotronSTFT, featurize_wavs_chunked, istft
from tacotron2_vae_torch.dsp import window_sumsquare
from tacotron2_vae_torch.ops import stft_mel as sm
from tacotron2_vae_torch.text import text_to_sequence

ARGS = (1024, 256, 1024, 80, 16000, 0.0, 8000.0)


def _wav(n_samples=9000, seed=0):
    rng = np.random.RandomState(seed)
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(n_samples) / 16000)
         + 0.01 * rng.randn(n_samples))
    return np.clip(x, -1, 1).astype(np.float32)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jsm.pl, "pallas_call", patched)


def test_mel_spectrogram_matches_jax_plain():
    wavs = np.stack([_wav(), _wav(seed=1)])
    want = np.asarray(JaxSTFT(*ARGS, use_pallas=False).mel_spectrogram(wavs))
    got = TacotronSTFT(*ARGS, device="cpu").mel_spectrogram(t(wavs))
    assert got.shape == want.shape == (2, 80, 9000 // 256 + 1)
    np.testing.assert_allclose(n(got), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_samples", [9000, 256 * 7])
def test_kernel_twin_matches_pallas_interpret(interpret_pallas, n_samples):
    wav = _wav(n_samples) if n_samples != 256 * 7 else np.zeros(n_samples, np.float32)
    want = np.asarray(jsm.mel_spectrogram_pallas(wav))
    before = sm.mel_spectrogram_fused.launches
    got = sm.mel_spectrogram_fused(t(wav), 1024, 256, 1024, 80, 16000, 0.0, 8000.0)
    assert got.shape == want.shape == (1, 80, n_samples // 256 + 1)
    np.testing.assert_allclose(n(got), want, atol=1e-4, rtol=0)
    assert sm.mel_spectrogram_fused.launches == before  # CPU tensors never launch


def test_featurize_chunked_matches_per_clip():
    stft = TacotronSTFT(*ARGS, device="cpu")
    clips = [_wav(40000), _wav(5000, seed=2), _wav(700, seed=3)]
    mels = featurize_wavs_chunked(stft, clips, chunk_frames=32, batch_chunks=4)
    for clip, mel in zip(clips, mels):
        ref = n(stft.mel_spectrogram(t(clip)[None]))[0]
        assert mel.shape == ref.shape
        np.testing.assert_allclose(mel, ref, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        featurize_wavs_chunked(stft, [np.zeros(100, np.float32)])


def test_istft_and_window_sumsquare_match_jax():
    rng = np.random.RandomState(0)
    mag = np.abs(rng.randn(2, 513, 12)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 513, 12)).astype(np.float32)
    want = np.asarray(jinv.istft(mag, phase, 1024, 256, 1024))
    np.testing.assert_allclose(n(istft(t(mag), t(phase), 1024, 256, 1024)), want,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(window_sumsquare(12, 1024, 256, 1024),
                               jinv.window_sumsquare(12, 1024, 256, 1024))


@pytest.mark.parametrize("symbol_type", [1, 2, 3, 4])
def test_text_to_sequence_matches(symbol_type):
    for text, cleaners in (("안녕하세요, 반갑습니다! 3개의 사과.", ["korean_cleaners"]),
                           ("Dr. Smith paid $3.50 on Jan 2nd.", ["english_cleaners"])):
        assert (text_to_sequence(text, cleaners, symbol_type=symbol_type)
                == jax_text_to_sequence(text, cleaners, symbol_type=symbol_type))
