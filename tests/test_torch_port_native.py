"""Port parity: the ctypes binding of ``native/dataio.cpp`` (``data/native.py``).

The port's ``load_wav``, ``collate_mels`` and ``collate_text`` are held
against the JAX package's ``data/native.py`` and against scipy / plain
numpy, bit for bit, on the native path (the library the port builds under
``tacotron2_vae_torch/build/``) and on the NumPy path (both bindings with
their library switched off in the test).
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from tacotron2_vae_torch.data import native
from tacotron2_vae_tpu.data import native as jnative
from _torch_port_common import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = np.clip(0.5 * np.sin(2 * np.pi * 440 * np.arange(5000) / 16000)
                + 0.01 * rng.randn(5000), -1, 1)
    path = str(tmp_path_factory.mktemp("wavs") / "clip.wav")
    wavfile.write(path, 16000, (x * 32767).astype(np.int16))
    return path


@pytest.fixture(params=["native", "numpy"])
def path_kind(request, monkeypatch):
    if request.param == "numpy":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_load", lambda: None)
    else:
        assert native.available() and jnative.available()
    return request.param


def _items(seed=0):
    rng = np.random.RandomState(seed)
    mels = [rng.randn(80, t).astype(np.float32) for t in (37, 12, 64, 5)]
    seqs = [rng.randint(1, 60, n).astype(np.int32) for n in (9, 30, 1, 17)]
    return mels, seqs


def test_port_builds_under_its_own_directory():
    assert native.available()
    so = native._so_path()
    assert so.startswith(os.path.join(ROOT, "tacotron2_vae_torch", "build") + os.sep)
    assert os.path.exists(so)


def test_load_wav_matches_jax_and_scipy(wav_file, path_kind):
    got, sr = native.load_wav(wav_file, scale=32768.0)
    want, jsr = jnative.load_wav(wav_file, scale=32768.0)
    sr_ref, ref = wavfile.read(wav_file)
    assert sr == jsr == sr_ref == 16000
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.astype(np.float32) / np.float32(32768.0))


def test_collate_mels_matches_jax_and_numpy(path_kind):
    mels, _ = _items()
    t_max = 72
    mel, gate, lengths = native.collate_mels(mels, t_max)
    for got, want in zip((mel, gate, lengths), jnative.collate_mels(mels, t_max)):
        np.testing.assert_array_equal(got, want)
    ref_mel = np.zeros((4, 80, t_max), np.float32)
    ref_gate = np.zeros((4, t_max), np.float32)
    for i, m in enumerate(mels):
        ref_mel[i, :, :m.shape[1]] = m
        ref_gate[i, m.shape[1] - 1:] = 1.0
    np.testing.assert_array_equal(mel, ref_mel)
    np.testing.assert_array_equal(gate, ref_gate)
    np.testing.assert_array_equal(lengths, [37, 12, 64, 5])


def test_collate_text_matches_jax_and_numpy(path_kind):
    _, seqs = _items()
    out, lengths = native.collate_text(seqs, 32)
    want, wlen = jnative.collate_text(seqs, 32)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(lengths, wlen)
    ref = np.zeros((4, 32), np.int32)
    for i, s in enumerate(seqs):
        ref[i, :len(s)] = s
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32
