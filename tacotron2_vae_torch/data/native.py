"""ctypes binding of the native data-IO core (``native/dataio.cpp``).

The port's copy of the JAX package's ``data/native.py``: the same entry
points and the same pure-NumPy fallbacks.  The library is compiled with
``g++`` at first use into ``tacotron2_vae_torch/build/`` (the file name
carries a hash of the source, so an edited source is rebuilt);
``available()`` says whether the native path is active.  The wav reader and
both collates release the GIL, so the loader's worker threads run them in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "dataio.cpp")
BUILD = os.path.join(_PKG, "build")

_lib = None
_lock = threading.Lock()
_tried = False


def _so_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD, f"libdataio_{digest}.so")


def _compile(so: str) -> None:
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, SOURCE],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(SOURCE):
            return None
        so = _so_path()
        try:
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError):
            return None
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.wav_info.argtypes = [ctypes.c_char_p, i64p, i32p]
        lib.wav_read.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_float]
        lib.collate_mels.argtypes = [f32p, i64p, i32p, ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, f32p, f32p]
        lib.collate_text.argtypes = [i32p, i64p, i32p, ctypes.c_int32, ctypes.c_int32, i32p]
        for fn in (lib.wav_info, lib.wav_read, lib.collate_mels, lib.collate_text):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_wav(path: str, scale: float = 1.0):
    """Read a PCM16 wav -> (float32 samples divided by ``scale``, sample rate).

    Falls back to scipy when the library is unavailable or the file is not
    plain PCM16."""
    lib = _load()
    if lib is not None:
        n, sr = ctypes.c_int64(), ctypes.c_int32()
        if lib.wav_info(path.encode(), ctypes.byref(n), ctypes.byref(sr)) == 0:
            out = np.empty(n.value, np.float32)
            if lib.wav_read(path.encode(), _ptr(out, ctypes.c_float), n.value,
                            ctypes.c_float(scale)) == 0:
                return out, int(sr.value)
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    return data.astype(np.float32) / (scale or 1.0), int(sr)


def collate_mels(mels: list[np.ndarray], t_max: int):
    """[(n_mel, T_i) float32] -> (mel (B, n_mel, t_max), gate (B, t_max),
    lengths); gate targets are 1 from each item's last real frame on."""
    B, n_mel = len(mels), mels[0].shape[0]
    lengths = np.asarray([m.shape[1] for m in mels], np.int32)
    mel_out = np.empty((B, n_mel, t_max), np.float32)
    gate_out = np.empty((B, t_max), np.float32)
    lib = _load()
    if lib is not None:
        flat = np.concatenate([np.ascontiguousarray(m, np.float32).reshape(-1) for m in mels])
        offsets = np.zeros(B, np.int64)
        np.cumsum([m.size for m in mels[:-1]], out=offsets[1:])
        if lib.collate_mels(_ptr(flat, ctypes.c_float), _ptr(offsets, ctypes.c_int64),
                            _ptr(lengths, ctypes.c_int32), B, n_mel, t_max,
                            _ptr(mel_out, ctypes.c_float), _ptr(gate_out, ctypes.c_float)) == 0:
            return mel_out, gate_out, lengths
    mel_out[:] = 0.0
    gate_out[:] = 0.0
    for i, m in enumerate(mels):
        mel_out[i, :, :m.shape[1]] = m
        gate_out[i, m.shape[1] - 1:] = 1.0
    return mel_out, gate_out, lengths


def collate_text(seqs: list[np.ndarray], s_max: int):
    """[(S_i,) int32] -> ((B, s_max) zero-padded, lengths)."""
    B = len(seqs)
    lengths = np.asarray([len(s) for s in seqs], np.int32)
    out = np.empty((B, s_max), np.int32)
    lib = _load()
    if lib is not None:
        flat = np.concatenate([np.ascontiguousarray(s, np.int32) for s in seqs])
        offsets = np.zeros(B, np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        if lib.collate_text(_ptr(flat, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
                            _ptr(lengths, ctypes.c_int32), B, s_max,
                            _ptr(out, ctypes.c_int32)) == 0:
            return out, lengths
    out[:] = 0
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lengths
