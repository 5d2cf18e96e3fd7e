"""STFT / log-mel front end in PyTorch.

Counterpart of the JAX package's ``dsp/stft.py``: reflect padding of
n_fft//2, periodic Hann window, magnitude spectrum, slaney mel filterbank,
log compression with a 1e-5 clamp.  ``TacotronSTFT.mel_spectrogram`` routes
a single waveform on a CUDA tensor to kernel K2 (``ops/stft_mel``), as the
JAX package routes B=1 to its Pallas kernel on a TPU; batches and CPU
tensors take the ``torch.fft.rfft`` path.  The bulk featurizer uses the
DFT-basis product on host-padded rows.
"""

from __future__ import annotations

import threading
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .mel import mel_filterbank


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window, zero-padded to n_fft (centred)."""
    n = np.arange(win_length)
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    if n_fft > win_length:
        pad = (n_fft - win_length) // 2
        win = np.pad(win, (pad, n_fft - win_length - pad))
    return win


class Tables(NamedTuple):
    """Constant tables of the log-mel front end (numpy on the host,
    tensors from ``device_tables``)."""
    window: object   # (n_fft,) f32 periodic Hann, centred
    twiddle: object  # (n_fft, 2) f32: exp(-2 pi i k / n_fft) from float64, K2's FFT
    cos_b: object    # (n_fft, n_freq) f32 DFT bases of the plain twin
    sin_b: object
    fb: object       # (n_mels, n_freq) f32 slaney mel filterbank
    bands: object    # (n_mels, 3) int32: [start, end) of each band's nonzero bins, offset in melw
    melw: object     # (nnz,) f32: the bands' weights, packed band after band


def mel_bands(fb: np.ndarray):
    """The filterbank as K2 reads it: per band the [start, end) of its
    nonzero bins and the offset of its weights in a packed array, and that
    array (each band's fb[b, start:end] in turn)."""
    bands = np.zeros((fb.shape[0], 3), np.int32)
    parts, off = [], 0
    for b, row in enumerate(fb):
        nz = np.flatnonzero(row)
        start, end = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        bands[b] = (start, end, off)
        parts.append(row[start:end])
        off += end - start
    return bands, np.concatenate(parts).astype(np.float32)


@lru_cache(maxsize=8)
def _tables(n_fft, win_length, n_mels, sampling_rate, fmin, fmax) -> Tables:
    """The front end's host tables, numpy (see ``Tables``)."""
    m = np.arange(n_fft)
    w = np.exp(-2j * np.pi * m / n_fft)
    twiddle = np.stack([w.real, w.imag], axis=1).astype(np.float32)
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * m[:, None] / n_fft
    fb = mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)
    return Tables(padded_window(win_length, n_fft), twiddle, np.cos(ang).astype(np.float32),
                  (-np.sin(ang)).astype(np.float32), fb, *mel_bands(fb))


@lru_cache(maxsize=8)
def _device_tables(device: str, *key) -> Tables:
    return Tables(*(torch.from_numpy(t).to(device) for t in _tables(*key)))


_tables_lock = threading.Lock()


def device_tables(device: str, *key) -> Tables:
    """``_tables`` as tensors on ``device`` (cached; built once when several
    threads ask at once)."""
    with _tables_lock:
        return _device_tables(device, *key)


def frame_signal(y, n_fft: int, hop_length: int):
    """Reflect-pad and frame: (B, T) -> (B, T//hop + 1, n_fft)."""
    pad = n_fft // 2
    y = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(1, n_fft, hop_length)


def stft_complex(y, n_fft: int, hop_length: int, win_length: int):
    """(B, T) -> complex spectrum (B, 1 + n_fft//2, n_frames)."""
    window = torch.from_numpy(padded_window(win_length, n_fft)).to(y.device)
    frames = frame_signal(y.float(), n_fft, hop_length) * window
    return torch.fft.rfft(frames, dim=-1).transpose(1, 2)


def stft_magnitude(y, n_fft: int, hop_length: int, win_length: int):
    """Magnitude STFT: (B, T) -> (B, 1 + n_fft//2, n_frames)."""
    return stft_complex(y, n_fft, hop_length, win_length).abs()


def dynamic_range_compression(x, C: float = 1.0, clip_val: float = 1e-5):
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x, C: float = 1.0):
    return torch.exp(x) / C


class TacotronSTFT:
    """Waveform -> log-mel spectrogram (reference layers.py:54-92 API).

    Runs on the card by default (``device=None`` is ``"cuda"``) and raises
    without one unless ``device="cpu"`` is passed."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0, device=None):
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TacotronSTFT runs on a CUDA card and none is "
                               "available; pass device='cpu' to run on the CPU")
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        self.mel_fmin = mel_fmin
        self.mel_fmax = mel_fmax
        self.mel_basis = torch.from_numpy(mel_filterbank(
            sampling_rate, filter_length, n_mel_channels, mel_fmin, mel_fmax
        )).to(self.device)

    def _key(self):
        return (self.filter_length, self.win_length, self.n_mel_channels,
                self.sampling_rate, self.mel_fmin, self.mel_fmax)

    def mel_spectrogram(self, y):
        """(B, T) or (T,) waveform in [-1, 1] -> (B, n_mels, T//hop + 1)."""
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        if y.ndim == 1:
            y = y[None]
        if y.is_cuda and y.shape[0] == 1:
            from ..ops.stft_mel import mel_spectrogram_fused

            return mel_spectrogram_fused(
                y[0], self.filter_length, self.hop_length, self.win_length,
                self.n_mel_channels, self.sampling_rate, self.mel_fmin, self.mel_fmax)
        mag = stft_magnitude(y, self.filter_length, self.hop_length, self.win_length)
        return dynamic_range_compression(torch.matmul(self.mel_basis, mag))

    def mel_spectrogram_prepadded(self, y):
        """Bulk path: (B, T + n_fft) host-padded rows (each with its own
        reflect padding, then zero extension) -> (B, n_mels, frames); the
        caller trims each item to its own frame count."""
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        tab = device_tables(str(self.device), *self._key())
        frames = y.unfold(1, self.filter_length, self.hop_length) * tab.window
        re, im = frames @ tab.cos_b, frames @ tab.sin_b
        mag = torch.sqrt(re * re + im * im).transpose(1, 2)  # (B, F, T)
        return dynamic_range_compression(torch.matmul(tab.fb, mag))


def featurize_wavs_chunked(stft: TacotronSTFT, audios, chunk_frames: int = 128,
                           batch_chunks: int = 64):
    """Log-mels for variable-length waveforms through fixed-shape chunk
    batches: each waveform is reflect-padded with its own boundary, cut into
    overlapping chunks of ``chunk_frames`` frames, and ``batch_chunks``
    chunks are featurized per call.  Returns a list of (n_mels, n_frames)
    numpy arrays, equal to the per-clip ``mel_spectrogram``."""
    n_fft, hop = stft.filter_length, stft.hop_length
    pad = n_fft // 2
    stride = chunk_frames * hop
    width = (chunk_frames - 1) * hop + n_fft
    rows, meta, counts = [], [], []
    for i, audio in enumerate(audios):
        audio = np.asarray(audio, np.float32)
        if len(audio) <= pad:
            raise ValueError(f"waveform {i} shorter than n_fft//2 = {pad} samples")
        padded = np.pad(audio, pad, mode="reflect")
        n_frames = (len(audio) + 2 * pad - n_fft) // hop + 1
        n_chunks = -(-n_frames // chunk_frames)
        need = (n_chunks - 1) * stride + width
        if need > len(padded):
            padded = np.pad(padded, (0, need - len(padded)))
        counts.append((n_frames, n_chunks))
        for c in range(n_chunks):
            rows.append(padded[c * stride: c * stride + width])
            meta.append((i, c))
    parts = {}
    for b in range(0, len(rows), batch_chunks):
        buf = np.zeros((batch_chunks, width), np.float32)
        take = rows[b: b + batch_chunks]
        buf[: len(take)] = take
        mels = stft.mel_spectrogram_prepadded(buf).cpu().numpy()
        for j, (i, c) in enumerate(meta[b: b + batch_chunks]):
            parts.setdefault(i, {})[c] = mels[j]
    return [np.concatenate([parts[i][c] for c in range(n_chunks)], axis=1)[:, :n_frames]
            for i, (n_frames, n_chunks) in enumerate(counts)]
