"""STFT -> mel -> log kernel K2 (``csrc/stft_mel.cu``) and its plain twin.

``mel_spectrogram_fused(wav)`` maps one waveform (n,) to its (1, n_mels,
n//hop + 1) log-mel: reflect pad n_fft/2, Hann-windowed 1024/256 frames,
real FFT in full fp32, magnitude, slaney mel filterbank, log(max(x, 1e-5)).
On a CUDA tensor it launches the kernel; on a CPU tensor it runs
``mel_spectrogram_plain`` (the DFT-basis product of the TPU kernel, its
sums in float64).  It counts its kernel launches in
``mel_spectrogram_fused.launches``.  It is safe to call from several
threads (the loader's workers); it keeps no output buffer between calls.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ..dsp.stft import device_tables

# The kernel's layout in csrc/stft_mel.cu (kFrames, kRadix; a CPU test holds
# them to the source): one frame a block, an n_fft/2-point complex FFT in
# radix-4 Stockham stages (one radix-2 stage last when log2(n_fft/2) is odd).
FRAMES_PER_BLOCK = 1
RADIX = 4


def mel_spectrogram_plain(wav, n_fft=1024, hop=256, win_length=1024, n_mels=80,
                          sampling_rate=16000, fmin=0.0, fmax=8000.0):
    """The kernel's function in PyTorch: (n,) -> (1, n_mels, n//hop + 1)."""
    tab = device_tables(str(wav.device), n_fft, win_length, n_mels, sampling_rate, fmin, fmax)
    y = torch.nn.functional.pad(wav.float()[None, None], (n_fft // 2, n_fft // 2),
                                mode="reflect")[0, 0]
    # the DFT sums in float64: in float32 their rounding (2-4e-5 of a
    # low-energy band's log) changes with the BLAS's split of the sums, and
    # the twin would move by that much between machines and thread counts
    frames = (y.unfold(0, n_fft, hop) * tab.window).double()   # (n_frames, n_fft)
    re, im = frames @ tab.cos_b.double(), frames @ tab.sin_b.double()
    mag = torch.sqrt(re * re + im * im).float()         # (n_frames, n_freq)
    mel = mag @ tab.fb.t()
    return torch.log(torch.clamp(mel, min=1e-5)).t()[None]


# The loader's worker threads call the wrapper concurrently: the resolved
# kernel and the launch counter are guarded by one lock.
_lock = threading.Lock()
_fn = None


def _kernel():
    """``t2v_stft_mel`` with its C signature, resolved once."""
    global _fn
    with _lock:
        if _fn is None:
            fn = _build.load("stft_mel").t2v_stft_mel
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            _fn = fn
        return _fn


def mel_spectrogram_fused(wav, n_fft=1024, hop=256, win_length=1024, n_mels=80,
                          sampling_rate=16000, fmin=0.0, fmax=8000.0):
    """(n,) or (1, n) fp32 waveform -> (1, n_mels, n//hop + 1) log-mel."""
    if wav.ndim == 2:
        if wav.shape[0] != 1:
            raise ValueError("mel_spectrogram_fused takes one waveform")
        wav = wav[0]
    if wav.device.type == "cpu":
        return mel_spectrogram_plain(wav, n_fft, hop, win_length, n_mels,
                                     sampling_rate, fmin, fmax)
    if not wav.is_cuda:
        raise ValueError(f"mel_spectrogram_fused runs on CUDA or CPU, not {wav.device}")
    if wav.dtype != torch.float32 or wav.ndim != 1:
        raise ValueError("mel_spectrogram_fused takes a float32 (n,) waveform")
    n = wav.shape[0]
    if n <= n_fft // 2 or n_fft < 4 or n_fft & (n_fft - 1):
        raise ValueError(f"need n > n_fft/2 and n_fft a power of two >= 4 "
                         f"(n={n}, n_fft={n_fft})")
    wav = wav.contiguous()
    tab = device_tables(str(wav.device), n_fft, win_length, n_mels, sampling_rate, fmin, fmax)
    out = torch.empty((n_mels, n // hop + 1), dtype=torch.float32, device=wav.device)
    err = _kernel()(wav.data_ptr(), n, tab.window.data_ptr(), tab.twiddle.data_ptr(),
                    tab.bands.data_ptr(), tab.melw.data_ptr(), tab.melw.numel(),
                    out.data_ptr(), n_fft, hop, n_mels,
                    torch.cuda.current_stream(wav.device).cuda_stream)
    _build.check(err, "t2v_stft_mel")
    with _lock:
        mel_spectrogram_fused.launches += 1
    return out[None]


mel_spectrogram_fused.launches = 0
