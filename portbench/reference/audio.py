"""Waveform -> log-mel: reflect padding of n_fft // 2, a periodic Hann
window, |rfft|, the slaney filterbank (``mel.py``), log with a 1e-5 clamp
(Tacotron2's ``TacotronSTFT``)."""

import numpy as np
import torch
from scipy.io import wavfile

from .mel import mel_filterbank


def read_wav(path: str, max_wav_value: float = 32768.0) -> np.ndarray:
    sr, data = wavfile.read(path)
    if sr != 16000 or data.dtype != np.int16:
        raise ValueError(f"{path}: expected 16 kHz PCM16, got {sr} Hz {data.dtype}")
    return data.astype(np.float32) / max_wav_value


def mel_spectrogram(audio: np.ndarray, hp: dict, device) -> torch.Tensor:
    """(T,) waveform in [-1, 1] -> (n_mel, T // hop + 1) float32."""
    n_fft, hop, win = hp["filter_length"], hp["hop_length"], hp["win_length"]
    y = torch.as_tensor(audio, dtype=torch.float64, device=device)[None, None]
    y = torch.nn.functional.pad(y, (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    n = np.arange(win)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)
    w = np.pad(w, ((n_fft - win) // 2, n_fft - win - (n_fft - win) // 2))
    frames = y.unfold(0, n_fft, hop) * torch.as_tensor(w, device=device)
    mag = torch.fft.rfft(frames, dim=-1).abs().T                    # (n_freq, frames)
    fb = torch.as_tensor(mel_filterbank(hp["sampling_rate"], n_fft, hp["n_mel_channels"],
                                        hp["mel_fmin"], hp["mel_fmax"]), dtype=torch.float64,
                         device=device)
    return torch.log(torch.clamp(fb @ mag, min=1e-5)).float()
