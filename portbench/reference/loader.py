"""The training loader's batches, worked out again: Tacotron2's
``TextMelDataset`` order (the filelist shuffled once by Python's
``random.Random(seed)``), each epoch's permutation from
``np.random.RandomState(seed + epoch)``, the last partial batch dropped,
each batch sorted by text length (longest first, stable), text padded
with zeros to a multiple of ``text_bucket_size``, mels with zeros to a
multiple of ``mel_bucket_size``, gate targets 1 from each item's last
frame on."""

from __future__ import annotations

import random

import numpy as np
import torch

from . import audio
from .text import text_to_sequence


def read_filelist(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split("|") for line in f if line.strip()]


def shuffled_entries(entries: list, seed: int) -> list:
    entries = list(entries)
    random.Random(seed).shuffle(entries)
    return entries


def epoch_chunks(n_items: int, batch_size: int, seed: int, epoch: int) -> list:
    """Item indices (into the shuffled entries) of every batch of an epoch."""
    idx = np.arange(n_items)
    np.random.RandomState(seed + epoch).shuffle(idx)
    n_batches = n_items // batch_size
    return [idx[b * batch_size:(b + 1) * batch_size] for b in range(n_batches)]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def batch_shape(tokens_len: list, frames: list, hp: dict) -> tuple:
    """(B, S, T) of a batch of items with these token and frame counts."""
    S = _round_up(max(tokens_len), hp["text_bucket_size"])
    T = _round_up(_round_up(max(frames), hp["mel_bucket_size"]), hp["n_frames_per_step"])
    return len(tokens_len), S, T


def tokens(text: str, hp: dict) -> np.ndarray:
    return np.asarray(text_to_sequence(text, list(hp["text_cleaners"]),
                                       symbol_type=hp["symbol_type"]), np.int64)


def make_batch(items: list, hp: dict, device) -> dict:
    """items: (path, text) pairs -> the collated batch as tensors."""
    seqs = [tokens(t, hp) for _, t in items]
    mels = [audio.mel_spectrogram(audio.read_wav(p, hp["max_wav_value"]), hp, device)
            for p, _ in items]
    order = np.argsort([-len(s) for s in seqs], kind="stable")
    seqs, mels = [seqs[i] for i in order], [mels[i] for i in order]
    B, S, T = batch_shape([len(s) for s in seqs], [m.shape[1] for m in mels], hp)
    text = torch.zeros(B, S, dtype=torch.long)
    mel = torch.zeros(B, hp["n_mel_channels"], T, device=device)
    gate = torch.zeros(B, T, device=device)
    for i, (s, m) in enumerate(zip(seqs, mels)):
        text[i, :len(s)] = torch.from_numpy(s)
        mel[i, :, :m.shape[1]] = m
        gate[i, m.shape[1] - 1:] = 1.0
    return {"text": text.to(device), "input_lengths": torch.tensor([len(s) for s in seqs],
                                                                   device=device),
            "mel": mel, "gate": gate,
            "output_lengths": torch.tensor([m.shape[1] for m in mels], device=device)}
