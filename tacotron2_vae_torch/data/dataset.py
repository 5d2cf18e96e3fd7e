"""Training data: filelists, text and mel featurisation, collate, batching.

Counterpart of the JAX package's ``data/dataset.py`` (reference
``TextMelLoader`` / ``TextMelCollate``, data_utils.py:11-137): the
``path|text|speaker|emotion`` filelist, the deterministic shuffle (seed
1234), one-hot speaker and emotion vectors, gate targets of 1 from the last
real frame on, and batches padded to bucketed lengths.  Mels come from the
port's ``TacotronSTFT`` on the trainer's device, so on the card a clip is
featurised by kernel K2; they are cached as ``.npy`` beside the wav, and
``warm_mel_cache`` featurises every un-cached clip in fixed-shape chunk
batches first.  Wavs are read and batches collated by the ctypes binding
of ``native/dataio.cpp`` (``data/native.py``, NumPy when it cannot be
built); a pool of ``num_workers`` threads assembles batches
(``data/prefetch.py``); ``shard=(rank, world)`` gives each rank of a
data-parallel run its disjoint slice of every epoch.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np
import torch

from ..dsp import TacotronSTFT, featurize_wavs_chunked
from ..text import text_to_sequence
from . import native
from .prefetch import prefetch_map


_streams = threading.local()


@contextlib.contextmanager
def _own_stream(device):
    """On a card, run the enclosed work on a CUDA stream of the calling
    thread's own: a worker's featurisation (kernel K2) and its copy back
    then wait for nothing the training thread has queued."""
    if device.type != "cuda":
        yield
        return
    stream = getattr(_streams, "stream", None)
    if stream is None:
        stream = _streams.stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        yield


def load_filepaths_and_text(filename: str, split: str = "|") -> List[List[str]]:
    """Parse a filelist (reference utils.py:21-24)."""
    with open(filename, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class Batch:
    """A padded training batch (numpy, host side)."""

    text: np.ndarray            # (B, S) int32
    input_lengths: np.ndarray   # (B,) int32
    mel: np.ndarray             # (B, n_mel, T) float32
    gate: np.ndarray            # (B, T) float32
    output_lengths: np.ndarray  # (B,) int32
    speakers: np.ndarray        # (B, n_speakers) float32
    emotions: np.ndarray        # (B, n_emotions) float32

    def asdict(self) -> dict:
        return dict(self.__dict__)


class TextMelDataset:
    """(tokens, mel, speaker one-hot, emotion one-hot) items of a filelist;
    ``device`` is where mels are featurised (None: the card)."""

    def __init__(self, filelist_path: str, hp, shuffle: bool = True, device=None):
        self.hp = hp
        self.entries = load_filepaths_and_text(filelist_path)
        self.text_cleaners = list(hp.text_cleaners)
        self.stft = TacotronSTFT(hp.filter_length, hp.hop_length, hp.win_length,
                                 hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                                 hp.mel_fmax, device=device)
        self.mel_cache = getattr(hp, "mel_cache", True)
        self._cache_tag = (f"mel{hp.n_mel_channels}_{hp.filter_length}_{hp.hop_length}_"
                           f"{hp.win_length}_{hp.sampling_rate}_{hp.mel_fmin:g}_{hp.mel_fmax:g}")
        if shuffle:
            random.Random(hp.seed).shuffle(self.entries)
        self._static: dict = {}
        self._mel_lengths = None

    def __len__(self) -> int:
        return len(self.entries)

    def get_text(self, text: str) -> np.ndarray:
        return np.asarray(text_to_sequence(text, self.text_cleaners,
                                           symbol_type=getattr(self.hp, "symbol_type", 1)),
                          dtype=np.int32)

    def mel_cache_path(self, audiopath: str) -> str:
        """Cache file beside the wav; the name carries the STFT config and
        the wav's (mtime, size), so an edited wav never reads a stale mel."""
        try:
            st = os.stat(audiopath)
            src = f"{st.st_mtime_ns:x}{st.st_size:x}"
        except OSError:
            src = "nosrc"
        return f"{audiopath}.{self._cache_tag}.{src}.npy"

    def _load_audio(self, path: str) -> np.ndarray:
        audio, sr = native.load_wav(path, scale=self.hp.max_wav_value)
        if sr != self.hp.sampling_rate:
            raise ValueError(f"{sr} SR doesn't match target {self.hp.sampling_rate} SR")
        return audio

    @staticmethod
    def _save(cache: str, mel: np.ndarray) -> bool:
        tmp = f"{cache}.{os.getpid()}.tmp.npy"
        try:
            np.save(tmp, mel)
            os.replace(tmp, cache)
            return True
        except OSError:
            return False  # read-only corpus: the cache is best-effort

    def get_mel(self, audiopath: str) -> np.ndarray:
        """wav -> (n_mel, T) log-mel (``load_mel_from_disk``: the .npy)."""
        hp = self.hp
        if hp.load_mel_from_disk:
            mel = np.load(audiopath)
            if mel.shape[0] != hp.n_mel_channels:
                raise ValueError(f"Mel dim mismatch: {mel.shape[0]} != {hp.n_mel_channels}")
            return mel.astype(np.float32)
        cache = self.mel_cache_path(audiopath) if self.mel_cache else None
        if cache and os.path.exists(cache):
            return np.load(cache)
        audio = self._load_audio(audiopath)
        with _own_stream(self.stft.device):
            mel = self.stft.mel_spectrogram(audio[None])[0].cpu().numpy().astype(np.float32)
        if cache:
            self._save(cache, mel)
        return mel

    def warm_mel_cache(self, chunk_frames: int = 128, batch_chunks: int = 64,
                       shard: tuple[int, int] = (0, 1)) -> int:
        """Featurise every un-cached wav in fixed-shape chunk batches
        (``dsp.featurize_wavs_chunked``); returns the number of mels written.
        ``shard=(rank, world)`` takes the rank's slice ``[rank::world]`` of
        the stable entry list, so the ranks of a data-parallel run featurise
        a shared corpus once between them."""
        if self.hp.load_mel_from_disk or not self.mel_cache:
            return 0
        rank, world = shard
        todo = [p for p in [e[0] for e in self.entries][rank::world]
                if not os.path.exists(self.mel_cache_path(p))]
        pad = self.hp.filter_length // 2
        paths, audios = [], []
        for path in todo:
            audio = self._load_audio(path)
            if len(audio) > pad:  # shorter clips take get_mel's path
                paths.append(path)
                audios.append(audio)
        written = 0
        window = 64
        for i in range(0, len(audios), window):
            mels = featurize_wavs_chunked(self.stft, audios[i:i + window],
                                          chunk_frames=chunk_frames, batch_chunks=batch_chunks)
            for path, mel in zip(paths[i:i + window], mels):
                written += self._save(self.mel_cache_path(path), mel.astype(np.float32))
        return written

    def mel_lengths(self) -> np.ndarray:
        """Per-entry mel frame counts from the wav headers (samples // hop + 1)
        or the .npy headers; no decode."""
        if self._mel_lengths is None:
            if self.hp.load_mel_from_disk:
                lens = [int(np.load(e[0], mmap_mode="r").shape[1]) for e in self.entries]
            else:
                import wave

                lens = []
                for e in self.entries:
                    with wave.open(e[0], "rb") as w:
                        lens.append(w.getnframes() // self.hp.hop_length + 1)
            self._mel_lengths = np.asarray(lens, np.int64)
        return self._mel_lengths

    def max_lengths(self) -> tuple[int, int]:
        """(longest token sequence, most mel frames) over the filelist, from
        token counts and ``mel_lengths`` only; ``fixed_batch_shapes`` pads
        every batch to these, rounded to the buckets."""
        max_s = max(len(self.get_text(e[1])) for e in self.entries)
        return max_s, int(self.mel_lengths().max())

    @staticmethod
    def get_onehot(index: str, n: int) -> np.ndarray:
        v = np.zeros(n, np.float32)
        v[int(index)] = 1.0
        return v

    def __getitem__(self, idx: int):
        audiopath, text, speaker, emotion = self.entries[idx][:4]
        if idx not in self._static:
            self._static[idx] = (self.get_text(text),
                                 self.get_onehot(speaker, self.hp.n_speakers),
                                 self.get_onehot(emotion, self.hp.n_emotions))
        tokens, spk, emo = self._static[idx]
        return tokens, self.get_mel(audiopath), spk, emo


def collate(items: Sequence[tuple], n_frames_per_step: int = 1, text_bucket: int = 1,
            mel_bucket: int = 1, fixed_text_len: int | None = None,
            fixed_mel_len: int | None = None) -> Batch:
    """Sort by text length (descending), pad text and mels to bucket
    multiples (or fixed lengths) and the mel length to a multiple of r."""
    order = np.argsort([-len(it[0]) for it in items], kind="stable")
    items = [items[i] for i in order]
    max_s = fixed_text_len or _round_up(max(len(it[0]) for it in items), text_bucket)
    max_t = fixed_mel_len or _round_up(max(it[1].shape[1] for it in items), mel_bucket)
    max_t = _round_up(max_t, n_frames_per_step)
    text, input_lengths = native.collate_text([it[0] for it in items], max_s)
    mel, gate, output_lengths = native.collate_mels([it[1] for it in items], max_t)
    return Batch(text, input_lengths, mel, gate, output_lengths,
                 np.stack([it[2] for it in items]).astype(np.float32),
                 np.stack([it[3] for it in items]).astype(np.float32))


class DataLoader:
    """Deterministic batch iterator: per-epoch shuffle, ``drop_last``,
    length-pooled batches (``sort_by_length``), bucketed padding, batches
    assembled by ``num_workers`` threads.  With ``shard=(rank, world)``
    each rank takes the slice ``[rank::world]`` of every epoch's
    permutation, and every rank yields the same number of batches
    (``len(dataset) // world // batch_size``), so no rank waits in a
    collective for a step the others never take."""

    def __init__(self, dataset: TextMelDataset, batch_size: int, hp, shuffle: bool = True,
                 drop_last: bool = True, shard: tuple[int, int] = (0, 1),
                 seed: int | None = None, fixed_lengths: tuple[int, int] | None = None,
                 num_workers: int | None = None):
        self.ds, self.batch_size, self.hp = dataset, batch_size, hp
        self.shuffle, self.drop_last = shuffle, drop_last
        self.rank, self.world = shard
        if not 0 <= self.rank < self.world:
            raise ValueError(f"shard {shard} is not (rank, world) with 0 <= rank < world")
        self.seed = hp.seed if seed is None else seed
        self.fixed_lengths = fixed_lengths
        self.num_workers = hp.num_workers if num_workers is None else num_workers
        self._warmed = False

    def __len__(self) -> int:
        n = len(self.ds) // self.world
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _make_batch(self, chunk) -> Batch:
        fixed_s, fixed_t = self.fixed_lengths or (None, None)
        return collate([self.ds[int(i)] for i in chunk], self.hp.n_frames_per_step,
                       text_bucket=self.hp.text_bucket_size,
                       mel_bucket=self.hp.mel_bucket_size,
                       fixed_text_len=fixed_s, fixed_mel_len=fixed_t)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        if not self._warmed:
            self.ds.warm_mel_cache(shard=(self.rank, self.world))
            self._warmed = True
        idx = np.arange(len(self.ds))
        rng = np.random.RandomState(self.seed + epoch_idx)
        if self.shuffle:
            rng.shuffle(idx)
        idx = idx[self.rank::self.world]
        if self.drop_last:
            # the rank-invariant count: low ranks hold one more item when
            # len % world != 0, and it is dropped here, before pooling
            idx = idx[:len(self) * self.batch_size]
        if getattr(self.hp, "sort_by_length", False):
            # within pools of 8 batches of this rank's slice, sort by mel
            # length so each batch pads to near its own maximum
            lens = self.ds.mel_lengths()
            pool = self.batch_size * 8
            parts = [p[np.argsort(lens[p], kind="stable")]
                     for p in (idx[i:i + pool] for i in range(0, len(idx), pool))]
            idx = np.concatenate(parts) if parts else idx
        chunks = [idx[b * self.batch_size:(b + 1) * self.batch_size] for b in range(len(self))]
        chunks = [c for c in chunks if len(c)]
        if getattr(self.hp, "sort_by_length", False) and self.shuffle:
            rng.shuffle(chunks)
        if self.num_workers > 1 and len(chunks) > 1:
            yield from prefetch_map(self._make_batch, chunks, workers=self.num_workers)
        else:
            for chunk in chunks:
                yield self._make_batch(chunk)
