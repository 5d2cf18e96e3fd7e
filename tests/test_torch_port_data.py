"""Port parity: the training data loaders against the JAX package's.

The port's ``training.train.prepare_dataloaders`` and the JAX one are built
on one tiny corpus (6 clips of 0.3-1.6 s, batch 2, text buckets of 32 and
mel buckets of 64) with ``fixed_batch_shapes`` off and on.  With it on,
every train batch pads to the corpus maxima rounded to the buckets, so
the JAX trainer sees one shape, (2, 80, 128); without the flag honoured the
port would hand out (2, 80, 64) for a batch of short clips, and both losses
average over the padded frames.  Every batch of epochs 0 and 1, train and
validation, must have the same shapes and contents on both sides: text,
lengths, gate targets and one-hots exactly; mels exactly when they load
from ``.npy`` (``load_mel_from_disk``), and within atol 1e-4 when each side
featurises the wavs with its own STFT (tests/test_torch_port_dsp.py: a
1024-tap float32 sum in another order).  The two sides read separate
copies of the corpus, so neither reads the other's mel cache.
"""

import os
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from tacotron2_vae_tpu.config import create_hparams as jax_hparams
from tacotron2_vae_tpu.data import dataset as jds
from tacotron2_vae_tpu.training import train as jtr
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.data import dataset as ds
from tacotron2_vae_torch.training import train as tr
from _torch_port_common import one_thread  # noqa: F401 (autouse)

TEXTS = ["안녕하세요.", "감사합니다, 또 만나요.", "반갑습니다.",
         "오늘은 날씨가 참 좋네요.", "내일 다시 만나요.", "네."]
SECONDS = (0.3, 1.6, 0.5, 1.2, 0.8, 0.4)
MEL_ATOL = {"npy": 0.0, "wav": 1e-4}


def _write_corpus(root, source):
    """train.txt (the 6 clips) and val.txt (3 of them) under ``root``:
    16 kHz wavs, or their log-mels as ``.npy`` (n_mel, T)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    lines = []
    for i, (text, sec) in enumerate(zip(TEXTS, SECONDS)):
        n = int(16000 * sec)
        x = (0.3 * np.sin(2 * np.pi * (160 + 30 * i) * np.arange(n) / 16000)
             + 0.01 * rng.randn(n))
        if source == "wav":
            path = os.path.join(root, f"clip{i}.wav")
            wavfile.write(path, 16000, (x * 32767).astype(np.int16))
        else:
            path = os.path.join(root, f"clip{i}.npy")
            np.save(path, (rng.randn(80, n // 256 + 1) - 4).astype(np.float32))
        lines.append(f"{path}|{text}|0|{i % 4}\n")
    paths = {}
    for name, chosen in (("train", lines), ("val", lines[1::2])):
        paths[name] = os.path.join(root, f"{name}.txt")
        with open(paths[name], "w", encoding="utf-8") as f:
            f.writelines(chosen)
    return paths


def _hparams(root, source, fixed):
    paths = _write_corpus(root, source)
    return (f"training_files='{paths['train']}',validation_files='{paths['val']}',"
            f"batch_size=2,load_mel_from_disk={source == 'npy'},fixed_batch_shapes={fixed}")


def _batches(loader, epoch):
    return [b.asdict() for b in loader.epoch(epoch)]


@pytest.mark.parametrize("fixed", [False, True], ids=["bucketed", "fixed"])
@pytest.mark.parametrize("source", ["npy", "wav"])
def test_loaders_match_jax(tmp_path, source, fixed):
    hp = create_hparams(_hparams(str(tmp_path / "port"), source, fixed))
    hpj = jax_hparams(_hparams(str(tmp_path / "jax"), source, fixed))
    got = tr.prepare_dataloaders(hp, "cpu")
    want = jtr.prepare_dataloaders(hpj)
    shapes = set()
    for split, g_loader, w_loader in zip(("train", "val"), got, want):
        assert len(g_loader) == len(w_loader)
        for epoch in (0, 1):
            g_batches, w_batches = _batches(g_loader, epoch), _batches(w_loader, epoch)
            assert len(g_batches) == len(w_batches) == len(w_loader)
            for i, (g, w) in enumerate(zip(g_batches, w_batches)):
                where = f"{split} epoch {epoch} batch {i}"
                assert {k: v.shape for k, v in g.items()} == \
                    {k: v.shape for k, v in w.items()}, where
                for k in w:
                    if k == "mel":
                        np.testing.assert_allclose(g[k], w[k], atol=MEL_ATOL[source], rtol=0,
                                                   err_msg=f"{where}: mel")
                    else:
                        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{where}: {k}")
                if split == "train":
                    shapes.add(w["mel"].shape)
    # the corpus holds 19-101 frames: the flag pads every train batch to 128
    if fixed:
        assert shapes == {(2, 80, 128)}
    else:
        assert shapes == {(2, 80, 64), (2, 80, 128)}


@pytest.mark.parametrize("source", ["npy", "wav"])
def test_max_lengths_match_jax(tmp_path, source):
    hp = create_hparams(_hparams(str(tmp_path), source, True))
    hpj = jax_hparams(_hparams(str(tmp_path), source, True))
    got = ds.TextMelDataset(hp.training_files, hp, device="cpu").max_lengths()
    want = jds.TextMelDataset(hpj.training_files, hpj).max_lengths()
    assert got == want
    assert want[1] == int(16000 * max(SECONDS)) // 256 + 1


# --- shards, the worker pool and the sharded mel cache --------------------------
#
# A 13-clip corpus of random-length mels (.npy, so both sides read the same
# values): 13 % 2 and 13 % 3 are 1, so the low ranks' strided slices hold one
# more item, which the rank-invariant batch count drops.


def _npy_corpus(root, n=13, seed=0):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    path = os.path.join(root, "train.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            mel = os.path.join(root, f"m{i}.npy")
            np.save(mel, (rng.randn(80, int(rng.randint(20, 140))) - 4).astype(np.float32))
            f.write(f"{mel}|{TEXTS[i % len(TEXTS)]}|0|{i % 4}\n")
    return path


def _shard_hparams(flist, sort, batch_size=2):
    return (f"training_files='{flist}',validation_files='{flist}',batch_size={batch_size},"
            f"load_mel_from_disk=True,sort_by_length={sort},text_bucket_size=8,"
            f"mel_bucket_size=16")


@pytest.mark.parametrize("sort", [False, True], ids=["plain", "sort_by_length"])
@pytest.mark.parametrize("world", [2, 3])
def test_sharded_loaders_match_jax(tmp_path, world, sort):
    flist = _npy_corpus(str(tmp_path))
    hp = create_hparams(_shard_hparams(flist, sort))
    hpj = jax_hparams(_shard_hparams(flist, sort))
    fixed = (32, 144)
    seen = []
    for rank in range(world):
        got = ds.DataLoader(ds.TextMelDataset(flist, hp, device="cpu"), 2, hp,
                            shard=(rank, world), fixed_lengths=fixed)
        want = jds.DataLoader(jds.TextMelDataset(flist, hpj), 2, hpj,
                              shard=(rank, world), fixed_lengths=fixed)
        assert len(got) == len(want) == 13 // world // 2
        for epoch in (0, 1):
            g_batches, w_batches = _batches(got, epoch), _batches(want, epoch)
            assert len(g_batches) == len(w_batches) == len(want)
            for g, w in zip(g_batches, w_batches):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"rank {rank} {k}")
            if epoch == 0:
                seen.append({b["mel"][i].tobytes() for b in g_batches for i in range(2)})
    for a in range(world):  # the ranks' items are disjoint
        for b in range(a + 1, world):
            assert not seen[a] & seen[b]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_prepare_dataloaders_match_jax(tmp_path, world):
    flist = _npy_corpus(str(tmp_path))
    spec = _shard_hparams(flist, False, batch_size=2 * world)
    hp, hpj = create_hparams(spec), jax_hparams(spec)
    for rank in range(world):
        got, _ = tr.prepare_dataloaders(hp, "cpu", shard=(rank, world))
        want, _ = jtr.prepare_dataloaders(hpj, shard=(rank, world))
        assert got.batch_size == want.batch_size == 2
        assert got.fixed_lengths == want.fixed_lengths is not None
        g_batches, w_batches = _batches(got, 0), _batches(want, 0)
        assert len(g_batches) == len(w_batches) > 0
        for g, w in zip(g_batches, w_batches):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("workers", [4, 32])
def test_worker_pool_epochs_equal_serial_epochs(tmp_path, workers):
    """Batches from a pool of threads (32: more than the cores, switching
    threads every microsecond) equal the serial ones, in order."""
    flist = _npy_corpus(str(tmp_path))
    hp = create_hparams(_shard_hparams(flist, True))
    dataset = ds.TextMelDataset(flist, hp, device="cpu")
    serial = ds.DataLoader(dataset, 2, hp, num_workers=1)
    pooled = ds.DataLoader(dataset, 2, hp, num_workers=workers)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch in (0, 3):
            a, b = _batches(serial, epoch), _batches(pooled, epoch)
            assert len(a) == len(b) == 6
            for x, y in zip(a, b):
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    finally:
        sys.setswitchinterval(interval)


def test_sharded_mel_cache_is_disjoint_and_complete(tmp_path):
    paths = _write_corpus(str(tmp_path), "wav")
    hp = create_hparams(f"training_files='{paths['train']}',validation_files='{paths['val']}'")
    written = []
    for rank in range(3):
        dataset = ds.TextMelDataset(paths["train"], hp, device="cpu")
        before = {e[0] for e in dataset.entries if os.path.exists(dataset.mel_cache_path(e[0]))}
        assert dataset.warm_mel_cache(shard=(rank, 3)) == 2
        after = {e[0] for e in dataset.entries if os.path.exists(dataset.mel_cache_path(e[0]))}
        written.append(after - before)
        assert written[-1] == {e[0] for e in dataset.entries[rank::3]}
    assert set().union(*written) == {e[0] for e in dataset.entries}
    assert sum(len(w) for w in written) == len(dataset.entries)


def test_indivisible_batch_is_rejected(tmp_path):
    flist = _npy_corpus(str(tmp_path))
    hp = create_hparams(_shard_hparams(flist, False, batch_size=3))
    with pytest.raises(ValueError, match="not divisible"):
        tr.prepare_dataloaders(hp, "cpu", shard=(0, 2))
    with pytest.raises(ValueError, match="rank"):
        ds.DataLoader(ds.TextMelDataset(flist, hp, device="cpu"), 2, hp, shard=(2, 2))
