"""Port parity: ``tools/bench_pooled.py`` against the JAX package's tool.

``build_corpus`` writes the JAX tool's wavs byte for byte and its filelist
up to the directory; ``epoch_stats`` over the port's loader equals the JAX
tool's over the JAX loader, without and with length pooling (the JAX side
host-side only).  The CLI at tiny width on the CPU prints the JAX tool's
keys (read from its source) plus ``graph_captures_in_timed_window_*`` (on
a corpus of short clips, which the CPU trains on quickly), and its
``--host_only`` run prints what the JAX tool's does; without a card and
without ``--device`` it raises.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, TINY, load_jax_tool
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.config import create_hparams as jax_hparams
from tacotron2_vae_tpu.data.dataset import DataLoader as JaxDataLoader
from tacotron2_vae_tpu.data.dataset import TextMelDataset as JaxTextMelDataset
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.data.dataset import DataLoader, TextMelDataset
from tacotron2_vae_torch.tools import bench_pooled

ITEMS = 24


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("bench_pooled")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory, jax_tool):
    """{side: filelist} of the two tools' corpora of ``ITEMS`` clips."""
    out = {}
    for side, mod in (("port", bench_pooled), ("jax", jax_tool)):
        d = tmp_path_factory.mktemp(f"pool_{side}")
        out[side] = mod.build_corpus(str(d), ITEMS)
    return out


def _jax_keys(device: bool):
    """The JSON keys of the JAX tool, from its source."""
    with open(os.path.join(ROOT, "tools", "bench_pooled.py"), encoding="utf-8") as f:
        src = f.read()
    tagged = re.findall(r'out\[f"(\w+)_\{tag\}"\]', src)
    plain = re.findall(r'out\["(\w+)"\] =', src)
    host = {"padded_frame_ratio", "batch_shapes"}
    keys = {"batch", "items", "padding_saving"}
    keys |= {f"{k}_{t}" for k in tagged if device or k in host
             for t in ("pooled", "unpooled")}
    keys |= {k for k in plain if device or k == "padding_saving"}
    return keys


def test_corpus_is_the_jax_tools(corpora):
    port_dir, jax_dir = (os.path.dirname(corpora[s]) for s in ("port", "jax"))
    wavs = sorted(n for n in os.listdir(jax_dir) if n.endswith(".wav"))
    assert len(wavs) == ITEMS
    for name in wavs:
        with open(os.path.join(port_dir, name), "rb") as g, \
                open(os.path.join(jax_dir, name), "rb") as w:
            assert g.read() == w.read(), name
    with open(corpora["port"], encoding="utf-8") as g, \
            open(corpora["jax"], encoding="utf-8") as w:
        assert g.read().replace(port_dir, "D") == w.read().replace(jax_dir, "D")


@pytest.mark.parametrize("batch", [4, 16])
@pytest.mark.parametrize("pooled", [False, True], ids=["unpooled", "pooled"])
def test_epoch_stats_are_the_jax_tools(jax_tool, corpora, pooled, batch):
    extra = f"batch_size={batch},sort_by_length={pooled}"
    hpj, hp = jax_hparams(extra), create_hparams(extra)
    jds = JaxTextMelDataset(corpora["jax"], hpj)
    jds.warm_mel_cache()
    want = jax_tool.epoch_stats(JaxDataLoader(jds, batch, hpj, shuffle=True), jds, hpj)
    ds = TextMelDataset(corpora["port"], hp, device="cpu")
    ds.warm_mel_cache()
    got = bench_pooled.epoch_stats(DataLoader(ds, batch, hp, shuffle=True), ds, hp)
    assert got == want
    assert got[2] == ITEMS // batch and got[0] > 1.0


def test_host_side_cli_is_the_jax_tools(monkeypatch, capsys, jax_tool):
    args = ["--items", "8", "--batch", "4", "--host_only"]
    monkeypatch.setattr(sys, "argv", ["bench_pooled.py", *args])
    jax_tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) == _jax_keys(device=False)
    got = bench_pooled.main(args + ["--device", "cpu"])
    assert got == want
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got


def _short_corpus(tmpd, n_items, sr=16000):
    """``n_items`` clips of 0.2-1.8 s, across two 64-frame mel buckets
    (``build_corpus``'s are 1-8 s, which the CPU twin of K3/K4 trains on
    too slowly for a test)."""
    from tacotron2_vae_torch.dsp import save_wav

    lines = []
    for i in range(n_items):
        secs = 0.2 + 1.6 * i / max(n_items - 1, 1)
        t = np.arange(int(secs * sr)) / sr
        p = os.path.join(tmpd, f"s{i:03d}.wav")
        save_wav(p, (0.3 * np.sin(2 * np.pi * (120 + 5 * i) * t)).astype(np.float32), sr)
        lines.append(f"{p}|{'가나다라마바사' * (1 + i % 3)}|0|{i % 4}")
    filelist = os.path.join(tmpd, "pool.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return filelist


def test_cli_prints_the_jax_keys_and_graph_captures(monkeypatch, capsys):
    monkeypatch.setattr(bench_pooled, "build_corpus", _short_corpus)
    got = bench_pooled.main(["--items", "16", "--batch", "4", "--steps", "2", "--hparams",
                             TINY + ",n_frames_per_step=2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    captures = {"graph_captures_in_timed_window_pooled",
                "graph_captures_in_timed_window_unpooled"}
    assert set(got) == _jax_keys(device=True) | captures
    assert all(got[k] is None for k in captures)  # no CUDA graphs on the CPU
    for tag in ("pooled", "unpooled"):
        assert np.isfinite(got[f"steps_per_sec_{tag}"]) and got[f"steps_per_sec_{tag}"] > 0
        assert got[f"true_frames_per_sec_{tag}"] > 0
        assert got[f"compiles_in_timed_window_{tag}"] >= 0
    assert got["padding_saving"] > 1.0


def test_cli_wants_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_pooled.main(["--items", "2", "--host_only"])
