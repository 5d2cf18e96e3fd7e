"""Port: the timed train loop (``tools/train_turns.py``) and its corpus
(``profile_train.synthetic_corpus``).

- ``lru_misses`` counts the calls that miss a most-recently-used cache of
  ``GRAPHS`` entries, the most graphs K3/K4 may instantiate;
- the synthetic corpus takes its texts, speakers and emotions from the
  reference corpus's train filelist as they are, each clip as long as
  ``clip_seconds`` of its text;
- ``timed_train`` runs ``train()`` on the CPU with every step wrapped: one
  mark and one shape per iteration, a finite steady s/it, and the train
  module's ``make_train_step`` put back afterwards.
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from _torch_port_common import TINY
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_torch import profile_train as pt
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.tools import train_turns as tt
from tacotron2_vae_torch.training import train as tr


@pytest.mark.parametrize("keys,size,misses", [
    ([], 4, 0),
    ([1, 1, 1], 4, 1),
    ([1, 2, 3, 4, 1, 2], 4, 4),
    ([1, 2, 3, 4, 5, 1], 4, 6),
    ([1, 2, 1, 3, 1, 4, 1, 5, 1], 2, 5),
])
def test_lru_misses(keys, size, misses):
    assert tt.lru_misses(keys, size) == misses


def test_clip_seconds_counts_hangul_syllables():
    assert pt.clip_seconds("안녕하세요.") == pytest.approx(pt.SILENCE_S + 5 / pt.SYLLABLES_PER_S)
    assert pt.clip_seconds("abc, 123") == pytest.approx(pt.SILENCE_S)


def test_synthetic_corpus_takes_the_reference_texts(tmp_path):
    with open(pt.KOEMO, encoding="utf-8") as f:
        reference = {tuple(line.rstrip("\n").split("|")[1:]) for line in f if line.strip()}
    flist = pt.synthetic_corpus(str(tmp_path), 3, seed=7)
    with open(flist, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("|") for line in f]
    assert len(rows) == 3 and len({r[1] for r in rows}) == 3
    for wav, text, speaker, emotion in rows:
        assert (text, speaker, emotion) in reference
        sr, x = wavfile.read(wav)
        assert sr == 16000 and len(x) == int(16000 * pt.clip_seconds(text))
    with open(pt.synthetic_corpus(str(tmp_path), 3, seed=7, name="b"), encoding="utf-8") as f:
        assert [line.split("|")[1] for line in f] == [r[1] for r in rows]


def test_timed_train_marks_every_step(tmp_path):
    rng = np.random.RandomState(0)
    flist = str(tmp_path / "train.txt")
    with open(flist, "w", encoding="utf-8") as f:
        for i in range(4):
            wav = str(tmp_path / f"utt{i}.wav")
            k = 4000 + 800 * i
            x = 0.3 * np.sin(2 * np.pi * 220 * np.arange(k) / 16000) + 0.01 * rng.randn(k)
            wavfile.write(wav, 16000, (x * 32767).astype(np.int16))
            f.write(f"{wav}|안녕하세요 반갑습니다|0|{i % 4}\n")
    hp = create_hparams(TINY + f",training_files='{flist}',validation_files='{flist}',"
                        "batch_size=2,epochs=2,iters_per_checkpoint=10000,"
                        "text_bucket_size=8,mel_bucket_size=16")
    make = tr.make_train_step
    row = tt.timed_train(hp, "cpu", str(tmp_path / "out"), warm=1)
    assert tr.make_train_step is make
    assert row["iterations"] == 4 and len(row["shapes"]) == 4
    assert all(s[0] == 2 for s in row["shapes"])
    assert row["graph_misses_at_most"] == tt.lru_misses(row["shapes"], 4)
    assert 0 < row["s_per_it"] < row["wall_s"]
    assert row["launches"] == {"K2": 0, "K3": 0, "K4": 0}  # the CPU runs the twins
    assert os.path.isdir(str(tmp_path / "out"))
