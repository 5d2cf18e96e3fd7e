"""The traffic generators are fixed by their seed, the arrivals follow
their parameters, and the reference's copy of the loader's order matches
the port's loader."""

import os

import numpy as np
import pytest

from portbench import arrivals, client, core, serve, train
from portbench.reference import loader

HPD = {"text_cleaners": ["korean_cleaners"], "symbol_type": 1, "text_bucket_size": 32,
       "mel_bucket_size": 64, "n_frames_per_step": 1, "hop_length": 256, "batch_size": 4}


@pytest.fixture(scope="module")
def pool():
    traffic = core.load_json(os.path.join(core.BENCH_DIR, "traffic", "open.json"))
    return serve.text_pool(traffic, HPD)


def test_text_pool_keeps_distinct_lines_of_at_most_128_symbols(pool):
    assert len(pool) == 977 == len({t for t, _ in pool})
    assert max(n for _, n in pool) <= 128


@pytest.mark.parametrize("name", ["open", "saturated", "single"])
def test_requests_fixed_by_seed(pool, name):
    traffic = core.load_json(os.path.join(core.BENCH_DIR, "traffic", name + ".json"))
    refs = [f"ref{i}.wav" for i in range(16)]
    seed = 2 ** 31 + 12345
    a = serve.make_requests(traffic, pool, refs, seed, 20.0)
    assert a == serve.make_requests(traffic, pool, refs, seed, 20.0)
    b = serve.make_requests(traffic, pool, refs, seed + 1, 20.0)
    assert a != b and len(a) == len(b)
    assert len({r["text"] for r in a}) == len(a)
    n_get = sum(r["kind"] == "get" for r in a)
    assert n_get == sum(r["kind"] == "get" for r in b) == round(traffic["get_share"] * len(a))
    assert sorted(r["text"] for r in a) == sorted(r["text"] for r in b)   # the same work
    if traffic["arrivals"]["loop"] == "open":
        assert len(a) == round(traffic["arrivals"]["rate_per_s"] * 20.0)
        dues = [r["due"] for r in a]
        assert dues == sorted(dues) and 0.0 <= dues[0] and dues[-1] < 20.0
        assert dues == [r["due"] for r in b]                   # one order for every seed


def test_poisson_arrivals_inside_the_window():
    arr = {"loop": "open", "rate_per_s": 5.0}
    a = arrivals.dues(arr, 40.0, 200)
    assert np.array_equal(a, arrivals.dues(arr, 40.0, 200))
    assert np.all(np.diff(a) > 0) and 0.0 < a[0] and a[-1] < 40.0
    assert arrivals.count(arr, 40.0) == 200
    assert arrivals.count({"loop": "closed", "clients": 8}, 40.0) is None


@pytest.mark.parametrize("shape,cv", [(1, 1.0), (4, 0.5), (16, 0.25)])
def test_gap_shape_sets_the_variation(shape, cv):
    d = arrivals.dues({"loop": "open", "rate_per_s": 50.0, "gap_shape": shape}, 200.0, 10000)
    gaps = np.diff(np.concatenate([[0.0], d]))
    assert gaps.std() / gaps.mean() == pytest.approx(cv, rel=0.05)
    assert gaps.mean() == pytest.approx(200.0 / 10001, rel=1e-3)


def test_bursts_arrive_in_the_on_periods_alone():
    arr = {"loop": "open", "rate_per_s": 4.0, "on_s": 2.0, "off_s": 3.0}
    d = arrivals.dues(arr, 40.0, 160)
    assert np.all(np.mod(d, 5.0) < 2.0) and d[-1] < 40.0
    assert np.all(np.diff(d) >= 0)
    per_cycle = np.bincount((d // 5.0).astype(int), minlength=8)
    assert per_cycle.min() > 0 and per_cycle.sum() == 160


def test_wav_seconds(tmp_path):
    from scipy.io import wavfile

    p = tmp_path / "a.wav"
    wavfile.write(p, 16000, np.zeros(24000, np.int16))
    assert client.wav_seconds(p.read_bytes()) == 1.5


def test_corpus_fixed_by_seed(tmp_path):
    traffic = core.load_json(os.path.join(core.BENCH_DIR, "traffic", "corpus.json"))
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    fa, _ = train.write_corpus(str(tmp_path / "a"), traffic, 8, 99)
    fb, _ = train.write_corpus(str(tmp_path / "b"), traffic, 8, 99)
    la = [line.split("|")[1:] for line in open(fa, encoding="utf-8")]
    lb = [line.split("|")[1:] for line in open(fb, encoding="utf-8")]
    assert la == lb
    assert (tmp_path / "a" / "clip3.wav").read_bytes() == (tmp_path / "b" / "clip3.wav").read_bytes()


def test_loader_copy_matches_the_ports_loader(tmp_path):
    """The reference's batch order and shapes against the port's
    DataLoader on a small corpus (the port's own code, on the CPU)."""
    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.data.dataset import DataLoader, TextMelDataset

    traffic = core.load_json(os.path.join(core.BENCH_DIR, "traffic", "corpus.json"))
    flist, _ = train.write_corpus(str(tmp_path), traffic, 12, 7)
    hp = create_hparams().replace(batch_size=4, num_workers=1, seed=31, training_files=flist)
    ds = TextMelDataset(flist, hp, device="cpu")
    got = [(b.text.shape[0], b.text.shape[1], b.mel.shape[2], list(b.output_lengths))
           for e in range(2) for b in DataLoader(ds, 4, hp).epoch(e)]
    plan = train.batch_plan(flist, {**HPD, "batch_size": 4}, 31, 6)
    want = []
    for items, shape in plan:
        frames = sorted(((len(loader.tokens(t, HPD)),
                          (os.path.getsize(p) - 44) // 2 // 256 + 1) for p, t in items),
                        key=lambda x: -x[0])
        want.append((*shape, [f for _, f in frames]))
    assert [(B, S, T) for B, S, T, _ in got] == [w[:3] for w in want]
    assert [sorted(o) for *_, o in got] == [sorted(w[3]) for w in want]


def test_reference_text_front_end_matches_the_ports():
    """The frozen Korean front end against the port's on every test text
    (the port's own code, on the CPU), and what it refuses."""
    from portbench.reference.text import text_to_sequence as ref
    from tacotron2_vae_torch.text import text_to_sequence as port

    with open(os.path.join(core.BENCH_DIR, "data", "koemo_test_texts.txt"),
              encoding="utf-8") as f:
        texts = [line.rstrip("\n") for line in f if line.strip()]
    for t in texts:
        assert ref(t, ["korean_cleaners"], 1) == port(t, ["korean_cleaners"], 1), t
    with pytest.raises(ValueError):
        ref("hello", ["english_cleaners"], 1)
    with pytest.raises(ValueError):
        ref("{HH AW1}", ["korean_cleaners"], 1)
