"""Port: the HTTP API (``tacotron2_vae_torch/serving/app.py``) on the CPU.

The micro-batcher's adaptive window (as tests/test_serving.py holds the JAX
one), ``_normalize_ratios`` against the JAX function, and the routes of
``make_server(0)`` with a tiny CPU ``Synthesizer`` vocoding through a tiny
WaveGlow: ``/``, ``/generate``, ``/api``, concurrent ``/api`` requests that
the batcher groups, and 404s for unknown routes and ``..`` paths.
"""

import base64
import io
import json
import pickle
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import quote

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_common import TINY, build
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.serving import app as app_mod
from tacotron2_vae_torch.serving.synthesizer import Synthesizer

WG_CFG_ARGS = dict(n_flows=4, n_group=8, n_early_every=2, n_early_size=2, n_layers=2,
                   n_channels=8)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from tacotron2_vae_tpu.models import waveglow as jwg

    tmp = tmp_path_factory.mktemp("port_app")
    _, _, params, state, _ = build()
    ckpt = tmp / "ckpt.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump({"params": params, "model_state": state}, f)
    cfg = jwg.WaveGlowConfig(**WG_CFG_ARGS)
    wg = jax.tree_util.tree_map(np.asarray, jwg.init(jax.random.PRNGKey(2), cfg))
    rng = np.random.RandomState(2)
    for flow in wg["flows"]:  # a zero end would make every coupling the identity
        flow["wn"]["end"]["w"] = 0.05 * rng.randn(*flow["wn"]["end"]["w"].shape)
    with open(tmp / "wg.pkl", "wb") as f:
        pickle.dump({"waveglow": wg, "config": cfg.__dict__}, f)
    s = Synthesizer(create_hparams(TINY), device="cpu")
    with pytest.warns(UserWarning, match="not found"):
        s.load(str(ckpt), str(tmp / "wg.pkl"), centroid_filelist=str(tmp / "missing.txt"))
    s.hparams = s.hparams.replace(max_decoder_steps=40)  # short decodes for the tests
    return s


@pytest.fixture()
def server(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(app_mod, "synthesizer", synth)
    monkeypatch.setattr(app_mod, "_WEB", str(tmp_path / "web"))
    monkeypatch.setattr(app_mod, "_batcher", None)
    srv = app_mod.make_server(0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _wav(data: bytes):
    sr, wav = wavfile.read(io.BytesIO(data))
    assert sr == 16000 and len(wav) > 0 and np.isfinite(wav.astype(np.float64)).all()
    return wav


def _post(url, text):
    body = json.dumps({"text": text, "neu": 1, "sad": 0, "hap": 2, "ang": 1}).encode()
    req = urllib.request.Request(f"{url}/api", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_micro_batcher_adaptive_window():
    """A lone request at an idle worker skips the companion window; a burst
    is grouped, and a full batch ends the wait before the window does."""
    calls = []

    def run_batch(reqs):
        calls.append(len(reqs))
        time.sleep(0.02)  # stand-in for one decode
        return [f"r{r}" for r in reqs]

    window = 0.25  # large, so skipping it and paying it differ clearly
    mb = app_mod.MicroBatcher(run_batch, max_batch=4, window_s=window)
    t0 = time.perf_counter()
    assert mb.submit(1) == "r1"
    assert time.perf_counter() - t0 < window
    assert calls == [1]

    results = {}

    def hit(i):
        results[i] = mb.submit(i)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(2, 6)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results == {i: f"r{i}" for i in range(2, 6)}
    assert max(calls[1:]) >= 2, calls
    assert time.perf_counter() - t0 < 2 * window + 1.0


def test_micro_batcher_propagates_errors():
    def run_batch(reqs):
        raise ValueError("boom")

    mb = app_mod.MicroBatcher(run_batch, max_batch=2, window_s=0.0)
    with pytest.raises(ValueError, match="boom"):
        mb.submit("x")


@pytest.mark.parametrize("ratios", [(1, 0, 0, 0), (1, 2, 3, 4), (0, 0, 0, 0), (0.3, 0.3, 0.3, 0)])
def test_normalize_ratios_matches_jax(ratios):
    from tacotron2_vae_tpu.serving import app as jax_app

    assert app_mod._normalize_ratios(*ratios) == jax_app._normalize_ratios(*ratios)


def test_import_builds_no_synthesizer():
    import subprocess
    import sys

    code = ("import tacotron2_vae_torch.serving.app as a; "
            "assert a.synthesizer is None and a._batcher is None")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_main_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        app_mod.main(["--checkpoint_path", str(tmp_path / "none.pkl")])
    assert app_mod.synthesizer is None


def test_routes(server, synth):
    with urllib.request.urlopen(f"{server}/?text={quote('안녕')}") as r:
        assert r.status == 200 and "안녕" in r.read().decode("utf-8")
    url = f"{server}/generate?text={quote('안녕')}&con=false&n=1&s=0&h=0&a=0"
    with urllib.request.urlopen(url, timeout=600) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
        wav = _wav(r.read())
    # WaveGlow (not Griffin-Lim) vocoded it: a whole number of hops
    assert len(wav) % synth.hparams.hop_length == 0
    payload = _post(server, "반갑습니다")
    assert payload["params"] == {"text": "반갑습니다", "neu": 1.0, "hap": 2.0, "sad": 0.0,
                                 "ang": 1.0}
    _wav(base64.b64decode(payload["data"]))
    with urllib.request.urlopen(f"{server}/generate") as r:
        assert r.read() == b"{}"


@pytest.mark.parametrize("path", ["/nothing", "/js/../../../etc/passwd", "/samples/..%2F..%2Fx",
                                  "/uploads/missing.txt"])
def test_unknown_routes_and_dotdot_are_404(server, path):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}{path}")
    assert e.value.code == 404


def test_post_elsewhere_is_404_and_bad_body_400(server):
    for path, body, code in (("/generate", b"{}", 404), ("/api", b"not json", 400)):
        req = urllib.request.Request(f"{server}{path}", data=body)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == code


def test_concurrent_api_requests_are_micro_batched(server, synth, monkeypatch):
    sizes = []
    real = synth.synthesize_batch

    def spy(reqs, **kw):
        sizes.append(len(reqs))
        return real(reqs, **kw)

    monkeypatch.setattr(synth, "synthesize_batch", spy)
    texts = ["안녕하세요", "반갑습니다", "테스트", "음성 합성", "파도"]
    results, errors = {}, []

    def hit(i):
        try:
            results[i] = _post(server, texts[i])["data"]
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append((i, e))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert len(results) == len(texts)
    for data in results.values():
        _wav(base64.b64decode(data))
    assert sum(sizes) == len(texts)
    assert max(sizes) >= 2, sizes


class _FakeSynth:
    """Writes a tiny wav for each request of a batch; no model."""

    def __init__(self):
        self.batches = []

    def synthesize_batch(self, reqs):
        self.batches.append([r[0] for r in reqs])
        time.sleep(0.01)
        for r in reqs:
            wavfile.write(r[1], 16000, np.zeros(160, np.int16))
        return [r[1] for r in reqs]


def test_recorded_requests_carry_one_rid_across_threads(tmp_path, monkeypatch):
    """Each /api or /generate request yields ``http``, ``http.submit`` and
    ``batcher.queue`` with one request id (the handler's and the worker's
    threads), and each ``batch`` lists exactly the ids it served."""
    from tacotron2_vae_torch.utils import profiling

    fake = _FakeSynth()
    monkeypatch.setattr(app_mod, "synthesizer", fake)
    monkeypatch.setattr(app_mod, "_WEB", str(tmp_path / "web"))
    monkeypatch.setattr(app_mod, "_batcher", None)
    monkeypatch.setattr(app_mod, "_window_s", 0.05)
    srv = app_mod.make_server(0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    texts = [f"문장 {i}" for i in range(6)]

    def hit(i):
        if i % 2:
            _post(url, texts[i])
        else:
            with urllib.request.urlopen(f"{url}/generate?text={quote(texts[i])}",
                                        timeout=60) as r:
                _wav(r.read())

    profiling.start()
    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        rec = profiling.stop()
        srv.shutdown()
    spans = rec["spans"]
    http = [d for d in spans if d["name"] == "http"]
    assert len(http) == len(texts) and len({d["rid"] for d in http}) == len(texts)
    for h in http:
        sub = [d for d in spans if d["name"] == "http.submit" and d["rid"] == h["rid"]]
        queue = [d for d in spans if d["name"] == "batcher.queue" and d["rid"] == h["rid"]]
        assert len(sub) == 1 and sub[0]["parent"] == h["id"]
        assert sub[0]["thread"] == h["thread"]
        assert len(queue) == 1 and queue[0]["thread"] != h["thread"]
        assert h["start"] <= queue[0]["start"] <= queue[0]["end"] <= h["end"]
    batches = [d for d in spans if d["name"] == "batch"]
    served = sorted(r for b in batches for r in b["rids"])
    assert served == sorted(d["rid"] for d in http)
    assert [len(b["rids"]) for b in batches] == [len(b) for b in fake.batches]
    for b in batches:     # a request is queued until its own batch starts
        for r in b["rids"]:
            q = next(d for d in spans if d["name"] == "batcher.queue" and d["rid"] == r)
            assert q["end"] <= b["start"] and q["thread"] == b["thread"]
    assert any(d["name"] == "batcher.idle" for d in spans)


def test_synthesizer_records_its_stages(synth, tmp_path):
    """A batch of a reference-clip request and a ratios request on the CPU:
    ``batch.styles`` (one ``style.ref``), ``mel`` with ``mel.text``,
    ``mel.encoder``, ``mel.decode``, ``mel.postnet`` and ``mel.fetch``, and
    ``vocode`` and ``wav.write`` per item, each with its request id."""
    from tacotron2_vae_torch.utils import profiling

    ref = str(tmp_path / "ref.wav")
    x = 0.3 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
    wavfile.write(ref, 16000, (x * 32767).astype(np.int16))
    reqs = [("안녕", str(tmp_path / "a.wav"), True, ref, None),
            ("반갑습니다", str(tmp_path / "b.wav"), False, None, [0.5, 0.5, 0, 0])]
    profiling.start()
    try:
        with profiling.span("batch", rids=[11, 12]):
            synth.synthesize_batch(reqs)
    finally:
        rec = profiling.stop()
    spans = rec["spans"]
    by_id = {d["id"]: d for d in spans}

    def chain(d):
        out = []
        while d["parent"] is not None:
            d = by_id[d["parent"]]
            out.append(d["name"])
        return out

    names = [d["name"] for d in spans]
    for n in ("batch.styles", "style.ref", "mel", "mel.text", "mel.encoder", "mel.decode",
              "mel.postnet", "mel.fetch", "vocode", "wav.write"):
        assert n in names, n
        assert all(chain(d)[-1] == "batch" for d in spans if d["name"] == n), n
    style = next(d for d in spans if d["name"] == "style.ref")
    assert chain(style) == ["batch.styles", "batch"] and style["rid"] == 11
    mel = next(d for d in spans if d["name"] == "mel")
    assert [d["name"] for d in spans if d["parent"] == mel["id"]] == [
        "mel.text", "mel.encoder", "mel.decode", "mel.postnet", "mel.fetch"]
    for kind in ("vocode", "wav.write"):
        assert [d["rid"] for d in spans if d["name"] == kind] == [11, 12]
