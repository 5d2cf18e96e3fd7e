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
