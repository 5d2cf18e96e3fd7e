"""Web demo / HTTP API of the port (stdlib HTTP server).

Counterpart of the JAX package's ``serving/app.py`` (reference app.py
routes, demo_guide.md):
  GET  /                  -> demo page
  GET  /generate?text=...&n=&s=&h=&a=  (or &con=true&ref=path) -> wav file
  POST /api   {"text":..., "neu":..., "hap":..., "sad":..., "ang":...}
              -> {"params": {...}, "data": "<base64 wav>"}
  GET  /js/*, /css/*, /audio/*, /uploads/*, /samples/*  -> static files

Concurrent requests are micro-batched: a worker thread drains the queue up
to ``--max_batch`` requests at a time and runs one batched synthesis
(``Synthesizer.synthesize_batch``: one launch of the decode-loop kernel K1
for the batch on the card), then vocodes each item.  The wav cache key
hashes the text and the style parameters.

While ``utils.profiling`` records, each ``/generate`` or ``/api`` request
is an ``http`` span with a request id (``rid``), its handler's wait in
``MicroBatcher.submit`` is ``http.submit``, and the worker records each
request's ``batcher.queue`` (from its enqueue to the start of its batch),
its own waits (``batcher.idle`` with nothing queued, ``batcher.window``
for companions) and each ``batch`` with the ``rids`` it serves.

Unlike the JAX module, importing this one builds no ``Synthesizer``: that
needs a card, so ``main`` builds it (``synthesizer`` stays None until then;
tests set it).

    python -m tacotron2_vae_torch.serving.app --checkpoint_path ckpt.pt \\
        [--vocoder_path waveglow.pkl | g_05000000] [--port 51000] [--device cuda]

``--vocoder_path`` (alias ``--waveglow_path``) names a WaveGlow pickle or
``.pt``, or a BigVGAN generator checkpoint in its published layout with
its ``config.json`` beside it (``Synthesizer.load``); without one the app
vocodes by Griffin-Lim.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils import profiling
from .synthesizer import Synthesizer

ROOT_PATH = "web"
AUDIO_DIR = "audio"

_BASE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_WEB = os.path.join(_BASE, "web")

synthesizer: Synthesizer | None = None


class MicroBatcher:
    """Blocking submit() + a worker thread that drains the queue in groups.

    A queued request waits up to ``window_s`` for companions, then the
    worker runs one batched synthesis for up to ``max_batch`` requests.  The
    window is adaptive: a lone request arriving at an idle worker with no
    recent concurrency is served at once (there is nothing to batch with),
    and the wait ends early the moment the batch fills.  Errors propagate to
    every request in the failed batch."""

    def __init__(self, run_batch, max_batch: int = 4, window_s: float = 0.01):
        self.run_batch = run_batch
        self.max_batch = max(1, int(max_batch))
        self.window_s = window_s
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, request):
        item = {"req": request, "done": threading.Event(), "result": None, "error": None,
                "rid": profiling.current_rid(), "t": time.perf_counter()}
        with profiling.span("http.submit"):
            with self._cv:
                self._queue.append(item)
                self._cv.notify()
            item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _run(self):
        concurrent = False  # did the previous drain see companion traffic?
        while True:
            with self._cv:
                if not self._queue:
                    with profiling.span("batcher.idle"):
                        while not self._queue:
                            self._cv.wait()
                if (self.window_s > 0 and self.max_batch > 1
                        and len(self._queue) < self.max_batch
                        and (concurrent or len(self._queue) > 1)):
                    # let companions arrive; wake early once the batch fills
                    with profiling.span("batcher.window"):
                        self._cv.wait_for(lambda: len(self._queue) >= self.max_batch,
                                          timeout=self.window_s)
                batch = self._queue[:self.max_batch]
                del self._queue[:len(batch)]
                concurrent = len(batch) > 1 or bool(self._queue)
            rids = None
            if profiling.recording():
                t = time.perf_counter()
                for it in batch:
                    profiling.add("batcher.queue", it["t"], t, rid=it["rid"])
                rids = [it["rid"] for it in batch]
            try:
                with profiling.span("batch", rids=rids):
                    results = self.run_batch([it["req"] for it in batch])
                for it, res in zip(batch, results):
                    it["result"] = res
            except Exception as e:  # noqa: BLE001 - propagate to callers
                for it in batch:
                    it["error"] = e
            for it in batch:
                it["done"].set()


_batcher: MicroBatcher | None = None
_batcher_lock = threading.Lock()
_max_batch = 4
_window_s = 0.01


def _get_batcher() -> MicroBatcher:
    global _batcher
    with _batcher_lock:
        if _batcher is None:
            _batcher = MicroBatcher(lambda reqs: synthesizer.synthesize_batch(reqs),
                                    max_batch=_max_batch, window_s=_window_s)
        return _batcher


def _normalize_ratios(n, s, h, a):
    """Emotion weights normalised to sum 1 (reference app.py:57-65)."""
    sigma = n + s + h + a
    if sigma:
        return [round(x / sigma * 100) / 100 for x in (n, s, h, a)]
    return [1.0, 0.0, 0.0, 0.0]


def _audio_path(text: str, extra: str) -> str:
    hashed = hashlib.md5((text + "|" + extra).encode("utf-8")).hexdigest()
    d = os.path.join(_WEB, AUDIO_DIR, "tacotron2-vae")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{hashed}.wav")


def _synthesize(text, condition_on_ref, ref_audio, ratios) -> str:
    extra = ref_audio if condition_on_ref else ",".join(map(str, ratios))
    path = _audio_path(text, extra or "")
    return _get_batcher().submit((text, path, bool(condition_on_ref), ref_audio, ratios))


class Handler(BaseHTTPRequestHandler):
    server_version = "tacotron2-vae-torch/0.1"

    def _send(self, code, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def _send_file(self, path, ctype):
        try:
            with open(path, "rb") as f:
                self._send(200, f.read(), ctype)
        except FileNotFoundError:
            self._send(404, b'{"success": false}', "application/json")

    def do_GET(self):  # noqa: N802
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        route = url.path

        if route == "/":
            page = _render_index(q.get("text", "듣고 싶은 문장을 입력해 주세요."))
            return self._send(200, page.encode("utf-8"), "text/html; charset=utf-8")

        if route == "/generate":
            with profiling.span("http", rid=profiling.next_rid()):
                return self._generate(q)

        for prefix, base, sub in (
            ("/js/", _WEB, "static/js"), ("/css/", _WEB, "static/css"),
            ("/audio/", _WEB, "static/audio"), ("/uploads/", _WEB, "static/uploads"),
            ("/samples/", _BASE, "samples"),  # shipped demo reference wavs
        ):
            if route.startswith(prefix):
                rel = os.path.normpath(route[len(prefix):]).lstrip("/")
                if rel.startswith(".."):
                    return self._send(404, b'{"success": false}')
                ctype = {".js": "application/javascript", ".css": "text/css",
                         ".wav": "audio/wav", ".txt": "text/plain"}.get(
                    os.path.splitext(rel)[1], "application/octet-stream")
                return self._send_file(os.path.join(base, sub, rel), ctype)

        self._send(404, b'{"success": false}')

    def _generate(self, q):
        text = q.get("text")
        if not text:
            return self._send(200, b"{}")
        try:
            if q.get("con") == "true":
                path = _synthesize(text, True, q.get("ref"), None)
            else:
                ratios = _normalize_ratios(
                    float(q.get("n", 1)), float(q.get("s", 0)),
                    float(q.get("h", 0)), float(q.get("a", 0)))
                path = _synthesize(text, False, None, ratios)
        except Exception:  # noqa: BLE001 - the client gets a 400
            traceback.print_exc()
            return self._send(400, b'{"success": false}')
        return self._send_file(path, "audio/wav")

    def do_POST(self):  # noqa: N802
        if urlparse(self.path).path != "/api":
            return self._send(404, b'{"success": false}')
        with profiling.span("http", rid=profiling.next_rid()):
            self._api()

    def _api(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            args = json.loads(self.rfile.read(length))
            text = args["text"]
            n, s = float(args["neu"]), float(args["sad"])
            h, a = float(args["hap"]), float(args["ang"])
            path = _synthesize(text, False, None, _normalize_ratios(n, s, h, a))
            with open(path, "rb") as f:
                b64 = base64.b64encode(f.read()).decode("utf-8")
            body = json.dumps({"params": {"text": text, "neu": n, "hap": h, "sad": s, "ang": a},
                               "data": b64})
            self._send(200, body.encode("utf-8"))
        except Exception:  # noqa: BLE001 - the client gets a 400
            traceback.print_exc()
            self._send(400, b'{"success": false}')

    def log_message(self, fmt, *args):
        print("[http]", fmt % args)


def _render_index(text: str) -> str:
    try:
        with open(os.path.join(_WEB, "templates", "index.html"), encoding="utf-8") as f:
            tpl = f.read()
    except FileNotFoundError:
        tpl = "<html><body><h1>tacotron2-vae</h1><p>{{ text }}</p></body></html>"
    return tpl.replace("{{ text }}", text)


def make_server(port: int) -> ThreadingHTTPServer:
    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--vocoder_path", "--waveglow_path", dest="vocoder_path", default=None,
                        help="a WaveGlow pickle or .pt, or a BigVGAN generator checkpoint")
    parser.add_argument("--port", default=51000, type=int)
    # the reference's flags, accepted and ignored as the JAX CLI does
    parser.add_argument("--debug", default=False)
    parser.add_argument("--is_korean", default=True)
    parser.add_argument("--max_batch", default=4, type=int,
                        help="micro-batch cap for concurrent requests (K1 decodes up to 8 rows)")
    parser.add_argument("--batch_window_ms", default=10.0, type=float,
                        help="max wait for micro-batch companions; adaptive "
                             "(lone requests at an idle server skip it)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    global synthesizer, _max_batch, _window_s
    _max_batch = args.max_batch
    _window_s = args.batch_window_ms / 1000.0
    synthesizer = Synthesizer(device=args.device)
    if os.path.exists(args.checkpoint_path):
        synthesizer.load(args.checkpoint_path, args.vocoder_path)
    else:
        print(f" [!] load_path not found: {args.checkpoint_path}")

    server = make_server(args.port)
    print(f"Serving on 0.0.0.0:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
