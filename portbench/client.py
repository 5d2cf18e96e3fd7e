"""The serving cells' clients: a process of its own that imports the
standard library alone (no torch), so that load generation takes no
interpreter time from the server.

    python -B -m portbench.client SPEC.json

SPEC holds ``port``, ``seconds``, ``loop`` ("open" or "closed"),
``clients`` (closed loop), ``timeout_s`` and ``requests``: each a dict
with ``kind`` ("post": ``POST /api`` with ``text`` and emotion weights
``ratios`` = [neu, sad, hap, ang]; "get": ``GET /generate?con=true`` with
``text`` and ``ref``) and, in an open loop, ``due``, seconds after the
window opens.  An open loop sends every request at its due time,
whatever is still in flight; a closed loop's clients each send the next
request of the list when their last reply has come, until the window
closes.  Replies are awaited up to ``timeout_s`` past the close.  Writes
``out``: the window's monotonic start, every request's due, sent and
done times, status, the md5 and the seconds of the returned wav, and any
forbidden module found loaded here.
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import json
import sys
import threading
import time
import urllib.parse

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tacotron2_vae_tpu")


def wav_seconds(data: bytes) -> float:
    """Seconds of a PCM wav: the data chunk's bytes over the byte rate."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a wav")
    pos, rate = 12, None
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "little")
        if tag == b"fmt ":
            rate = int.from_bytes(data[pos + 16:pos + 20], "little")
        elif tag == b"data":
            if not rate:
                raise ValueError("wav without a byte rate")
            return size / rate
        pos += 8 + size + (size & 1)
    raise ValueError("wav without data")


def send(port: int, req: dict, timeout: float) -> tuple:
    """(status, wav bytes or None)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if req["kind"] == "post":
            n, s, h, a = req["ratios"]
            body = json.dumps({"text": req["text"], "neu": n, "sad": s, "hap": h, "ang": a})
            conn.request("POST", "/api", body=body.encode("utf-8"),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                return resp.status, None
            return 200, base64.b64decode(json.loads(raw)["data"])
        q = urllib.parse.urlencode({"text": req["text"], "con": "true", "ref": req["ref"]})
        conn.request("GET", "/generate?" + q)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw if resp.status == 200 else None
    finally:
        conn.close()


def run(spec: dict) -> dict:
    reqs = spec["requests"]
    seconds, timeout = float(spec["seconds"]), float(spec["timeout_s"])
    results = [None] * len(reqs)
    lock = threading.Lock()
    t0 = time.monotonic() + 0.2
    t1 = t0 + seconds

    started = []

    def one(i, due):
        sent = time.monotonic()
        with lock:
            started.append(i)
        row = {"i": i, "due": due, "sent": sent, "done": None, "status": None,
               "md5": None, "audio_s": 0.0, "error": None}
        try:
            status, wav = send(spec["port"], reqs[i], max(1.0, t1 + timeout - sent))
            row["status"] = status
            if wav is not None:
                row["md5"] = hashlib.md5(wav).hexdigest()
                row["audio_s"] = wav_seconds(wav)
        except (OSError, ValueError, KeyError, http.client.HTTPException) as e:
            row["error"] = f"{type(e).__name__}: {e}"
        row["done"] = time.monotonic()
        with lock:
            results[i] = row

    threads = []
    if spec["loop"] == "open":
        for i, r in enumerate(reqs):
            due = t0 + float(r["due"])
            if due >= t1:
                break
            while True:
                now = time.monotonic()
                if now >= due:
                    break
                time.sleep(min(due - now, 0.05))
            th = threading.Thread(target=one, args=(i, due), daemon=True)
            th.start()
            threads.append(th)
    else:
        nxt = [0]

        def client():
            while True:
                now = time.monotonic()
                if now >= t1:
                    return
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(reqs):
                    return
                one(i, now)

        while time.monotonic() < t0:
            time.sleep(0.005)
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(int(spec["clients"]))]
        for th in threads:
            th.start()
    for th in threads:
        th.join(timeout=max(0.0, t1 + timeout - time.monotonic()))
    with lock:
        rows = [r for r in results if r is not None]
        hung = [i for i in started if results[i] is None]
    return {"t0": t0, "t1": t1, "results": rows, "unanswered": hung,
            "forbidden": sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0], encoding="utf-8") as f:
        spec = json.load(f)
    out = run(spec)
    with open(spec["out"], "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
