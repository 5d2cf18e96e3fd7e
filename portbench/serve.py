"""The serving runner: the port's HTTP app under a traffic mix.

Set-up: weights from the seed (``weights``), written as the checkpoint
and WaveGlow pickle ``Synthesizer.load`` reads, with a manifest of
``refs`` reference clips (tone and noise, 2-6 s) for the emotion
centroids; ``app.make_server(0)`` in a thread of this process with the
CLI's micro-batching defaults; every decode shape of the traffic (each
bucket of text length at the traffic's ``warm_rows``), every reference clip's style
and the vocoder's one mel bucket run once, then one request of each kind
through HTTP.  The window: the clients (``client.py``, a process that
imports no torch) send the traffic for ``seconds``; every reply is
awaited.  Then the sample is checked against the reference
(``compare.serve_numbers``) and the wavs the app wrote are deleted.

Records for the per-layer readers (``--trace 1`` only, with the
profiler): each ``synthesize_batch`` call's rows and start, the
synchronised time of each ``synthesize_mel_batch`` and ``vocode`` call,
CUDA events around each ``decode_loop`` call (kernel K1), decode graphs
instantiated in the window.  The profiler stops between two batches,
while the next one waits (``core.Pause``).
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from . import arrivals, compare, core, weights
from .reference import loader

K1_KERNELS = ("head_kernel", "lstm_kernel", "att_kernel", "tail_kernel")
HP_KEYS = ("filter_length", "hop_length", "win_length", "n_mel_channels", "sampling_rate",
           "mel_fmin", "mel_fmax", "max_wav_value", "text_cleaners", "symbol_type",
           "prenet_dim", "z_latent_dim", "gate_threshold", "max_decoder_steps",
           "n_frames_per_step", "mel_bucket_size", "text_bucket_size", "attention_rnn_dim",
           "decoder_rnn_dim", "p_attention_dropout", "p_decoder_dropout", "learning_rate",
           "weight_decay", "grad_clip_thresh", "anneal_upper", "anneal_k", "anneal_x0",
           "encoder_embedding_dim", "attention_dim", "attention_location_n_filters",
           "attention_location_kernel_size", "postnet_embedding_dim", "E", "batch_size",
           "ref_enc_filters", "n_symbols", "compute_dtype")


def hp_dict(hp) -> dict:
    return {k: getattr(hp, k) for k in HP_KEYS}


def write_clip(path: str, seconds: float, freq: float, rng) -> None:
    from scipy.io import wavfile

    t = np.arange(int(seconds * 16000)) / 16000
    x = (0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.02 * rng.standard_normal(len(t)))
    wavfile.write(path, 16000, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def text_pool(traffic: dict, hp: dict) -> list:
    """(text, symbols) of the traffic's distinct texts of at most
    ``max_symbols``, in file order."""
    with open(os.path.join(core.BENCH_DIR, "data", traffic["texts"]), encoding="utf-8") as f:
        texts = list(dict.fromkeys(line.rstrip("\n") for line in f if line.strip()))
    out = []
    for t in texts:
        n = len(loader.tokens(t, hp))
        if n <= traffic["max_symbols"]:
            out.append((t, n))
    return out


def make_requests(traffic: dict, pool: list, refs: list, seed: int, seconds: float) -> list:
    """The window's requests.  Every seed gets the same work: the same
    distinct texts, the same count of ``GET /generate`` requests with a
    reference clip (the rest ``POST /api``), and in an open loop the same
    arrival times (``arrivals.dues``); the seed orders the texts and kinds,
    and draws the emotion weights (Dirichlet) and the clips."""
    fixed = np.random.default_rng(0)
    rng = np.random.default_rng(seed)
    n = min(arrivals.count(traffic["arrivals"], seconds) or len(pool), len(pool))
    texts = fixed.permutation(len(pool))[:n]
    order = texts[rng.permutation(n)]
    n_get = int(round(traffic["get_share"] * n))
    kinds = np.array(["get"] * n_get + ["post"] * (n - n_get))
    rng.shuffle(kinds)
    due = None
    if traffic["arrivals"]["loop"] == "open":
        due = arrivals.dues(traffic["arrivals"], seconds, n)
    reqs = []
    for i in range(n):
        r = {"kind": str(kinds[i]), "text": pool[order[i]][0]}
        if r["kind"] == "post":
            r["ratios"] = [round(float(x), 4) for x in rng.dirichlet([traffic["alpha"]] * 4)]
        else:
            r["ref"] = refs[int(rng.integers(len(refs)))]
        if due is not None:
            r["due"] = float(due[i])
        reqs.append(r)
    return reqs


def warm_texts(pool: list, hp: dict, rng) -> dict:
    """Four texts of each text-length bucket of the pool."""
    bucket = hp["text_bucket_size"]
    by = {}
    for t, n in pool:
        by.setdefault(-(-n // bucket) * bucket, []).append(t)
    return {S: [ts[i] for i in rng.choice(len(ts), min(4, len(ts)), replace=False)]
            for S, ts in sorted(by.items())}


class Recorder:
    """Wraps the synthesizer's calls (instance attributes) and K1's entry
    (a module attribute) and records what the readers and the check need."""

    def __init__(self, synth, dl, traced: bool, cuda: bool):
        import torch

        self.torch, self.synth, self.dl = torch, synth, dl
        self.traced, self.cuda = traced, cuda
        self.events = []          # ("mel", batch) or ("voc", batch, item) in call order
        self.batches = []         # {"reqs", "t0", "t1", "items"}
        self.cur = None
        self.mel_s, self.voc_s, self.voc_audio_s, self.k1 = [], [], [], []
        self.spans = core.Spans()
        self.pause = core.Pause()
        self.inner = (synth.synthesize_batch, synth.synthesize_mel_batch, synth.vocode,
                      dl.decode_loop)
        synth.synthesize_batch = self.synthesize_batch
        synth.synthesize_mel_batch = self.synthesize_mel_batch
        synth.vocode = self.vocode
        if traced and cuda:
            def decode_loop(*args, **kwargs):
                return self.decode_loop(*args, **kwargs)
            # the entry keeps its counters on its module attribute
            decode_loop.__dict__.update(self.inner[3].__dict__)
            dl.decode_loop = decode_loop

    def restore(self):
        for name in ("synthesize_batch", "synthesize_mel_batch", "vocode"):
            self.synth.__dict__.pop(name, None)
        if self.dl.decode_loop is not self.inner[3]:
            self.inner[3].__dict__.update(self.dl.decode_loop.__dict__)
            self.dl.decode_loop = self.inner[3]

    def _span(self, name):
        return self.spans(name) if self.traced else contextlib.nullcontext()

    def _sync(self):
        if self.traced and self.cuda:
            self.torch.cuda.synchronize()

    def synthesize_batch(self, requests, *args, **kwargs):
        with self.pause.work() if self.traced else contextlib.nullcontext():
            b = {"reqs": list(requests), "t0": time.monotonic(), "items": None, "voc": 0}
            self.batches.append(b)
            self.cur = b
            with self._span("batch"):
                out = self.inner[0](requests, *args, **kwargs)
            b["t1"] = time.monotonic()
        return out

    def synthesize_mel_batch(self, texts, styles):
        self._sync()
        t = time.perf_counter()
        with self._span("mel"):
            items = self.inner[1](texts, styles)
        self.mel_s.append(time.perf_counter() - t)
        if self.cur is not None and self.cur["items"] is None:
            self.cur["items"] = items
        self.events.append(("mel", self.cur))
        return items

    def vocode(self, mel, *args, **kwargs):
        self._sync()
        t = time.perf_counter()
        with self._span("vocode"):
            wav = self.inner[2](mel, *args, **kwargs)
        self.voc_s.append(time.perf_counter() - t)
        self.voc_audio_s.append(len(wav) / 16000.0)
        item = self.cur["voc"] if self.cur is not None else None
        if self.cur is not None:
            self.cur["voc"] += 1
        self.events.append(("voc", self.cur, item))
        return wav

    def decode_loop(self, kw, memory, pmem, mask=None, **kwargs):
        torch = self.torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        start.record()
        out = self.inner[3](kw, memory, pmem, mask, **kwargs)
        end.record()
        self.k1.append({"t": t, "B": int(memory.shape[0]), "S": int(memory.shape[1]),
                        "dtype": str(kw["att_w"].dtype).split(".")[-1], "start": start,
                        "end": end, "lengths": out[3], "r": kwargs.get("r", 1)})
        return out


def _wav_samples(path: str) -> np.ndarray:
    from scipy.io import wavfile

    return wavfile.read(path)[1]


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", hp_overrides: dict | None = None, vocoder_dtype=None,
        fault=None, quant=None, log=print) -> dict:
    """One run of a serving cell; returns the result (without ``device``
    when not on a card).  ``hp_overrides``, ``vocoder_dtype``, ``fault``
    (a callable given the synthesizer, which may break it) and ``quant``
    (the control's precision, judged in the program's place) serve the
    benchmark's tests."""
    import torch

    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.convert import to_jax_waveglow
    from tacotron2_vae_torch.models.waveglow import WaveGlowConfig
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.serving import app
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer

    traffic, sizes = spec["traffic"], spec["config"]["sizes"]
    cuda = device == "cuda"
    hp = create_hparams().replace(**{**sizes["tacotron2"], **(hp_overrides or {})}).replace(
        sampling_rate=16000, max_decoder_steps=sizes["max_decoder_steps"])
    hpd = hp_dict(hp)
    wg_cfg = WaveGlowConfig(n_mel_channels=hp.n_mel_channels, **sizes["waveglow"])
    work = tempfile.mkdtemp(prefix="portbench_serve_")
    rec = proc = server = None
    written = set()
    phases = {"imports": time.perf_counter() - t_start}
    try:
        sd = weights.tacotron2(hp, seed, device)
        wg_sd = weights.waveglow(wg_cfg, seed, device)
        if cuda:
            torch.cuda.synchronize()
        phases["weights"] = time.perf_counter() - t_start
        ckpt = os.path.join(work, "tacotron2.pt")
        torch.save({"state_dict": {k: v.to(torch.bfloat16).cpu() if v.is_floating_point()
                                   else v.cpu() for k, v in sd.items()}}, ckpt)
        tree = to_jax_waveglow({k: v.cpu() for k, v in wg_sd.items()})
        tree = _map_leaves(tree, lambda a: np.asarray(a, np.float16))
        wg_path = os.path.join(work, "waveglow.pkl")
        with open(wg_path, "wb") as f:
            pickle.dump({"waveglow": tree, "config": dict(wg_cfg.__dict__)}, f)
        rng = np.random.default_rng(seed)
        refs, manifest = [], []
        lo, hi = traffic["ref_seconds"]
        for i in range(traffic["refs"]):
            p = os.path.join(work, f"ref{i}.wav")
            write_clip(p, lo + (hi - lo) * i / max(traffic["refs"] - 1, 1),
                       120 + 23 * i, rng)
            refs.append(p)
            manifest.append([p, "-", "0", str(i % 4)])
        man_path = os.path.join(work, "manifest.txt")
        with open(man_path, "w", encoding="utf-8") as f:
            f.writelines("|".join(m) + "\n" for m in manifest)

        phases["files"] = time.perf_counter() - t_start
        synth = Synthesizer(hparams=hp, device=device)
        if synth.hparams.max_decoder_steps != hp.max_decoder_steps:   # tiny test cells
            synth.hparams = synth.hparams.replace(max_decoder_steps=hp.max_decoder_steps)
        synth.load(ckpt, wg_path, man_path)
        synth.vocoder_dtype = vocoder_dtype
        phases["load"] = time.perf_counter() - t_start
        pool = text_pool(traffic, hpd)
        reqs = make_requests(traffic, pool, refs, seed, seconds)
        rec = Recorder(synth, dl, trace, cuda)
        if fault is not None:
            fault(synth)
        app.synthesizer = synth
        app._max_batch = sizes["serving"]["max_batch"]
        app._window_s = sizes["serving"]["batch_window_ms"] / 1000.0
        app._batcher = None

        # warm-up: every decode shape, every reference clip, the vocoder
        # the batch sizes the traffic forms, the commonest last (K1 keeps the
        # most recent decode graphs)
        style = synth.style_from_ratios([1.0, 0.0, 0.0, 0.0])
        warm = warm_texts(pool, hpd, rng)
        for B in traffic["warm_rows"]:
            for texts in warm.values():
                synth.synthesize_mel_batch(texts[:B] + texts[:1] * (B - len(texts[:B])),
                                           [style] * B)
        phases["warm_decode"] = time.perf_counter() - t_start
        for p in refs:
            synth.style_from_ref(p)
        phases["warm_refs"] = time.perf_counter() - t_start
        server = app.make_server(0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        from . import client

        for w in ({"kind": "post", "text": pool[0][0], "ratios": [0.7, 0.1, 0.1, 0.1]},
                  {"kind": "get", "text": pool[1][0], "ref": refs[0]}):
            status, _ = client.send(port, w, 600.0)
            if status != 200:
                raise RuntimeError(f"warm-up request failed with HTTP {status}")
        if cuda:
            torch.cuda.synchronize()
        n_warm_batches, n_warm_mel = len(rec.batches), len(rec.mel_s)
        n_warm_voc, n_warm_k1 = len(rec.voc_s), len(rec.k1)
        graphs0 = dl.graph_captures() if cuda else 0
        spec_path = os.path.join(work, "client.json")
        out_path = os.path.join(work, "client_out.json")
        with open(spec_path, "w", encoding="utf-8") as f:
            json.dump({"port": port, "seconds": seconds, "loop": traffic["arrivals"]["loop"],
                       "clients": traffic["arrivals"].get("clients", 0), "timeout_s": 60.0,
                       "requests": reqs, "out": out_path}, f)
        setup_s = time.perf_counter() - t_start
        prof = None
        if trace and cuda:
            t_prof0 = time.perf_counter()
            prof, anchor = core.start_trace()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.Popen([sys.executable, "-B", "-m", "portbench.client", spec_path],
                                cwd=core.ROOT, env=env)
        if prof is not None:
            # the profiler records the first TRACE_S seconds of the window
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=core.TRACE_S + 0.3)
            t_hold = time.perf_counter()
            with rec.pause.hold():      # between batches: no launch while it stops
                torch.cuda.synchronize()
                t_prof1 = time.perf_counter()
                t_prof = t_prof1 - t_prof0
                prof.__exit__(None, None, None)
            phases["trace_stop_wait"] = t_prof1 - t_hold
            phases["trace_stop_held"] = time.perf_counter() - t_prof1
        proc.wait(timeout=seconds + 180)
        if cuda:
            torch.cuda.synchronize()
        graphs1 = dl.graph_captures() if cuda else 0
        if proc.returncode != 0:
            raise RuntimeError(f"the client process exited with {proc.returncode}")
        res = core.load_json(out_path)
        device_rec = core.device_info() if cuda else None
        server.shutdown()
        server.server_close()
        server = None

        # end to end
        t0, t1 = res["t0"], res["t1"]
        rows = res["results"]
        lat, audio_done = [], 0.0
        failed = len(res["unanswered"])
        for r in rows:
            ok = r["status"] == 200 and r["md5"] is not None
            failed += not ok
            lat.append((r["done"] - r["due"]) * 1e3 if ok else float("inf"))
            if ok and r["done"] <= t1:
                audio_done += r["audio_s"]
        lat += [float("inf")] * len(res["unanswered"])
        metrics = {}
        for m in spec["end_to_end"]:
            v = {"latency_p50_ms": lambda: core.percentile(lat, 50),
                 "latency_p95_ms": lambda: core.percentile(lat, 95),
                 "audio_s_per_s": lambda: audio_done / (t1 - t0),
                 "setup_s": lambda: setup_s}[m["name"]]()
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        # the check
        by_text = {}
        for b in rec.batches[n_warm_batches:]:
            for row, req in enumerate(b["reqs"]):
                by_text[req[0]] = (b, row)
        seeds = compare.seed_stream(hp.seed, len(rec.events))
        mel_ev = {id(ev[1]): i for i, ev in enumerate(rec.events) if ev[0] == "mel"}
        voc_ev = {(id(ev[1]), ev[2]): i for i, ev in enumerate(rec.events) if ev[0] == "voc"}
        done = [r for r in rows if r["status"] == 200 and r["md5"] is not None]
        for r in done:
            b, row = by_text[reqs[r["i"]]["text"]]
            written.add(b["reqs"][row][1])
        pick = np.random.default_rng(seed + 1).permutation(len(done))
        n_get = traffic["check_get"]
        gets = [done[i] for i in pick if reqs[done[i]["i"]]["kind"] == "get"][:n_get]
        posts = [done[i] for i in pick if reqs[done[i]["i"]]["kind"] == "post"]
        sample = gets + posts[:traffic["check_requests"] - len(gets)]
        bytes_bad = 0
        for r in done:
            path = by_text[reqs[r["i"]]["text"]][0]["reqs"][by_text[reqs[r["i"]]["text"]][1]][1]
            with open(path, "rb") as f:
                bytes_bad += hashlib.md5(f.read()).hexdigest() != r["md5"]
        samples = []
        for r in sample:
            q = reqs[r["i"]]
            b, row = by_text[q["text"]]
            mel, mel_post, _gate, _align, n = b["items"][row]
            s = {"kind": q["kind"], "text": q["text"], "row": row, "n": n, "mel": mel,
                 "mel_post": mel_post, "decode_seed": seeds[mel_ev[id(b)]],
                 "vocode_seed": seeds[voc_ev[(id(b), row)]],
                 "wav": _wav_samples(b["reqs"][row][1])}
            if q["kind"] == "post":
                s["ratios"] = compare.normalize_ratios(*q["ratios"])
            else:
                s["ref"] = q["ref"]
            samples.append(s)

        # per-layer records, before the reference runs on the card
        per_layer, breakdown = {}, None
        if trace and cuda:
            k1_hidden = sum(k["start"].elapsed_time(k["end"]) / 1e3 for k in rec.k1[n_warm_k1:]
                            if t_prof0 <= k["t"] < t_prof1)
            tr = core.device_trace(prof, anchor, rec.spans.items, [(K1_KERNELS, k1_hidden)])
            win_batches = rec.batches[n_warm_batches:]
            sent = {reqs[r["i"]]["text"]: r["sent"] for r in rows}
            prec = {"window_s": t1 - t0, "trace_window_s": t_prof, "busy_s": tr["busy_s"],
                    "batches": [{"rows": len(b["reqs"]), "t0": b["t0"],
                                 "sent": [sent.get(q[0]) for q in b["reqs"]]}
                                for b in win_batches],
                    "mel_s": rec.mel_s[n_warm_mel:], "vocode_s": rec.voc_s[n_warm_voc:],
                    "vocode_audio_s": rec.voc_audio_s[n_warm_voc:],
                    "k1": [{"B": k["B"], "S": k["S"], "dtype": k["dtype"],
                            "steps": int(k["lengths"].max()) // k["r"],
                            "ms": k["start"].elapsed_time(k["end"])}
                           for k in rec.k1[n_warm_k1:]],
                    "k1_graphs": graphs1 - graphs0, "sizes": sizes,
                    "completed": [{"S": -(-len(loader.tokens(reqs[r["i"]]["text"], hpd))
                                     // hp.text_bucket_size) * hp.text_bucket_size,
                                   "frames": by_text[reqs[r["i"]]["text"]][0]["items"][
                                       by_text[reqs[r["i"]]["text"]][1]][4],
                                   "ref_frames": (((os.path.getsize(reqs[r["i"]]["ref"]) - 44)
                                                   // 2 // hp.hop_length + 1)
                                                  if reqs[r["i"]]["kind"] == "get" else 0)}
                                  for r in done if r["done"] <= t1],
                    "mel_bucket": hp.mel_bucket_size}
            per_layer = core.per_layer_metrics(spec, prec)
            breakdown = tr["breakdown"]
            device_rec["busy_s"] = tr["busy_s"]
            device_rec["window_s"] = t_prof
        # free the program's state, then the reference
        del synth
        app.synthesizer = None
        rec.restore()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers = compare.serve_numbers(sd, wg_sd, dict(wg_cfg.__dict__), hpd, samples,
                                        manifest, device, quant=quant)
        phases["reference"] = time.perf_counter() - t_ref
        numbers["bytes"] = bytes_bad
        checks = compare.checks(numbers, compare.SERVE_CHECKS)
        correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
        result = {"correct": bool(correct), "attempted": len(rows) + len(res["unanswered"]),
                  "failed": failed, "metrics": per_layer if trace else metrics}
        if device_rec is not None:
            result["device"] = device_rec
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        if res["forbidden"]:
            result["forbidden_in_client"] = res["forbidden"]
        by_due = sorted(rows, key=lambda r: r["due"])
        quarter = max(1, len(by_due) // 4)

        def med_ms(part):
            return core.median([(r["done"] - r["due"]) * 1e3 for r in part])
        log(f"serve: {len(rows)} replies, {failed} failed, sample {len(samples)}, late start "
            f"{max((r['sent'] - r['due'] for r in rows), default=0.0):.4f} s; latency median "
            f"first quarter {med_ms(by_due[:quarter]):.1f} ms, last quarter "
            f"{med_ms(by_due[-quarter:]):.1f} ms; drain after the close "
            f"{max((r['done'] for r in rows), default=t1) - t1:.3f} s; set-up {setup_s:.2f} s "
            f"({', '.join(f'{k} {v:.2f}' for k, v in phases.items())})")
        return result
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if rec is not None:
            rec.restore()
            for b in rec.batches:
                written.update(q[1] for q in b["reqs"])
        for p in written:
            with contextlib.suppress(OSError):
                os.unlink(p)
        audio_dir = os.path.join(core.ROOT, "web", "audio", "tacotron2-vae")
        for d in (audio_dir, os.path.dirname(audio_dir)):
            with contextlib.suppress(OSError):
                os.rmdir(d)
        shutil.rmtree(work, ignore_errors=True)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)
