"""The serving runner with a BigVGAN vocoder: the port's HTTP app under a
traffic mix, as ``serve.py`` runs it, with BigVGAN in WaveGlow's place.

Set-up: Tacotron2's weights from the seed (``weights``), BigVGAN's from
the seed in its published checkpoint layout (``bigvgan_checkpoint``:
``{"generator": state_dict}`` with weight norm, and ``config.json``
beside it), both written where ``Synthesizer.load`` reads them; the
manifest, the warm-up and the window as in ``serve.py``, with the
program's recorder (``utils.profiling``) started at the window's opening
and stopped after its last reply.  Exits with an error at once where the
program has no BigVGAN.

The check (``serve_numbers``): ``mel``, ``post``, ``frames`` and
``bytes`` as ``compare`` decides them, the decode seeds counted without
vocoder draws (BigVGAN is deterministic); ``wav``: max |served PCM16 -
reference PCM16| over max |reference PCM16|, the reference being the
plain BigVGAN (``reference/bigvgan.py``, float32, TF32 off) on the served
postnet mel padded as the program pads it; ``k9_launches``: the launches
of kernel K9 counted in the window against 109 a generator call (the
served path runs every activation through K9).

Records for the per-layer readers (``--trace 1``): ``serve.py``'s, the
program's record (``program``: its spans and counters), the traced part of
the window (``trace_span``) and K9's kernel time in the profiler's trace
(``k9_kernel_s``).
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from . import compare, core, reference, weights
from .counts import bigvgan as counts_bv
from .reference import bigvgan as ref_bv
from .reference import loader
from .reference.waveglow import to_pcm16
from .serve import (K1_KERNELS, Recorder, _wav_samples, hp_dict, make_requests, text_pool,
                    warm_texts, write_clip)

# wav: max |served - reference PCM16| over max |reference PCM16|.  At the
# committed weight draw, sound runs read 1 LSB of a peak near full scale,
# 3.05e-5 to 3.13e-5 (10 runs, 10 seeds); the reference with TF32
# convolutions, the nearest precision below the float32 the configuration
# states, reads 1.88e-3 to 2.77e-3, on bf16 operands 0.015-0.030, the
# activation without anti-aliasing 0.81-1.06 (NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md lists the runs): 3e-4 sits ~10x above the one and ~6x
# below the other.
LIMITS = {"wav": 3e-4, "k9_launches": 0}
CHECKS = ("mel", "post", "wav", "frames", "bytes", "k9_launches")
K9_KERNEL = "aa_snake_kernel"
# the checkpoint's draw: weight_g a row norm of this scale (see bigvgan_checkpoint)
ROW_NORM = {"conv_pre": 1.0, "ups": 0.75, "resblocks": 0.5, "conv_post": 1.0}
BIAS_STD, SNAKE_STD = 0.01, 0.1


def bigvgan_checkpoint(bv: dict, seed: int, device) -> dict:
    """``{"generator": state_dict}`` of float32 tensors on ``device`` in the
    published layout (``reference.bigvgan.layout``, from the config alone),
    from one ``torch.randn`` of a generator seeded from ``seed``: each
    convolution's ``weight_v`` N(0, 1) and ``weight_g`` a row norm of
    ``ROW_NORM`` x (1 + 0.1 N(0, 1)) (the folded weight keeps a signal's
    scale whatever the width); biases N(0, BIAS_STD^2); log-scale alpha and
    beta N(0, SNAKE_STD^2); the published anti-aliasing filters."""
    import torch

    shapes = ref_bv.layout(bv)
    total = sum(math.prod(s) for k, s in shapes.items() if not k.endswith(".filter"))
    gen = torch.Generator(device=device).manual_seed(seed ^ 0xB16)
    flat = torch.randn(total, generator=gen, device=device)
    filt = ref_bv.kaiser_sinc_filter1d(0.25, 0.3, ref_bv.TAPS).to(device)
    sd, off = {}, 0
    for k, s in shapes.items():
        if k.endswith(".filter"):
            sd[k] = filt.clone()
            continue
        n = math.prod(s)
        x = flat[off:off + n].reshape(s)
        off += n
        sd[k] = (SNAKE_STD * x if k.endswith((".alpha", ".beta")) else
                 BIAS_STD * x if k.endswith(".bias") else
                 ROW_NORM[k.split(".")[0]] * (1.0 + 0.1 * x) if k.endswith(".weight_g") else x)
    return {"generator": sd}


def _pad_mel(mel_post, hp: dict):
    """The served postnet mel (T, n_mel) as the program vocodes it: (1,
    n_mel, T) padded with log(1e-5) to a multiple of ``mel_bucket_size``."""
    import torch

    T = mel_post.shape[0]
    pad = -(-T // hp["mel_bucket_size"]) * hp["mel_bucket_size"] - T
    return torch.nn.functional.pad(mel_post.T[None], (0, pad), value=float(np.log(1e-5)))


def serve_numbers(sd: dict, bv_sd: dict, bv: dict, hp: dict, samples: list, manifest: list,
                  device, quant=None) -> dict:
    """``mel``, ``post``, ``frames`` as ``compare.serve_numbers`` reckons
    them and ``wav`` against the plain BigVGAN.  With ``quant``
    ("bfloat16" or "tf32") the control: the reference's wav at that
    precision in the program's place."""
    import torch

    reference.setup()
    ref_bv.setup()
    ref = compare.Ref(sd, hp)
    cents = compare.centroids(ref, manifest, hp, device)
    out = {"mel": 0.0, "post": 0.0, "wav": 0.0, "frames": 0, "wav_rms": [], "wav_clip": 0.0}
    with torch.no_grad():
        for s in samples:
            mel_r, res_r, gate_r = compare._reference_outputs(ref, s, cents, hp, device)
            served = torch.as_tensor(s["mel"][0].T, device=device)
            served_post = torch.as_tensor(s["mel_post"][0].T, device=device)
            out["mel"] = max(out["mel"], compare._rel(served, mel_r))
            out["post"] = max(out["post"], compare._rel(served_post, served + res_r))
            fired = torch.nonzero(torch.sigmoid(gate_r) > hp["gate_threshold"])
            stop = int(fired[0, 0]) + 1 if len(fired) else hp["max_decoder_steps"]
            out["frames"] += int(s["n"] != stop * hp["n_frames_per_step"])
            n = served_post.shape[0] * hp["hop_length"]
            mel_p = _pad_mel(served_post, hp)
            wav = ref_bv.infer(bv_sd, bv, mel_p)[0, :n].cpu().numpy()
            want = to_pcm16(wav)
            if quant:
                got = to_pcm16(ref_bv.infer(bv_sd, bv, mel_p, quant=quant)[0, :n].cpu().numpy())
            else:
                got = s["wav"]
            out["wav_rms"].append(float(np.sqrt(np.mean(np.square(wav, dtype=np.float64)))))
            out["wav_clip"] = max(out["wav_clip"], float(np.mean(np.abs(wav) > 0.99)))
            if got.shape != want.shape:
                out["wav"] = max(out["wav"], 1.0)
            else:
                out["wav"] = max(out["wav"], float(np.abs(got.astype(np.int64) - want).max())
                                 / max(float(np.abs(want.astype(np.int64)).max()), 1.0))
    return out


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", hp_overrides: dict | None = None, fault=None, quant=None,
        log=print) -> dict:
    """One run of a BigVGAN serving cell; returns the result (without
    ``device`` when not on a card).  ``hp_overrides``, ``fault`` (a
    callable given the synthesizer, which may break it) and
    ``quant`` (the reference's precision in the program's place) serve the
    benchmark's controls and tests."""
    try:
        import tacotron2_vae_torch.models.bigvgan  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"this program cannot serve BigVGAN: {e}") from e
    import torch

    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.serving import app
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer
    from tacotron2_vae_torch.utils import profiling

    traffic, sizes = spec["traffic"], spec["config"]["sizes"]
    bv = sizes["bigvgan"]
    cuda = device == "cuda"
    hp = create_hparams().replace(**{**sizes["tacotron2"], **(hp_overrides or {})}).replace(
        sampling_rate=16000, max_decoder_steps=sizes["max_decoder_steps"])
    hpd = hp_dict(hp)
    work = tempfile.mkdtemp(prefix="portbench_serve_bigvgan_")
    rec = proc = server = None
    recording = False
    written = set()
    phases = {"imports": time.perf_counter() - t_start}
    try:
        sd = weights.tacotron2(hp, seed, device)
        blob = bigvgan_checkpoint(bv, seed, device)
        if cuda:
            torch.cuda.synchronize()
        phases["weights"] = time.perf_counter() - t_start
        ckpt = os.path.join(work, "tacotron2.pt")
        torch.save({"state_dict": {k: v.to(torch.bfloat16).cpu() if v.is_floating_point()
                                   else v.cpu() for k, v in sd.items()}}, ckpt)
        bv_dir = os.path.join(work, "bigvgan")
        os.makedirs(bv_dir)
        bv_path = os.path.join(bv_dir, "g_00000000")
        torch.save({"generator": {k: v.cpu() for k, v in blob["generator"].items()}}, bv_path)
        with open(os.path.join(bv_dir, "config.json"), "w", encoding="utf-8") as f:
            json.dump(bv, f)
        rng = np.random.default_rng(seed)
        refs, manifest = [], []
        lo, hi = traffic["ref_seconds"]
        for i in range(traffic["refs"]):
            p = os.path.join(work, f"ref{i}.wav")
            write_clip(p, lo + (hi - lo) * i / max(traffic["refs"] - 1, 1), 120 + 23 * i, rng)
            refs.append(p)
            manifest.append([p, "-", "0", str(i % 4)])
        man_path = os.path.join(work, "manifest.txt")
        with open(man_path, "w", encoding="utf-8") as f:
            f.writelines("|".join(m) + "\n" for m in manifest)

        phases["files"] = time.perf_counter() - t_start
        synth = Synthesizer(hparams=hp, device=device)
        if synth.hparams.max_decoder_steps != hp.max_decoder_steps:   # tiny test cells
            synth.hparams = synth.hparams.replace(max_decoder_steps=hp.max_decoder_steps)
        synth.load(ckpt, bv_path, man_path)
        if synth.bigvgan is None:
            raise RuntimeError("Synthesizer.load did not load the BigVGAN checkpoint")
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

        # warm-up: every decode shape, every reference clip, and the vocoder
        # through one request of each kind (every request is one mel bucket)
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
        profiling.start()
        recording = True
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
        program = profiling.stop()
        recording = False
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
        mel_events = [ev for ev in rec.events if ev[0] == "mel"]
        seeds = compare.seed_stream(hp.seed, len(mel_events))
        mel_ev = {id(ev[1]): i for i, ev in enumerate(mel_events)}
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
            b, row = by_text[reqs[r["i"]]["text"]]
            with open(b["reqs"][row][1], "rb") as f:
                bytes_bad += hashlib.md5(f.read()).hexdigest() != r["md5"]
        samples = []
        for r in sample:
            q = reqs[r["i"]]
            b, row = by_text[q["text"]]
            mel, mel_post, _gate, _align, n = b["items"][row]
            s = {"kind": q["kind"], "text": q["text"], "row": row, "n": n, "mel": mel,
                 "mel_post": mel_post, "decode_seed": seeds[mel_ev[id(b)]],
                 "wav": _wav_samples(b["reqs"][row][1])}
            if q["kind"] == "post":
                s["ratios"] = compare.normalize_ratios(*q["ratios"])
            else:
                s["ref"] = q["ref"]
            samples.append(s)
        spans = [d for d in program["spans"] if d["name"] == "vocode.bigvgan"]
        k9_expected = sum(len(counts_bv.k9_launches(bv, d["frames"])) for d in spans)
        k9_counted = program["counters"].get("aa_snake.launches", 0)

        # per-layer records, before the reference runs on the card
        per_layer, breakdown = {}, None
        if trace and cuda:
            k1_hidden = sum(k["start"].elapsed_time(k["end"]) / 1e3 for k in rec.k1[n_warm_k1:]
                            if t_prof0 <= k["t"] < t_prof1)
            tr = core.device_trace(prof, anchor, rec.spans.items, [(K1_KERNELS, k1_hidden)])
            win_batches = rec.batches[n_warm_batches:]
            sent = {reqs[r["i"]]["text"]: r["sent"] for r in rows}
            prec = {"window_s": t1 - t0, "trace_window_s": t_prof, "busy_s": tr["busy_s"],
                    "trace_span": (t_prof0, t_prof1), "program": program,
                    "k9_kernel_s": sum(t for n, t in tr["kernels"].items() if K9_KERNEL in n),
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
        numbers = serve_numbers(sd, blob["generator"], bv, hpd, samples, manifest, device,
                                quant=quant)
        phases["reference"] = time.perf_counter() - t_ref
        numbers["bytes"] = bytes_bad
        numbers["k9_launches"] = abs(k9_counted - k9_expected) if cuda else 0
        checks = {k: {"value": numbers[k], "limit": {**compare.LIMITS, **LIMITS}[k]}
                  for k in CHECKS}
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
        rms = numbers["wav_rms"] or [0.0]
        log(f"serve_bigvgan: {len(rows)} replies, {failed} failed, sample {len(samples)}; "
            f"reference wav rms {min(rms):.4f}-{max(rms):.4f}, largest share above 0.99 "
            f"{numbers['wav_clip']:.5f}; K9 launches {k9_counted} of {k9_expected} in "
            f"{len(spans)} vocoder calls; set-up {setup_s:.2f} s "
            f"({', '.join(f'{k} {v:.2f}' for k, v in phases.items())})")
        return result
    finally:
        if recording:
            profiling.stop()
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
