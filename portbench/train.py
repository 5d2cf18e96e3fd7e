"""The training runner: the port's ``training.train.train`` loop on a
corpus drawn from the seed.

Set-up: ``train_clips`` lines drawn without replacement, once for every
seed, from the reference corpus's train texts, each a 16 kHz tone-and-noise clip lasting
``silence_s`` plus its Hangul syllables at ``syllables_per_s`` (the
corpus's shapes; the audio is not speech); weights from the seed
(``weights``), which ``train`` loads with ``warm_start``; one train step
of a throw-away train state on every batch shape the loader will give in
the window (worked out with ``reference.loader``), so that no cuDNN
autotuning or kernel build falls in the window.  Then ``train`` runs at
the configuration's hparams: its first ``check_steps`` steps are the
check's, the window opens (after a device synchronise) at the next step
and closes at the first step called ``seconds`` later (after another);
that step is not taken and ``train`` is left by an exception.

The check: the reference takes the same first steps from the same
weights, batches and seed (``compare.train_numbers``).
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import re
import shutil
import tempfile
import time

import numpy as np

from . import compare, core, weights
from .reference import loader
from .serve import hp_dict


# the kernels that K3 (``teacher_fwd.cu``) and K4 (``teacher_bwd.cu``)
# launch, by the names the profiler gives them
K34_KERNELS = re.compile(r"(?:\(anonymous namespace\)|t2v)::(?:round_rows|lstm_tc|lstm_gemm|"
                         r"lstm_cell|att_query|att_fwd|dx_tc|gemm_nt|sum_split|lstm_bwd|"
                         r"att_bwd|sum_rows)[<(]")


class WindowClosed(Exception):
    """Raised inside ``train`` when the window has closed."""


def clip_seconds(text: str, traffic: dict) -> float:
    return traffic["silence_s"] + sum("가" <= c <= "힣" for c in text) / \
        traffic["syllables_per_s"]


def write_corpus(work: str, traffic: dict, clips: int, seed: int) -> tuple:
    """(train filelist, validation filelist) of the drawn clips."""
    from scipy.io import wavfile

    with open(os.path.join(core.BENCH_DIR, "data", traffic["texts"]), encoding="utf-8") as f:
        lines = [line.rstrip("\n").split("|") for line in f if line.strip()]
    # every seed trains on the same clips (the same work), drawn once; the
    # seed orders them (the loader's shuffle) and draws their noise
    rng = np.random.default_rng(seed)
    rows = []
    for i, j in enumerate(np.random.default_rng(0).choice(len(lines), clips, replace=False)):
        text, speaker, emotion = lines[j]
        k = int(16000 * clip_seconds(text, traffic))
        t = np.arange(k, dtype=np.float32) * np.float32(2 * np.pi * (110 + 5 * (i % 60)) / 16000)
        x = np.float32(0.3) * np.sin(t) + np.float32(0.01) * rng.standard_normal(
            k, dtype=np.float32)
        p = os.path.join(work, f"clip{i}.wav")
        wavfile.write(p, 16000, (x * 32767).astype(np.int16))
        rows.append(f"{p}|{text}|{speaker}|{emotion}\n")
    paths = []
    for name, part in (("train.txt", rows), ("val.txt", rows[:traffic["val_clips"]])):
        paths.append(os.path.join(work, name))
        with open(paths[-1], "w", encoding="utf-8") as f:
            f.writelines(part)
    return tuple(paths)


def batch_plan(flist: str, hpd: dict, seed: int, n_steps: int) -> list:
    """The loader's first ``n_steps`` batches: (items, (B, S, T))."""
    entries = loader.shuffled_entries(loader.read_filelist(flist), seed)
    toks = [len(loader.tokens(e[1], hpd)) for e in entries]
    frames = [(os.path.getsize(e[0]) - 44) // 2 // hpd["hop_length"] + 1 for e in entries]
    plan, epoch = [], 0
    while len(plan) < n_steps:
        for chunk in loader.epoch_chunks(len(entries), hpd["batch_size"], seed, epoch):
            plan.append(([(entries[i][0], entries[i][1]) for i in chunk],
                         loader.batch_shape([toks[i] for i in chunk],
                                            [frames[i] for i in chunk], hpd)))
            if len(plan) == n_steps:
                break
        epoch += 1
    return plan


def warm_shapes(hp, shapes, device) -> None:
    """One step of a throw-away train state on a batch of each shape."""
    import torch

    from tacotron2_vae_torch.training import train_state as tsm

    ts = tsm.create_train_state(hp, device)
    step = tsm.make_train_step(hp)
    gen = torch.Generator(device=device).manual_seed(0)
    for B, S, T in sorted(set(shapes)):
        lengths = torch.full((B,), S, dtype=torch.long, device=device)
        lengths[1:] = torch.randint(S // 2 + 1, S + 1, (B - 1,), generator=gen, device=device)
        out_len = torch.full((B,), T, dtype=torch.long, device=device)
        mel = torch.randn(B, hp.n_mel_channels, T, generator=gen, device=device) - 4.0
        gate = torch.zeros(B, T, device=device)
        gate[:, -1] = 1.0
        batch = {"text": torch.randint(1, hp.n_symbols, (B, S), generator=gen, device=device),
                 "input_lengths": torch.sort(lengths, descending=True)[0], "mel": mel,
                 "gate": gate, "output_lengths": out_len,
                 "speakers": torch.ones(B, hp.n_speakers, device=device),
                 "emotions": torch.zeros(B, hp.n_emotions, device=device)}
        step(ts, batch, gen)
    if device != "cpu":
        torch.cuda.synchronize()
    del ts, step


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", hp_overrides: dict | None = None, fault=None, quant=None,
        log=print) -> dict:
    """One run of a training cell.  ``hp_overrides``, ``fault`` (wraps the
    train step: ``fault(step) -> step``) and ``quant`` (the control's
    precision in the program's place) serve the benchmark's tests."""
    import torch

    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.ops import teacher_fwd as tf
    from tacotron2_vae_torch.training import train as tr

    traffic, sizes = spec["traffic"], spec["config"]["sizes"]
    cuda = device == "cuda"
    work = tempfile.mkdtemp(prefix="portbench_train_")
    inner = (tr.make_train_step, tr.prefetch, tf.teacher_fwd, tf.teacher_bwd)
    phases = {"imports": time.perf_counter() - t_start}
    try:
        flist, vlist = write_corpus(work, traffic, sizes["train_clips"], seed)
        phases["corpus"] = time.perf_counter() - t_start
        hp = create_hparams().replace(**{**sizes["tacotron2"], **(hp_overrides or {})})
        hp = hp.replace(seed=seed % 2 ** 31, training_files=flist, validation_files=vlist)
        hpd = hp_dict(hp)
        sd = weights.tacotron2(hp, seed, device)
        ckpt = os.path.join(work, "warm.pt")
        torch.save({"state_dict": {k: v.to(torch.bfloat16).cpu() if v.is_floating_point()
                                   else v.cpu() for k, v in sd.items()}}, ckpt)
        n_check = traffic["check_steps"]
        plan = batch_plan(flist, hpd, hp.seed,
                          n_check + math.ceil(seconds / traffic["min_step_s"]))
        phases["weights"] = time.perf_counter() - t_start
        warm_shapes(hp, [shape for _, shape in plan], device)
        phases["warm_shapes"] = time.perf_counter() - t_start

        st = {"calls": 0, "losses": [], "grad": None, "params": None, "t0": None, "t1": None,
              "lengths": [], "updated": [], "host_s": [], "wait_s": [], "k34": [],
              "prof": None, "graphs0": None, "trace_s": None, "out1": None}

        pause = core.Pause()

        def stop_trace():
            """The profiler records the window's first TRACE_S seconds; it
            stops while the prefetch thread starts no copy."""
            if st["prof"] is not None and st["trace_s"] is None:
                with pause.hold():
                    torch.cuda.synchronize()
                    st["trace_s"] = time.perf_counter() - st["t0"]
                    st["k34_traced"] = len(st["k34"])
                    st["prof"].__exit__(None, None, None)

        def counters():
            return sum(tf.graph_captures().values()) if cuda else 0

        spans = core.Spans()

        def span(name):
            return spans(name) if trace else contextlib.nullcontext()

        def make_step(*args, **kwargs):
            step = inner[0](*args, **kwargs)
            if fault is not None:
                step = fault(step)

            def wrapped(ts, batch, generator=None):
                i = st["calls"]
                st["calls"] += 1
                if i == n_check:
                    st["params"] = {k: p.detach().clone() for k, p in ts.model.named_parameters()}
                    if cuda:
                        torch.cuda.synchronize()
                    if trace and cuda:
                        st["prof"], st["anchor"] = core.start_trace()
                    st["graphs0"] = counters()
                    st["setup_s"] = time.perf_counter() - t_start
                    st["t0"] = time.perf_counter()
                elif i > n_check and time.perf_counter() - st["t0"] >= seconds:
                    if cuda:
                        torch.cuda.synchronize()
                    st["t1"] = time.perf_counter()
                    st["graphs1"] = counters()
                    stop_trace()
                    raise WindowClosed
                elif (st["prof"] is not None and st["trace_s"] is None
                      and time.perf_counter() - st["t0"] >= core.TRACE_S):
                    stop_trace()
                t = time.perf_counter()
                hook = None
                if i == 0:      # the first step's model output, for the check
                    hook = ts.model.register_forward_hook(
                        lambda mod, inp, out: st.__setitem__(
                            "out1", out.mel_outputs_postnet.detach().clone()))
                with span("step"):
                    m = step(ts, batch, generator)
                if hook is not None:
                    hook.remove()
                if i >= n_check:
                    st["host_s"].append(time.perf_counter() - t)
                    st["lengths"].append((batch["input_lengths"], batch["output_lengths"]))
                    st["updated"].append(m["updated"])
                else:
                    st["losses"].append(m["loss"].detach().clone())
                    if i == 0:
                        opt = ts.optimizer
                        st["grad"] = {k: opt.state[p]["exp_avg"].detach().clone() / 0.1
                                      if p in opt.state else torch.zeros_like(p)
                                      for k, p in ts.model.named_parameters()}
                return m
            return wrapped

        def timed_prefetch(iterable, *args, **kwargs):
            move = kwargs.get("transform")
            if trace and move is not None:
                def held(item):
                    with pause.work():
                        return move(item)
                kwargs["transform"] = held
            it = inner[1](iterable, *args, **kwargs)
            try:
                while True:
                    t = time.perf_counter()
                    try:
                        with span("data"):
                            item = next(it)
                    except StopIteration:
                        return
                    if st["t0"] is not None:
                        st["wait_s"].append(time.perf_counter() - t)
                    yield item
            finally:
                it.close()

        def shaped_kernel(kind):
            """The K3/K4 entry, recording the shapes of each call in the window."""
            fn = inner[2] if kind == "fwd" else inner[3]

            def call(*args, **kwargs):
                if st["t0"] is None or st["t1"] is not None:
                    return fn(*args, **kwargs)
                if kind == "fwd":
                    T, B = args[1].shape[:2]
                    S, dt, masks = args[2].shape[1], args[0]["attn_w"].dtype, args[5]
                else:
                    T, B, S = args[5][2].shape
                    dt, masks = args[0]["attn_w"].dtype, args[3]
                st["k34"].append({"kind": kind, "T": int(T), "B": int(B), "S": int(S),
                                  "dtype": str(dt).split(".")[-1], "masks": masks is not None})
                return fn(*args, **kwargs)
            call.__dict__.update(fn.__dict__)      # the entry keeps counters on itself
            return call

        tr.make_train_step, tr.prefetch = make_step, timed_prefetch
        if trace and cuda:
            tf.teacher_fwd, tf.teacher_bwd = shaped_kernel("fwd"), shaped_kernel("bwd")
        try:
            tr.train(os.path.join(work, "out"), "", ckpt, True, hp, device=device)
        except WindowClosed:
            pass
        finally:
            for fn, orig in ((tf.teacher_fwd, inner[2]), (tf.teacher_bwd, inner[3])):
                if fn is not orig:
                    orig.__dict__.update(fn.__dict__)
            tr.make_train_step, tr.prefetch, tf.teacher_fwd, tf.teacher_bwd = inner
        if st["t1"] is None:
            raise RuntimeError("train() ended before the window closed")
        device_rec = core.device_info() if cuda else None
        window = st["t1"] - st["t0"]
        lens = [(i.cpu().numpy(), o.cpu().numpy()) for i, o in st["lengths"]]
        frames = float(sum(int(o.sum()) for _, o in lens))
        failed = sum(not bool(u) for u in st["updated"])
        metrics = {}
        for m in spec["end_to_end"]:
            v = {"train_frames_per_s": frames / window, "setup_s": st["setup_s"]}[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = None
        if trace and cuda:
            trd = core.device_trace(st["prof"], st["anchor"], spans.items)
            prec = {"window_s": window, "trace_window_s": st["trace_s"], "busy_s": trd["busy_s"],
                    "step_host_s": st["host_s"], "data_wait_s": st["wait_s"],
                    "k34": st["k34"][:st["k34_traced"]],
                    "k34_kernel_s": sum(t for n, t in trd["kernels"].items()
                                        if K34_KERNELS.search(n)),
                    "k34_graphs": st["graphs1"] - st["graphs0"], "steps": len(lens),
                    "items": [(int(s), int(t)) for i, o in lens for s, t in zip(i, o)],
                    "sizes": sizes}
            metrics = core.per_layer_metrics(spec, prec)
            breakdown = trd["breakdown"]
            device_rec["busy_s"] = trd["busy_s"]
            device_rec["window_s"] = st["trace_s"]
        prog = {"losses": [float(x) for x in st["losses"]], "grad": st["grad"],
                "params": st["params"], "out1": st["out1"]}
        setup_s = st["setup_s"]
        del st
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        batches = [loader.make_batch(items, hpd, device) for items, _ in plan[:n_check]]
        numbers = compare.train_numbers(sd, batches, hpd, hp.seed, prog, device, quant=quant)
        phases["reference"] = time.perf_counter() - t_ref
        checks = compare.checks(numbers, compare.TRAIN_CHECKS)
        correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
        log(f"train: {len(lens)} steps in {window:.3f} s, reference losses "
            f"{numbers['ref_losses']}, program {prog['losses']}; grad_med "
            f"{numbers['grad_med']}; largest step loss gap "
            f"{numbers['loss']}; largest leaf gaps grad {numbers['grad']} change "
            f"{numbers['change']}; worst grad {numbers['worst_grad']}; worst change "
            f"{numbers['worst_change']}; left out of the change: {numbers['left_out']}; "
            f"set-up {setup_s:.2f} s "
            f"({', '.join(f'{k} {v:.2f}' for k, v in phases.items())}); shapes "
            f"{len(set(s for _, s in plan))} in {len(plan)} planned steps")
        result = {"correct": bool(correct), "attempted": len(lens), "failed": failed,
                  "metrics": metrics}
        if device_rec is not None:
            result["device"] = device_rec
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        return result
    finally:
        tr.make_train_step, tr.prefetch, tf.teacher_fwd, tf.teacher_bwd = inner
        shutil.rmtree(work, ignore_errors=True)
