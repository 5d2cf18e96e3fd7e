"""Where the decode loop's time goes on the card (kernel K1, full width).

    python -m tacotron2_vae_torch.profile_decode

First the kernel's L2 facts on this card (``decoder_loop.info``: the most
bytes it may set aside for persisting lines, the largest access-policy
window, the persisting limit before any decode).  For B in ``ROWS`` and
each weight dtype: the wall time of one ``decode_loop`` call (CUDA events,
its step loop as the cached graph, mean of 3) and the graphs instantiated
over those calls (0: a repeated call at one shape reuses its graph); then
one call that launches each step's kernels on the stream
(``decoder_loop.USE_GRAPH = False``: the profiler does not see the
launches of a conditional graph node's body one by one), under
``torch.profiler`` and between two CUDA events: the device time of each of
K1's kernels (sum, count, mean), that call's wall time and the device's
busy share of it (kernel time over that wall time; both from the one
stream-launched call, so the share is not the graph's).  Random full-width
weights from a fixed seed, S=64, the gate threshold above every sigmoid so
every call runs ``STEPS`` steps (the shape ``chip_smoke.py`` holds the
kernel against its twin at).  Then, per batch size, the split of one
``Tacotron2.infer`` call (S=32 text, 600 steps, the serving path of
``chip_smoke.py``) into encoder, decode loop and postnet, by host clock
around synchronised stages.  Prints one JSON line per configuration.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from .config import create_hparams
from .models.tacotron2 import Tacotron2, compute_dtype, init_weights
from .ops import decoder_loop as dl
from .ops.layers import linear

STEPS, ROWS, SEQ = 200, (1, 4), 64
DTYPES = (torch.bfloat16, torch.float32)


def profile(dec, B, S, steps, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    memory = torch.from_numpy(
        (rng.randn(B, S, dec.hp.encoder_embedding_dim) * 0.3).astype(np.float32)).to(device)
    pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight)
    kw = dl.pack_weights(dec, dtype)
    args = dict(max_steps=steps, gate_threshold=1.0, seed=7, dropout_on=True)

    def run():
        return dl.decode_loop(kw, memory, pmem, None, **args)

    run()
    torch.cuda.synchronize()
    graphs = dl.graph_captures()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        run()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / 3

    # the profiler does not see a conditional graph node's body launch by
    # launch, so the profiled call launches each step's kernels on the stream
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    use_graph, dl.USE_GRAPH = dl.USE_GRAPH, False
    try:
        run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
        stream_ms = start.elapsed_time(end)
    finally:
        dl.USE_GRAPH = use_graph
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops; their device time is their kernels'
        dev_us = evt.device_time_total
        kernels[evt.key[:90]] = {"total_us": dev_us, "count": evt.count,
                                 "mean_us": dev_us / max(evt.count, 1)}
    busy_us = sum(k["total_us"] for k in kernels.values())
    return {"B": B, "S": S, "steps": steps, "dtype": str(dtype).replace("torch.", ""),
            "wall_ms": wall_ms, "us_per_step": wall_ms * 1e3 / steps,
            "stream_ms": stream_ms, "kernel_us_per_step": busy_us / steps,
            "device_busy_share": busy_us / (stream_ms * 1e3) if stream_ms else None,
            "graphs_instantiated": dl.graph_captures() - graphs, "kernels": kernels}


@torch.no_grad()
def profile_infer(model, B, S=32, steps=600, seed=0):
    """Host-clock split of one ``Tacotron2.infer`` (bf16 defaults) into
    encoder, decoder loop and postnet; the gate never fires."""
    hp = model.hp
    device = next(model.parameters()).device
    rng = np.random.RandomState(seed)
    text = torch.from_numpy(rng.randint(1, hp.n_symbols, (B, S))).to(device)
    lengths = torch.full((B,), S, device=device)
    style = torch.from_numpy((rng.randn(B, hp.E) * 0.1).astype(np.float32)).to(device)
    dtype = compute_dtype(hp)
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    for _ in range(2):  # the first pass warms up
        marks.clear()
        mark()
        emb = model.transcript_embedding.weight[text]
        memory = model.encoder(emb, lengths, dtype=dtype, mask_conv_inputs=True)
        memory = memory + style[:, None, :]
        mark()
        mel, *_ = model.decoder.infer(memory, seed=1, max_steps=steps,
                                      gate_threshold=hp.gate_threshold, dtype=dtype,
                                      memory_lengths=lengths)
        mark()
        model.postnet(mel, dtype=dtype)
        mark()
    enc, dec, post = (1e3 * (b - a) for a, b in zip(marks, marks[1:]))
    return {"infer_B": B, "S": S, "steps": steps, "encoder_ms": enc, "decode_loop_ms": dec,
            "postnet_ms": post, "decode_us_per_frame": 1e3 * (enc + dec + post) / steps}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    device = torch.device("cuda")
    hp = create_hparams()
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(1234))
    with torch.no_grad():
        model.decoder.gate_layer.linear_layer.bias.fill_(-10.0)
    model = model.to(device).eval().requires_grad_(False)
    print(json.dumps({"l2": dl.info(), "card": card}), flush=True)
    for dtype in DTYPES:
        for B in ROWS:
            row = profile(model.decoder, B, SEQ, STEPS, dtype, device)
            row["card"] = card
            print(json.dumps(row), flush=True)
    for B in ROWS:
        print(json.dumps(dict(profile_infer(model, B), card=card)), flush=True)


if __name__ == "__main__":
    main()
