"""Where WaveGlow's time goes on the card (full width, one 600-frame mel).

    python -m tacotron2_vae_torch.profile_vocoder

For float32 and bf16: the wall time of one ``infer`` (CUDA events, mean of
3 after a warm-up), then one call under ``torch.profiler`` with the device
time of each kernel (sum, count), the sums by kind (convolutions, matrix
products, elementwise passes, the rest) and the device's busy share of the
call.  Random weights from a fixed seed with a random ``end`` (scale
``END_SCALE``; ``chip_smoke.py`` serves the same model).  Prints one JSON
line per dtype.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from .models.waveglow import WaveGlow, init_weights

FRAMES, SEED, END_SCALE = 600, 1234, 0.01
KINDS = (("conv", ("fprop", "conv", "implicit", "winograd", "dgrad")),
         ("product", ("gemm", "cutlass", "xmma", "nvjet")),
         ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce", "cat")))


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(key in low for key in keys):
            return k
    return "other"


@torch.no_grad()
def profile(wg, mel, dtype, w_inv):
    gen = torch.Generator(device=mel.device).manual_seed(SEED)

    def run():
        return wg.infer(mel, 0.666, gen, dtype, w_inv)

    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        run()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / 3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels, kinds = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops; their device time is their kernels'
        k = kind(evt.key)
        kinds.setdefault(k, {"total_us": 0.0, "count": 0})
        kinds[k]["total_us"] += evt.device_time_total
        kinds[k]["count"] += evt.count
        kernels[evt.key[:90]] = {"total_us": evt.device_time_total, "count": evt.count,
                                 "kind": k}
    busy_us = sum(k["total_us"] for k in kinds.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["total_us"])[:12])
    return {"dtype": str(dtype).replace("torch.", ""), "frames": mel.shape[2],
            "wall_ms": wall_ms, "kernel_ms": busy_us / 1e3,
            "launches": sum(k["count"] for k in kinds.values()),
            "device_busy_share": busy_us / (wall_ms * 1e3), "by_kind": kinds, "top": top}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_vocoder needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    wg = init_weights(WaveGlow(), torch.Generator().manual_seed(SEED), end_scale=END_SCALE)
    wg = wg.to("cuda").eval().requires_grad_(False)
    w_inv = wg.inverse_weights()
    rng = np.random.RandomState(SEED)
    mel = torch.from_numpy((-6 + 2 * rng.rand(1, 80, FRAMES)).astype(np.float32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(dict(profile(wg, mel, dtype, w_inv), card=card)), flush=True)


if __name__ == "__main__":
    main()
