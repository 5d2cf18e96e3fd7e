"""K1's early-step check over many random memories, for checkouts side by side.

    python -m tacotron2_vae_torch.tools.k1_early_probe --trees OLD .

``chip_smoke.py`` holds K1 to its twin over the first ``K1_EARLY_STEPS``
steps at 1e-5 in bf16, on its own inputs.  This probe runs that check
(``chip_smoke.k1_compare``) on other memories: for each seed of ``SEEDS``
(memory from ``numpy.random.RandomState(100 + seed)``), B in ``ROWS`` with
the masked lengths of ``LENGTHS``, and prenet dropout off and on, at full
width (``chip_smoke.random_model``: random weights from its seed, gate bias
-10), S=64, ``STEPS`` steps, in ``DTYPE``.  Beside each reading stands a
second witness: the same twin on the CPU, whose float32 sums run in another
order than on the card.  Where the kernel fails the limit against the card's
twin, the card's twin against the CPU's twin tells a sum-order flip (the
two twins differ by as much) from a fault of the kernel (they agree, and the
kernel is far from both).

Each tree is a directory that holds a ``tacotron2_vae_torch`` package, as
for ``tools.decode_turns`` (the helpers come from this checkout's
``chip_smoke.py``); each runs in a process of its own and prints one ``PROBE
{json}`` line a case: the early errors of the kernel against the card's
twin (``kernel_twin``), against the CPU's twin (``kernel_cpu``) and of the
card's twin against the CPU's (``twin_cpu``), and the limits each pair
fails.  Then one ``SAME {json}`` line a case: whether every tree's kernel
gave bit-equal outputs.  A probe, not a gate: it exits 0 whatever it reads.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEEDS = range(6)
ROWS = (4, 8)
LENGTHS = (64, 50, 33, 17, 64, 41, 25, 9)
DTYPE = "bfloat16"
SEQ, STEPS = 64, 16


def child(tree: str, out: str):
    """One tree: every case's readings, and its kernel outputs to ``out``."""
    sys.path[:0] = [os.path.abspath(tree), ROOT]
    import chip_smoke as cs
    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.ops import decoder_loop as dl
    from tacotron2_vae_torch.ops.layers import linear

    device = torch.device("cuda")
    hp = create_hparams()
    dec = cs.random_model(hp, device).decoder
    kw = dl.pack_weights(dec, getattr(torch, DTYPE))
    kw_cpu = {k: v.cpu() for k, v in kw.items()}
    kept = {}
    for seed in SEEDS:
        for B in ROWS:
            rng = np.random.RandomState(100 + seed)
            memory = torch.from_numpy(
                (rng.randn(B, SEQ, hp.encoder_embedding_dim) * 0.3).astype(np.float32)).to(device)
            mask = torch.arange(SEQ, device=device)[None] < torch.tensor(
                LENGTHS[:B], device=device)[:, None]
            pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight)
            for dropout_on in (False, True):
                args = dict(max_steps=STEPS, gate_threshold=1.0, seed=7, dropout_on=dropout_on)
                got = dl.decode_loop(kw, memory, pmem, mask, **args)
                twin = dl.finish(*dl.decode_loop_plain(kw, memory, pmem, mask, **args), 1.0, 1)
                cpu = dl.finish(*dl.decode_loop_plain(kw_cpu, memory.cpu(), pmem.cpu(),
                                                      mask.cpu(), **args), 1.0, 1)
                cpu = tuple(x.to(device) for x in cpu)
                row = {"tree": tree, "dtype": DTYPE, "seed": seed, "B": B,
                       "dropout": dropout_on}
                for name, (a, b) in (("kernel_twin", (got, twin)), ("kernel_cpu", (got, cpu)),
                                     ("twin_cpu", (twin, cpu))):
                    errs, fails = cs.k1_compare(a, b, DTYPE, 1)
                    row[name] = {k: v for k, v in errs.items() if k.startswith("early_")}
                    row[name]["fails"] = fails
                print("PROBE " + json.dumps(row), flush=True)
                kept[(seed, B, dropout_on)] = [x.cpu() for x in got]
    torch.save(kept, out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trees", nargs="+", default=["."], help="checkouts to compare")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        child(args.child, args.out)
        return
    if not torch.cuda.is_available():
        raise SystemExit("k1_early_probe needs a CUDA card")
    build = "from tacotron2_vae_torch.ops import _build; _build.build(['decoder_loop'])"
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
              for tree in dict.fromkeys(args.trees)]
    if any(b.wait() != 0 for b in builds):
        raise SystemExit("a tree's kernel did not build")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"{i}.pt") for i in range(len(args.trees))]
        for tree, out in zip(args.trees, outs):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                            "--out", out], check=True, timeout=900)
        runs = [torch.load(out) for out in outs]
    for case, first in runs[0].items():
        same = all(all(map(torch.equal, first, run[case])) for run in runs[1:])
        seed, B, dropout_on = case
        print("SAME " + json.dumps({"seed": seed, "B": B, "dropout": dropout_on,
                                    "trees": args.trees, "bit_equal": same}), flush=True)


if __name__ == "__main__":
    main()
