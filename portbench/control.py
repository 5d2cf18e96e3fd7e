"""The controls and faults of a cell, read on the card at the cell's size.

    python3 -B -m portbench.control --workload CELL --seeds 1,2,3 --seconds S

For each seed, one run of the cell with the program as it is (its
numbers are the sound readings), then, for a serving cell, the control
(the reference at float8 in the program's place; the program with its
bfloat16 vocoder path on) and a served answer altered where it is
produced; for the training cell, the control (the reference at float8)
and the faults: a step that returns its state unchanged, half of the
batch left out.  Prints one JSON line per run with its numbers; the
limits in ``compare.LIMITS`` are set between the two readings.  The
benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def alter_answer(synth):
    """A fault: the vocoder's output altered where it is produced."""
    inner = synth.vocode

    def vocode(mel, *args, **kwargs):
        wav = inner(mel, *args, **kwargs).copy()
        wav[len(wav) // 4: len(wav) // 2] = 0.0
        return wav
    synth.vocode = vocode


def state_unchanged(step):
    """A fault: the step computes and then leaves the state as it was."""
    import torch

    def faulty(ts, batch, generator=None):
        params = [p.detach().clone() for p in ts.model.parameters()]
        opt = {k: {n: (v.clone() if torch.is_tensor(v) else v) for n, v in s.items()}
               for k, s in ts.optimizer.state.items()}
        m = step(ts, batch, generator)
        with torch.no_grad():
            for p, old in zip(ts.model.parameters(), params):
                p.copy_(old)
        for k, s in ts.optimizer.state.items():
            if k in opt:
                for n, v in opt[k].items():
                    if torch.is_tensor(v):
                        s[n].copy_(v)
            else:
                for v in s.values():
                    if torch.is_tensor(v):
                        v.zero_()
        return m
    return faulty


def half_batch(step):
    """A fault: half of the batch left out, the mean taken over the rest."""
    def faulty(ts, batch, generator=None):
        B = batch["text"].shape[0]
        return step(ts, {k: v[:B // 2] for k, v in batch.items()}, generator)
    return faulty


def variants(runner: str) -> dict:
    if runner == "serve":
        return {"program": {}, "control_fp8": {"quant": "fp8"},
                "control_vocoder_bf16": {"vocoder_dtype": "bfloat16"},
                "fault_answer_altered": {"fault": alter_answer}}
    return {"program": {}, "control_fp8": {"quant": "fp8"},
            "fault_state_unchanged": {"fault": state_unchanged},
            "fault_half_batch": {"fault": half_batch},
            "program_float32": {"hp_overrides": {"compute_dtype": "float32"}}}


def run_variant(spec, runner_mod, name, kw, seed, seconds, device="cuda", hp_overrides=None):
    import torch

    kw = dict(kw)
    hp_overrides = kw.pop("hp_overrides", hp_overrides)
    if kw.get("vocoder_dtype") == "bfloat16":
        kw["vocoder_dtype"] = torch.bfloat16
    t = time.perf_counter()
    r = runner_mod.run(spec, seed, seconds, False, t, device=device, hp_overrides=hp_overrides,
                       log=lambda msg: print(msg, file=sys.stderr, flush=True), **kw)
    return {"variant": name, "seed": seed, "correct": r["correct"],
            "numbers": {k: v["value"] for k, v in r["checks"].items()},
            "metrics": {k: v["value"] for k, v in r["metrics"].items()}}


def main(argv=None) -> int:
    import importlib

    from portbench import core

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--only", default=None, help="comma-separated variants")
    args = p.parse_args(argv)
    spec = core.cell_spec(args.workload)
    runner = spec["traffic"]["runner"]
    mod = importlib.import_module("portbench." + runner)
    only = set(args.only.split(",")) if args.only else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, kw in variants(runner).items():
            if only and name not in only:
                continue
            print(json.dumps(run_variant(spec, mod, name, kw, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
