"""The controls and faults of a BigVGAN serving cell, read on the card at
the cell's size (as ``control.py`` reads the other cells').

    python3 -B -m portbench.control_bigvgan --workload CELL --seeds 1,2,3 --seconds S

For each seed, one run of the cell with the program as it is (the sound
readings), then the controls: the reference's wav with TF32 convolutions
and on bfloat16 operands in the program's place; and the faults: the
activation without its anti-aliasing (SnakeBeta alone, no Up or Down), and
a served answer altered where it is produced.  Prints one JSON line per
run with its numbers; ``serve_bigvgan.LIMITS["wav"]`` is set between the
sound readings and the controls.  The benchmark's own runs never run
these.
"""

from __future__ import annotations

import argparse
import json
import sys


def no_antialias(synth):
    """A fault: every activation of the loaded BigVGAN is SnakeBeta alone."""
    import torch

    def snake_alone(act):
        def forward(x):
            a = torch.exp(act.act.alpha)[:, None]
            b = torch.exp(act.act.beta)[:, None]
            return x + 1.0 / (b + 1e-9) * torch.sin(x * a) ** 2
        return forward
    from tacotron2_vae_torch.models.bigvgan import Activation1d

    for m in synth.bigvgan.modules():
        if isinstance(m, Activation1d):
            m.forward = snake_alone(m)


def variants() -> dict:
    from portbench import control

    return {"program": {}, "control_reference_tf32": {"quant": "tf32"},
            "control_reference_bf16": {"quant": "bfloat16"},
            "fault_no_antialias": {"fault": no_antialias},
            "fault_answer_altered": {"fault": control.alter_answer}}


def main(argv=None) -> int:
    from portbench import control, core, serve_bigvgan

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="serve_bigvgan_saturated")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--only", default=None, help="comma-separated variants")
    args = p.parse_args(argv)
    spec = core.cell_spec(args.workload)
    only = set(args.only.split(",")) if args.only else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, kw in variants().items():
            if only and name not in only:
                continue
            print(json.dumps(control.run_variant(spec, serve_bigvgan, name, kw, seed,
                                                 args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
