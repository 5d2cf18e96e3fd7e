"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 -B -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout.  Loads and warms the cell (the set-up,
``setup_s``), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints as its last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit (also the last lines
of standard error).  Exits non-zero, and prints no result, without a
CUDA card (or fewer than the cell asks for), or when a module of JAX or
of the JAX package is loaded by the end of the run.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Kernel caches inside the checkout, at fixed paths (the port builds
    its kernels into its own ``build/`` directory)."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


WATCH_S = 300.0     # a run still going then has every thread's stack written to stderr


def main(argv=None) -> int:
    faulthandler.dump_traceback_later(WATCH_S, repeat=True)
    try:
        return run_cell(argv)
    finally:
        faulthandler.cancel_dump_traceback_later()


def run_cell(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
    from portbench import core

    cache_dirs(core.ROOT)
    spec = core.cell_spec(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    runner = importlib.import_module("portbench." + spec["traffic"]["runner"])
    result = runner.run(spec, args.seed, args.seconds, bool(args.trace), t_start,
                        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    bad = core.forbidden_modules() + result.pop("forbidden_in_client", [])
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks
    print(core.checks_line(checks), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
