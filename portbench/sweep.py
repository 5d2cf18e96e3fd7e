"""The knee of an open-loop serving cell: one run at each of a few rates.

    python3 -B -m portbench.sweep --workload serve_open --rates 4,5,6 --seconds 20 --seed N

Each run is the cell with its rate replaced; its log line gives the
latency medians of the first and last quarter of the window's requests
and the drain after the close.  The knee is the highest rate whose last
quarter waits no longer than its first and whose backlog drains at once.
Run once, when the cell is defined; the cell's rate is set from it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from portbench import core, serve


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    base = core.cell_spec(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        spec = copy.deepcopy(base)
        spec["traffic"]["arrivals"]["rate_per_s"] = rate
        logs = []
        r = serve.run(spec, args.seed, args.seconds, False, time.perf_counter(),
                      log=logs.append)
        print(json.dumps({"rate_per_s": rate, "correct": r["correct"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "log": logs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
