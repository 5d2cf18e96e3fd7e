"""Kernel K9's share of its roofline: the sum of its bounds
(``portbench.counts.bigvgan.k9_bound_s``, 109 launches a generator call,
from each call's padded mel frames) over the device time of its kernel in
the profiler's trace, for the program's ``vocode.bigvgan`` spans that
started in the traced part of the window (a call runs whole inside it:
the profiler stops between batches).  A program without the span or the
kernel finds nothing."""

from portbench.counts import bigvgan


def read(rec):
    prog = rec.get("program") or {}
    t0, t1 = rec.get("trace_span", (None, None))
    frames = [s["frames"] for s in prog.get("spans", [])
              if s["name"] == "vocode.bigvgan" and "frames" in s and t0 is not None
              and t0 <= s["start"] <= t1]
    t = rec.get("k9_kernel_s", 0.0)
    if not frames or t <= 0:
        return None
    bv = rec["sizes"]["bigvgan"]
    return 100.0 * sum(bigvgan.k9_bound_s(bv, f) for f in frames) / t
