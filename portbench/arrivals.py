"""The one generator of a serving mix's arrivals, driven by the mix's
``arrivals`` parameters (``traffic/<mix>.json``):

- ``loop``: ``"closed"``, with ``clients``: each client sends its next
  request when its last reply has come; or ``"open"``: every request is
  sent at its due time, whatever is still in flight.
- ``rate_per_s`` (open): the mean rate over the window; the window gets
  ``round(rate_per_s * seconds)`` arrivals.
- ``gap_shape`` (open, default 1): the shape of the gamma law of the gaps
  between arrivals: 1 is a Poisson process, larger is steadier (the gaps'
  coefficient of variation is ``1 / sqrt(gap_shape)``).
- ``on_s`` and ``off_s`` (open, optional): bursts: arrivals only in the
  first ``on_s`` seconds of every ``on_s + off_s``.

The gaps are drawn once, in one order for every seed (the seed orders
the requests that arrive), and scaled so that the window's arrivals end
one mean gap before its close: a renewal process given its count.  Queue
tails swing with the order of the gaps far more than with the requests,
so a seed that reordered them would change the work.  A new arrival
pattern is a new data file.
"""

from __future__ import annotations

import numpy as np


def count(arr: dict, seconds: float) -> int | None:
    """The window's number of arrivals of an open loop, None for a closed one."""
    if arr["loop"] == "closed":
        return None
    return int(round(float(arr["rate_per_s"]) * seconds))


def dues(arr: dict, seconds: float, n: int) -> np.ndarray:
    """The due times of ``n`` open-loop arrivals, in seconds after the
    window opens, ascending and inside the window."""
    gaps = np.random.default_rng(0).gamma(float(arr.get("gap_shape", 1.0)), 1.0, n + 1)
    on, off = arr.get("on_s"), float(arr.get("off_s", 0.0))
    if on is None or off <= 0.0:
        return np.cumsum(gaps)[:n] / gaps.sum() * seconds
    on, cycle = float(on), float(on) + off
    full = np.floor(seconds / cycle)
    span = full * on + min(seconds - full * cycle, on)        # on-time inside the window
    u = np.cumsum(gaps)[:n] / gaps.sum() * span
    return np.floor(u / on) * cycle + np.mod(u, on)
