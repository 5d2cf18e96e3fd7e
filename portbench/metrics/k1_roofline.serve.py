"""The decode loop K1's share of its roofline: the sum of its bounds
(``portbench.counts.k1_bound_s``, from each call's rows, text length and
steps) over the sum of its device time, by CUDA events around each
``decode_loop`` call in the window."""

from portbench import counts


def read(rec):
    calls = rec.get("k1", [])
    t = sum(c["ms"] for c in calls) / 1e3
    if not calls or t <= 0:
        return None
    t2 = rec["sizes"]["tacotron2"]
    bound = sum(counts.k1_bound_s(t2, c["B"], c["S"], c["steps"], c["dtype"]) for c in calls)
    return 100.0 * bound / t
