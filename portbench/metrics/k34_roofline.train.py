"""The recurrence kernels K3 and K4's share of their roofline: the sum of
their bounds (``portbench.counts.k3_bound_s``/``k4_bound_s``, from the
shapes of each ``teacher_fwd`` and ``teacher_bwd`` call in the traced part
of the window) over the device time of their kernels in the profiler's
trace of that part (``k34_kernel_s``)."""

from portbench import counts


def read(rec):
    calls, t = rec.get("k34", []), rec.get("k34_kernel_s", 0.0)
    if not calls or t <= 0:
        return None
    t2 = rec["sizes"]["tacotron2"]
    fn = {"fwd": counts.k3_bound_s, "bwd": counts.k4_bound_s}
    bound = sum(fn[c["kind"]](t2, c["B"], c["S"], c["T"], c["dtype"], c["masks"])
                for c in calls)
    return 100.0 * bound / t
