"""The card's idle share of the traced window: 1 - busy / window, busy
being the union of the profiler's kernel, copy and set intervals (K3/K4's
step loops are plain CUDA graphs, whose kernels the profiler sees)."""


def read(rec):
    w = rec.get("trace_window_s")
    if not w or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / w)
