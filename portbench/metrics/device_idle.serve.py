"""The card's idle share of the window: 1 - busy / window, busy being the
union of the profiler's kernel and copy intervals plus the CUDA-event
time of each ``decode_loop`` call, whose body (a conditional graph node)
the profiler does not see."""


def read(rec):
    w = rec.get("trace_window_s")
    if not w or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / w)
