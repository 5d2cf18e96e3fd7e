"""Median, over the window's requests, of the time from the client's send
to the start of the ``synthesize_batch`` call that carried the request:
the HTTP front end and the micro-batcher's queue and window."""

from portbench.core import median


def read(rec):
    waits = [(b["t0"] - s) * 1e3 for b in rec.get("batches", []) for s in b["sent"]
             if s is not None]
    return median(waits) if waits else None
