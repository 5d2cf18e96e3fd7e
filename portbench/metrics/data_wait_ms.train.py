"""Mean time per step that the train loop waited on ``next()`` of the
prefetch iterator (the input pipeline) in the window."""


def read(rec):
    waits = rec.get("data_wait_s", [])
    return 1e3 * sum(waits) / len(waits) if waits else None
