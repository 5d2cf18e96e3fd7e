"""Median host time of each train-step call in the window (the step
returns without waiting for the card: this is its dispatch cost)."""

from portbench.core import median


def read(rec):
    ms = [s * 1e3 for s in rec.get("step_host_s", [])]
    return median(ms) if ms else None
