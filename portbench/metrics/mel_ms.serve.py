"""Median synchronised wall time of ``Synthesizer.synthesize_mel_batch``
(text front end, encoder, decode loop K1, postnet) in the window."""

from portbench.core import median


def read(rec):
    ms = [s * 1e3 for s in rec.get("mel_s", [])]
    return median(ms) if ms else None
