"""The train step's share of the card's peak: the seconds the forward and
backward operations of the window's batches, counted on the real
(unpadded) lengths, would take at the peak of their type
(``portbench.counts.train_item_peak_s``), over the window."""

from portbench import counts


def read(rec):
    items = rec.get("items", [])
    if not items:
        return None
    t2 = rec["sizes"]["tacotron2"]
    return 100.0 * sum(counts.train_item_peak_s(t2, S, T) for S, T in items) / rec["window_s"]
