"""The served path's share of the card's peak: the seconds the model
operations of the requests completed in the window (encoder, VAE on a
reference clip, decode steps, postnet, WaveGlow) would take at the peak
of their type (``portbench.counts.serve_request_peak_s``), over the
window."""

from portbench import counts


def read(rec):
    done = rec.get("completed", [])
    if not done:
        return None
    t = sum(counts.serve_request_peak_s(rec["sizes"], r["S"], r["frames"], r["ref_frames"],
                                        rec["mel_bucket"]) for r in done)
    return 100.0 * t / rec["window_s"]
