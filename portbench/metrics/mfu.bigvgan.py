"""The served path's share of the card's peak with BigVGAN: the seconds
the model operations of the requests completed in the window (encoder,
VAE on a reference clip, decode steps, postnet; BigVGAN's convolutions
and K9) would take at the peak of their type
(``portbench.counts.bigvgan.serve_request_peak_s``), over the window."""

from portbench.counts import bigvgan


def read(rec):
    done = rec.get("completed", [])
    if not done:
        return None
    t = sum(bigvgan.serve_request_peak_s(rec["sizes"], r["S"], r["frames"], r["ref_frames"],
                                         rec["mel_bucket"]) for r in done)
    return 100.0 * t / rec["window_s"]
