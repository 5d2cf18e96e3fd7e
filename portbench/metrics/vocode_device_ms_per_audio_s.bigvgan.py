"""Device time of BigVGAN's generator over the audio it made: the sum of
the CUDA-event pairs of the program's ``vocode.bigvgan`` spans in the
window (``device_ms``) over the seconds of the counter
``bigvgan.audio_samples`` (the samples ``vocode`` returned).  A program
without the span finds nothing."""


def read(rec):
    prog = rec.get("program") or {}
    ms = [s["device_ms"] for s in prog.get("spans", [])
          if s["name"] == "vocode.bigvgan" and "device_ms" in s]
    samples = prog.get("counters", {}).get("bigvgan.audio_samples", 0)
    if not ms or not samples:
        return None
    return sum(ms) / (samples / rec["sizes"]["tacotron2"]["sampling_rate"])
