"""Synchronised wall time of every ``Synthesizer.vocode`` call (WaveGlow)
in the window over the seconds of audio they made."""


def read(rec):
    audio = sum(rec.get("vocode_audio_s", []))
    return sum(rec["vocode_s"]) * 1e3 / audio if audio else None
