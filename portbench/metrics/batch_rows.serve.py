"""Mean requests per ``Synthesizer.synthesize_batch`` call in the window
(the micro-batcher's batch size)."""


def read(rec):
    rows = [b["rows"] for b in rec.get("batches", [])]
    return sum(rows) / len(rows) if rows else None
