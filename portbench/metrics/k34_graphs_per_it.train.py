"""K3/K4 step-loop graphs instantiated per train step in the window
(``ops.teacher_fwd.graph_captures()``, both directions)."""


def read(rec):
    steps = rec.get("steps")
    return rec["k34_graphs"] / steps if steps else None
