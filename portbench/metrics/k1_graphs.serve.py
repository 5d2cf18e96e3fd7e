"""Decode graphs K1 instantiated in the window
(``ops.decoder_loop.graph_captures()``): a shape that misses the kernel's
graph cache pays one."""


def read(rec):
    return rec.get("k1_graphs")
