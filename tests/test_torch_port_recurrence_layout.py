"""The host-side arithmetic of the recurrence kernels K3/K4 (CPU only).

The wrappers in ``ops/teacher_fwd.py`` size the kernels' work buffers from
constants that ``csrc/teacher_common.cuh`` defines for the device code; a
buffer sized with a stale constant would be overrun on the card, where no
CPU test reaches.  These tests hold the Python constants to the header and
check the sizes at the full-width defaults and at the odd widths of the
card tests (``tests/test_torch_port_cuda.py::ODD``).
"""

import os
import re

import pytest

from tacotron2_vae_torch.ops import teacher_fwd as tf

HEADER = os.path.join(os.path.dirname(tf.__file__), os.pardir, "csrc", "teacher_common.cuh")


def _header_constants():
    with open(HEADER) as f:
        text = f.read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("py_name,c_name", [("SPLIT", "kSplit"), ("CLUSTER", "kNC"),
                                            ("Q_CHUNK", "kQChunk"), ("TILE_K", "kTileK")])
def test_python_constants_match_the_kernel_header(py_name, c_name):
    assert getattr(tf, py_name) == _header_constants()[c_name]


def test_max_rows_is_one_wgmma_tile():
    # the bf16 products take all B rows as the warpgroup's M = 64 tile
    assert tf.MAX_ROWS == 64


# (T, B, S, E, H, P, A): the full-width defaults and the card tests' odd widths
FULL = (512, 64, 128, 512, 1024, 256, 128)
ODD = (6, 63, 70, 68, 72, 36, 24)


@pytest.mark.parametrize("dims,bf16,want", [
    # rows padded to the 64-deep reduction tile: 1792 and 2560 already are
    (FULL, True, {"part": 0, "qpart": 16 * 64 * 128, "xa": 2 * 64 * 1792, "xd": 2 * 64 * 2560}),
    # P+E+H = 176 -> 192, 2H+E = 212 -> 256; one query partial (H = 72 < 64 * 2)
    (ODD, True, {"part": 0, "qpart": 2 * 63 * 24, "xa": 2 * 64 * 192, "xd": 2 * 64 * 256}),
    # the float32 stream keeps the K-split partials and needs no bf16 operands
    (ODD, False, {"part": 4 * 63 * 4 * 72, "qpart": 2 * 63 * 24, "xa": 0, "xd": 0}),
], ids=["full_bf16", "odd_bf16", "odd_f32"])
def test_forward_scratch_sizes(dims, bf16, want):
    assert tf.fwd_scratch(*dims, bf16) == want


def test_backward_work_sizes_follow_the_argument_order():
    T, B, S, E, H, P, A = FULL
    Fn = 32
    sizes = tf.bwd_work(B, S, E, H, P, A, Fn)
    # dx_dec, dh_att carry, dctx carry, dc_att, dc_dec, dw_prev, dwcum, dq,
    # the dv and dWld partials of every (row, attention CTA), a zero row
    assert sizes == (B * (2 * H + E), B * H, B * E, B * H, B * H, B * S, B * S, B * A,
                     B * tf.CLUSTER * A, B * tf.CLUSTER * Fn * A, S)


@pytest.mark.parametrize("a,b,want", [(0, 4, 0), (1, 4, 1), (128, 64, 2), (176, 64, 3)])
def test_cdiv(a, b, want):
    assert tf.cdiv(a, b) == want
