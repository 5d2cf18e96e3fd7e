"""The host-side arithmetic of the recurrence kernels K3/K4 (CPU only).

The wrappers in ``ops/teacher_fwd.py`` size the kernels' work buffers from
constants that ``csrc/teacher_common.cuh`` defines for the device code; a
buffer sized with a stale constant would be overrun on the card, where no
CPU test reaches.  These tests hold the Python constants to the header and
check the sizes at the full-width defaults and at the odd widths of the
card tests (``tests/test_torch_port_cuda.py::ODD``), and the wrappers'
stream dtype codes (K3/K4's and K1's) to the sources' dispatch.
"""

import os
import re

import pytest
import torch

from tacotron2_vae_torch.ops import teacher_fwd as tf
from _torch_port_common import one_thread  # noqa: F401 (autouse)

CSRC = os.path.join(os.path.dirname(tf.__file__), os.pardir, "csrc")
HEADER = os.path.join(CSRC, "teacher_common.cuh")


def _header_constants():
    with open(HEADER) as f:
        text = f.read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("py_name,c_name", [("SPLIT", "kSplit"), ("CLUSTER", "kNC"),
                                            ("Q_CHUNK", "kQChunk"), ("TILE_K", "kTileK"),
                                            ("GRAPHS", "kGraphs")])
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


def test_ring_alignment_matches_the_backward_kernel():
    with open(os.path.join(CSRC, "teacher_bwd.cu")) as f:
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", f.read()))
    assert tf.RING_ALIGN == int(consts["kRingAlign"])


def test_backward_ring_sizes_follow_the_ring_order():
    C, B, S, H, A, Fn, K = 16, 64, 384, 1024, 128, 32, 31
    # att_query partials, ta, M, N (2K taps), loc, de; each already a
    # multiple of 64 floats at these widths
    assert tf.bwd_ring(C, B, S, H, A, Fn, K) == (
        C * 16 * B * A, C * B * S * A, C * B * S * Fn, C * B * S * 2 * K, C * B * S * Fn,
        C * B * S)
    # the odd widths: rounded up to RING_ALIGN
    sizes = tf.bwd_ring(3, 63, 70, 72, 24, 6, 31)
    assert all(n % tf.RING_ALIGN == 0 for n in sizes)
    assert sizes[0] == 3 * 2 * 63 * 24 + 16 and sizes[-1] == 3 * 63 * 70 + 18


# (T, S, C): 25.6 MB of coefficients a step at (64, 384) and 8.9 MB at
# (64, 128) give C 16, the cap; 65.8 MB at S = 1000 gives 8; a step past
# RING_BYTES / 4 still takes the least chunk, 4; T bounds C
@pytest.mark.parametrize("T,S,want", [(1344, 384, 16), (512, 128, 16), (1344, 1000, 8),
                                      (1344, 4000, 4), (5, 384, 5), (2, 128, 2)])
def test_backward_chunk_adapts_to_the_step_size(T, S, want):
    C = tf.bwd_chunk(T, 64, S, 1024, 128, 32, 31)
    assert C == want
    # graph nodes a reverse step: five on the chain, three a chunk
    assert C < 3 or 5 + 3 / C <= 6


@pytest.mark.parametrize("a,b,want", [(0, 4, 0), (1, 4, 1), (128, 64, 2), (176, 64, 3)])
def test_cdiv(a, b, want):
    assert tf.cdiv(a, b) == want


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("module,source", [("teacher_fwd", "teacher_common.cuh"),
                                           ("decoder_loop", "decoder_loop.cu")],
                         ids=["K3_K4", "K1"])
def test_dtype_codes_match_the_kernel_sources(module, source):
    """The wrappers' stream dtype codes are the C side's: K3/K4's
    ``StreamType`` enum, K1's dispatch ``switch``; float16 has a code of its
    own, so it cannot be read as another type."""
    import tacotron2_vae_torch.ops.decoder_loop as dl

    dtypes = (tf if module == "teacher_fwd" else dl).DTYPES
    text = _source(source)
    if module == "teacher_fwd":
        enum = re.search(r"enum StreamType \{([^}]*)\}", text).group(1)
        codes = {name: int(v) for name, v in re.findall(r"(k\w+) = (\d+)", enum)}
        assert codes == {"kF32": 0, "kBF16": 1, "kF16": 2}
        want = {torch.float32: codes["kF32"], torch.bfloat16: codes["kBF16"],
                torch.float16: codes["kF16"]}
    else:
        pattern = r"case (\d+): return \(int\)run_b<(\w+)>"
        cases = {t: int(c) for c, t in re.findall(pattern, text)}
        want = {torch.float32: cases["float"], torch.bfloat16: cases["__nv_bfloat16"],
                torch.float16: cases["__half"]}
    assert dtypes == want
    assert len(set(dtypes.values())) == 3

