"""The host-side arithmetic of kernels K2 and K1's attention step (CPU only).

K2 (``csrc/stft_mel.cu``) computes each frame's real FFT as an n_fft/2-point
complex FFT of its even and odd samples, in Stockham stages over two
swizzled shared buffers, with twiddles from a host table, and applies the
mel filterbank through a per-band [start, end) table over packed weights.
None of that index arithmetic runs on the CPU, where the wrapper takes the
plain twin, so these tests emulate it in numpy, step for step as the
kernel does it, and hold it to ``np.fft.rfft``, to the function in float64
and to the twin: an index error shows here before the card.  They also hold the Python constants to
the CUDA sources (K2's frames per block and radix; K1's attention and tail
clusters, its graph cache, the steps of its loop's body and its flags), K1's
loop to the device (a conditional WHILE node ended by the tail kernel, one
synchronise a decode), the tail's split of the projection columns and
prenet outputs over its cluster, and the tail's plain version
(``tail_step_plain``, what ``tail_step`` runs on CPU tensors): rows that
have finished, the step cap and a decode that has ended.
"""

import os
import re

import numpy as np
import pytest
import torch

from _torch_port_common import log_mel_float64
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_torch.dsp.mel import mel_filterbank
from tacotron2_vae_torch.dsp.stft import _tables, mel_bands
from tacotron2_vae_torch.ops import decoder_loop as dl
from tacotron2_vae_torch.ops import stft_mel as sm

CSRC = os.path.join(os.path.dirname(sm.__file__), os.pardir, "csrc")
ARGS = (80, 16000, 0.0, 8000.0)  # n_mels, sampling rate, fmin, fmax


def _constants(source):
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("module,py_name,source,c_name", [
    (sm, "FRAMES_PER_BLOCK", "stft_mel.cu", "kFrames"),
    (sm, "RADIX", "stft_mel.cu", "kRadix"),
    (dl, "CLUSTER", "decoder_loop.cu", "kNC"),
    (dl, "TAIL_CLUSTER", "decoder_loop.cu", "kTailNC"),
    (dl, "GRAPHS", "decoder_loop.cu", "kDecodeGraphs"),
    (dl, "UNROLL", "decoder_loop.cu", "kUnroll"),
    (dl, "FLAGS", "decoder_loop.cu", "kFlags"),
], ids=["K2_frames", "K2_radix", "K1_cluster", "K1_tail_cluster", "K1_graphs", "K1_unroll",
        "K1_flags"])
def test_python_constants_match_the_kernel_sources(module, py_name, source, c_name):
    assert getattr(module, py_name) == _constants(source)[c_name]


def _code(source):
    """The source without its comments."""
    with open(os.path.join(CSRC, source)) as f:
        return re.sub(r"//[^\n]*", "", f.read())


def test_decode_loop_runs_on_the_device():
    """K1 loops on the device: its step is the body of a conditional WHILE
    node that the tail kernel ends, and a decode (``run``) synchronises
    once (after the graph, for the step count), not every few steps."""
    code = _code("decoder_loop.cu")
    decode = code[code.index("cudaError_t run(const Args& a"):code.index("cudaError_t run_b(")]
    assert "cudaGraphCondTypeWhile" in code
    assert code.count("cudaGraphSetConditional(loop, 0)") == 2  # past the end; at the stop
    assert decode.count("cudaStreamSynchronize") == 1
    assert decode.count("cudaGraphLaunch") == 1 == code.count("cudaGraphLaunch")
    assert "check_every" not in code and not hasattr(dl, "CHECK_EVERY")


def tail_split(N, P, nc):
    """(columns, prenet outputs) of each of the tail's nc CTAs, as the
    kernel's TailGeo splits them: ceil(N / nc) columns and ceil(P / nc)
    outputs a CTA, the last ones fewer or none."""
    Nc, Pc = -(-N // nc), -(-P // nc)
    return ([range(r * Nc, min(N, (r + 1) * Nc)) for r in range(nc)],
            [range(r * Pc, min(P, (r + 1) * Pc)) for r in range(nc)])


@pytest.mark.parametrize("N,P", [(81, 256), (161, 256), (9, 32), (81, 16), (3, 48)])
@pytest.mark.parametrize("nc", [4, 8])
def test_tail_split_covers_each_output_once(N, P, nc):
    """Every projection column (n_mel r + 1 of them) and prenet output has
    one owning CTA, and each CTA's prenet range has an even start and
    length (the kernel's layer 2 takes rows two at a time; P % 16 == 0)."""
    cols, outs = tail_split(N, P, nc)
    assert sorted(c for r in cols for c in r) == list(range(N))
    assert sorted(o for r in outs for o in r) == list(range(P))
    assert all(r.start % 2 == 0 and len(r) % 2 == 0 for r in outs)


@pytest.mark.parametrize("t,done", [(3, 0), (11, 0), (4, 1)], ids=["step", "cap", "ended"])
def test_tail_step_plain_writes_what_the_step_owns(t, done):
    """The tail's plain version at TINY widths on one state (B=3, row 1
    finished, 12 steps): at a step it writes mel, gate and alignments of
    step t for the other rows only, h_dec into xd, the prenet of step t + 1
    (its dropout drawn with step t + 1's bits) into xa's first P columns,
    and advances the flags; at the cap it writes no prenet and ends the
    decode; past the end it copies h_dec alone.  Every launch is counted."""
    from _torch_port_common import TINY
    from tacotron2_vae_torch.config import create_hparams
    from tacotron2_vae_torch.models.tacotron2 import Tacotron2, init_weights

    dec = init_weights(Tacotron2(create_hparams(TINY)), torch.Generator().manual_seed(0)).decoder
    kw = dl.pack_weights(dec, torch.bfloat16)
    B, S, steps = 3, 7, 12
    Ha, Hd = kw["att_w"].shape[0] // 4, kw["dec_w"].shape[0] // 4
    P, n_out = kw["w1"].shape
    E = kw["pg_w"].shape[1] - Hd
    g = torch.Generator().manual_seed(1)
    xa, xd, xp = (torch.randn(B, k, generator=g) for k in (P + E + Ha, Ha + E + Hd, Hd + E))
    wprev = torch.rand(B, S, generator=g)
    mel, gate, align = (torch.randn(steps, B, *k, generator=g) for k in ((n_out,), (), (S,)))
    flags = torch.zeros(dl.FLAGS, dtype=torch.int32)
    flags[0], flags[1], flags[3] = done, t, 1
    before = [x.clone() for x in (xa, xd, mel, gate, align, flags)]
    dl.tail_step(kw, xa, xd, xp, wprev, flags, mel, gate, align, max_steps=steps,
                 gate_threshold=0.9, seed=5, dropout_on=True)

    assert torch.equal(xd[:, Ha + E:], xp[:, :Hd])
    assert torch.equal(xd[:, :Ha + E], before[1][:, :Ha + E])
    assert int(flags[-1]) == 1
    written = torch.zeros(steps, B, dtype=torch.bool)
    if not done:
        written[t] = torch.tensor([True, False, True])
    assert torch.equal(mel != before[2], written[..., None].expand_as(mel))
    assert torch.equal(gate[~written], before[3][~written])
    assert torch.equal(align[~written], before[4][~written])
    if not done:
        assert torch.equal(align[t, [0, 2]], wprev[[0, 2]])
    assert torch.equal(xa[:, P:], before[0][:, P:])
    if t + 1 < steps and not done:
        kept = dl.dropout_keep(5, t + 1, 1, B, P) > 0
        assert bool((xa[:, :P][~kept] == 0).all()) and bool((xa[:, :P] != before[0][:, :P]).all())
    else:
        assert torch.equal(xa, before[0])
    want_flags = before[5].clone()
    want_flags[-1] = 1
    if not done:
        want_flags[1] = t + 1
        want_flags[0] = int(t + 1 == steps)
    assert torch.equal(flags, want_flags)


# ------------------------------------------------------- K2, in numpy


def sw(i):
    """The kernel's swizzle of a shared-buffer index (``sw`` in stft_mel.cu)."""
    return i ^ (((i >> 4) & 3) * 5)


def stages(M, radix=sm.RADIX):
    """(R, Ns) of each Stockham stage, in the kernel's order."""
    out, ns = [], 1
    while ns * radix <= M:
        out.append((radix, ns))
        ns *= radix
    if ns < M:
        out.append((2, ns))
    return out


def butterfly(v):
    """The kernel's radix-4 / radix-2 butterfly (forward transform)."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    t0, t1, t2, t3 = v[0] + v[2], v[0] - v[2], v[1] + v[3], (v[1] - v[3]) * np.complex64(-1j)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def kernel_rfft(x, twiddle):
    """|X| as K2 computes it for frames x (F, n_fft) float32: complex64
    Stockham stages over the swizzled buffer, then the even/odd split."""
    F, n_fft = x.shape
    M = n_fft // 2
    tw = (twiddle[:, 0] + 1j * twiddle[:, 1]).astype(np.complex64)
    buf = np.empty((F, M), np.complex64)
    buf[:, sw(np.arange(M))] = x[:, 0::2] + np.complex64(1j) * x[:, 1::2]
    for R, ns in stages(M):
        q = M // R
        j = np.arange(q)
        jm = j & (ns - 1)
        v = [buf[:, sw(j + r * q)] for r in range(R)]
        if ns > 1:
            v = [v[0]] + [v[r] * tw[r * jm * (n_fft // (ns * R))] for r in range(1, R)]
        d = (j - jm) * R + jm
        out = np.empty_like(buf)
        for r, y in enumerate(butterfly(v)):
            out[:, sw(d + r * ns)] = y
        buf = out
    k = np.arange(M + 1)
    a, c = buf[:, sw(k & (M - 1))], np.conj(buf[:, sw((M - k) & (M - 1))])
    ze, zo = np.complex64(0.5) * (a + c), np.complex64(-0.5j) * (a - c)
    return np.abs(ze + tw[k] * zo)


def kernel_frames(wav, n_fft, hop, window):
    """The kernel's frames: reflect padding by index arithmetic, windowed."""
    n = len(wav)
    j = np.arange(n // hop + 1)[:, None] * hop + np.arange(n_fft)[None, :] - n_fft // 2
    j = np.where(j < 0, -j, np.where(j >= n, 2 * (n - 1) - j, j))
    return wav[j] * window


def kernel_log_mel(wav, n_fft, hop=256):
    """The kernel's whole function, in numpy: (n_mels, n // hop + 1)."""
    tab = _tables(n_fft, n_fft, *ARGS)
    mag = kernel_rfft(kernel_frames(wav, n_fft, hop, tab.window), tab.twiddle)
    mel = np.zeros((len(tab.bands), mag.shape[0]), np.float32)
    for b, (start, end, off) in enumerate(tab.bands):
        for k in range(start, end):  # the kernel's order: ascending bins, one FMA each
            mel[b] += tab.melw[off + k - start] * mag[:, k]
    return np.log(np.maximum(mel, np.float32(1e-5)))


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_kernel_fft_matches_numpy_rfft(n_fft):
    """Stage order, two-buffer swizzle, even/odd packing and twiddle table:
    each bin within 1e-5 of the largest (float64 ``np.fft.rfft``)."""
    rng = np.random.RandomState(n_fft)
    tab = _tables(n_fft, n_fft, *ARGS)
    x = (rng.randn(5, n_fft) * tab.window).astype(np.float32)
    got = kernel_rfft(x, tab.twiddle)
    want = np.abs(np.fft.rfft(x.astype(np.float64), axis=1))
    assert got.shape == want.shape == (5, n_fft // 2 + 1)
    assert np.abs(got - want).max() <= 1e-5 * want.max()


def _wav(n, seed=0):
    rng = np.random.RandomState(seed)
    return (0.4 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000)
            + 0.01 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("n_fft,n", [(1024, 9000), (1024, 8800), (1024, 513), (512, 9000),
                                     (2048, 9000)],
                         ids=["even_frames", "odd_frames", "shortest_clip", "n_fft512",
                              "n_fft2048"])
def test_kernel_emulation_matches_float64(n_fft, n):
    """The whole kernel in numpy (reflect indices, FFT, band table, log)
    against the function in float64, atol 1e-4 as the card check
    (tests/test_pallas_stft.py:36); the emulation's error is 0.5-2.6e-5."""
    wav = _wav(n)
    got = kernel_log_mel(wav, n_fft)
    assert got.shape == (80, n // 256 + 1)
    np.testing.assert_allclose(got, log_mel_float64(wav, n_fft), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [9000, 8800, 513], ids=["even_frames", "odd_frames",
                                                      "shortest_clip"])
def test_kernel_emulation_matches_the_twin(n):
    """... and against ``mel_spectrogram_plain`` on the CPU at the card
    check's n_fft 1024.  The twin sums its DFT in float64 (3e-6 off the
    function here): in float32 those sums were 2.4-4.3e-5 off, by an amount
    that moved with the BLAS's thread split and code path, and left the
    comparison's margin to chance."""
    wav = _wav(n)
    want = sm.mel_spectrogram_plain(torch.from_numpy(wav), 1024, 256, 1024, *ARGS)[0].numpy()
    np.testing.assert_allclose(kernel_log_mel(wav, 1024), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_shared_accesses_are_free_of_bank_conflicts(n_fft):
    """Every half-warp's 16 float2 accesses of every stage (reads and
    writes) and the split's reads of Z[k] fall on 16 distinct 8-byte bank
    pairs."""
    M = n_fft // 2
    for R, ns in stages(M):
        q = M // R
        for j0 in range(0, q, 16):
            j = np.arange(j0, min(j0 + 16, q))
            jm = j & (ns - 1)
            d = (j - jm) * R + jm
            for r in range(R):
                for idx in (j + r * q, d + r * ns):
                    assert len(set(sw(idx) % 16)) == len(j), (n_fft, R, ns, j0, r)
    for k0 in range(0, M + 1, 16):
        k = np.arange(k0, min(k0 + 16, M + 1))
        assert len(set(sw(k & (M - 1)) % 16)) == len(k)


def test_swizzle_permutes_each_row_of_16():
    i = np.arange(4096)
    assert np.array_equal(np.sort(sw(i)), i)
    assert np.array_equal(sw(i) // 16, i // 16)


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_band_table_rebuilds_the_filterbank(n_fft):
    """The packed weights between each band's [start, end) are exactly the
    dense filterbank, and its nonzeros are all the kernel sums over (~1000
    FMAs a frame at n_fft 1024, against 80 x 513 dense)."""
    fb = mel_filterbank(16000, n_fft, *ARGS[:1], *ARGS[2:])
    bands, melw = mel_bands(fb)
    rebuilt = np.zeros_like(fb)
    for b, (start, end, off) in enumerate(bands):
        rebuilt[b, start:end] = melw[off:off + end - start]
        if b + 1 < len(bands):
            assert bands[b + 1][2] == off + end - start  # packed back to back
    assert np.array_equal(rebuilt, fb)
    assert melw.size == np.count_nonzero(fb)
    mag = np.random.RandomState(1).rand(7, fb.shape[1]).astype(np.float32)
    dense = mag @ fb.T.astype(np.float64)
    banded = np.stack([mag[:, s:e] @ melw[o:o + e - s].astype(np.float64)
                       for s, e, o in bands], axis=1)
    np.testing.assert_allclose(banded, dense, rtol=1e-12, atol=0)


def test_twiddle_table_is_rounded_once_from_float64():
    tab = _tables(1024, 1024, *ARGS)
    k = np.arange(1024)
    exact = np.exp(-2j * np.pi * k / 1024)
    assert tab.twiddle.dtype == np.float32 and tab.twiddle.shape == (1024, 2)
    assert np.array_equal(tab.twiddle[:, 0], exact.real.astype(np.float32))
    assert np.array_equal(tab.twiddle[:, 1], exact.imag.astype(np.float32))


def test_decode_turns_needs_a_card(monkeypatch):
    """The turns tool measures the card: without one it stops, and never
    times the CPU in its place."""
    from tacotron2_vae_torch.tools import decode_turns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        decode_turns.main(["--trees", "."])


def test_k1_early_probe_needs_a_card(monkeypatch):
    """The early-step probe reads the card's kernel: without a card it stops."""
    from tacotron2_vae_torch.tools import k1_early_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        k1_early_probe.main(["--trees", "."])
