"""The port's CUDA kernels against their plain twins, on the card.

Kernels K1 (decode loop), K2 (STFT -> mel -> log), K3 and K4 (the
teacher-forced recurrence, forward and backward), K5 and K6 (the reshape
and output-block probes), K7 and K8 (the encoder's BiLSTM recurrence,
forward and backward) have no CPU mode: on a
CPU tensor their wrappers run the twin, so these tests need a card and skip
without one.  They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tiny widths (``TINY``) with shapes that reach the kernels' partial tiles:
S split unevenly over K1's 8-CTA attention cluster in chunks of ceil(S / 8)
(3: three CTAs of one position and five empty; 13: six of 2, one of 1 and
an empty last; 70: seven of 9 and one of 7; 16 and 80) at B = 1, 3, 4 and
8; K2 at even and odd frame counts, at the shortest clip it takes (n =
n_fft/2 + 1) and at n_fft 512, 1024 and 2048; two calls of K1 and of K2 bit
for bit alike.  K1's graph: one instantiation per set of sizes and weights,
reused by calls on new memory, at a new step cap and at a shape seen
before, each call against the twin, an earlier call's outputs untouched by
later ones; the gate firing at steps 1, 2 and 3 ends the device-side loop
where the twin ends; the tail kernel's launches counted on the device, a
loop body's worth a graph iteration; the persisting-L2 limit is back to its
value after a decode whose LSTM weights exceed L2 (float32 at full width),
whose graph's two LSTM nodes a step carry their window; the tail kernel
alone against its plain version on the same state (a row finished, the step
cap, past the end: the frame to K1's early limit, the copies and flags
exactly, the next prenet to K1's whole-run mel limit).
Tolerances: K1 per
output, over the first steps and the whole run, by ``chip_smoke.k1_compare``
(f32: sum order only; bf16 and float16: the same casting points, sum order
flips a rounding now and then, and the flip feeds back); K1, K3 and K4
take float16 streams as they take bf16 ones, and refuse a dtype code the
C side does not know; K2 atol 1e-4 as
tests/test_pallas_stft.py:36, against the twin and against the function in
float64 (the sizes other than 1024 against float64 alone); K3 and K4,
outputs and every gradient of the
recurrence, by ``chip_smoke.k34_check`` and its limits ``K34_TOL``, at
widths whose LSTM input sizes (P+E+H = 176, 2H+E = 212) are not multiples
of the 64-deep wgmma tiles and whose 4H = 288 is not a multiple of the
64-unit blocks, with B from 1 to the 64-row tile and S split unevenly over
the attention cluster; K4 at two T off its chunk length against the
twin, its coefficient pass counted once a reverse step (as K4 reports
it), the ta its coefficient pass writes equal bit for bit to K3's
(``tests/k3_ta_probe.cu``), and every kernel it launches named as the
harness's ``K34_KERNELS`` counts; two K4 calls bit for bit alike; K3/K4
calls on new
tensors at cached sizes update their graph in place and match the same
calls launched kernel by kernel bit for bit; K5 exactly
(a copy plus one): one flat pass and one grid row per input row, a base
off 16-byte alignment, row strides and row lengths that are not multiples
of 4 (scalar heads and tails), B = 1, more blocks than one wave; K6 atol
1e-5 (sum order) against a float64 product, with rows off its 4-row tile,
F off its 32-column tile and not a multiple of 4, K off its 4-way split
and beyond one 128-deep chunk (2048: past the shared-memory limit of the
earlier design), a misaligned x, T = 1, and two calls bit for bit alike;
K7/K8 by ``chip_smoke.k78_check`` and its limits ``K78_TOL`` at serve
shapes, a partial row tile, B = 64 at T = 561 and every hidden size they
take, and the encoder's one launch of each a call.
WaveGlow
(cuDNN/cuBLAS, no kernel of its own) on the card against the CPU: float32
to 1e-5 of max |audio| (TF32 would give ~1e-3); bf16 one WaveNet to one
bf16 ulp of its output scale (same rounding points, another sum order).
"""

import numpy as np
import pytest
import torch

from _torch_port_common import TINY, log_mel_float64, n
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from chip_smoke import k1_compare, k34_check, k78_check, k78_encoder_launches
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.models import waveglow as twg
from tacotron2_vae_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_vae_torch.ops import decoder_loop as dl
from tacotron2_vae_torch.ops import encoder_lstm as el
from tacotron2_vae_torch.ops import reshape_probe as rp
from tacotron2_vae_torch.ops import stft_mel as sm
from tacotron2_vae_torch.ops.layers import linear
from tacotron2_vae_torch.tools import multihost_dryrun as mh


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1 and K2 have no CPU mode")
    return torch.device("cuda")


def _decode_inputs(device, dtype, B, S, lengths):
    """Packed TINY weights and one batch of memory for K1 (30 steps, the
    gate never fires, prenet dropout on)."""
    hp = create_hparams(TINY)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(device).eval().requires_grad_(False).decoder
    rng = np.random.RandomState(1)
    memory = torch.from_numpy((rng.randn(B, S, hp.encoder_embedding_dim) * 0.3)
                              .astype(np.float32)).to(device)
    lens = torch.tensor(lengths, device=device)
    mask = torch.arange(S, device=device)[None] < lens[:, None]
    pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight)
    kw = dl.pack_weights(dec, getattr(torch, dtype))
    args = dict(max_steps=30, gate_threshold=1.1, seed=9, dropout_on=True)
    return (kw, memory, pmem, mask), args


def _decode_check(device, dtype, B, S, lengths):
    inputs, args = _decode_inputs(device, dtype, B, S, lengths)
    got = dl.decode_loop(*inputs, **args)
    want = dl.finish(*dl.decode_loop_plain(*inputs, **args), 1.1, 1)
    errs, fails = k1_compare(got, want, dtype, 1)
    assert not fails, errs


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(3, 16), (4, 80)], ids=["B3_S16", "B4_S80"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_decode_loop_kernel_matches_twin_on_card(cuda_device, dtype, B, S):
    _decode_check(cuda_device, dtype, B, S, [S, S - 5, S - 9, S // 2][:B])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [3, 13, 70])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_decode_loop_attention_cluster_splits_on_card(cuda_device, dtype, B, S):
    """S over the cluster's CTAs in chunks of ceil(S / 8): 3 leaves five CTAs
    no position, 13 leaves the last one none; every row masked to its own
    length."""
    _decode_check(cuda_device, dtype, B, S, [max(1, S - 2 * i) for i in range(B)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_decode_loop_kernel_is_deterministic_on_card(cuda_device, dtype):
    """Two K1 calls give the same bits: the softmax sums and the context
    partials have one owner and a fixed order (no float atomics)."""
    inputs, args = _decode_inputs(cuda_device, dtype, 8, 70, [70 - 7 * i for i in range(8)])
    first = [x.clone() for x in dl.decode_loop(*inputs, **args)]
    second = dl.decode_loop(*inputs, **args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_decode_loop_graph_is_reused_across_calls_on_card(cuda_device, dtype):
    """One graph per set of sizes and weights: a call on new memory, a new
    step cap and a shape seen before instantiate none; a new S and a new B
    one each.  Every call matches the twin at K1's limits, and a call's
    outputs stay as they were after later calls (no buffer shared)."""
    # (B, S, max_steps, graphs the call instantiates); shapes no other test uses
    calls = [(2, 21, 30, 1), (2, 21, 30, 0), (2, 22, 30, 1), (5, 22, 30, 1), (5, 22, 12, 0),
             (2, 21, 30, 0)]
    hp = create_hparams(TINY)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    kw = dl.pack_weights(dec, getattr(torch, dtype))
    rng = np.random.RandomState(4)
    kept = None
    for B, S, steps, new in calls:
        memory = torch.from_numpy((rng.randn(B, S, hp.encoder_embedding_dim) * 0.3)
                                  .astype(np.float32)).to(cuda_device)
        mask = torch.arange(S, device=cuda_device)[None] < torch.tensor(
            [S - 3 * i for i in range(B)], device=cuda_device)[:, None]
        pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight)
        args = dict(max_steps=steps, gate_threshold=1.1, seed=9, dropout_on=True)
        before = dl.graph_captures()
        got = dl.decode_loop(kw, memory, pmem, mask, **args)
        assert dl.graph_captures() - before == new, (B, S, steps)
        want = dl.finish(*dl.decode_loop_plain(kw, memory, pmem, mask, **args), 1.1, 1)
        errs, fails = k1_compare(got, want, dtype, 1)
        assert not fails, (B, S, steps, errs)
        if kept is None:
            kept, first = [x.clone() for x in got], got
    for a, b in zip(kept, first):
        assert torch.equal(a, b)


def _gate_inputs(device, dtype):
    """TINY weights, one row at S=16, and a dropout seed under which the
    gate, with its bias zeroed and its weight row scaled by +-2^8 (exact in
    every dtype; the gate feeds nothing back), rises over the first three
    steps by at least 0.05 a step: so a bias can make it fire first at step
    1, 2 or 3."""
    (kw, memory, pmem, mask), args = _decode_inputs(device, dtype, 1, 16, [16])
    n_out = kw["pg_w"].shape[0] - 1
    kw = dict(kw, pg_w=kw["pg_w"].clone(), pg_b=kw["pg_b"].clone())
    kw["pg_b"][n_out] = 0.0
    for seed in range(64):
        args = dict(args, seed=seed, max_steps=8, gate_threshold=1.1)
        gate = dl.decode_loop_plain(kw, memory, pmem, mask, **args)[1][:3, 0]
        for scale in (256.0, -256.0):
            if bool((scale * (gate[1:] - gate[:-1]) > 0.05).all()):
                kw["pg_w"][n_out] *= scale
                return (kw, memory, pmem, mask), args, (scale * gate).tolist()
    raise AssertionError("no seed below 64 makes the gate rise over three steps")


@pytest.mark.cuda
@pytest.mark.parametrize("fire", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_loop_gate_ends_the_device_loop_on_card(cuda_device, dtype, fire):
    """The gate firing first at step 1, 2 or 3 of 8 ends the graph's
    device-side loop there: the twin's step count and outputs."""
    (kw, memory, pmem, mask), args, gate = _gate_inputs(cuda_device, dtype)
    n_out = kw["pg_w"].shape[0] - 1
    below = gate[fire - 2] if fire > 1 else gate[0] - 1.0
    kw["pg_b"][n_out] = -(gate[fire - 1] + below) / 2  # sigmoid crosses 0.5 at step `fire`
    args = dict(args, gate_threshold=0.5)
    got = dl.decode_loop(kw, memory, pmem, mask, **args)
    want = dl.finish(*dl.decode_loop_plain(kw, memory, pmem, mask, **args), 0.5, 1)
    assert got[3].tolist() == [fire] == want[3].tolist()
    errs, fails = k1_compare(got, want, dtype, 1)
    assert not fails, errs


@pytest.mark.cuda
def test_decode_loop_restores_the_persisting_l2_limit_on_card(cuda_device):
    """A decode whose LSTM weights exceed L2 (float32 at the full-width
    defaults) sets L2 aside for the decode alone; the graph's LSTM nodes
    (two a step of its loop's body) carry their window, whose hitRatio is
    the set-aside's share.  TINY weights fit and take no window."""
    hp = create_hparams()
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.decoder.to(cuda_device).eval().requires_grad_(False)
    kw = dl.pack_weights(dec, torch.float32)
    assert dl.l2_window(kw)
    assert not dl.l2_window(_decode_inputs(cuda_device, "float32", 1, 16, [16])[0][0])
    memory = torch.from_numpy((np.random.RandomState(2).randn(2, 16, hp.encoder_embedding_dim)
                               * 0.3).astype(np.float32)).to(cuda_device)
    pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight)
    args = dict(max_steps=12, gate_threshold=1.1, seed=9, dropout_on=True)
    before = dl.info()
    got = dl.decode_loop(kw, memory, pmem, None, **args)
    after = dl.info()
    want = dl.finish(*dl.decode_loop_plain(kw, memory, pmem, None, **args), 1.1, 1)
    errs, fails = k1_compare(got, want, "float32", 1)
    assert not fails, errs
    assert after["persisting_l2_limit"] == before["persisting_l2_limit"]
    assert after["windowed_lstm_nodes"] == 2 * dl.UNROLL
    assert 0 < after["l2_setaside_bytes"] <= after["max_persisting_l2_bytes"]
    assert 0.0 < after["hit_ratio"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("use_graph", [True, False], ids=["graph", "stream"])
def test_decode_loop_counts_tail_launches_on_device(cuda_device, monkeypatch, use_graph):
    """The tail kernel counts its own launches: in the graph, the loop's
    body (UNROLL steps) runs until the step that ends the decode; on the
    stream, every one of max_steps steps is launched (past the end each
    returns at once)."""
    monkeypatch.setattr(dl, "USE_GRAPH", use_graph)
    inputs, args = _decode_inputs(cuda_device, "bfloat16", 2, 16, [16, 9])
    for steps in (1, 8, 13):
        before = dl.decode_loop.tail_launches
        dl.decode_loop(*inputs, **dict(args, max_steps=steps))
        want = -(-steps // dl.UNROLL) * dl.UNROLL if use_graph else steps
        assert dl.decode_loop.tail_launches - before == want, steps


@pytest.mark.cuda
@pytest.mark.parametrize("t,done", [(3, 0), (11, 0), (4, 1)], ids=["step", "cap", "ended"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_tail_kernel_matches_plain_on_card(cuda_device, dtype, t, done):
    """The tail kernel alone against ``tail_step_plain`` on one state: row
    1 finished; at step 3 of 12, at the cap (11: no prenet, the decode
    done) and past the end (only h_dec copied).  The frame within K1's
    early limit, the copies and flags exactly, the next prenet (two
    roundings) within K1's whole-run mel limit."""
    from chip_smoke import K1_EARLY_TOL, K1_TOL

    (kw, *_), _ = _decode_inputs(cuda_device, dtype, 3, 16, [16, 16, 16])
    B, S, steps = 3, 21, 12
    Ha, Hd = kw["att_w"].shape[0] // 4, kw["dec_w"].shape[0] // 4
    P, n_out = kw["w1"].shape
    E = kw["pg_w"].shape[1] - Hd
    g = torch.Generator(device=cuda_device).manual_seed(t)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)

    bufs = [r(B, P + E + Ha), r(B, Ha + E + Hd), torch.cat([torch.tanh(r(B, Hd)), r(B, E)], 1),
            torch.softmax(r(B, S), 1)]
    outs = [r(steps, B, n_out), r(steps, B), r(steps, B, S)]
    flags = torch.zeros(dl.FLAGS, dtype=torch.int32, device=cuda_device)
    flags[0], flags[1], flags[3] = done, t, 1
    args = dict(max_steps=steps, gate_threshold=0.5, seed=5, dropout_on=True)
    got = [x.clone() for x in bufs + [flags] + outs]
    want = [x.clone() for x in bufs + [flags] + outs]
    dl.tail_step(kw, *got, **args)
    dl.tail_step_plain(kw, *want, **args)
    names = ("xa", "xd", "xp", "wprev", "flags", "mel", "gate", "align")
    tol = dict(xa=K1_TOL[dtype]["mel"], mel=K1_EARLY_TOL[dtype], gate=K1_EARLY_TOL[dtype])
    for name, a, b in zip(names, got, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol.get(name, 0.0), (name, err)
    assert int(got[4][1]) == (t if done else t + 1)
    assert int(got[4][-1]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [9000, 32000, 48000])
def test_stft_mel_kernel_matches_twin_on_card(cuda_device, n_samples):
    rng = np.random.RandomState(0)
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(n_samples) / 16000)
         + 0.01 * rng.randn(n_samples))
    wav = torch.from_numpy(np.clip(x, -1, 1).astype(np.float32)).to(cuda_device)
    args = (1024, 256, 1024, 80, 16000, 0.0, 8000.0)
    got = sm.mel_spectrogram_fused(wav, *args)
    want = sm.mel_spectrogram_plain(wav, *args)
    assert got.shape == (1, 80, n_samples // 256 + 1)
    np.testing.assert_allclose(n(got.cpu()), n(want.cpu()), atol=1e-4, rtol=0)


def _clip(n_samples):
    rng = np.random.RandomState(0)
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(n_samples) / 16000)
         + 0.01 * rng.randn(n_samples))
    return np.clip(x, -1, 1).astype(np.float32)


# (samples, n_fft): 36 and 35 frames; the shortest clip K2 takes; other n_fft
K2_EDGES = {"even_frames": (9000, 1024), "odd_frames": (8800, 1024),
            "shortest_clip": (513, 1024), "n_fft512": (9000, 512), "n_fft2048": (9000, 2048)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_EDGES)
def test_stft_mel_kernel_edges_on_card(cuda_device, case):
    n_samples, n_fft = K2_EDGES[case]
    wav = _clip(n_samples)
    args = (n_fft, 256, n_fft, 80, 16000, 0.0, 8000.0)
    got = sm.mel_spectrogram_fused(torch.from_numpy(wav).to(cuda_device), *args)
    assert got.shape == (1, 80, n_samples // 256 + 1)
    np.testing.assert_allclose(n(got.cpu())[0], log_mel_float64(wav, n_fft), atol=1e-4, rtol=0)
    if n_fft == 1024:
        want = sm.mel_spectrogram_plain(torch.from_numpy(wav).to(cuda_device), *args)
        np.testing.assert_allclose(n(got.cpu()), n(want.cpu()), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_stft_mel_kernel_is_deterministic_on_card(cuda_device):
    wav = torch.from_numpy(_clip(48000)).to(cuda_device)
    first = sm.mel_spectrogram_fused(wav).clone()
    second = sm.mel_spectrogram_fused(wav)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


ODD = TINY + ",prenet_dim=36,encoder_embedding_dim=68,symbols_embedding_dim=68," \
    "attention_rnn_dim=72,decoder_rnn_dim=72,attention_dim=24,attention_location_n_filters=6"


# (B, S, T, memory lengths): B at 1, below the 64-row wgmma tile, one short
# of it and at it; S split over the 4-CTA attention cluster unevenly (70 ->
# 18+18+18+16, 13 -> 4+4+4+1) and with an empty last chunk (5 -> 2+2+1+0)
RECURRENCE_CASES = [(5, 13, 9, (13, 12, 9, 5, 1)), (64, 70, 6, None), (1, 5, 7, None),
                    (63, 70, 5, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,lengths", RECURRENCE_CASES,
                         ids=["B5_S13", "B64_S70", "B1_S5", "B63_S70"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_recurrence_kernels_match_twins_on_card(cuda_device, dtype, B, S, T, lengths):
    hp = create_hparams(ODD)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    for dropout_on in (False, True):
        row = k34_check(dec, B, S, T, lengths, dtype, dropout_on, cuda_device, timed=False)
        assert not row["fails"], row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_recurrence_backward_kernel_is_deterministic_on_card(cuda_device, dtype):
    """Two K4 calls on the same inputs give the same bits: every cross-row
    and cross-CTA sum has one owner and a fixed order (no float atomics)."""
    from chip_smoke import k34_inputs
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    hp = create_hparams(ODD)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    w, pn, mem, pm, add, masks, dys = k34_inputs(dec, 64, 70, 6, None, getattr(torch, dtype),
                                                 True, cuda_device)
    ys, res = tf.teacher_fwd(w, pn, mem, pm, add, masks)
    w_cum_prev = torch.cat([torch.zeros_like(ys[2][:1]), torch.cumsum(ys[2], 0)[:-1]])
    args = (w, mem, pm, masks, dys, ys, res, w_cum_prev.contiguous())
    first = [x.clone() for x in tf.teacher_bwd(*args)]
    second = tf.teacher_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_recurrence_graph_update_reads_new_pointers_on_card(cuda_device, dtype, monkeypatch):
    """A K3/K4 call at sizes seen before but on new tensors updates the
    cached graph in place (no instantiation), and the updated graph reads
    and writes the new tensors: its outputs are bit-equal to the same call
    launched kernel by kernel."""
    from chip_smoke import k34_inputs
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    hp = create_hparams(ODD)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    w, pn, mem, pm, add, masks, dys = k34_inputs(dec, 64, 70, 6, None, getattr(torch, dtype),
                                                 True, cuda_device)

    def run(pn, mem, dys):
        ys, res = tf.teacher_fwd(w, pn, mem, pm, add, masks)
        w_cum_prev = torch.cat([torch.zeros_like(ys[2][:1]), torch.cumsum(ys[2], 0)[:-1]])
        grads = tf.teacher_bwd(w, mem, pm, masks, dys, ys, res, w_cum_prev.contiguous())
        return [x.clone() for x in (*ys, *res, *grads)]

    first = run(pn, mem, dys)
    captures, updates = tf.graph_captures(), tf.graph_updates()
    new = (pn.flip(1).contiguous(), (0.5 * mem).contiguous(),
           [d.flip(1).contiguous() for d in dys])
    second = run(*new)
    assert tf.graph_captures() == captures
    assert all(tf.graph_updates()[k] == updates[k] + 1 for k in ("K3", "K4"))
    monkeypatch.setattr(tf, "USE_GRAPH", False)
    streamed = run(*new)
    torch.cuda.synchronize()
    assert not torch.equal(first[0], second[0])
    for a, b in zip(second, streamed):
        assert torch.equal(a, b)


# T off K4's chunk length at these widths (16 + 5 and 16 + 7).  At T = 21
# float16 fails the early limit of K4_dctx, 1.298e-5 against 1.25e-5, on
# this K4 and on the one before it alike (PERF.md, open questions): the
# case stays, and fails on the card until that limit is settled.
@pytest.mark.cuda
@pytest.mark.parametrize("T", [21, 23])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_recurrence_backward_chunks_match_twins_on_card(cuda_device, dtype, T):
    """K4 at a T that is not a multiple of its chunk length C against the
    step-by-step twin, by ``k34_check``'s limits; K4 reports the
    coefficient pass launched for every reverse step of every call."""
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    B, S = 64, 70
    hp = create_hparams(ODD)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    C = tf.bwd_chunk(T, B, S, hp.attention_rnn_dim, hp.attention_dim,
                     hp.attention_location_n_filters, hp.attention_location_kernel_size)
    assert T % C != 0
    steps, calls = tf.teacher_bwd.coef_steps, tf.teacher_bwd.launches
    row = k34_check(dec, B, S, T, None, dtype, True, cuda_device, timed=False)
    calls = tf.teacher_bwd.launches - calls
    assert calls >= 2 and tf.teacher_bwd.coef_steps - steps == calls * T
    assert not row["fails"], {k: row[k] for k in row["fails"]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrence_backward_recomputes_the_forward_tanh_on_card(cuda_device, dtype,
                                                                 monkeypatch, tmp_path):
    """The ta = tanh(q + loc . loc_dense + pmem) that K4's coefficient pass
    writes into its ring equals bit for bit the ta of K3's attention
    (``tests/k3_ta_probe.cu``: K3's att_fwd up to its tanh, on K3's own
    h_att and alignments): at S = 150 the pass's 64-position CTAs and the
    forward's S / 4 = 38 split the positions differently.  T <= C, so the
    ring holds every step after the call."""
    import ctypes
    import os
    import subprocess

    from chip_smoke import k34_inputs
    from tacotron2_vae_torch.ops import _build
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    so = str(tmp_path / "libk3_ta_probe.so")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k3_ta_probe.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so, src],
                   check=True, capture_output=True)
    probe = ctypes.CDLL(so).t2v_k3_ta_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 12

    B, S, T = 6, 150, 9
    hp = create_hparams(ODD)
    H, A, Fn, K = (hp.attention_rnn_dim, hp.attention_dim, hp.attention_location_n_filters,
                   hp.attention_location_kernel_size)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    w, pn, mem, pm, add, masks, dys = k34_inputs(dec, B, S, T, None, getattr(torch, dtype),
                                                 True, cuda_device)
    ys, res = tf.teacher_fwd(w, pn, mem, pm, add, masks)
    # the cumulative alignments as K3 adds them up, one step at a time
    w_cum, cum = [], torch.zeros_like(ys[2][0])
    for t in range(T):
        w_cum.append(cum)
        cum = cum + ys[2][t]
    w_cum_prev = torch.stack(w_cum)
    rings = []
    ring_tensor = tf._ring_tensor

    def keep(*a, **k):
        rings.append(ring_tensor(*a, **k))
        return rings[-1]

    monkeypatch.setattr(tf, "_ring_tensor", keep)
    tf.teacher_bwd(w, mem, pm, masks, dys, ys, res, w_cum_prev)
    C = tf.bwd_chunk(T, B, S, H, A, Fn, K)
    assert C == T and len(rings) == 1
    sizes = tf.bwd_ring(C, B, S, H, A, Fn, K)
    got = rings[0].split(sizes)[1][:T * B * S * A].view(T, B, S, A)

    h_att = res[4]
    E = mem.shape[2]
    P = w["attn_w"].shape[0] - E - H
    want = torch.full((T, B, S, A), float("nan"), device=cuda_device)
    qpart = torch.empty(tf.cdiv(H, tf.Q_CHUNK) * B * A, device=cuda_device)
    zeros = torch.zeros(S, device=cuda_device)
    ptr = [ctypes.c_void_p(x.data_ptr()) for x in
           (h_att, w["query_w"], w["loc_w"], w["loc_dense_w"], w["v"], pm, ys[2], w_cum_prev,
            zeros, qpart, want)]
    err = probe(T, B, S, E, H, P, A, Fn, K, *ptr,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert err == 0
    # the probe is the forward's ta: against float64 on the CPU, to float32
    # rounding
    w64 = {k: x.double().cpu() for k, x in w.items()}
    seq, cums, h64, pm64 = (x.double().cpu() for x in (ys[2], w_cum_prev, h_att, pm))
    plain = torch.stack([tf._energy_terms(w64, h64[t], seq[t - 1] if t else 0 * seq[0],
                                          cums[t], pm64)[1] for t in range(T)])
    assert float((want.double().cpu() - plain).abs().max()) <= 1e-5
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_recurrence_backward_kernels_count_in_k34_time_on_card(cuda_device):
    """Every kernel a K4 call launches (profiled kernel by kernel) has a
    name that the harness's ``K34_KERNELS`` counts, so that
    ``k34_roofline.train``'s time holds all of K4: the three phases of
    ``att_bwd`` among them."""
    from chip_smoke import k34_inputs
    from portbench.train import K34_KERNELS
    from tacotron2_vae_torch.ops import teacher_fwd as tf

    hp = create_hparams(ODD)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    w, pn, mem, pm, add, masks, dys = k34_inputs(dec, 64, 70, 21, None, torch.bfloat16, True,
                                                 cuda_device)
    ys, res = tf.teacher_fwd(w, pn, mem, pm, add, masks)
    w_cum_prev = torch.cat([torch.zeros_like(ys[2][:1]), torch.cumsum(ys[2], 0)[:-1]])
    args = (w, mem, pm, masks, dys, ys, res, w_cum_prev.contiguous())
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    old, steps = tf.USE_GRAPH, tf.teacher_bwd.coef_steps
    tf.USE_GRAPH = False
    try:
        with torch.profiler.profile(activities=acts) as prof:
            tf.teacher_bwd(*args)
            torch.cuda.synchronize()
    finally:
        tf.USE_GRAPH = old
    # kernel by kernel, K4 counts its coefficient launches too
    assert tf.teacher_bwd.coef_steps - steps == 21
    # less the wrapper's own zero fills and copies (PyTorch's kernels)
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "at::" not in e.key
             and not e.key.startswith(("Memset", "Memcpy"))}
    assert names, "the profiler saw no kernel"
    assert all(K34_KERNELS.search(n) for n in names), sorted(names)
    phases = {n for n in names if "att_bwd<" in n}
    assert len(phases) == 3, sorted(names)


@pytest.mark.cuda
def test_weight_grad_float16_product_keeps_float32_sums(cuda_device):
    from tacotron2_vae_torch.models.decoder_bptt import weight_grad

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(4096, 176, generator=g, device=cuda_device).half()
    dg = torch.randn(4096, 288, generator=g, device=cuda_device).half()
    got = weight_grad(x, dg)
    want = x.double().t() @ dg.double()
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["teacher_fwd", "teacher_bwd", "decode_loop"])
def test_kernels_refuse_an_unknown_dtype_code_on_card(cuda_device, entry):
    """The C entry points return cudaErrorInvalidValue (1) for a dtype code
    outside their enum, before they touch any pointer."""
    import ctypes

    from tacotron2_vae_torch.ops import teacher_fwd as tf

    code = max(tf.DTYPES.values()) + 1
    assert code == max(dl.DTYPES.values()) + 1
    null = ctypes.c_void_p(0)
    if entry == "decode_loop":
        fn = dl._kernel_fn()
        ints = (code, 1, 16, 64, 64, 64, 32, 32, 8, 31, 80)
        counts = (ctypes.c_int * 2)()
        err = fn(*ints, *([null] * 18), 4, ctypes.c_float(0.5), 0, 0, 1, 1, counts, null,
                 null, null)
    elif entry == "teacher_fwd":
        fn = tf._fn(entry, f"t2v_{entry}", 11, 31)
        err = fn(code, 3, 1, 16, 64, 64, 32, 32, 8, 31, 0, *([null] * 31))
    else:  # K4 takes the chunk length C after K, and its count's pointer
        fn = tf._fn(entry, f"t2v_{entry}", 12, 46)
        err = fn(code, 3, 1, 16, 64, 64, 32, 32, 8, 31, 3, 0, *([null] * 46))
    assert err == 1


@pytest.mark.cuda
def test_weight_grad_bf16_product_keeps_float32_sums(cuda_device):
    from tacotron2_vae_torch.models.decoder_bptt import weight_grad

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(4096, 176, generator=g, device=cuda_device).bfloat16()
    dg = torch.randn(4096, 288, generator=g, device=cuda_device).bfloat16()
    got = weight_grad(x, dg)
    want = x.double().t() @ dg.double()
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,X,pad", [(4, 128, 32, 0), (3, 7, 5, 0), (2, 9, 12, 4)],
                         ids=["vec4", "scalar", "strided"])
def test_reshape_kernel_matches_twin_on_card(cuda_device, B, S, X, pad):
    rng = np.random.RandomState(0)
    full = torch.from_numpy(rng.randn(B, S * X + pad).astype(np.float32)).to(cuda_device)
    x = full[:, :S * X]
    got = rp.reshape_rows_plus_one(x, S, X)
    torch.testing.assert_close(got, rp.reshape_rows_plus_one_plain(x, S, X), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("BS,K,F,T", [(512, 128, 32, 4), (13, 40, 24, 3)], ids=["probe", "odd"])
def test_out_block_kernel_matches_twin_on_card(cuda_device, BS, K, F, T):
    rng = np.random.RandomState(1)
    x = torch.from_numpy((0.3 * rng.randn(BS, K)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((0.3 * rng.randn(K, F)).astype(np.float32)).to(cuda_device)
    got = rp.out_block_matmul(x, w, T)
    want = rp.out_block_matmul_plain(x, w, T)
    assert got.shape == (T, BS, F)
    np.testing.assert_allclose(n(got.cpu()), n(want.cpu()), atol=1e-5, rtol=0)


# (B, S, X, row padding, floats the base is off a 16-byte boundary)
RESHAPE_EDGES = {
    "misaligned_base": (4, 128, 128, 0, 1),
    "ld_not_multiple_of_4": (3, 16, 8, 3, 0),
    "row_not_multiple_of_4": (3, 7, 5, 2, 0),
    "misaligned_odd_rows": (2, 9, 12, 1, 2),
    "B1": (1, 128, 32, 0, 0),
    "many_waves_flat": (64, 512, 128, 0, 0),
    "many_waves_rows": (64, 512, 128, 4, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", RESHAPE_EDGES)
def test_reshape_kernel_tiling_edges_on_card(cuda_device, case):
    B, S, X, pad, off = RESHAPE_EDGES[case]
    rng = np.random.RandomState(2)
    full = torch.from_numpy(rng.randn(off + B * (S * X + pad)).astype(np.float32))
    x = full.to(cuda_device)[off:].reshape(B, S * X + pad)[:, :S * X]
    got = rp.reshape_rows_plus_one(x, S, X)
    torch.cuda.synchronize()
    assert torch.equal(got, rp.reshape_rows_plus_one_plain(x, S, X))


# (BS, K, F, T, floats x's base is off a 16-byte boundary)
OUT_BLOCK_EDGES = {
    "probe_T1": (512, 128, 32, 1, 0),
    "two_column_tiles": (512, 128, 64, 4, 0),
    "rows_off_tile": (13, 128, 32, 4, 0),
    "F_not_multiple_of_4": (13, 40, 37, 2, 0),
    "K200": (64, 200, 32, 3, 0),
    "K2048": (100, 2048, 32, 3, 0),
    "misaligned_x": (512, 128, 32, 4, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", OUT_BLOCK_EDGES)
def test_out_block_kernel_tiling_edges_on_card(cuda_device, case):
    BS, K, F, T, off = OUT_BLOCK_EDGES[case]
    rng = np.random.RandomState(3)
    # inputs scaled so that every sum has the spread it has at K = 128
    scale = 0.3 * (128 / K) ** 0.25
    xf = torch.from_numpy((scale * rng.randn(off + BS * K)).astype(np.float32))
    x = xf.to(cuda_device)[off:].view(BS, K)
    w = torch.from_numpy((scale * rng.randn(K, F)).astype(np.float32)).to(cuda_device)
    got = rp.out_block_matmul(x, w, T)
    again = rp.out_block_matmul(x, w, T)
    torch.cuda.synchronize()
    want = (x.double() @ w.double()).expand(T, BS, F)
    assert got.shape == (T, BS, F)
    assert float((got.double() - want).abs().max()) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_waveglow_float32_on_card_matches_cpu(cuda_device):
    cfg = twg.WaveGlowConfig(n_flows=4, n_early_every=2, n_layers=3, n_channels=32)
    wg = twg.init_weights(twg.WaveGlow(cfg), torch.Generator().manual_seed(0), end_scale=0.02)
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(1, 20 * 32, 8).astype(np.float32))
    mel = torch.from_numpy(rng.randn(1, 80, 20).astype(np.float32) - 5)
    with torch.no_grad():
        want = wg.inverse(z, mel)
        got = wg.to(cuda_device).inverse(z.to(cuda_device), mel.to(cuda_device)).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_waveglow_bf16_wavenet_on_card_matches_cpu(cuda_device):
    cfg = twg.WaveGlowConfig(n_flows=2, n_layers=3, n_channels=32)
    wg = twg.init_weights(twg.WaveGlow(cfg), torch.Generator().manual_seed(1), end_scale=0.05)
    rng = np.random.RandomState(1)
    x0 = torch.from_numpy(rng.randn(1, 4, 300).astype(np.float32))
    cond = torch.from_numpy(rng.randn(1, 640, 300).astype(np.float32))
    with torch.no_grad():
        want = twg._wn(wg.WN[0], x0, cond, cfg, torch.bfloat16)
        wn = wg.WN[0].to(cuda_device)
        got = twg._wn(wn, x0.to(cuda_device), cond.to(cuda_device), cfg, torch.bfloat16)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 2 ** -8 * float(w.abs().max())


# (B, T, lengths, H): served batches (B 1/2/4, S 32-128), a partial row tile
# of 16, the longest training text at B = 64, and the other hidden sizes
K78_TEST_CASES = [(1, 32, None, 256), (2, 77, (77, 40), 256), (4, 128, (128, 97, 64, 3), 256),
                  (13, 45, "mixed", 256), (64, 561, "mixed", 256), (5, 19, "mixed", 32),
                  (9, 23, "mixed", 64), (3, 17, "mixed", 128), (4, 11, "mixed", 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lengths,H", K78_TEST_CASES,
                         ids=[f"B{c[0]}_T{c[1]}_H{c[3]}" for c in K78_TEST_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_encoder_lstm_kernels_match_loop_on_card(cuda_device, dtype, B, T, lengths, H):
    """K7 and K8 through the autograd.Function against autograd through the
    plain loop on the card, by ``chip_smoke.k78_check`` and its limits
    ``K78_TOL`` (float32: sum order; bf16 and float16: a rounding of h or
    of the rounded dh flipped by the sum order feeds back): outputs, gx's,
    w_hh's and the bias's gradients; the inference call bit for bit the
    training call's outputs; K8 deterministic; one launch each."""
    row = k78_check(B, T, lengths, H, dtype, cuda_device)
    assert not row["fails"], row


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["", mh.TINY], ids=["full_width", "multihost_dryrun_tiny"])
def test_encoder_runs_k7_and_k8_once_a_call_on_card(cuda_device, spec):
    """A served encoder call launches K7 once, a trained one K7 and K8
    once; the program's counters say the same.  At full width and at the
    tiny widths ``tools/multihost_dryrun.py`` runs on the card
    (encoder_embedding_dim 32: H = 16, the smallest the kernels take)."""
    model = Tacotron2(create_hparams(spec)).to(cuda_device)
    k78_encoder_launches(model, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(2, 48), (3, 32), (2, 512)])
def test_encoder_lstm_kernels_refuse_shapes_on_card(cuda_device, D, H):
    gx = torch.zeros(D, 2, 5, 4 * H, device=cuda_device)
    w = torch.zeros(D, 4 * H, H, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        el.lstm_fwd(gx, w, torch.zeros(D, 4 * H, device=cuda_device), None, (False,) * D)
