"""The port's CUDA kernels against their plain twins, on the card.

Kernels K1 (decode loop), K2 (STFT -> mel -> log), K3 and K4 (the
teacher-forced recurrence, forward and backward), K5 and K6 (the reshape
and output-block probes) have no CPU mode: on a
CPU tensor their wrappers run the twin, so these tests need a card and skip
without one.  They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tiny widths (``TINY``) with shapes that reach the kernels' partial tiles:
S below and above the attention kernel's 64-position chunk, frame counts
that are and are not a multiple of K2's 4-frame block.  Tolerances: K1 per
output, over the first steps and the whole run, by ``chip_smoke.k1_compare``
(f32: sum order only; bf16: the same casting points, sum order flips a
rounding now and then, and the flip feeds back); K2 atol 1e-4 as
tests/test_pallas_stft.py:36; K3 and K4, outputs and every gradient of the
recurrence, by ``chip_smoke.k34_check`` and its limits ``K34_TOL``, at
widths whose LSTM input sizes (P+E+H = 176, 2H+E = 212) are not multiples
of the 64-deep wgmma tiles and whose 4H = 288 is not a multiple of the
64-unit blocks, with B from 1 to the 64-row tile and S split unevenly over
the attention cluster; two K4 calls bit for bit alike; K5 exactly
(a copy plus one), on the 16-byte path and the scalar one, from a strided
view; K6 atol 1e-5 (sum order), with rows off its 8-row tile.  WaveGlow
(cuDNN/cuBLAS, no kernel of its own) on the card against the CPU: float32
to 1e-5 of max |audio| (TF32 would give ~1e-3); bf16 one WaveNet to one
bf16 ulp of its output scale (same rounding points, another sum order).
"""

import numpy as np
import pytest
import torch

from _torch_port_common import TINY, n
from chip_smoke import k1_compare, k34_check
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.models import waveglow as twg
from tacotron2_vae_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_vae_torch.ops import decoder_loop as dl
from tacotron2_vae_torch.ops import reshape_probe as rp
from tacotron2_vae_torch.ops import stft_mel as sm
from tacotron2_vae_torch.ops.layers import linear


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1 and K2 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(3, 16), (4, 80)], ids=["B3_S16", "B4_S80"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_loop_kernel_matches_twin_on_card(cuda_device, dtype, B, S):
    hp = create_hparams(TINY)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    rng = np.random.RandomState(1)
    memory = torch.from_numpy((rng.randn(B, S, hp.encoder_embedding_dim) * 0.3)
                              .astype(np.float32)).to(cuda_device)
    lens = torch.tensor([S, S - 5, S - 9, S // 2][:B], device=cuda_device)
    mask = torch.arange(S, device=cuda_device)[None] < lens[:, None]
    pmem = linear(memory, dec.attention_layer.memory_layer.linear_layer.weight)
    kw = dl.pack_weights(dec, getattr(torch, dtype))
    args = dict(max_steps=30, gate_threshold=1.1, seed=9, dropout_on=True)
    got = dl.decode_loop(kw, memory, pmem, mask, **args)
    want = dl.finish(*dl.decode_loop_plain(kw, memory, pmem, mask, **args), 1.1, 1)
    errs, fails = k1_compare(got, want, dtype, 1)
    assert not fails, errs


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrence_kernels_match_twins_on_card(cuda_device, dtype, B, S, T, lengths):
    hp = create_hparams(ODD)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    for dropout_on in (False, True):
        row = k34_check(dec, B, S, T, lengths, dtype, dropout_on, cuda_device, timed=False)
        assert not row["fails"], row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
