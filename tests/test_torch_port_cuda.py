"""The port's CUDA kernels against their plain twins, on the card.

Kernels K1 (decode loop), K2 (STFT -> mel -> log), K3 and K4 (the
teacher-forced recurrence, forward and backward) have no CPU mode: on a
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
of the 32-wide tiles, with B below the 64-row tile and at it.
"""

import numpy as np
import pytest
import torch

from _torch_port_common import TINY, n
from chip_smoke import k1_compare, k34_check
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_vae_torch.ops import decoder_loop as dl
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,lengths", [(5, 13, 9, (13, 12, 9, 5, 1)), (64, 70, 6, None)],
                         ids=["B5_S13", "B64_S70"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrence_kernels_match_twins_on_card(cuda_device, dtype, B, S, T, lengths):
    hp = create_hparams(ODD)
    model = init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))
    dec = model.to(cuda_device).eval().requires_grad_(False).decoder
    for dropout_on in (False, True):
        row = k34_check(dec, B, S, T, lengths, dtype, dropout_on, cuda_device, timed=False)
        assert not row["fails"], row


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
