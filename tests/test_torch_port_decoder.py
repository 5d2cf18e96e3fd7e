"""Port parity: the decoder loop, its kernel twin, the dropout hash, and
``tacotron2.infer`` as a whole.

The port's plain ``Decoder.infer`` is held against the JAX plain path
(``decoder.infer(use_pallas=False)``); the twin of kernel K1
(``ops.decoder_loop`` on CPU tensors) is held against the JAX Pallas
kernels run by the Pallas interpreter (``decode_loop`` at B=1,
``decode_loop_batched`` at B=3), at r=1 and r=2, with a memory mask and
with gate early exit.  All in fp32 with dropout off (the TPU's dropout bits
cannot be reproduced): atol 1e-5, sum-order differences only.  The CUDA
kernel itself is held against the twin on the card in
``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import build, n, t
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.models import decoder as jdec
from tacotron2_vae_tpu.models import tacotron2 as jt2
from tacotron2_vae_tpu.ops.layers import linear as jlinear
from tacotron2_vae_tpu.ops.pallas import decoder_loop as jdl
from tacotron2_vae_torch.ops import decoder_loop as dl
from tacotron2_vae_torch.ops.layers import linear

ATOL = 1e-5


def _close(a, b):
    np.testing.assert_allclose(n(b), np.asarray(a, np.float32), atol=ATOL, rtol=0)


def _inputs(B, S, hp, seed=1):
    rng = np.random.RandomState(seed)
    memory = (rng.randn(B, S, hp.encoder_embedding_dim) * 0.3).astype(np.float32)
    lens = np.array([S, S - 5, S - 9][:B], np.int32)
    return memory, lens


CASES = [(1, 1, False), (1, 2, False), (3, 1, True), (3, 2, True)]


@pytest.mark.parametrize("B,r,masked", CASES, ids=["B1r1", "B1r2", "B3r1_mask", "B3r2_mask"])
def test_plain_infer_matches_jax(B, r, masked):
    hpj, hp, params, _, model = build(f",n_frames_per_step={r}")
    memory, lens = _inputs(B, 16, hp)
    kw = dict(max_steps=12, gate_threshold=1.1, prenet_dropout_enabled=False)
    want = jdec.infer(params["decoder"], jnp.asarray(memory), hpj, rng=jax.random.PRNGKey(0),
                      use_pallas=False, memory_lengths=jnp.asarray(lens) if masked else None,
                      **kw)
    got = model.decoder.infer(t(memory), seed=0,
                              memory_lengths=t(lens).long() if masked else None, **kw)
    assert got[0].shape == (B, hp.n_mel_channels, 12 * r)
    for a, b in zip(want[:3], got[:3]):
        _close(a, b)
    np.testing.assert_array_equal(n(got[3]), np.asarray(want[3]))


@pytest.mark.parametrize("B,r,masked", CASES, ids=["B1r1", "B1r2", "B3r1_mask", "B3r2_mask"])
def test_kernel_twin_matches_pallas_interpret(B, r, masked):
    hpj, hp, params, _, model = build(f",n_frames_per_step={r}")
    memory, lens = _inputs(B, 16, hp)
    S = memory.shape[1]
    mask = np.arange(S)[None, :] < lens[:, None] if masked else None
    pmem = jlinear(params["decoder"]["attention"]["memory"], jnp.asarray(memory))
    kw = dict(max_steps=12, gate_threshold=1.1, seed=0, dropout_on=False, r=r)
    if B == 1:
        want = jdl.decode_loop(jdl.prepare_weights(params["decoder"], dtype=jnp.float32),
                               jnp.asarray(memory), pmem,
                               None if mask is None else jnp.asarray(mask),
                               interpret=True, dtype_name="float32", **kw)
    else:
        want = jdl.decode_loop_batched(params["decoder"], jnp.asarray(memory), pmem,
                                       None if mask is None else jnp.asarray(mask),
                                       interpret=True, dtype_name="float32", **kw)
    got = dl.decode_loop(dl.pack_weights(model.decoder), t(memory), t(np.asarray(pmem)),
                         None if mask is None else t(mask), **kw)
    for a, b in zip(want[:3], got[:3]):
        _close(a, b)
    np.testing.assert_array_equal(n(got[3]), np.asarray(want[3]))
    if masked:
        assert np.all(n(got[2])[1, :, S - 5:] < 1e-6)


@pytest.mark.parametrize("B", [1, 3])
def test_gate_early_exit(B):
    """threshold -1: every gate fires at the first step -> length r, and all
    later frames, gates and alignments are zero (kernel twin and plain)."""
    hpj, hp, params, _, model = build(",n_frames_per_step=2")
    memory, _ = _inputs(B, 16, hp)
    pmem = linear(t(memory), model.decoder.attention_layer.memory_layer.linear_layer.weight)
    twin = dl.decode_loop(dl.pack_weights(model.decoder), t(memory), pmem, None,
                          max_steps=20, gate_threshold=-1.0, seed=0, dropout_on=False, r=2)
    plain = model.decoder.infer(t(memory), seed=0, max_steps=20, gate_threshold=-1.0,
                                prenet_dropout_enabled=False)
    for mel, gate, align, lengths in (twin, plain):
        assert n(lengths).tolist() == [2] * B
        assert np.all(n(mel)[:, :, 2:] == 0) and np.all(n(gate)[:, 1:] == 0)
        assert np.all(n(align)[:, 1:] == 0)
    for a, b in zip(twin, plain):
        _close(n(a), b)


def test_plain_and_twin_agree_with_dropout_on():
    """Same seed -> the plain loop and the kernel twin draw the same prenet
    masks, so they agree with dropout on as well (fp32)."""
    _, hp, _, _, model = build()
    memory, lens = _inputs(3, 16, hp)
    mask = t(np.arange(16)[None, :] < lens[:, None])
    pmem = linear(t(memory), model.decoder.attention_layer.memory_layer.linear_layer.weight)
    twin = dl.decode_loop(dl.pack_weights(model.decoder), t(memory), pmem, mask,
                          max_steps=10, gate_threshold=1.1, seed=123, dropout_on=True)
    plain = model.decoder.infer(t(memory), seed=123, max_steps=10, gate_threshold=1.1,
                                memory_lengths=t(lens).long())
    for a, b in zip(twin[:3], plain[:3]):
        _close(n(a), b)
    off = model.decoder.infer(t(memory), seed=123, max_steps=10, gate_threshold=1.1,
                              memory_lengths=t(lens).long(), prenet_dropout_enabled=False)
    assert not np.allclose(n(off[0]), n(plain[0]))


def test_dropout_hash_rate_scale_and_determinism():
    bits = dl.dropout_bits(7, 3, 0, 8, 256)
    assert bits.min() >= 0 and bits.max() < 2 ** 32
    keep = dl.dropout_keep(7, 3, 0, 8, 4096)
    assert 0.48 < float(keep.mean()) < 0.52
    assert torch.equal(keep, dl.dropout_keep(7, 3, 0, 8, 4096))
    for other in (dl.dropout_keep(8, 3, 0, 8, 4096), dl.dropout_keep(7, 4, 0, 8, 4096),
                  dl.dropout_keep(7, 3, 1, 8, 4096)):
        assert 0.4 < float((other != keep).float().mean()) < 0.6
    # reference values of the 32-bit mix (the CUDA kernel's uint32 arithmetic)
    x = torch.tensor([0, 1, 0xFFFFFFFF], dtype=torch.int64)
    np.testing.assert_array_equal(dl._mix32(x).numpy().astype(np.uint64),
                                  [_mix32_ref(int(v)) for v in x])
    # the prenet scales kept units by 2 and zeroes the rest, layer by layer
    _, hp, _, _, model = build()
    x = torch.rand(4, hp.n_mel_channels, generator=torch.Generator().manual_seed(0))
    w1, w2 = (layer.linear_layer.weight for layer in model.decoder.prenet.layers)
    h = torch.relu(x @ w1.t()) * dl.dropout_keep(5, 2, 0, 4, hp.prenet_dim) * 2.0
    want = torch.relu(h @ w2.t()) * dl.dropout_keep(5, 2, 1, 4, hp.prenet_dim) * 2.0
    _close(n(want), model.decoder.prenet_forward(x, seed=5, step=2))


def _mix32_ref(x):
    M = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M
    x ^= x >> 15
    x = (x * 0x846CA68B) & M
    return x ^ (x >> 16)


def test_wrappers_refuse_other_devices():
    _, hp, _, _, model = build()
    memory = torch.zeros(1, 4, hp.encoder_embedding_dim, device="meta")
    with pytest.raises(ValueError):
        dl.decode_loop({}, memory, memory, None, max_steps=1, gate_threshold=0.5, seed=0)


@pytest.mark.parametrize("masked", [False, True])
def test_tacotron2_infer_matches_jax(masked):
    hpj, hp, params, state, model = build()
    rng = np.random.RandomState(2)
    B, S = 3, 16
    text = rng.randint(1, hp.n_symbols, (B, S)).astype(np.int32)
    lens = np.array([16, 11, 7], np.int32)
    style = (rng.randn(B, hp.E) * 0.1).astype(np.float32)
    kw = dict(max_steps=14, gate_threshold=1.1, prenet_dropout_enabled=False)
    want = jt2.infer(params, state, jnp.asarray(text), jnp.asarray(style), hpj,
                     rng=jax.random.PRNGKey(0), use_pallas=False,
                     text_lengths=jnp.asarray(lens) if masked else None, **kw)
    got = model.infer(t(text), t(style), seed=0,
                      text_lengths=t(lens).long() if masked else None, **kw)
    for a, b in zip(want[:4], got[:4]):
        _close(a, b)
    np.testing.assert_array_equal(n(got[4]), np.asarray(want[4]))
