"""Port parity: layers, recurrent scans, encoder, VAE-GST and postnet.

Each test feeds the same numpy-seeded inputs and the same weights (moved by
``convert.from_jax_params``) through the JAX function and the port's
counterpart.  fp32 tolerance is atol 1e-5 (sum-order differences only).
bf16 cases round at the same casting points, but the two frameworks may
round a sum to either neighbour of a half-ulp boundary, so they allow one
bf16 ulp: rtol 2^-7 on top of atol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import build, n, t
from tacotron2_vae_tpu.models import encoder as jenc
from tacotron2_vae_tpu.models import postnet as jpost
from tacotron2_vae_tpu.models import vae_gst as jvae
from tacotron2_vae_tpu.ops import layers as jl
from tacotron2_vae_tpu.ops import rnn as jr
from tacotron2_vae_torch.models import vae_gst as tvae
from tacotron2_vae_torch.ops import encoder_lstm as el
from tacotron2_vae_torch.ops import layers as tl
from tacotron2_vae_torch.ops import rnn as tr

ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    return build()


BF16 = dict(atol=1e-2, rtol=2.0 ** -7)


def _close(a, b, tol=None):
    tol = tol or dict(atol=ATOL, rtol=0)
    np.testing.assert_allclose(n(b), np.asarray(a, np.float32), **tol)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_linear_and_conv1d(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 40, 16).astype(np.float32)
    w = (rng.randn(24, 16) * 0.3).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    jd = None if dtype is None else jnp.bfloat16
    td = None if dtype is None else torch.bfloat16
    tol = None if dtype is None else BF16
    _close(jl.linear({"w": w.T, "b": b}, x, dtype=jd), tl.linear(t(x), t(w), t(b), td), tol)
    for K in (5, 31):
        cw = (rng.randn(24, 16, K) * 0.1).astype(np.float32)
        want = jl.conv1d({"w": np.transpose(cw, (2, 1, 0)), "b": b}, x, dtype=jd)
        got = tl.conv1d(t(x), t(cw), t(b), dtype=td)
        assert got.dtype == (torch.float32 if dtype is None else torch.bfloat16)
        _close(jnp.asarray(want, jnp.float32), got, tol)


def test_conv2d_batchnorm_embedding():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 10, 3).astype(np.float32)
    w = (rng.randn(4, 3, 3, 3) * 0.3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want = jl.conv2d({"w": np.transpose(w, (2, 3, 1, 0)), "b": b}, x, stride=(2, 2))
    _close(want, tl.conv2d(t(x), t(w), t(b)))

    bn = torch.nn.BatchNorm1d(3).eval()
    with torch.no_grad():
        bn.weight.copy_(t(rng.randn(3).astype(np.float32)))
        bn.bias.copy_(t(rng.randn(3).astype(np.float32)))
        bn.running_mean.copy_(t(rng.randn(3).astype(np.float32)))
        bn.running_var.copy_(t(rng.rand(3).astype(np.float32) + 0.5))
    y, _ = jl.batchnorm({"scale": n(bn.weight), "bias": n(bn.bias)},
                        {"mean": n(bn.running_mean), "var": n(bn.running_var)}, x,
                        train=False)
    _close(y, tl.batchnorm(t(x), bn))
    assert tl.batchnorm(t(x).to(torch.bfloat16), bn).dtype == torch.bfloat16

    table = rng.randn(10, 6).astype(np.float32)
    ids = np.array([[1, 9, 0], [3, 3, 2]])
    _close(jl.embedding({"table": table}, ids), tl.embedding(t(table), t(ids)))


def test_dropout_generator():
    x = torch.ones(4000)
    a = tl.dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = tl.dropout(x, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    assert 0.45 < float((a > 0).float().mean()) < 0.55
    assert torch.equal(tl.dropout(x, 0.5, enabled=False), x)


def test_lstm_bilstm_gru_with_lengths(setup):
    _, _, params, _, model = setup
    rng = np.random.RandomState(2)
    x = rng.randn(3, 12, 64).astype(np.float32)
    lens = np.array([12, 7, 3], np.int32)
    lp = params["encoder"]["lstm"]
    h, c = jr.lstm_cell(lp["fwd"], x[:, 0], x[:, 1, :32], x[:, 2, :32])
    lstm = model.encoder.lstm
    h2, c2 = tr.lstm_cell(t(x[:, 0]), t(x[:, 1, :32]), t(x[:, 2, :32]),
                          lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0,
                          lstm.bias_hh_l0)
    _close(h, h2)
    _close(c, c2)
    _close(jr.bilstm(lp, x, jnp.asarray(lens)), tr.bilstm(t(x), lstm, t(lens)))
    for reverse in (False, True):
        _close(jr.lstm_scan(lp["bwd"], x, jnp.asarray(lens), reverse=reverse),
               tr.lstm_scan(t(x), lstm.weight_ih_l0_reverse, lstm.weight_hh_l0_reverse,
                            lstm.bias_ih_l0_reverse, lstm.bias_hh_l0_reverse, t(lens),
                            reverse=reverse))

    gp = params["vae_gst"]["gru"]
    gx = rng.randn(3, 6, gp["wi"].shape[0]).astype(np.float32)
    glens = np.array([6, 4, 1], np.int32)
    outs, hf = jr.gru_scan(gp, gx, jnp.asarray(glens))
    outs2, hf2 = tr.gru_scan(t(gx), model.vae_gst.ref_encoder.gru, t(glens))
    _close(outs, outs2)
    _close(hf, hf2)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("reverse", [(False, True), (True,)], ids=["bilstm", "reversed"])
def test_lstm_recurrence_function_matches_loop_autograd(reverse, B, dtype):
    """The recurrence's autograd.Function on the CPU (the twins of K7 and
    K8, then dw_hh and dbias from one product and a sum) against autograd
    through the plain loop, with mixed lengths: outputs bit for bit (the
    same loop); gx's gradient to float32 sum order; dw_hh, rounded once to
    the stream dtype on both sides, to one ulp of it where the sum order
    moves a rounding (bf16: 2^-8 of the gradient's scale)."""
    rng = np.random.RandomState(B)
    D, T, H = len(reverse), 9, 8
    gx = t(rng.randn(D, B, T, 4 * H).astype(np.float32)).requires_grad_()
    w = t((0.4 * rng.randn(D, 4 * H, H)).astype(np.float32)).requires_grad_()
    b = t((0.2 * rng.randn(D, 4 * H)).astype(np.float32)).requires_grad_()
    lens = torch.tensor([9, 4, 1, 7, 6][:B])
    dout = t(rng.randn(D, B, T, H).astype(np.float32))
    valid = el.valid_mask(T, lens, reverse, "cpu")
    ref = el.lstm_fwd_plain(gx, w, b, valid, dtype)[0]
    want = torch.autograd.grad(ref, (gx, w, b), dout)
    out = el.lstm_dirs(gx, w, b, lens, reverse, dtype)
    got = torch.autograd.grad(out, (gx, w, b), dout)
    assert torch.equal(out, ref)
    assert not out.masked_select(~valid.transpose(1, 2)).any()  # padded steps emit zeros
    for name, g, r in zip(("dgx", "dw_hh", "dbias"), got, want):
        scale = float(r.abs().max())
        tol = 1e-5 if dtype is None or name != "dw_hh" else 2.0 ** -8
        err = float((g - r).abs().max()) / scale
        assert err <= tol, (name, err)


@pytest.mark.parametrize("D,H,dtype", [(2, 48, torch.bfloat16), (3, 32, torch.bfloat16),
                                       (2, 512, torch.bfloat16), (1, 32, torch.float64)])
def test_lstm_recurrence_kernel_refuses_shapes(D, H, dtype):
    """The kernels' wrapper refuses what K7/K8 do not take (checked before
    any launch): a hidden size outside ``SIZES``, more than two directions,
    a stream dtype without a code."""
    gx = torch.zeros(D, 2, 5, 4 * H)
    with pytest.raises(ValueError):
        el._args(gx, torch.zeros(D, 4 * H, H, dtype=dtype), None, (False,) * D)


def test_lstm_recurrence_kernel_names_stay_out_of_k34_time():
    """K7/K8's kernels have names of their own in the profiler's trace:
    the harness's sum of K3/K4's kernel time (``portbench/train.py``
    ``K34_KERNELS``, read by ``k34_roofline.train``) leaves them out."""
    import os
    import re

    from portbench import train

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tacotron2_vae_torch", "csrc", "encoder_lstm.cu")
    with open(src, encoding="utf-8") as f:
        launched = set(re.findall(r"\b([a-z_0-9]+)(?:<[^<>]*>)?<<<", f.read()))
    assert launched == {"enc_lstm_fwd", "enc_lstm_bwd"}
    for k in launched:
        name = f"void (anonymous namespace)::{k}<__nv_bfloat16, 256, 2>(int)"
        assert not train.K34_KERNELS.search(name), name


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_encoder_masked(setup, dtype):
    _, _, params, state, model = setup
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 64).astype(np.float32)
    lens = np.array([16, 9], np.int32)
    jd = None if dtype is None else jnp.bfloat16
    want, _ = jenc.apply(params["encoder"], state["encoder"], x, jnp.asarray(lens),
                         train=False, rng=jax.random.PRNGKey(0), dtype=jd,
                         mask_conv_inputs=True)
    got = model.encoder(t(x), t(lens), dtype=None if dtype is None else torch.bfloat16,
                        mask_conv_inputs=True)
    _close(want, got, None if dtype is None else BF16)


@pytest.mark.parametrize("raw_reshape", [False, True], ids=["transpose", "raw_reshape"])
def test_vae_gst(setup, raw_reshape):
    _, _, params, state, model = setup
    rng = np.random.RandomState(4)
    mel = rng.randn(3, 80, 40).astype(np.float32)
    lens = None if raw_reshape else np.array([40, 29, 13], np.int32)
    (style, mu, logvar, z), _ = jvae.apply(
        params["vae_gst"], state["vae_gst"], mel, train=False, raw_reshape=raw_reshape,
        mel_lengths=None if lens is None else jnp.asarray(lens))
    got = model.vae_gst(t(mel), raw_reshape=raw_reshape,
                        mel_lengths=None if lens is None else t(lens))
    for a, b in zip((style, mu, logvar, z), got):
        _close(a, b)


def test_vae_gst_exact_under_padding(setup):
    _, _, _, _, model = setup
    rng = np.random.RandomState(5)
    mel = rng.randn(1, 80, 27).astype(np.float32)
    padded = np.zeros((2, 80, 64), np.float32)
    padded[0, :, :27] = mel[0]
    alone = model.vae_gst(t(mel))[1]
    batch = model.vae_gst(t(padded), mel_lengths=torch.tensor([27, 1]))[1]
    _close(n(alone)[0], batch[0])


def test_add_coords_per_item_rows():
    x = np.zeros((2, 5, 4, 1), np.float32)
    lens = np.array([5, 3], np.int32)
    _close(jvae.add_coords_2d(x, jnp.asarray(lens)), tvae.add_coords_2d(t(x), t(lens)))
    _close(jvae.add_coords_2d(x), tvae.add_coords_2d(t(x)))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_postnet(setup, dtype):
    _, _, params, state, model = setup
    mel = np.random.RandomState(6).randn(2, 80, 30).astype(np.float32)
    want, _ = jpost.apply(params["postnet"], state["postnet"], mel, train=False,
                          rng=jax.random.PRNGKey(0),
                          dtype=None if dtype is None else jnp.bfloat16)
    got = model.postnet(t(mel), dtype=None if dtype is None else torch.bfloat16)
    _close(jnp.asarray(want, jnp.float32), got, None if dtype is None else BF16)
