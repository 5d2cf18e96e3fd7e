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
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.models import encoder as jenc
from tacotron2_vae_tpu.models import postnet as jpost
from tacotron2_vae_tpu.models import vae_gst as jvae
from tacotron2_vae_tpu.ops import layers as jl
from tacotron2_vae_tpu.ops import rnn as jr
from tacotron2_vae_torch.models import vae_gst as tvae
from tacotron2_vae_torch.ops import encoder_lstm as el
from tacotron2_vae_torch.ops import layers as tl
from tacotron2_vae_torch.ops import rnn as tr
from tacotron2_vae_torch.ops import teacher_fwd as tf

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


def factored_bwd(w, memory, pmem, masks, dys, ys, resids, w_cum_prev, chunk=None):
    """The recurrence backward of ``teacher_bwd_plain`` in K4's order, in
    plain PyTorch: the steps in chunks of ``chunk`` (default ``bwd_chunk``
    of the shapes) from the last, and for each chunk
      coefficients, every step of it: loc and ta as the forward has them,
        G = v (1 - ta^2), M = G . loc_dense^T, N[p, k, c] = sum_f M[p, f]
        loc_w[k, c, f];
      the chain, each step in reverse time: the two LSTM backwards as
        ``teacher_bwd_plain``, and between them dw, de, dq = G^T de and the
        location carries through the taps of N, all linear in de;
      accumulation, each step in reverse time: dloc = de M, dpmem += de G,
        dv += de ta, dWld += loc^T (de G)."""
    dh_dec_seq, dctx_seq, dw_seq = dys
    w_seq = ys[2]
    g_att_seq, g_dec_seq, c_att_prev, c_dec_prev, h_att_seq = resids
    T, B, S, E, H, P, sdt, wa, wd, z = tf._bwd_setup(w, memory, ys)
    v, ldw, qw, lw = w["v"], w["loc_dense_w"], w["query_w"], w["loc_w"]
    K = lw.shape[0]
    pad = (K - 1) // 2
    C = chunk or tf.bwd_chunk(T, B, S, H, qw.shape[1], ldw.shape[0], K)
    dh_att_c, dc_att_c, dh_dec_c, dc_dec_c = z(B, H), z(B, H), z(B, H), z(B, H)
    dw_prev_c, dwcum_c, dctx_c = z(B, S), z(B, S), z(B, E)
    dv, dwq, dwld, dpmem = z(*v.shape), z(*qw.shape), z(*ldw.shape), z(B, S, pmem.shape[2])
    streams = [[None] * T for _ in range(5)]
    for hi in range(T - 1, -1, -C):
        steps = range(max(0, hi - C + 1), hi + 1)
        coef = {}
        for t in steps:
            w_prev = w_seq[t - 1] if t else torch.zeros_like(w_seq[0])
            loc, ta = tf._energy_terms(w, h_att_seq[t], w_prev, w_cum_prev[t], pmem)
            G = v * (1.0 - ta * ta)
            M = G @ ldw.t()
            coef[t] = loc, ta, G, M, torch.einsum("bsf,kcf->bskc", M, lw)
        des = {}
        for t in reversed(steps):
            _, _, G, _, N = coef[t]
            dg_dec, dx_dec, dc_dec_c = tf._cell_bwd(wd, g_dec_seq[t], c_dec_prev[t],
                                                    dh_dec_seq[t] + dh_dec_c, dc_dec_c,
                                                    tf._mask(masks, 2, t),
                                                    tf._mask(masks, 3, t), H, sdt)
            dh_att = dx_dec[:, :H] + dh_att_c
            dctx = dx_dec[:, H:H + E] + dctx_seq[t] + dctx_c
            dh_dec_c = dx_dec[:, H + E:]

            wt = w_seq[t]
            dw = dw_seq[t] + dw_prev_c + dwcum_c + torch.bmm(memory, dctx[:, :, None])[..., 0]
            de = wt * (dw - (dw * wt).sum(1, keepdim=True))
            dq = torch.einsum("bs,bsa->ba", de, G)
            dh_att = dh_att + dq @ qw.t()
            dwq = dwq + h_att_seq[t].t() @ dq
            # dfeat[q] = sum_k de[q + pad - k] N[q + pad - k, k]: source p padded by pad
            src = torch.nn.functional.pad(de[:, :, None, None] * N, (0, 0, 0, 0, pad, pad))
            dfeats = sum(src[:, 2 * pad - k:2 * pad - k + S, k] for k in range(K))
            dw_prev_c, dwcum_c = dfeats[..., 0], dfeats[..., 1] + dwcum_c

            dg_att, dx_att, dc_att_c = tf._cell_bwd(wa, g_att_seq[t], c_att_prev[t], dh_att,
                                                    dc_att_c, tf._mask(masks, 0, t),
                                                    tf._mask(masks, 1, t), H, sdt)
            dctx_c, dh_att_c = dx_att[:, P:P + E], dx_att[:, P + E:]
            for lst, val in zip(streams[:4], (dg_att, dg_dec, dx_att[:, :P], dctx)):
                lst[t] = val
            des[t] = de
        for t in reversed(steps):
            loc, ta, G, M, _ = coef[t]
            de = des[t][:, :, None]
            dta = de * G
            streams[4][t] = (de * M).to(sdt)
            dpmem = dpmem + dta
            dv = dv + torch.einsum("bsa,bs->a", ta, des[t])
            dwld = dwld + torch.einsum("bsf,bsa->fa", loc, dta)
    dg_att, dg_dec, dpn, dctx, dloc = (torch.stack(s) for s in streams)
    return dg_att, dg_dec, dpn, dctx, dloc, dv, dwq, dwld, dpmem


# (B, S, T, chunk, K, memory lengths, dropout): S off the 4-way split of
# the chain's cluster and off the coefficient chunk, T off C, padded
# positions; the 31-tap halo past both ends of S (S = 40, and S = 6 with
# every tap reaching out); C = 1 and the default chunk of the shapes
FACTORED_CASES = [(3, 13, 7, 3, 5, (13, 9, 4), True), (2, 13, 7, 3, 5, None, False),
                  (2, 40, 5, None, 31, (40, 23), False), (1, 6, 4, 1, 31, None, True)]


@pytest.mark.parametrize("B,S,T,chunk,K,lengths,dropout", FACTORED_CASES,
                         ids=["S13_T7_C3_masked_dropout", "S13_T7_C3", "S40_K31_default_chunk",
                              "S6_K31_C1_dropout"])
def test_factored_attention_backward_matches_plain_and_autograd(B, S, T, chunk, K, lengths,
                                                                dropout):
    """K4's order of the recurrence backward in plain PyTorch
    (``factored_bwd``: coefficients a chunk, the chain linear in de,
    accumulation) against the step-by-step twin and against autograd
    through the forward twin, all in float64: every stream and accumulator
    of the twin, and the gradients of query_w, loc_dense_w, v, loc_w, pmem,
    the prenet input and memory."""
    H, E, P, A, Fn = 8, 8, 4, 6, 3
    g = torch.Generator().manual_seed(S * 100 + T)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, dtype=torch.float64) * scale)

    w = {"attn_w": r(P + E + H, 4 * H, scale=0.3), "attn_b": r(4 * H, scale=0.1),
         "dec_w": r(2 * H + E, 4 * H, scale=0.3), "dec_b": r(4 * H, scale=0.1),
         "query_w": r(H, A, scale=0.5), "loc_w": r(K, 2, Fn, scale=0.5),
         "loc_dense_w": r(Fn, A, scale=0.5), "v": r(A)}
    pn, mem, pm = r(T, B, P), r(B, S, E, scale=0.5), r(B, S, A, scale=0.5)
    lens = torch.tensor(lengths or (S,) * B)
    add = torch.where(torch.arange(S)[None] < lens[:, None], 0.0,
                      float(np.finfo(np.float32).min)).double()
    masks = None
    if dropout:
        masks = tuple((torch.rand(T, B, H, generator=g, dtype=torch.float64) < 0.9).double() / 0.9
                      for _ in range(4))
    dys = (r(T, B, H, scale=0.1), r(T, B, E, scale=0.1), r(T, B, S, scale=0.1))
    leaves = {k: x.clone().requires_grad_() for k, x in
              {**w, "prenet_seq": pn, "memory": mem, "pmem": pm}.items()}
    ys_g, _ = tf.teacher_fwd_plain({k: leaves[k] for k in w}, leaves["prenet_seq"],
                                   leaves["memory"], leaves["pmem"], add, masks)
    names = ("query_w", "loc_dense_w", "v", "loc_w", "pmem", "prenet_seq", "memory")
    auto = dict(zip(names, torch.autograd.grad(sum((y * d).sum() for y, d in zip(ys_g, dys)),
                                               [leaves[k] for k in names])))

    ys, res = tf.teacher_fwd_plain(w, pn, mem, pm, add, masks)
    zero = torch.zeros_like(ys[2][:1])
    w_cum_prev = torch.cat([zero, torch.cumsum(ys[2], 0)[:-1]])
    args = (w, mem, pm, masks, dys, ys, res, w_cum_prev)
    plain = tf.teacher_bwd_plain(*args)
    got = factored_bwd(*args, chunk=chunk)

    def err(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)

    outs = ("dg_att", "dg_dec", "dpn", "dctx", "dloc", "dv", "dwq", "dwld", "dpmem")
    for name, a, b in zip(outs, got, plain):
        assert a.dtype == torch.float64 and a.shape == b.shape, name
        assert err(a, b) <= 1e-12, (name, err(a, b))
    _, _, dpn, dctx, dloc, dv, dwq, dwld, dpmem = got
    pad = (K - 1) // 2
    w_prev = torch.cat([zero, ys[2][:-1]])
    feats = torch.nn.functional.pad(torch.stack([w_prev, w_cum_prev], -1), (0, 0, pad, pad))
    dloc_w = torch.stack([torch.einsum("tbsc,tbsf->cf", feats[:, :, k:k + S], dloc)
                          for k in range(K)])
    derived = {"query_w": dwq, "loc_dense_w": dwld, "v": dv, "loc_w": dloc_w, "pmem": dpmem,
               "prenet_seq": dpn, "memory": torch.einsum("tbs,tbe->bse", ys[2], dctx)}
    for name in names:
        assert err(derived[name], auto[name]) <= 1e-10, (name, err(derived[name], auto[name]))
