"""Port parity: ``fp16_run`` and float16 compute.

Held against the JAX package on numpy-seeded inputs, with the weights
carried over by ``convert.from_jax_params``, at tiny widths:

- the loss scalers over a sequence of overflow flags (halving with a floor
  of 1, growth after the window, the static scale of 1 that
  ``dynamic_loss_scaling=False`` gives) and ``scaled_value_and_grad``:
  exact;
- ``ScanCore`` (K3/K4's twins) in float16 against JAX's hand BPTT at
  float16: the forward's outputs and residuals within one float16 ulp
  (rtol 2^-10; both sides round at the same points), the gradients within
  2e-3 of the largest (the JAX package's own f16 limit is 2e-2,
  tests/test_bptt.py:386-387; measured 2.6e-4);
- K1's twin in float16 against the JAX Pallas decode (interpreter): the
  first step within 1e-5, the 12 steps within four float16 ulps of the
  largest value (a sum-order flip of one rounding feeds back in the loop;
  measured 7e-4 of the largest);
- ``Tacotron2.infer`` at ``compute_dtype=float16`` (serving) against
  JAX's: the first decoder step of the mel, gate and alignments within
  1e-5, every output within 2^-8 of its largest value (the postnet's
  outputs are stored in float16: one flipped rounding is 2^-10 of them;
  measured 6.6e-4 of the largest);
- the ``fp16_run`` train step against JAX's from a scale of 128, forward
  in eval mode with dropout off on both sides, over 3 steps: the loss
  (rtol 1e-4; measured 2e-5), the gradient norm (rtol 5e-4; measured
  6e-5), the scale and its count (exact), and the parameters' updates
  (relative L2 error 0.05; measured 0.005-0.011: Adam moves a parameter
  by about the learning rate whatever the size of its gradient, so the
  rounding noise of small gradients shows in full);
- a NaN batch halves the scale and leaves the parameters, Adam's state and
  the batchnorm statistics as they were, and the count grows after a
  clean step, as the JAX scaler's do;
- the scaler's checkpoint round trip, and a checkpoint saved without
  ``fp16_run`` resumed with it keeping a fresh scaler (JAX
  ``checkpoint.py:36-75``);
- ``train()`` and its CLI with ``--hparams fp16_run=True`` through a
  validation, a checkpoint and a resume, on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import TINY, build, n, t
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from test_torch_port_decoder import _inputs
from test_torch_port_train_loop import _batch as _loop_batch
from test_torch_port_train_loop import _state_snapshot, _write_corpus
from test_torch_port_train_model import _batch, _port_batch
from test_torch_port_train_scan import KEYS, _cfg, _jax_grads, _jax_masks, _port_grads, _setup
from tacotron2_vae_tpu.models import decoder_bptt as jb
from tacotron2_vae_tpu.models import tacotron2 as jt2
from tacotron2_vae_tpu.ops.layers import linear as jlinear
from tacotron2_vae_tpu.ops.pallas import decoder_loop as jdl
from tacotron2_vae_tpu.training import loss_scaler as jls
from tacotron2_vae_tpu.training import train_state as jts
from tacotron2_vae_torch import convert
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.models.tacotron2 import Tacotron2
from tacotron2_vae_torch.ops import decoder_loop as dl
from tacotron2_vae_torch.ops import teacher_fwd as tf
from tacotron2_vae_torch.training import loss_scaler as pls
from tacotron2_vae_torch.training import train as tr
from tacotron2_vae_torch.training import train_state as pts
from tacotron2_vae_torch.training.checkpoint import load_checkpoint, save_checkpoint

FLAGS = [True, True, True, True, True, False, False, False, False, True, False, False, False,
         False, False, True]


@pytest.mark.parametrize("kind", ["dynamic", "static", "default"])
def test_loss_scaler_schedule_matches_jax(kind):
    """Halving down to the floor of 1, growth after ``scale_window`` clean
    steps in a row, a reset of the count at either; ``default`` and
    ``static`` are what ``make_loss_scaler`` gives for ``fp16_run`` with
    ``dynamic_loss_scaling`` on and off.  The JAX package's static scaler
    (window 2^31) cannot update: JAX refuses 2^31 beside an int32 count
    (OverflowError), so the port's, which compares in int64, is held to the
    same scaler with a window of 2^31 - 1, alike over these steps."""
    if kind == "dynamic":
        port, ref = pls.DynamicLossScaler(8.0, 2.0, 3), jls.DynamicLossScaler(8.0, 2.0, 3)
    else:
        extra = ",fp16_run=True" + (",dynamic_loss_scaling=False" if kind == "static" else "")
        port = pts.make_loss_scaler(create_hparams(TINY + extra))
        ref = jts.make_loss_scaler(build_jax_hparams(extra))
        if kind == "static":
            assert ref.scale_window == port.scale_window == 2 ** 31
            ref = jls.DynamicLossScaler(ref.init_scale, ref.scale_factor, 2 ** 31 - 1)
    ps, js = port.init(), ref.init()
    trace = []
    for flag in FLAGS:
        assert float(ps.scale) == float(js.scale) and int(ps.iters_since_rescale) == int(
            js.iters_since_rescale)
        trace.append(float(ps.scale))
        ps = port.update(ps, torch.tensor(flag))
        js = ref.update(js, jnp.asarray(flag))
    assert float(ps.scale) == float(js.scale)
    assert int(ps.iters_since_rescale) == int(js.iters_since_rescale)
    assert ps.scale.dtype == torch.float32 and ps.iters_since_rescale.dtype == torch.int32
    if kind == "dynamic":  # the floor of 1 after three halvings, growth after 3 clean steps
        assert trace == [8, 4, 2, 1, 1, 1, 1, 1, 2, 2, 1, 1, 1, 2, 2, 2]
    if kind == "static":
        assert set(trace) == {1.0}


def build_jax_hparams(extra):
    from tacotron2_vae_tpu.config import create_hparams as jax_hparams

    return jax_hparams(TINY + extra)


@pytest.mark.parametrize("poison", [False, True], ids=["finite", "overflow"])
def test_scaled_value_and_grad_matches_jax(poison):
    rng = np.random.RandomState(0)
    x, w = rng.randn(5, 3).astype(np.float32), rng.randn(3).astype(np.float32)
    if poison:
        w[1] = 1e38  # x^2 w scaled by 2^10 overflows float32

    def jax_f(x):
        v = jnp.sum(x ** 2 * jnp.asarray(w))
        return v, {"v": v}

    def port_f(x):
        v = (x ** 2 * torch.from_numpy(w)).sum()
        return v, {"v": v}

    (jv, _), jg, jo = jls.scaled_value_and_grad(jax_f, 1024.0)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (pv, aux), pg, po = pls.scaled_value_and_grad(port_f, torch.tensor(1024.0))(xt)
    assert bool(po) == bool(jo) == poison
    np.testing.assert_array_equal(n(pg), np.asarray(jg))
    if not poison:
        np.testing.assert_allclose(float(pv), float(jv), rtol=1e-6)
        assert "v" in aux
    static = pls.LossScaler(4.0)
    assert float(static.scale_loss(torch.tensor(2.0))) == 8.0
    assert pls.LossScaler.has_overflow(pg) == poison
    np.testing.assert_array_equal(n(static.unscale_grads([torch.ones(2)])[0]), [0.25, 0.25])


@pytest.mark.parametrize("dropout", [False, True], ids=["masks_off", "masks_on"])
def test_scan_core_float16_matches_jax(dropout):
    params, pn, mem, pm, add, masks = data = _setup(dropout, dtype=jnp.float16)
    w = tf.pack({**{k: torch.from_numpy(v) for k, v in params.items() if k != "v_w"},
                 "v": torch.from_numpy(params["v_w"])}, torch.float16)
    tmasks = None if masks is None else tuple(
        torch.from_numpy(np.asarray(m, np.float32)).half() for m in masks)
    ys, resids = tf.teacher_fwd(w, *(torch.from_numpy(x) for x in (pn, mem, pm, add)), tmasks)
    jargs = ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pn), jnp.asarray(mem),
             jnp.asarray(pm), jnp.asarray(add), _jax_masks(masks))
    ys_x, res_x = jb._fwd_impl(*jargs, _cfg(dropout, "float16"))
    assert resids[0].dtype == resids[1].dtype == torch.float16
    for a, b in zip((*ys, *resids), (*ys_x, *res_x[:5])):
        np.testing.assert_allclose(n(a), np.asarray(b, np.float32), rtol=2 ** -10, atol=1e-6)
    lp, gp, xp = _port_grads(*data, dtype=torch.float16)
    lr, gr, xr = _jax_grads(_cfg(dropout, "float16"), *data, use_core=True)
    np.testing.assert_allclose(lp, lr, rtol=2 ** -10)
    for a, b in list(zip((gp[k] for k in KEYS), (gr[k] for k in KEYS))) + list(zip(xp, xr)):
        assert np.all(np.isfinite(a))
        assert np.abs(a - b).max() <= 2e-3 * max(1e-3, float(np.abs(b).max()))


@pytest.mark.parametrize("B,masked", [(1, False), (3, True)], ids=["B1", "B3_mask"])
def test_decode_twin_float16_matches_pallas_interpret(B, masked):
    hpj, hp, params, _, model = build("")
    memory, lens = _inputs(B, 16, hp)
    mask = np.arange(memory.shape[1])[None, :] < lens[:, None] if masked else None
    pmem = jlinear(params["decoder"]["attention"]["memory"], jnp.asarray(memory))
    kw = dict(max_steps=12, gate_threshold=1.1, seed=0, dropout_on=False, r=1)
    jmask = None if mask is None else jnp.asarray(mask)
    if B == 1:
        want = jdl.decode_loop(jdl.prepare_weights(params["decoder"], dtype=jnp.float16),
                               jnp.asarray(memory), pmem, jmask, interpret=True,
                               dtype_name="float16", **kw)
    else:
        want = jdl.decode_loop_batched(params["decoder"], jnp.asarray(memory), pmem, jmask,
                                       interpret=True, dtype_name="float16", **kw)
    got = dl.decode_loop(dl.pack_weights(model.decoder, torch.float16), t(memory),
                         t(np.asarray(pmem)), None if mask is None else t(mask), **kw)
    firsts = (lambda x: x[..., :1], lambda x: x[:, :1], lambda x: x[:, :1])
    for a, b, first in zip(got[:3], want[:3], firsts):
        a, b = n(a), np.asarray(b, np.float32)
        assert np.abs(first(a) - first(b)).max() <= 1e-5
        assert np.abs(a - b).max() <= 2 ** -8 * np.abs(b).max()
    np.testing.assert_array_equal(n(got[3]), np.asarray(want[3]))


def test_tacotron2_infer_float16_matches_jax():
    hpj, hp, params, state, model = build(",compute_dtype='float16'")
    rng = np.random.RandomState(2)
    B, S = 3, 16
    text = rng.randint(1, hp.n_symbols, (B, S)).astype(np.int32)
    lens = np.array([16, 11, 7], np.int32)
    style = (rng.randn(B, hp.E) * 0.1).astype(np.float32)
    kw = dict(max_steps=14, gate_threshold=1.1, prenet_dropout_enabled=False)
    want = jt2.infer(params, state, jnp.asarray(text), jnp.asarray(style), hpj,
                     rng=jax.random.PRNGKey(0), use_pallas=False,
                     text_lengths=jnp.asarray(lens), **kw)
    got = model.infer(t(text), t(style), seed=0, text_lengths=t(lens).long(), **kw)
    for i, (a, b) in enumerate(zip(want[:4], got[:4])):
        a, b = np.asarray(a, np.float32), n(b)
        assert np.abs(a - b).max() <= 2 ** -8 * np.abs(a).max()
        if i != 1:  # mel, gate, alignments: the first step, before any feedback
            first = (slice(None), slice(None), slice(0, 1)) if i == 0 else (slice(None),
                                                                             slice(0, 1))
            assert np.abs(a[first] - b[first]).max() <= 1e-5
    np.testing.assert_array_equal(n(got[4]), np.asarray(want[4]))


def _fp16_pair(custom):
    """(port state, port step, JAX state, JAX step) from one set of weights,
    both from a loss scale of 128, the forward in eval mode with dropout
    off (the two sides' random draws differ)."""
    hpj, hp, params, state, _ = build(f",fp16_run=True,use_custom_bptt={custom}")
    model = Tacotron2(pts.run_hparams(hp))
    model.load_state_dict(convert.from_jax_params(params, state, hp))
    forward = model.forward
    model.forward = lambda b, train, generator=None: forward(b, train=False,
                                                             prenet_dropout_enabled=False)
    scaler = pls.ScalerState(torch.tensor(128.0), torch.tensor(0, dtype=torch.int32))
    ts = pts.TrainState(model, pts.make_optimizer(model, hp), scaler=scaler)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jts.TrainState(jnp.zeros((), jnp.int32), jp,
                            jax.tree_util.tree_map(jnp.asarray, state),
                            jts.make_optimizer(hpj).init(jp),
                            jls.DynamicScalerState(jnp.float32(128.0), jnp.zeros((), jnp.int32)))
    return hp, state, params, ts, pts.make_train_step(hp), jstate, jts.make_train_step(hpj)


@pytest.mark.parametrize("custom", [True, False], ids=["custom_bptt", "autograd"])
def test_fp16_train_step_matches_jax(custom, monkeypatch):
    jax_forward = jts.tacotron2.forward

    def eval_forward(params, mstate, batch, hp, train, rng=None, **kw):
        return jax_forward(params, mstate, batch, hp, train=False, rng=rng,
                           prenet_dropout_enabled=False)

    monkeypatch.setattr(jts.tacotron2, "forward", eval_forward)
    hp, state, params, ts, step, jstate, jstep = _fp16_pair(custom)
    jstep = jax.jit(jstep)
    for i in range(3):
        batch = _batch(hp, seed=i)
        m = step(ts, _port_batch(batch))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        assert bool(m["updated"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=5e-4)
        assert float(m["loss_scale"]) == float(jm["loss_scale"]) == 128.0
        assert float(ts.scaler.scale) == float(jstate.scaler.scale)
        assert int(ts.scaler.iters_since_rescale) == int(jstate.scaler.iters_since_rescale)
    assert int(ts.scaler.iters_since_rescale) == 3  # the count grows after clean steps
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params), state, hp)
    init = convert.from_jax_params(params, state, hp)
    num = den = 0.0
    for name, p in ts.model.named_parameters():
        a, b, b0 = n(p), n(want[name]), n(init[name])
        num += float(((a - b) ** 2).sum())
        den += float(((b - b0) ** 2).sum())
    assert (num / den) ** 0.5 <= 0.05


def test_nan_batch_halves_the_scale_and_keeps_the_state():
    hp = create_hparams(TINY + ",fp16_run=True")
    ts = pts.create_train_state(hp, "cpu")
    ts.scaler = pls.ScalerState(torch.tensor(64.0), torch.tensor(0, dtype=torch.int32))
    step = pts.make_train_step(hp)
    gen = torch.Generator().manual_seed(0)
    m = step(ts, _loop_batch(hp), gen)
    assert bool(m["updated"]) and int(ts.scaler.iters_since_rescale) == 1
    assert ts.model.hp.compute_dtype == "float16"
    before = _state_snapshot(ts)
    bad = _loop_batch(hp, seed=1)
    bad["mel"][0, 0, 0] = float("nan")
    m = step(ts, bad, gen)
    assert not bool(m["updated"]) and float(m["loss_scale"]) == 64.0
    ref = jls.DynamicLossScaler().update(jls.DynamicScalerState(jnp.float32(64.0),
                                                                jnp.int32(1)), True)
    assert float(ts.scaler.scale) == float(ref.scale) == 32.0
    assert int(ts.scaler.iters_since_rescale) == int(ref.iters_since_rescale) == 0
    after = _state_snapshot(ts)
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)
    for i, s in before[2].items():
        for k, v in s.items():
            assert torch.equal(v, after[2][i][k]), k


@pytest.mark.parametrize("saved_fp16", [True, False], ids=["fp16_checkpoint", "pre_fp16"])
def test_scaler_checkpoint_round_trip(tmp_path, saved_fp16):
    """A checkpoint of an fp16 run restores its scaler; one saved without
    fp16_run, resumed with it, keeps the fresh scaler (JAX
    ``load_checkpoint``: "Pre-fp16 checkpoint resumed with fp16_run=True")."""
    hp16 = create_hparams(TINY + ",fp16_run=True")
    src = pts.create_train_state(hp16 if saved_fp16 else create_hparams(TINY), "cpu")
    if saved_fp16:
        src.scaler = pls.ScalerState(torch.tensor(512.0), torch.tensor(7, dtype=torch.int32))
    else:
        assert src.scaler is None
    path = save_checkpoint(src, 1e-3, str(tmp_path), iteration=5)
    dst = pts.create_train_state(hp16, "cpu", seed=9)
    dst, it, _ = load_checkpoint(path, dst)
    want = (512.0, 7) if saved_fp16 else (2.0 ** 32, 0)
    assert it == 5
    assert (float(dst.scaler.scale), int(dst.scaler.iters_since_rescale)) == want
    assert dst.scaler.scale.dtype == torch.float32
    assert dst.scaler.iters_since_rescale.dtype == torch.int32
    for a, b in zip(src.model.parameters(), dst.model.parameters()):
        assert torch.equal(a, b)


def test_train_cli_fp16_run_checkpoints_and_resumes(tmp_path, capsys):
    tmp = str(tmp_path)
    train_list = _write_corpus(tmp, 12, "train", 0)
    val_list = _write_corpus(tmp, 3, "val", 1)
    hparams = (TINY + f",training_files='{train_list}',validation_files='{val_list}'"
               ",batch_size=4,iters_per_checkpoint=2,text_bucket_size=8,mel_bucket_size=8"
               ",fp16_run=True")
    out = os.path.join(tmp, "out")
    tr.main(["-o", out, "-l", "logs", "--device", "cpu", "--hparams", hparams + ",epochs=1"])
    ckpt = os.path.join(out, "checkpoint_2")
    saved = torch.load(ckpt, weights_only=True)["scaler"]
    # from 2^32 the float16 gradients overflow, so the first steps skip
    assert float(saved[0]) < 2.0 ** 32
    tr.main(["-o", out, "-l", "logs", "--device", "cpu", "-c", ckpt,
             "--hparams", hparams + ",epochs=2"])
    text = capsys.readouterr().out
    assert "Train loss 0 non-finite; update skipped" in text
    assert "Validation loss 2:" in text and "Validation loss 4:" in text
    hp = create_hparams(hparams)
    resumed, _, _ = load_checkpoint(ckpt, pts.create_train_state(hp, "cpu"))
    assert float(resumed.scaler.scale) == float(saved[0])
    later = torch.load(os.path.join(out, "checkpoint_4"), weights_only=True)["scaler"]
    assert float(later[0]) <= float(saved[0])  # the resumed run went on from the saved scale
