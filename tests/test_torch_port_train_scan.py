"""Port parity: the teacher-forced recurrence (``ScanCore``, K3/K4's twins).

The port's ``models.decoder_bptt.ScanCore`` on CPU tensors runs the plain
twins of kernels K3 and K4 (``ops.teacher_fwd``); here it is held against
the JAX package's ``decoder_bptt`` at the sizes of ``tests/test_bptt.py``
(B=2 with one masked row, S=9, T=11, H=16, E=24, P=8, A=12, F=4, K=7), with
the recurrent-dropout masks on and off, the same masks on both sides:

- forward ys and residuals against ``_fwd_impl`` and against the Pallas
  forward kernel run by the interpreter: atol 2e-5;
- gradients against ``scan_core`` with the Pallas backward kernel
  (interpreter): atol 1e-4, rtol 2e-4 (test_bptt.py:308-310);
- gradients against autodiff of ``_fwd_impl``: atol 5e-5, rtol 1e-4;
- in bf16 against autodiff of the bf16 ``_fwd_impl``: max error 5e-2 of
  the largest gradient (test_bptt.py:205-206; the two sides round the
  residual streams at the same points, the sums in another order);
- ``loc_conv_weight_grad`` against torch autograd: atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_vae_tpu.models import decoder_bptt as jb
from tacotron2_vae_torch.models import decoder_bptt as bp
from tacotron2_vae_torch.ops import teacher_fwd as tf
from _torch_port_common import one_thread  # noqa: F401 (autouse)

B, S, T, K = 2, 9, 11, 7
P, H, E, A, F = 8, 16, 24, 12, 4
KEYS = ("attn_w", "attn_b", "dec_w", "dec_b", "query_w", "loc_w", "loc_dense_w", "v_w")


def _setup(masked_dropout, dtype=np.float32):
    rng = np.random.RandomState(0)

    def r(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)

    params = {"attn_w": r(P + E + H, 4 * H), "attn_b": r(4 * H), "dec_w": r(H + E + H, 4 * H),
              "dec_b": r(4 * H), "query_w": r(H, A), "loc_w": r(K, 2, F),
              "loc_dense_w": r(F, A), "v_w": r(A, 1)}
    prenet_seq, memory, pmem = r(T, B, P), r(B, S, E), r(B, S, A)
    valid = np.arange(S)[None, :] < np.array([S, S - 3])[:, None]
    add_mask = np.where(valid, 0.0, np.finfo(np.float32).min).astype(np.float32)
    masks = None
    if masked_dropout:
        km = jax.random.split(jax.random.PRNGKey(3), 4)
        masks = tuple(np.asarray(jb._dropout_mask(km[i], (T, B, H), 0.9, dtype))
                      for i in range(4))
    return params, prenet_seq, memory, pmem, add_mask, masks


def _jax_masks(masks):
    if masks is None:
        ones = jnp.ones((T, 1, 1), jnp.float32)
        return (ones,) * 4
    return tuple(jnp.asarray(m) for m in masks)


def _cfg(train, dtype="float32", **kw):
    return jb.ScanConfig(0.9, 0.9, train, compute_dtype=dtype, **kw)


def _jax_loss(core):
    def loss(params, prenet_seq, memory, pmem):
        h, c, w = core(params, prenet_seq, memory, pmem)
        return jnp.sum(h ** 2) + jnp.sum(c * 0.5) + jnp.sum(w ** 3)
    return loss


def _port_grads(params, prenet_seq, memory, pmem, add_mask, masks, dtype=torch.float32):
    """(loss, grads in the JAX argument order) through ``ScanCore``."""
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xs = [torch.tensor(x, requires_grad=True) for x in (prenet_seq, memory, pmem)]
    tmasks = (None,) * 4 if masks is None else tuple(
        torch.from_numpy(np.asarray(m, np.float32)).to(dtype) for m in masks)
    h, c, w = bp.ScanCore.apply(*(leaves[k] for k in KEYS[:-1]), leaves["v_w"][:, 0], *xs,
                                torch.from_numpy(add_mask), *tmasks, dtype)
    loss = (h ** 2).sum() + (c * 0.5).sum() + (w ** 3).sum()
    loss.backward()
    grads = {k: leaves[k].grad.numpy() for k in KEYS}
    return float(loss.detach()), grads, [x.grad.numpy() for x in xs]


def _jax_grads(cfg, params, prenet_seq, memory, pmem, add_mask, masks, use_core=True):
    jm = _jax_masks(masks)
    add = jnp.asarray(add_mask)
    if use_core:
        core = lambda *a: jb.scan_core(*a, add, jm, cfg)  # noqa: E731
    else:
        core = lambda *a: jb._fwd_impl(*a, add, jm, cfg)[0]  # noqa: E731
    args = ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(prenet_seq),
            jnp.asarray(memory), jnp.asarray(pmem))
    val, (gp, *gx) = jax.value_and_grad(_jax_loss(core), argnums=(0, 1, 2, 3))(*args)
    return float(val), {k: np.asarray(v) for k, v in gp.items()}, [np.asarray(g) for g in gx]


def _compare(port, ref, **tol):
    (lp, gp, xp), (lr, gr, xr) = port, ref
    np.testing.assert_allclose(lp, lr, rtol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(gp[k], gr[k], err_msg=k, **tol)
    for name, a, b in zip(("prenet_seq", "memory", "pmem"), xp, xr):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("dropout", [False, True], ids=["masks_off", "masks_on"])
def test_forward_matches_jax_and_pallas(dropout):
    params, pn, mem, pm, add, masks = _setup(dropout)
    w = tf.pack({**{k: torch.from_numpy(v) for k, v in params.items() if k != "v_w"},
                 "v": torch.from_numpy(params["v_w"])}, torch.float32)
    tmasks = None if masks is None else tuple(torch.tensor(m) for m in masks)
    ys, resids = tf.teacher_fwd(w, *(torch.from_numpy(x) for x in (pn, mem, pm, add)), tmasks)
    jargs = ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pn), jnp.asarray(mem),
             jnp.asarray(pm), jnp.asarray(add), _jax_masks(masks))
    ys_x, res_x = jb._fwd_impl(*jargs, _cfg(dropout))
    ys_p, saved = jb._fwd_rule(*jargs, _cfg(dropout, use_pallas_fwd=True, pallas_interpret=True))
    for ref_ys, ref_res in ((ys_x, res_x), (ys_p, saved[-1])):
        for a, b in zip((*ys, *resids), (*ref_ys, *ref_res[:5])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dropout", [False, True], ids=["masks_off", "masks_on"])
def test_grads_match_jax_pallas_backward(dropout):
    data = _setup(dropout)
    ref = _jax_grads(_cfg(dropout, use_pallas_bwd=True, pallas_interpret=True), *data)
    _compare(_port_grads(*data), ref, atol=1e-4, rtol=2e-4)


@pytest.mark.parametrize("dropout", [False, True], ids=["masks_off", "masks_on"])
def test_grads_match_jax_autodiff(dropout):
    data = _setup(dropout)
    ref = _jax_grads(_cfg(dropout), *data, use_core=False)
    _compare(_port_grads(*data), ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("dropout", [False, True], ids=["masks_off", "masks_on"])
def test_grads_bf16_match_jax_autodiff(dropout):
    data = _setup(dropout, dtype=jnp.bfloat16)
    lp, gp, xp = _port_grads(*data, dtype=torch.bfloat16)
    lr, gr, xr = _jax_grads(_cfg(dropout, "bfloat16"), *data, use_core=False)
    assert abs(lp - lr) <= 1e-2 * abs(lr)
    for a, b in list(zip((gp[k] for k in KEYS), (gr[k] for k in KEYS))) + list(zip(xp, xr)):
        assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-3) < 5e-2


def test_loc_conv_weight_grad_matches_autograd():
    rng = np.random.RandomState(0)
    N, S_, F_, K_ = 6, 12, 3, 5
    w_prev, w_cum = (torch.from_numpy(rng.randn(N, S_).astype(np.float32)) for _ in range(2))
    dloc = torch.from_numpy(rng.randn(N, S_, F_).astype(np.float32))
    loc_w = torch.from_numpy(rng.randn(K_, 2, F_).astype(np.float32)).requires_grad_()
    (tf.loc_conv(w_prev, w_cum, loc_w) * dloc).sum().backward()
    got = bp.loc_conv_weight_grad(w_prev, w_cum, dloc, K_)
    np.testing.assert_allclose(got.numpy(), loc_w.grad.numpy(), atol=1e-4, rtol=0)
