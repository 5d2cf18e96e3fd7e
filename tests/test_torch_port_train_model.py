"""Port parity: the teacher-forced model and the loss.

``Tacotron2.forward(train=False)`` with the prenet's dropout off, the
Tacotron2-VAE loss, and the gradient of that loss for every parameter are
held against the JAX package's ``tacotron2.forward`` + ``tacotron2_vae_loss``
and ``jax.grad``, with ``use_custom_bptt`` on (the port's ``ScanCore`` twin)
and off (plain autograd), at r=1 and r=2, on one masked batch at tiny
widths in fp32.  Tolerance: outputs atol 1e-5; the loss rtol 1e-5; each
gradient max |port - JAX| <= 1e-4 * max |JAX| + 1e-6 (sum-order differences
of two fp32 backward passes).  The KL anneal schedules match JAX's: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import build, n, t
from tacotron2_vae_torch import convert
from tacotron2_vae_torch.training.loss import kl_anneal_weight, tacotron2_vae_loss
from tacotron2_vae_tpu.models import tacotron2 as jt2
from tacotron2_vae_tpu.training import loss as jloss


def _batch(hp, B=3, S=14, T=24, seed=0):
    rng = np.random.RandomState(seed)
    in_lens = np.array([S, S - 3, S - 6][:B], np.int32)
    out_lens = np.array([T, T - 5, T - 10][:B], np.int32)
    gate = (np.arange(T)[None, :] >= out_lens[:, None] - 1).astype(np.float32)
    emotions = np.eye(hp.n_emotions, dtype=np.float32)[rng.randint(0, hp.n_emotions, B)]
    return {"text": rng.randint(1, hp.n_symbols, (B, S)).astype(np.int32),
            "input_lengths": in_lens,
            "mel": (rng.randn(B, hp.n_mel_channels, T) * 0.5 - 2.0).astype(np.float32),
            "output_lengths": out_lens, "gate": gate, "emotions": emotions}


def _port_batch(batch):
    return {k: t(v).long() if k in ("text", "input_lengths", "output_lengths") else t(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("custom", [True, False], ids=["custom_bptt", "autograd"])
def test_forward_loss_and_grads_match_jax(custom, r):
    hpj, hp, params, state, model = build(f",use_custom_bptt={custom},n_frames_per_step={r}")
    model.requires_grad_(True)
    batch = _batch(hp)
    step = 7

    def jax_loss(p):
        out, _ = jt2.forward(p, state, {k: jnp.asarray(v) for k, v in batch.items()}, hpj,
                             train=False, rng=jax.random.PRNGKey(0),
                             prenet_dropout_enabled=False)
        total, _ = jloss.tacotron2_vae_loss(out, jnp.asarray(batch["mel"]),
                                            jnp.asarray(batch["gate"]), step, hpj)
        return total, out

    (j_total, j_out), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    out = model(_port_batch(batch), train=False, prenet_dropout_enabled=False)
    total, _ = tacotron2_vae_loss(out, t(batch["mel"]), t(batch["gate"]), step, hp)
    total.backward()

    for name in ("mel_outputs", "mel_outputs_postnet", "gate_outputs", "alignments", "mu",
                 "logvar", "z"):
        np.testing.assert_allclose(n(getattr(out, name)), np.asarray(getattr(j_out, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), state, hp)
    for name, p in model.named_parameters():
        got = n(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
        ref = n(want[name])
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-6, name


@pytest.mark.parametrize("fn", ["logistic", "linear", "constant"])
def test_kl_anneal_matches_jax(fn):
    for step in (0, 100, 10000, 60000):
        args = (fn, 50000, step, 0.0025, 10000, 0.2)
        np.testing.assert_allclose(float(kl_anneal_weight(*args)),
                                   float(jloss.kl_anneal_weight(*args)), rtol=1e-6)
