"""Port parity: train-mode batchnorm and the train-mode modules.

``ops.layers.batchnorm(train=True)`` is held against the JAX package's
``layers.batchnorm(train=True)`` (one-pass statistics clamped at 0, momentum
0.1, unbiased running variance, output in the input's dtype): output and
running statistics atol 1e-5, in fp32 and for a bf16 input.  The encoder,
postnet and VAE-GST in train mode have no JAX counterpart with the same
dropout draws, so they are checked for what the port owns: batch
statistics (eval output differs, running buffers move), dropout drawn from
the generator (same seed, same output), and the reparameterised z.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import TINY, n
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_vae_torch.ops.layers import batchnorm
from tacotron2_vae_tpu.ops import layers as jl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 9, 6), (3, 5, 7, 6)], ids=["nwc", "nhwc"])
def test_batchnorm_train_matches_jax(shape, dtype):
    rng = np.random.RandomState(0)
    C = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.randn(C)).astype(np.float32), rng.randn(C).astype(np.float32)
    mean, var = (0.1 * rng.randn(C)).astype(np.float32), (1 + rng.rand(C)).astype(np.float32)
    bn = torch.nn.BatchNorm1d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y = batchnorm(torch.from_numpy(x).to(tdt), bn, train=True)
    jy, js = jl.batchnorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                          {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                          jnp.asarray(x).astype(jdt), train=True)
    assert y.dtype == tdt
    atol = 1e-5 if dtype == "float32" else 2 ** -7 * float(np.abs(np.asarray(jy, np.float32)).max())
    np.testing.assert_allclose(n(y), np.asarray(jy, np.float32), atol=atol, rtol=0)
    np.testing.assert_allclose(n(bn.running_mean), np.asarray(js["mean"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(bn.running_var), np.asarray(js["var"]), atol=1e-5, rtol=0)


def _model():
    hp = create_hparams(TINY)
    return hp, init_weights(Tacotron2(hp), torch.Generator().manual_seed(0))


def test_train_mode_modules_use_batch_stats_and_the_generator():
    hp, model = _model()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 11, hp.encoder_embedding_dim).astype(np.float32))
    lens = torch.tensor([11, 8])
    mel = torch.from_numpy((rng.randn(2, hp.n_mel_channels, 16) - 2).astype(np.float32))

    def run(module, *args, seed=5, **kw):
        return module(*args, train=True, generator=torch.Generator().manual_seed(seed), **kw)

    for module, args in ((model.encoder, (x, lens)), (model.postnet, (mel,)),
                         (model.vae_gst, (mel,))):
        running = [b.clone() for b in module.buffers()]
        with torch.no_grad():
            a, b, c = run(module, *args), run(module, *args), run(module, *args, seed=6)
            e = module(*args)
        a, b, c, e = (v[0] if isinstance(v, tuple) else v for v in (a, b, c, e))
        assert torch.equal(a, b)                                # same generator seed
        assert not torch.equal(a, c) and not torch.equal(a, e)  # other draws; eval mode
        moved = [not torch.equal(r, s) for r, s in zip(running, module.buffers())
                 if r.dtype.is_floating_point]
        assert moved and all(moved)


def test_vae_reparameterisation():
    hp, model = _model()
    mel = torch.from_numpy(
        (np.random.RandomState(1).randn(3, hp.n_mel_channels, 16) - 2).astype(np.float32))
    with torch.no_grad():
        style, mu, logvar, z = model.vae_gst(mel, train=True,
                                             generator=torch.Generator().manual_seed(2))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(z, mu + eps * torch.exp(0.5 * logvar))
    assert style.shape == (3, hp.E)
