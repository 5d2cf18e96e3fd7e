"""Port: WaveGlow (``tacotron2_vae_torch/models/waveglow.py``) against the
JAX package's ``models/waveglow.py``, and NVIDIA checkpoint conversion.

Both sides get the same weights: the JAX ``init`` on the tiny config of
tests/test_waveglow.py, then through ``convert.from_jax_waveglow``.  The
zero-initialised ``end`` makes every coupling the identity, which would hide
a wrong WaveNet, so ``end`` gets random weights (scale 0.05); the 1x1 mixing
matrices get noise too, so log|det W| is not ~0.  Inputs and z come from
numpy seeds (``jax.random`` and ``torch`` give other noise from one seed).

Tolerances: float32 forwards atol 1e-5, rtol 1e-4 (exp(log_s) compounds
over the flows); gradients atol 5e-5, rtol 1e-4 (ROADMAP.md); bf16: one
WaveNet conditioner matches to 1e-6 (both round at the same points, only
float32 sum order differs), and the whole inverse, where a rounding that
sum order flips feeds through the later flows, to one bf16 ulp of the
output's scale (2^-7 max|audio|).
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tacotron2_vae_torch import convert
from tacotron2_vae_torch.models import waveglow as twg
from tacotron2_vae_tpu.models import waveglow as jwg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from convert_torch_ckpt import convert_waveglow  # noqa: E402
from _torch_port_common import one_thread  # noqa: F401 (autouse)

CFG_J = jwg.WaveGlowConfig(n_mel_channels=80, n_flows=6, n_group=8, n_early_every=2,
                           n_early_size=2, n_layers=2, n_channels=16,
                           upsample_kernel=1024, upsample_stride=256)
CFG = twg.WaveGlowConfig(**CFG_J.__dict__)
F32 = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=1e-4)


def jax_params(seed=0):
    """JAX init with a random ``end`` and perturbed 1x1 matrices (numpy)."""
    p = jax.tree_util.tree_map(np.asarray, jwg.init(jax.random.PRNGKey(seed), CFG_J))
    rng = np.random.RandomState(100 + seed)
    for flow in p["flows"]:
        end = flow["wn"]["end"]
        end["w"] = (0.05 * rng.randn(*end["w"].shape)).astype(np.float32)
        end["b"] = (0.05 * rng.randn(*end["b"].shape)).astype(np.float32)
        w = flow["inv_conv"]["w"]
        flow["inv_conv"]["w"] = (w + 0.1 * rng.randn(*w.shape)).astype(np.float32)
    return p


def port_model(params, cfg=CFG):
    model = twg.WaveGlow(cfg)
    model.load_state_dict(convert.from_jax_waveglow(params))
    return model


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    frames = 17
    audio = (0.1 * rng.randn(2, frames * 256)).astype(np.float32)
    mel = rng.randn(2, 80, frames).astype(np.float32)
    z = rng.randn(2, frames * 32, 8).astype(np.float32)
    return audio, mel, z


def n(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def test_channel_schedule():
    for cfg_j in (CFG_J, jwg.WaveGlowConfig()):
        cfg = twg.WaveGlowConfig(**cfg_j.__dict__)
        assert cfg.audio_channels() == cfg_j.audio_channels()
        assert cfg.n_remaining_channels == cfg_j.n_remaining_channels
    assert twg.WaveGlowConfig() == twg.WaveGlowConfig(**jwg.WaveGlowConfig().__dict__)
    assert CFG.audio_channels() == [8, 8, 6, 6, 4, 4]


def test_module_tree_has_nvidia_names(params):
    keys = set(port_model(params).state_dict())
    for k in ("upsample.weight", "upsample.bias", "WN.0.start.weight", "WN.5.end.bias",
              "WN.3.cond_layer.weight", "WN.2.in_layers.1.weight",
              "WN.4.res_skip_layers.1.bias", "convinv.5.conv.weight"):
        assert k in keys, k
    assert "convinv.0.conv.bias" not in keys


def test_weight_bridge_round_trip(params):
    sd = convert.from_jax_waveglow(params)
    back = convert.to_jax_waveglow(sd)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat2, tree2 = jax.tree_util.tree_flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        np.testing.assert_array_equal(a, b)


def test_upsampler_matches_jax(params, data):
    mel = data[1]
    want = jwg._upsample_mel(params["upsample"], jnp.asarray(mel.transpose(0, 2, 1)), CFG_J)
    got = port_model(params).upsample_mel(torch.from_numpy(mel))
    assert got.shape == (2, 80, 17 * 256)
    np.testing.assert_allclose(n(got).transpose(0, 2, 1), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wn_matches_jax(params, dtype):
    rng = np.random.RandomState(1)
    x0 = rng.randn(2, 100, 4).astype(np.float32)
    cond = rng.randn(2, 100, 640).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    want = jwg._wn(params["flows"][1]["wn"], jnp.asarray(x0), jnp.asarray(cond), CFG_J,
                   dtype=jdt)
    model = port_model(params)
    tdt = None if dtype == "float32" else torch.bfloat16
    got = twg._wn(model.WN[1], torch.from_numpy(x0).transpose(1, 2),
                  torch.from_numpy(cond).transpose(1, 2), CFG, tdt)
    tol = F32 if dtype == "float32" else dict(atol=1e-6, rtol=0)
    for g, w in zip(got, want):  # (b, log_s)
        assert float(np.abs(np.asarray(w)).max()) > 1e-3  # end is not zero
        np.testing.assert_allclose(n(g).transpose(0, 2, 1), np.asarray(w), **tol)


def test_forward_matches_jax(params, data):
    audio, mel, _ = data
    zj, lsj, ldj = jwg.forward(params, jnp.asarray(audio), jnp.asarray(mel), CFG_J)
    zt, lst, ldt = port_model(params)(torch.from_numpy(audio), torch.from_numpy(mel))
    assert zt.shape == zj.shape == (2, 17 * 32, 8)
    np.testing.assert_allclose(n(zt), np.asarray(zj), **F32)
    assert len(lst) == len(ldt) == CFG.n_flows
    for g, w in zip(lst, lsj):
        np.testing.assert_allclose(n(g), np.asarray(w), **F32)
    for g, w in zip(ldt, ldj):
        assert abs(float(w)) > 1.0  # the perturbed W is not orthogonal
        np.testing.assert_allclose(float(n(g)), float(w), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inverse_matches_jax(params, data, dtype):
    _, mel, z = data
    cond = jwg._cond_from_mel(params, jnp.asarray(mel), CFG_J)
    want = np.asarray(jwg._unsqueeze_audio(jwg._inverse_impl(
        params, jnp.asarray(z), cond, CFG_J, None if dtype == "float32" else dtype)))
    got = port_model(params).inverse(torch.from_numpy(z), torch.from_numpy(mel),
                                     dtype=getattr(torch, dtype))
    assert got.shape == want.shape == (2, 17 * 256)
    if dtype == "float32":
        np.testing.assert_allclose(n(got), want, **F32)
        np.testing.assert_allclose(
            np.asarray(jwg.inverse(params, jnp.asarray(z), jnp.asarray(mel), CFG_J)), want,
            **F32)
    else:
        np.testing.assert_allclose(n(got), want, atol=2 ** -7 * np.abs(want).max(), rtol=0)


def test_forward_inverse_round_trip(params, data):
    audio, mel, _ = data
    model = port_model(params)
    with torch.no_grad():
        z, _, _ = model(torch.from_numpy(audio), torch.from_numpy(mel))
        back = model.inverse(z, torch.from_numpy(mel), w_inv=model.inverse_weights())
    np.testing.assert_allclose(n(back), audio, **F32)


def test_infer_shapes_and_finite(params):
    model = port_model(params)
    mel = torch.from_numpy(np.random.RandomState(0).randn(2, 80, 23).astype(np.float32))
    with torch.no_grad():
        audio = model.infer(mel, sigma=0.666, generator=torch.Generator().manual_seed(1))
        silent = model.infer(mel, sigma=0.0)
        zero = model.inverse(torch.zeros(2, 23 * 32, 8), mel)
    assert audio.shape == (2, 23 * 256) and bool(torch.isfinite(audio).all())
    torch.testing.assert_close(silent, zero, atol=0, rtol=0)
    assert not torch.equal(audio, silent)


def _jax_loss(p, audio, mel):
    z, log_s, log_det = jwg.forward(p, audio, mel, CFG_J)
    return jwg.waveglow_loss(z, log_s, log_det)


def test_loss_and_gradients_match_jax(params, data):
    audio, mel, _ = data
    loss_j, grads_j = jax.value_and_grad(_jax_loss)(params, jnp.asarray(audio),
                                                    jnp.asarray(mel))
    model = port_model(params)
    loss = twg.waveglow_loss(*model(torch.from_numpy(audio), torch.from_numpy(mel)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **F32)
    want = convert.from_jax_waveglow(jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for name, p in got.items():
        np.testing.assert_allclose(n(p.grad), want[name].numpy(), err_msg=name, **GRAD)


def test_train_steps_match_optax_and_lower_the_loss(params, data):
    audio, mel, _ = data
    opt_j = optax.adam(1e-3)
    step_j = jax.jit(jwg.make_waveglow_train_step(CFG_J, opt_j))
    pj, oj = params, opt_j.init(params)
    model = port_model(params)
    step = twg.make_waveglow_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3, fused=True))
    losses, losses_j = [], []
    for _ in range(5):
        out = step(torch.from_numpy(audio), torch.from_numpy(mel))
        assert bool(out["updated"]) and np.isfinite(float(out["grad_norm"]))
        losses.append(float(out["loss"]))
        oj, pj, lj = step_j(oj, pj, jnp.asarray(audio), jnp.asarray(mel))
        losses_j.append(float(lj))
    np.testing.assert_allclose(losses, losses_j, **F32)
    assert losses[-1] < losses[0], losses


def test_train_step_skips_a_non_finite_update(params, data):
    audio, mel, _ = data
    model = port_model(params)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, fused=True)
    step = twg.make_waveglow_train_step(model, opt)
    assert bool(step(torch.from_numpy(audio), torch.from_numpy(mel))["updated"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    adam = [{k: v.clone() for k, v in s.items()} for s in opt.state.values()]
    bad = audio.copy()
    bad[0, 5] = np.nan
    out = step(torch.from_numpy(bad), torch.from_numpy(mel))
    assert not bool(out["updated"]) and not np.isfinite(float(out["loss"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for s, saved in zip(opt.state.values(), adam):
        for k in saved:
            assert torch.equal(s[k], saved[k]), k
    assert all(p.grad is None for p in model.parameters())


# ------------------------------------------------ NVIDIA checkpoint conversion


def _wn_conv(rng, out, inn, k, norm=True):
    """A conv's parameters as NVIDIA glow.py pickles them (weight norm split)."""
    m = nn.Module()
    if norm:
        m.weight_g = nn.Parameter(torch.from_numpy(
            (0.5 + rng.rand(out, 1, 1)).astype(np.float32)))
        m.weight_v = nn.Parameter(torch.from_numpy(rng.randn(out, inn, k).astype(np.float32)))
    else:
        m.weight = nn.Parameter(torch.from_numpy(rng.randn(out, inn, k).astype(np.float32)))
    m.bias = nn.Parameter(torch.from_numpy(rng.randn(out).astype(np.float32)))
    return m


def _nvidia_model(cfg, glow):
    """A whole WaveGlow of NVIDIA glow.py's classes and parameter names."""
    rng = np.random.RandomState(5)
    model = glow.WaveGlow()
    up = nn.Module()
    up.weight = nn.Parameter(torch.from_numpy(
        0.05 * rng.randn(cfg.n_mel_channels, cfg.n_mel_channels, cfg.upsample_kernel)
        .astype(np.float32)))
    up.bias = nn.Parameter(torch.zeros(cfg.n_mel_channels))
    model.upsample = up
    model.WN, model.convinv = nn.ModuleList(), nn.ModuleList()
    nc = cfg.n_channels
    for c in cfg.audio_channels():
        wn = glow.WN()
        wn.start = _wn_conv(rng, nc, c // 2, 1)
        wn.end = _wn_conv(rng, c, nc, 1, norm=False)
        wn.cond_layer = _wn_conv(rng, 2 * nc * cfg.n_layers, cfg.n_mel_channels * cfg.n_group, 1)
        wn.in_layers = nn.ModuleList(_wn_conv(rng, 2 * nc, nc, cfg.kernel_size)
                                     for _ in range(cfg.n_layers))
        wn.res_skip_layers = nn.ModuleList(
            _wn_conv(rng, 2 * nc if i < cfg.n_layers - 1 else nc, nc, 1)
            for i in range(cfg.n_layers))
        model.WN.append(wn)
        inv = glow.Invertible1x1Conv()
        inv.conv = nn.Module()
        q = np.linalg.qr(rng.randn(c, c))[0]
        inv.conv.weight = nn.Parameter(torch.from_numpy(q[:, :, None].astype(np.float32)))
        model.convinv.append(inv)
    return model


@pytest.mark.parametrize("layout", ["state_dict", "pickled_model"])
def test_nvidia_checkpoint_converts_like_the_tool(tmp_path, layout):
    glow = types.ModuleType("glow")
    for cls in ("WaveGlow", "WN", "Invertible1x1Conv"):
        setattr(glow, cls, type(cls, (nn.Module,), {"__module__": "glow"}))
    path = str(tmp_path / "waveglow.pt")
    sys.modules["glow"] = glow
    try:
        model = _nvidia_model(CFG, glow)
        torch.save({"model": model, "iteration": 7} if layout == "pickled_model"
                   else {"state_dict": model.state_dict()}, path)
    finally:
        del sys.modules["glow"]  # loading must not need NVIDIA's module
    got = convert.from_reference_waveglow(path)
    assert "glow" not in sys.modules
    assert any(k.endswith("weight_v") for k in model.state_dict())
    want = convert.from_jax_waveglow(convert_waveglow(path, CFG_J))
    sys.modules.pop("glow", None)  # the tool leaves its stub behind
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    port = twg.WaveGlow(CFG)
    port.load_state_dict(got)
    mel = torch.from_numpy(np.random.RandomState(0).randn(1, 80, 3).astype(np.float32))
    with torch.no_grad():
        assert bool(torch.isfinite(port.infer(mel, 0.5, torch.Generator().manual_seed(0))).all())
