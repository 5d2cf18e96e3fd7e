"""Shared setup of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Both sides get the same weights: the JAX package initialises them, and
``tacotron2_vae_torch.convert.from_jax_params`` moves them into the port's
modules.  Inputs are made with numpy from a seed and handed to both.
JAX is imported inside ``build`` only, so the tests of the kernels on the
card (``test_torch_port_cuda.py``) can use this module where JAX is absent.

Every ``tests/test_torch_*.py`` imports ``one_thread``, an autouse fixture:
its tests run on one intra-op thread, and the processes they start (CLI
children, torchrun ranks; ``child_env``) on one OpenMP / MKL thread, so
the suite's parallel workers do not oversubscribe the cores.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from tacotron2_vae_torch import convert
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.models.tacotron2 import Tacotron2

TINY = (
    "symbols_embedding_dim=64,encoder_embedding_dim=64,attention_rnn_dim=64,"
    "decoder_rnn_dim=64,prenet_dim=32,attention_dim=32,postnet_embedding_dim=64,"
    "E=64,ref_enc_gru_size=32,z_latent_dim=8,ref_enc_filters=[2,2,4,4,8,8],"
    "attention_location_n_filters=8,compute_dtype='float32'"
)


def build(extra: str = "", seed: int = 0):
    """(jax hparams, port hparams, jax params, jax state, port model), with
    non-trivial batchnorm statistics."""
    import jax

    from tacotron2_vae_tpu.config import create_hparams as jax_hparams
    from tacotron2_vae_tpu.models import tacotron2 as jax_tacotron2

    hpj = jax_hparams(TINY + extra)
    hp = create_hparams(TINY + extra)
    params, state = jax_tacotron2.init(jax.random.PRNGKey(seed), hpj)
    params, state = randomize_bn(*jax.tree_util.tree_map(np.asarray, (params, state)),
                                 seed=seed)
    model = Tacotron2(hp)
    model.load_state_dict(convert.from_jax_params(params, state, hp))
    return hpj, hp, params, state, model.eval().requires_grad_(False)


def randomize_bn(params, state, seed=0):
    """Non-trivial BN statistics, so eval-mode BN is exercised (in place)."""
    rng = np.random.RandomState(seed)
    for group in ("encoder", "postnet", "vae_gst"):
        for p, s in zip(params[group]["bns"], state[group]["bns"]):
            n = p["scale"].shape[0]
            p["scale"] = (1.0 + 0.1 * rng.randn(n)).astype(np.float32)
            p["bias"] = (0.1 * rng.randn(n)).astype(np.float32)
            s["mean"] = (0.1 * rng.randn(n)).astype(np.float32)
            s["var"] = (1.0 + 0.2 * rng.rand(n)).astype(np.float32)
    return params, state


def t(x):
    return torch.from_numpy(np.asarray(x))


def n(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) else np.asarray(x)


def log_mel_float64(wav, n_fft, hop=256, n_mels=80, sampling_rate=16000, fmin=0.0,
                    fmax=8000.0):
    """K2's function in float64 (numpy): reflect pad, periodic Hann window
    (win_length = n_fft), |rfft|, slaney mel product, log(max(x, 1e-5));
    (n_mels, len(wav) // hop + 1)."""
    from tacotron2_vae_torch.dsp.mel import mel_filterbank
    from tacotron2_vae_torch.dsp.stft import padded_window

    y = np.pad(np.asarray(wav, np.float64), n_fft // 2, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(y, n_fft)[::hop]
    mag = np.abs(np.fft.rfft(frames * padded_window(n_fft, n_fft), axis=1))
    fb = mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax).astype(np.float64)
    return np.log(np.maximum(mag @ fb.T, 1e-5)).T


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tests (the fastest at tiny
    widths), and ``ONE_THREAD_ENV`` for every process they start; both
    restored after the module."""
    n = torch.get_num_threads()
    saved = {k: os.environ.get(k) for k in ONE_THREAD_ENV}
    torch.set_num_threads(1)
    os.environ.update(ONE_THREAD_ENV)
    yield
    torch.set_num_threads(n)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def child_env(**extra) -> dict:
    """The environment of a process a port test starts: the checkout on
    ``PYTHONPATH``, ``ONE_THREAD_ENV``, and none of the parent's torchrun or
    XLA settings."""
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD_ENV, **extra)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    return env


def load_jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module of its own.  Some
    of those tools turn on JAX's persistent compilation cache (a directory
    in the checkout) when they are imported; the settings are restored, so
    nothing compiled in the tests is written there."""
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
    return mod
