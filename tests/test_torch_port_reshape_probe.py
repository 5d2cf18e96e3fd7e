"""Port: the twins of kernels K5/K6 against the JAX reshape probes.

``tools/reshape_probe.py`` calls ``pl.pallas_call`` without ``interpret``,
so on the CPU its probes would only report a compile failure.  The tests
load it under another module name and give it a ``pl`` whose
``pallas_call`` adds ``interpret=True``, records the output and, for the
random cases, hands the kernel other inputs than the probe built.  The JAX
file is not touched.

Tolerances: K5 copies and adds 1, so it matches exactly; K6 sums 128
products in another order, atol 1e-5.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from tacotron2_vae_torch.ops import reshape_probe as rp
from tacotron2_vae_torch.tools import reshape_probe as port_probe
from _torch_port_common import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_SHAPES = [(128, 128), (128, 32), (128, 256)]


class _InterpretPallas(types.SimpleNamespace):
    """``pl`` as the probes see it: every other name is the real module's."""

    def __init__(self, real):
        super().__init__(real=real, calls=[], inputs=None)

    def __getattr__(self, name):
        return getattr(self.real, name)

    def pallas_call(self, kernel, **kw):
        call = self.real.pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            args = self.inputs or args
            out = call(*args)
            self.calls.append(([np.array(a) for a in args], np.asarray(out)))
            return out

        return run


@pytest.fixture()
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "_jax_reshape_probe", os.path.join(ROOT, "tools", "reshape_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _InterpretPallas(mod.pl)
    sys.modules.pop("_jax_reshape_probe", None)
    return mod


@pytest.mark.parametrize("S,X", PROBE_SHAPES, ids=[f"S{s}_X{x}" for s, x in PROBE_SHAPES])
def test_reshape_twin_matches_jax_probe(jax_probe, capsys, S, X):
    assert jax_probe.probe_reshape(S, X) is True
    jax_line = capsys.readouterr().out
    (x,), want = jax_probe.pl.calls[-1]
    assert want.shape == (4 * S, X)
    got = rp.reshape_rows_plus_one(torch.from_numpy(x), S, X)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's probe prints the same line and returns the same bool
    assert port_probe.probe_reshape(S, X, device="cpu") is True
    assert capsys.readouterr().out == jax_line


def test_out_block_twin_matches_jax_probe(jax_probe, capsys):
    assert jax_probe.probe_out_block() is True
    jax_line = capsys.readouterr().out
    (x, w), want = jax_probe.pl.calls[-1]
    assert want.shape == (4, 512, 32)
    got = rp.out_block_matmul(torch.from_numpy(x), torch.from_numpy(w), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert port_probe.probe_out_block(device="cpu") is True
    assert capsys.readouterr().out == jax_line


def test_reshape_twin_random_input(jax_probe):
    S, X, B = 128, 32, 4
    x = np.random.RandomState(0).randn(B, S * X).astype(np.float32)
    jax_probe.pl.inputs = (x,)
    jax_probe.probe_reshape(S, X, B)  # the probe's own check fails on other inputs
    (_, want), = jax_probe.pl.calls
    got = rp.reshape_rows_plus_one(torch.from_numpy(x), S, X)
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_block_twin_random_input(jax_probe):
    rng = np.random.RandomState(1)
    # entries of x @ w of order 1, where atol 1e-5 is ~10 float32 ulps
    x = (0.3 * rng.randn(512, 128)).astype(np.float32)
    w = (0.3 * rng.randn(128, 32)).astype(np.float32)
    jax_probe.pl.inputs = (x, w)
    jax_probe.probe_out_block()
    (_, want), = jax_probe.pl.calls
    got = rp.out_block_matmul(torch.from_numpy(x), torch.from_numpy(w), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_probe_main_prints_the_jax_lines(jax_probe, capsys):
    assert port_probe.main(["--device", "cpu"]) is True
    port_lines = capsys.readouterr().out.splitlines()
    for S, X in PROBE_SHAPES:
        jax_probe.probe_reshape(S, X)
    jax_probe.probe_out_block()
    assert port_lines == ["device: cpu"] + capsys.readouterr().out.splitlines()


def test_wrappers_check_shapes_and_probes_need_a_card():
    with pytest.raises(ValueError):
        rp.reshape_rows_plus_one(torch.zeros(4, 100), 128, 32)
    with pytest.raises(ValueError):
        rp.out_block_matmul(torch.zeros(8, 16), torch.zeros(15, 4), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_probe.probe_reshape(128, 32)
        with pytest.raises(RuntimeError, match="CUDA"):
            port_probe.main([])
