"""Port parity: ``tools/smoke_train.py`` against the JAX package's tool.

The synthetic batches are the JAX tool's bit for bit (one numpy stream
from ``RandomState(0)``), at r=1 and r=2 (T padded to a multiple of r with
gate 1) and with and without the emotion tilt; the diagonality metric is
equal on random alignments.  The eval-mode forward that the tool reads its
alignments from matches JAX ``tacotron2.forward(train=False)`` on the same
weights within atol 1e-5 (float32, prenet dropout off on both sides: the
two frameworks draw dropout from different streams).  The CLI at tiny
width on the CPU prints the JAX tool's summary keys, with a finite loss
that falls.
"""

import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, TINY, build, load_jax_tool
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.config import create_hparams as jax_hparams
from tacotron2_vae_tpu.models import tacotron2 as jax_tacotron2
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.tools import smoke_train
from tacotron2_vae_torch.training.train_state import batch_to_device


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("smoke_train")


@pytest.mark.parametrize("tilt", [0.0, 0.7], ids=["plain", "tilt"])
@pytest.mark.parametrize("r", [1, 2])
def test_synth_batch_is_the_jax_tools(jax_tool, r, tilt):
    # two batches from one stream: the stream's position carries over
    extra = f"n_frames_per_step={r}"
    want_rng, got_rng = np.random.RandomState(0), np.random.RandomState(0)
    for S in (7, 9):
        want = jax_tool.synth_batch(want_rng, jax_hparams(extra), 3, S, emotion_tilt=tilt)
        got = smoke_train.synth_batch(got_rng, create_hparams(extra), 3, S, emotion_tilt=tilt)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_synth_batch_pads_to_a_multiple_of_r(jax_tool):
    hp = create_hparams("n_frames_per_step=3")
    got = smoke_train.synth_batch(np.random.RandomState(0), hp, 2, 5)
    want = jax_tool.synth_batch(np.random.RandomState(0), jax_hparams("n_frames_per_step=3"),
                                2, 5)
    assert got["mel"].shape[2] == 21 and got["gate"][:, 19:].all() and not got["gate"][:, :19].any()
    np.testing.assert_array_equal(got["mel"], np.asarray(want["mel"]))


@pytest.mark.parametrize("r", [1, 2, 3])
def test_alignment_diagonality_is_the_jax_tools(jax_tool, r):
    align = np.random.RandomState(r).dirichlet(np.ones(11), size=(4, 30)).astype(np.float32)
    got = smoke_train.alignment_diagonality(align, 4, r)
    assert got == jax_tool.alignment_diagonality(align, 4, r)
    eye = np.zeros((1, 40, 10), np.float32)
    eye[0, np.arange(40), np.minimum(np.arange(40) * r // 4, 9)] = 1.0
    assert smoke_train.alignment_diagonality(eye, 4, r) == 1.0


@pytest.mark.parametrize("r", [1, 2])
def test_eval_alignments_match_jax_forward(r):
    hpj, hp, params, state, model = build(f",n_frames_per_step={r},anneal_function='constant'")
    batch = smoke_train.synth_batch(np.random.RandomState(3), hp, 3, 9)
    want, _ = jax_tacotron2.forward(params, state, {k: jnp.asarray(v) for k, v in batch.items()},
                                    hpj, train=False, rng=jax.random.PRNGKey(1),
                                    prenet_dropout_enabled=False)
    got = smoke_train.eval_alignments(functools.partial(model, prenet_dropout_enabled=False),
                                      batch_to_device(batch, "cpu"), torch.Generator())
    assert got.shape == (3, 36 // r, 9)
    np.testing.assert_allclose(got, np.asarray(want.alignments), atol=1e-5, rtol=0)
    assert smoke_train.alignment_diagonality(got, 4, r) == pytest.approx(
        smoke_train.alignment_diagonality(np.asarray(want.alignments), 4, r), abs=1e-5)


def _jax_summary_keys():
    """The keys of the summary dict the JAX tool prints (from its source)."""
    with open(os.path.join(ROOT, "tools", "smoke_train.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "summary"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in the JAX tool")


def test_cli_prints_the_jax_summary_and_the_loss_falls(capsys):
    summary = smoke_train.main(["--steps", "50", "--batch", "2", "--seq", "8",
                                "--hparams", TINY, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:2] == [f"step 25: loss {summary['loss_first25']:.4f}",
                         f"step 50: loss {summary['loss_final']:.4f}"]
    printed = json.loads(lines[-1])
    assert printed == summary
    assert list(printed) == _jax_summary_keys()
    assert np.isfinite(printed["loss_first25"]) and np.isfinite(printed["loss_final"])
    assert printed["loss_ratio"] < 1.0
    assert 0.0 < printed["alignment_diagonality"] <= 1.0
    assert (printed["steps"], printed["batch"]) == (50, 2)


def test_cli_wants_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke_train.main(["--steps", "1", "--hparams", TINY])
