"""The check sees a broken timed path: a run of each cell at tiny widths on
the CPU (the harness's look for a card skipped), sound and with each
fault the cell can have planted under it, must come out correct and not
correct.  The cells run one chip, so no exchange between chips can be
left out."""

import time

import pytest

from portbench import control, serve, train
from portbench.tests._tiny import tiny_spec

SEED = 2 ** 31 + 101


def serve_run(**kw):
    return serve.run(tiny_spec("serve_single"), SEED, 2.0, False, time.perf_counter(),
                     device="cpu", log=lambda m: None, **kw)


def train_run(**kw):
    return train.run(tiny_spec("train_corpus"), SEED, 1.0, False, time.perf_counter(),
                     device="cpu", log=lambda m: None, **kw)


def test_serve_sound_is_correct():
    r = serve_run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_serve_altered_answer_is_not_correct():
    r = serve_run(fault=control.alter_answer)
    assert not r["correct"]
    assert r["checks"]["wav"]["value"] > r["checks"]["wav"]["limit"]


def test_train_sound_is_correct():
    r = train_run()
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [control.state_unchanged, control.half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(fault):
    r = train_run(fault=fault)
    assert not r["correct"], r["checks"]
