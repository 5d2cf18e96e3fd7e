"""The controls on the card: the reference one precision step below the
configuration's (float8 for bfloat16; the program's own bfloat16 vocoder
for its float32 one) in the program's place fails a number of every
cell, at the cell's own size.  Needs a card; runs on the chip with

    python3 -m pytest -q -m cuda portbench/tests/test_portbench_control.py
"""

import pytest

from portbench import control, core

CASES = [("serve_saturated", "control_fp8"), ("serve_saturated", "control_vocoder_bf16"),
         ("train_corpus", "control_fp8")]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", CASES)
def test_control_is_not_correct(card, cell, variant):
    import importlib

    spec = core.cell_spec(cell)
    mod = importlib.import_module("portbench." + spec["traffic"]["runner"])
    kw = control.variants(spec["traffic"]["runner"])[variant]
    r = control.run_variant(spec, mod, variant, kw, 2 ** 31 + 7, 8.0)
    assert not r["correct"], r
