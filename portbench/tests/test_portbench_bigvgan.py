"""The BigVGAN cell and the fixed-shape training cell on the CPU, at tiny
widths: they resolve, their runs are correct when sound and not correct
with a fault planted (the activation without its anti-aliasing, an
altered answer), the new readers read their records, and the counts hold
the published generator's figures."""

import copy
import time

import pytest

from portbench import control, control_bigvgan, core, serve_bigvgan, train_fixed
from portbench.counts import bigvgan as counts_bv
from portbench.tests._tiny import TINY_T2, tiny_spec

SEED = 2 ** 31 + 207
TINY_BV = {"upsample_rates": [16, 16], "upsample_kernel_sizes": [32, 32],
           "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]]}


def bigvgan_spec() -> dict:
    spec = copy.deepcopy(core.cell_spec("serve_bigvgan_saturated"))
    sizes = spec["config"]["sizes"]
    sizes["tacotron2"].update(TINY_T2, compute_dtype="float32")
    sizes["bigvgan"].update(TINY_BV)
    sizes["max_decoder_steps"] = 12
    return spec


def bigvgan_run(**kw):
    return serve_bigvgan.run(bigvgan_spec(), SEED, 2.0, False, time.perf_counter(),
                             device="cpu", log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", ["serve_bigvgan_saturated", "train_fixed_shapes"])
def test_new_cells_resolve(cell):
    spec = core.cell_spec(cell)
    assert spec["cell"]["chips"] == 1
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"] and all(m["moves"] in names for m in spec["per_layer"])
    for m in spec["per_layer"]:
        assert callable(core.load_reader(m["name"]))


def test_bigvgan_sound_is_correct():
    r = bigvgan_run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(serve_bigvgan.CHECKS)


@pytest.mark.parametrize("fault", [control_bigvgan.no_antialias, control.alter_answer],
                         ids=["no_antialias", "answer_altered"])
def test_bigvgan_fault_is_not_correct(fault):
    r = bigvgan_run(fault=fault)
    assert not r["correct"]
    assert r["checks"]["wav"]["value"] > r["checks"]["wav"]["limit"]


def test_train_fixed_is_correct_and_pads_to_one_shape(monkeypatch):
    from portbench import train

    shapes = []
    inner = train.warm_shapes
    monkeypatch.setattr(train, "warm_shapes",
                        lambda hp, s, device: shapes.extend(s) or inner(hp, s, device))
    spec = tiny_spec("train_corpus")
    spec["traffic"] = dict(core.cell_spec("train_fixed_shapes")["traffic"],
                           min_step_s=spec["traffic"]["min_step_s"])
    r = train_fixed.run(spec, SEED, 1.0, False, time.perf_counter(), device="cpu",
                        log=lambda m: None)
    assert r["correct"], r["checks"]
    assert len(set(shapes)) == 1


def test_readers_read_the_program_record():
    bv = core.load_json(core.ROOT + "/portbench/configs/t2vae-ko-bigvgan.json")
    spans = [{"name": "vocode.bigvgan", "start": 1.0 + i, "end": 1.05 + i, "device_ms": 40.0,
              "frames": 640} for i in range(4)]
    rec = {"program": {"spans": spans, "counters": {"bigvgan.audio_samples": 4 * 600 * 256}},
           "trace_span": (0.5, 2.5), "k9_kernel_s": 0.004, "sizes": bv, "window_s": 10.0,
           "completed": [{"S": 64, "frames": 600, "ref_frames": 0}], "mel_bucket": 64}
    read = {m: core.load_reader(m) for m in ("vocode_device_ms_per_audio_s.bigvgan",
                                             "aa_snake_roofline.bigvgan", "mfu.bigvgan")}
    assert read["vocode_device_ms_per_audio_s.bigvgan"](rec) == pytest.approx(160.0 / 38.4)
    assert read["aa_snake_roofline.bigvgan"](rec) == pytest.approx(
        100.0 * 2 * counts_bv.k9_bound_s(bv["bigvgan"], 640) / 0.004)
    assert 0 < read["mfu.bigvgan"](rec) < 100
    for reader in read.values():     # a program without the span or the counters
        assert reader({"program": {"spans": [], "counters": {}}, "sizes": bv}) is None


def test_checkpoint_is_drawn_in_the_reference_layout():
    """The cell's BigVGAN checkpoint has the names and shapes of the
    reference's ``layout`` (the published generator's, from the config
    alone), is the same for a seed, and its ``weight_g`` are row norms near
    ``ROW_NORM``'s scale."""
    from portbench.reference import bigvgan as ref_bv

    bv = dict(bigvgan_spec()["config"]["sizes"]["bigvgan"])
    a = serve_bigvgan.bigvgan_checkpoint(bv, SEED, "cpu")["generator"]
    b = serve_bigvgan.bigvgan_checkpoint(bv, SEED, "cpu")["generator"]
    assert {k: tuple(v.shape) for k, v in a.items()} == ref_bv.layout(bv)
    assert all(a[k].equal(b[k]) for k in a)
    g = a["ups.0.0.weight_g"]
    assert 0.5 < float(g.mean()) / serve_bigvgan.ROW_NORM["ups"] < 1.5


def test_counts_hold_the_published_figures():
    bv = core.load_json(core.ROOT + "/portbench/configs/t2vae-ko-bigvgan.json")["bigvgan"]
    assert len(counts_bv.k9_launches(bv, 640)) == 109
    assert counts_bv.conv_flops(bv, 62.5) == pytest.approx(112.7e9, rel=1e-3)
    assert sum(C * L for C, L in counts_bv.k9_launches(bv, 62.5)) == pytest.approx(38.4e6)
    assert counts_bv.k9_bound_s(bv, 640) == pytest.approx(8 * 38.4e6 * 10.24 / 3.35e12)
