"""BENCHMARK.json and the benchmark's files: they parse, names resolve,
the manifest keeps the benchmark's contract, and a cell can be added by
new files and entries alone."""

import json
import os
import re
import shutil

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", ["train_corpus", "serve_open", "serve_saturated",
                                  "serve_single"])
def test_cell_resolves(cell):
    spec = core.cell_spec(cell)
    assert spec["cell"]["chips"] == 1
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in names
        assert os.path.exists(os.path.join(core.BENCH_DIR, "metrics", m["name"] + ".py"))
        assert callable(core.load_reader(m["name"]))
    assert os.path.exists(os.path.join(core.BENCH_DIR, spec["traffic"]["runner"] + ".py"))


def test_configs_files(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        sizes = core.load_json(os.path.join(core.ROOT, c["file"]))
        assert sizes["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size")), k


def test_dummy_cell_by_new_files_alone(tmp_path, bench):
    """A new cell, traffic mix (a new arrival pattern: bursts) and per-layer
    metric added as files and entries only, in a copy: the harness finds
    each by name and the one generator reads the new mix."""
    from portbench import serve

    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "serve_dummy", "config": "t2vae-ko-waveglow",
                           "traffic": "dummy", "chips": 1, "why": "a test cell"})
    b["end_to_end"][0]["workloads"].append("serve_dummy")
    b["per_layer"].append({"name": "dummy_rows.serve", "unit": "rows", "better": "higher",
                           "source": "program_span", "layer": "a test layer",
                           "moves": b["end_to_end"][0]["name"], "workloads": ["serve_dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = core.load_json(os.path.join(core.BENCH_DIR, "traffic", "single.json"))
    traffic["arrivals"] = {"loop": "open", "rate_per_s": 3.0, "on_s": 1.0, "off_s": 2.0}
    (root / "portbench" / "traffic" / "dummy.json").write_text(json.dumps(traffic))
    (root / "portbench" / "metrics" / "dummy_rows.serve.py").write_text(
        "def read(rec):\n    return rec.get('dummy')\n")
    spec = core.cell_spec("serve_dummy", root=str(root), bench_dir=str(root / "portbench"))
    assert spec["traffic"]["arrivals"]["on_s"] == 1.0
    pool = [(f"text {i}", 8) for i in range(100)]
    reqs = serve.make_requests(spec["traffic"], pool, ["r.wav"], 11, 12.0)
    assert len(reqs) == 36 and all(r["due"] % 3.0 < 1.0 for r in reqs)
    assert [m["name"] for m in spec["per_layer"]] == ["dummy_rows.serve"]
    assert core.per_layer_metrics(spec, {"dummy": 3.0}) == {
        "dummy_rows.serve": {"value": 3.0, "unit": "rows"}}
    # a metric declared for the cell that finds nothing fails the run
    with pytest.raises(RuntimeError, match="dummy_rows.serve"):
        core.per_layer_metrics(spec, {})
    # one that the cell reports only through its end-to-end metric is left out
    del b["per_layer"][-1]["workloads"]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = core.cell_spec("serve_dummy", root=str(root), bench_dir=str(root / "portbench"))
    assert core.per_layer_metrics(spec, {}) == {}
