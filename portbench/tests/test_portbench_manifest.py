"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolving to its files."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import common, run
from portbench.tests.tiny import tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_shape(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert manifest["paths"] == ["portbench"]
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in manifest[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for w in manifest["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        mine = {m["name"] for m in common.end_to_end_for(manifest, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        assert common.per_layer_for(manifest, w["name"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert m["moves"] in {x["name"] for x in common.end_to_end_for(manifest, c)}
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_names_resolve_to_files(manifest):
    for c in manifest["configs"]:
        path = common.ROOT / c["file"]
        assert path == common.config_path(c["name"]) and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert len(c["source"]) <= 200
    for w in manifest["workloads"]:
        mix = json.loads(common.mix_path(w["traffic"]).read_text())
        assert common.driver_path(mix["driver"]).is_file()
        assert set(mix["limits"])
    for m in manifest["per_layer"]:
        reader = common.load_module(common.metric_path(m["name"]), "m_" + m["name"])
        assert callable(reader.read)


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_added_from_files_alone_runs(manifest, tmp_path, monkeypatch, trace):
    """A new configuration, mix and per-layer metric, each a file of its
    own, and their manifest entries make a cell; no file of the harness
    changes, and the tests cut the new configuration without an entry of
    its own."""
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(common.BENCH_DIR / sub, bench / sub)
    cfg = json.loads(common.config_path("recipenlg-dense-512").read_text())
    cfg.update(name="recipenlg-dense-64", dim=64)
    (bench / "configs" / "recipenlg-dense-64.json").write_text(json.dumps(cfg))
    mix = json.loads(common.mix_path("batch-b256-k100").read_text())
    mix.update(batch=4, k=5)
    (bench / "traffic" / "batch-b4-k5.json").write_text(json.dumps(mix))
    # a reader of its own: the traced calls' score products, by host
    # operator calls, and the cell's batch
    (bench / "metrics" / "products_per_query.py").write_text(
        "def read(t, cell):\n"
        "    n = t.host_calls.get('aten::mm', 0)\n"
        "    return n / (t.work['calls'] * cell.mix['batch']) if n else None\n")
    added = json.loads(json.dumps(manifest))
    added["configs"].append({"name": "recipenlg-dense-64", "source": cfg["source"],
                             "file": "portbench/configs/recipenlg-dense-64.json",
                             "reduced": ["dim"], "why": "a test configuration"})
    added["workloads"].append({"name": "recipenlg-search-b4", "config": "recipenlg-dense-64",
                               "traffic": "batch-b4-k5", "chips": 1, "why": "a test cell"})
    for m in added["end_to_end"] + added["per_layer"]:
        if "recipenlg-search-b256" in m.get("workloads", ()):
            m["workloads"].append("recipenlg-search-b4")
    added["per_layer"].append({"name": "products_per_query", "unit": "1/query",
                               "better": "lower", "source": "device_trace",
                               "layer": "retrieval GEMM", "moves": "search_queries_per_s",
                               "workloads": ["recipenlg-search-b4"]})
    monkeypatch.setattr(common, "BENCH_DIR", bench)
    cell = tiny_cell(added, "recipenlg-search-b4")
    # the generic cut
    assert (cell.config["n_items"], cell.config["dim"]) == (200, 32)
    assert (cell.mix["k"], cell.mix["batch"], cell.mix["pool_calls"]) == (5, 4, 16)
    out, checks = run.run_cell(added, "recipenlg-search-b4", 5, 0.2, trace,
                               device="cpu", cell=cell)
    assert out["correct"], checks.lines()
    if trace:
        # one score product a call of 4 queries
        assert out["metrics"]["products_per_query"]["value"] == pytest.approx(0.25)
    else:
        assert set(out["metrics"]) == {"search_queries_per_s", "search_p95_ms", "setup_s"}


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_sub_seeds_take_any_whole_number(seed):
    a, b = common.sub_seed(seed, 1), common.sub_seed(seed, 2)
    assert a != b and 0 <= a < 2**63 and common.sub_seed(seed, 1) == a
