"""What a run may load and where it may run: no JAX and no JAX package in
the process, no fallback to the CPU, no run without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench import common

TINY_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import common, run
from portbench.tests.tiny import tiny_cell
m = common.load_manifest()
for name in ("ml25m-sgd-sigmoid", "ml25m-als-linear", "recipenlg-search-b1"):
    out, _ = run.run_cell(m, name, 7, 0.1, False, device="cpu", cell=tiny_cell(m, name))
    assert out["correct"], name
print(json.dumps(run.forbidden_loaded()))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    res = subprocess.run([sys.executable, "-c", TINY_RUN.format(root=str(common.ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "matrix_factorization_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert "matrix_factorization_tpu_torch_x" not in run.forbidden_loaded()
    assert "jaxtyping" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "matrix_factorization_tpu.ops", sys)
    assert run.forbidden_loaded() == ["matrix_factorization_tpu.ops"]


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "recipenlg-search-b1",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _cli(common.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_the_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files holds
    no program: the run fails and prints no result."""
    shutil.copy(common.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(common.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
