"""The plain references against the program's plain CPU versions at tiny
sizes, and the controls against the references."""

from __future__ import annotations

import pytest
import torch

from portbench import common
from portbench.reference import search as ref_search
from portbench.tests.tiny import tiny_cell

# At these sizes a float32 program step moves a table entry by about 1e-3
# and rounds it at about 1e-8 relative; the gaps of sound runs read
# 1e-8 to 1e-4 (table_gap, relative to the largest move, the most), so
# 1e-3 holds every sound run and no run that drops or misroutes updates.
TINY_TOL = 1e-3


def _driver(cell):
    return common.load_module(common.driver_path(cell.mix["driver"]),
                              "d_" + cell.mix["driver"])


@pytest.mark.parametrize("name", ["ml25m-sgd-sigmoid", "ml25m-als-linear"])
def test_training_reference_agrees_with_the_program(manifest, name):
    cell = tiny_cell(manifest, name)
    d = _driver(cell)
    checks = d.check(d.setup(cell))
    assert checks.rows and not checks.failures
    for n, row in checks.rows.items():
        assert row["value"] < TINY_TOL, (n, row)


@pytest.mark.parametrize("name", ["recipenlg-search-b256", "recipenlg-search-b1"])
def test_search_reference_agrees_with_the_program(manifest, name):
    cell = tiny_cell(manifest, name)
    d = _driver(cell)
    st = d.setup(cell)
    for j in range(cell.mix["check_calls"]):
        d.unit(st, j)
    checks = d.check(st)
    # exact f32 products against float64: a few ulps of scores near 1
    assert checks.rows["score_gap"]["value"] < 1e-5
    assert checks.rows["rank_gap"]["value"] < 1e-5
    assert checks.rows["order_faults"]["value"] == 0


def test_sgd_control_fails(manifest):
    """bfloat16 tables (the SGD control) read far above sound runs."""
    cell = tiny_cell(manifest, "ml25m-sgd-sigmoid")
    d = _driver(cell)
    st = d.setup(cell)
    sound = d.check(st)
    control = d.check(st, control=True)
    assert control.rows["table_gap"]["value"] > 100 * sound.rows["table_gap"]["value"]
    assert not control.correct


def test_search_reference_tie_rule():
    emb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.6, 0.8]])
    q = torch.tensor([[1.0, 0.0]])
    vals, idx = ref_search.search(emb, q, 3)
    assert idx.tolist() == [[0, 2, 3]]
    assert ref_search.topk_scores(emb, q, 3).tolist() == [[1.0, 1.0, pytest.approx(0.6)]]
    exact = ref_search.exact_scores(emb, q, torch.tensor([[3, 1]]))
    assert exact.tolist() == [[pytest.approx(0.6), 0.0]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ml25m-als-linear", "recipenlg-search-b256"])
def test_tf32_controls_fail_on_the_card(manifest, cuda_device, name):
    """TF32 exists only on the card: there the ALS and search controls
    read above their limits (at a small size; the cell's own size is in
    PERF.md)."""
    cell = tiny_cell(manifest, name, device=cuda_device)
    cell.config.update({"n_factors": 64} if name.startswith("ml25m") else
                       {"n_items": 200_000, "dim": 512})
    d = _driver(cell)
    st = d.setup(cell)
    for j in range(cell.mix.get("check_calls", 0)):
        d.unit(st, j)
    assert d.check(st).correct
    assert not d.check(st, control=True).correct
