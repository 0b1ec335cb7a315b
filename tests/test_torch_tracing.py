"""The port's program spans (``utils/profiling.py::span``): recorded in the
``torch.profiler`` trace exactly when a profiler records, named and nested
as the module docstring lists them, at the counts the work implies, and
without changing a result."""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import ials, scoring, spd
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.retrieval import search
from matrix_factorization_tpu_torch.retrieval.index import DenseItemIndex
from matrix_factorization_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "matrix_factorization_tpu_torch"
N_USERS, N_ITEMS = 40, 30
# d = 131 > cuda_spd.MAX_D: the Schur block solve, with two Gauss-Jordan leaves
ALS_FACTORS = 130
K = 5  # the search's cut
ROWS = 4  # query rows a search block


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ratings(n=600, seed=0):
    rng = np.random.default_rng(seed)
    pairs = rng.choice(N_USERS * N_ITEMS, size=n, replace=False)
    u, i = (pairs // N_ITEMS).astype(np.int32), (pairs % N_ITEMS).astype(np.int32)
    return u, i, rng.uniform(1, 5, n).astype(np.float32)


def _sgd(epochs=1):
    cfg = SGDConfig(kernel="sigmoid", n_factors=8, lr=0.05, reg=0.02,
                    min_rating=1.0, max_rating=5.0, batch_size=128)
    data = sgd.pack_ratings(*_ratings(), 128, device="cpu")
    p0 = sgd.init_params(torch.Generator().manual_seed(0), N_USERS, N_ITEMS,
                         cfg, 3.0)
    p, hist = sgd.sgd_train(p0, data, torch.Generator().manual_seed(1), cfg,
                            epochs, 0.05)
    return (p.user_features, p.item_features, hist), data.n_batches


def _als():
    u, i, r = _ratings(seed=1)
    cfg = SGDConfig(kernel="linear", n_factors=ALS_FACTORS, reg=0.1)
    bu, bi = ials.group_both_sides_bucketed(u, i, r, N_USERS, N_ITEMS,
                                            max_block_rows=200, device="cpu")
    p0 = sgd.init_params(torch.Generator().manual_seed(2), N_USERS, N_ITEMS,
                         cfg, 3.0)
    data = sgd.pack_ratings(u, i, r, 128, device="cpu")
    p, hist = ials.ials_train_bucketed(p0, bu, bi, data, cfg, 1,
                                       reg_scale="per_obs")
    return p.user_features, p.item_features, hist


def _index():
    """30 identical rows along the first axis, scoring 1 for a tie query,
    and 470 random rows orthogonal to it."""
    rng = np.random.default_rng(3)
    emb = np.zeros((500, 16), np.float32)
    emb[:30, 0] = 1.0
    emb[30:, 1:] = rng.normal(size=(470, 15))
    emb[30:] /= np.linalg.norm(emb[30:], axis=1, keepdims=True)
    return DenseItemIndex(item_ids=[f"r{j}" for j in range(500)], texts=[],
                          embeddings=emb)


def _queries(tie_blocks):
    """Three blocks of ``ROWS`` queries; a block in ``tie_blocks`` holds one
    query whose k-th score lies among the 30 tied rows, the others score
    those rows at -1, below any cut."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3 * ROWS, 16)).astype(np.float32) * 0.1
    q[:, 0] = -1.0
    for b in tie_blocks:
        q[b * ROWS + 1, 0] = 1.0
    return q


@pytest.fixture
def small_blocks(monkeypatch):
    """``dense_topk`` in blocks of ``ROWS`` queries, and the selection body
    (``topk.select``) for those blocks, as at the service's scale."""
    monkeypatch.setattr(search, "_TOPK_ELEMS", ROWS * 500)
    monkeypatch.setattr(scoring, "SORT_MAX_SCORES", 500)


def _search(tie_blocks=(0, 2)):
    index = _index()
    vals, pos = search.search_topk_batch(index, _queries(tie_blocks), K,
                                         device="cpu")
    one = search.search_topk(index, _queries(())[0], K, device="cpu")
    return vals, pos, one


def _all_four():
    return _sgd()[0], _als(), _search()


def _spans(trace_dir):
    """The ``mf:`` spans of the one Chrome trace in ``trace_dir``: (name,
    start, end), by start."""
    (f,) = list(Path(trace_dir).glob("trace_*.json"))
    events = json.loads(f.read_text())["traceEvents"]
    return sorted((e["name"][3:], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("name", "").startswith("mf:"))


def _ancestors(spans, child):
    """The names of the spans that hold ``child``, innermost first."""
    _, a, b = child
    holders = [s for s in spans if s is not child and s[1] <= a and b <= s[2]]
    return [s[0] for s in sorted(holders, key=lambda s: s[2] - s[1])]


def _traced(fn, tmp_path):
    with profiling.trace(str(tmp_path)):
        out = fn()
    return out, _spans(tmp_path)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_no_profiler_no_span(monkeypatch, small_blocks):
    def refuse(*a, **k):
        raise AssertionError("a span reached the profiler with none recording")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("sgd.step") is profiling.span("topk.ties")
    _all_four()


def test_spans_named_and_nested(tmp_path, small_blocks):
    _, spans = _traced(_all_four, tmp_path)
    names = {s[0] for s in spans}
    assert names == {"sgd.epoch", "sgd.step", "sgd.apply", "sgd.rmse",
                     "als.epoch", "als.bucket", "als.normal_eq", "als.write",
                     "spd.solve", "spd.split", "spd.schur", "spd.leaf",
                     "spd.backsolve", "search.query",
                     "search.gemm", "search.fetch", "search.answer",
                     "topk.sort", "topk.select", "topk.sync", "topk.ties"}
    parents = {}
    for s in spans:
        up = _ancestors(spans, s)
        parents.setdefault(s[0], set()).add(up[0] if up else None)
        if s[0] == "spd.leaf":
            assert "als.bucket" in up
    assert parents["sgd.epoch"] == {None}
    assert parents["sgd.step"] == parents["sgd.apply"] == {"sgd.epoch"}
    assert parents["sgd.rmse"] == {"sgd.epoch", "als.epoch"}
    assert parents["als.bucket"] == {"als.epoch"}
    assert parents["als.normal_eq"] == parents["als.write"] == {"als.bucket"}
    assert parents["spd.solve"] == {"als.bucket"}
    assert parents["spd.split"] == parents["spd.schur"] == {"spd.solve"}
    assert parents["spd.leaf"] == parents["spd.backsolve"] == {"spd.solve"}
    assert parents["search.query"] == parents["search.gemm"] == {None}
    assert parents["topk.select"] == parents["topk.sort"] == {None}
    assert parents["topk.sync"] == parents["topk.ties"] == {"topk.select"}
    assert parents["search.fetch"] == parents["search.answer"] == {None}


def _spd_system(d, seed=6):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(2, d + 40, d, generator=g)
    A = X.transpose(1, 2) @ X + d * torch.eye(d)
    return A, torch.randn(2, d, generator=g)


@pytest.mark.parametrize("case,outer", [
    ("spd_inverse_d300", None),
    ("spd_inverse_scaled_d300", None),
    ("spd_solve_d300", "spd.solve"),
    ("spd_solve_cholesky_d131", "spd.solve"),
])
def test_schur_recursion_nests_its_spans(tmp_path, case, outer):
    """Where the Schur recursion runs (EASE's inverses, the solve past
    d = 232 and with the Cholesky leaf), each ``spd.leaf`` sits in an
    ``spd.schur``, and each ``spd.schur`` in the caller's span or in an
    outer ``spd.schur``; the block solve's spans do not appear."""
    d = int(case.rsplit("_d", 1)[1])
    A, b = _spd_system(d)
    run = {"spd_inverse_d300": lambda: spd.spd_inverse(A),
           "spd_inverse_scaled_d300": lambda: spd.spd_inverse_scaled(A),
           "spd_solve_d300": lambda: spd.spd_solve(A, b),
           "spd_solve_cholesky_d131": lambda: spd.spd_solve(A, b, leaf="cholesky")}[case]
    _, spans = _traced(run, tmp_path)
    parents = {}
    for s in spans:
        up = _ancestors(spans, s)
        parents.setdefault(s[0], set()).add(up[0] if up else None)
    assert set(parents) == {"spd.schur", "spd.leaf"} | ({outer} - {None})
    assert parents["spd.leaf"] == {"spd.schur"}
    assert parents["spd.schur"] == {outer, "spd.schur"}


def test_sgd_step_count(tmp_path):
    (_, n_batches), spans = _traced(lambda: _sgd(epochs=3), tmp_path)
    count = {n: sum(1 for s in spans if s[0] == n)
             for n in ("sgd.epoch", "sgd.step", "sgd.apply", "sgd.rmse")}
    assert n_batches > 1
    assert count == {"sgd.epoch": 3, "sgd.step": 3 * n_batches,
                     "sgd.apply": 3 * n_batches, "sgd.rmse": 3}


@pytest.mark.parametrize("tie_blocks", [(), (1,), (0, 2)])
def test_topk_ties_once_per_tied_block(tmp_path, small_blocks, tie_blocks):
    (vals, pos, _), spans = _traced(lambda: _search(tie_blocks), tmp_path)
    count = {n: sum(1 for s in spans if s[0] == n)
             for n in ("search.gemm", "topk.select", "topk.sync", "topk.ties",
                       "topk.sort", "search.fetch", "search.answer")}
    # three blocks of the batch (the selection body), and the one query's
    # block of 500 scores (the whole-row sort)
    assert count == {"search.gemm": 4, "topk.select": 3, "topk.sync": 3,
                     "topk.ties": len(tie_blocks), "topk.sort": 1,
                     "search.fetch": 4, "search.answer": 1}
    for b in tie_blocks:  # the tied query keeps the lowest tied positions
        np.testing.assert_array_equal(pos[b * ROWS + 1], np.arange(K))


def test_results_bit_identical_traced(tmp_path, small_blocks):
    untraced = _all_four()
    traced, _ = _traced(_all_four, tmp_path)
    _same(untraced, traced)


def test_profiling_is_the_only_range_opener():
    """Outside ``utils/profiling.py`` the port opens no profiler range of
    its own: every span goes through ``span``, gated on the profiler."""
    opener = re.compile(r"record_function|_RecordFunctionFast")
    found = [str(f.relative_to(PORT)) for f in PORT.rglob("*.py")
             if f.name != "profiling.py" and opener.search(f.read_text())]
    assert found == []


@pytest.mark.parametrize("name", ["ml25m-sgd-sigmoid", "ml25m-als-linear",
                                  "recipenlg-search-b256"])
def test_trace_spans_tool_reads_a_cut_cell(monkeypatch, name):
    """``tools/trace_spans.py`` keeps the benchmark's traced run and reads
    it by span: a cell cut to the CPU, run through the harness's own
    ``run_cell``."""
    from portbench import common, run
    from portbench.tests.tiny import tiny_cell

    spec = importlib.util.spec_from_file_location("trace_spans",
                                                  ROOT / "tools" / "trace_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cell = tiny_cell(common.load_manifest(), name)
    real = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda m, n, seed, seconds, traced: real(
        m, n, seed, seconds, traced, device="cpu", cell=cell))
    out = tool.trace_cell(name, cell.seed)
    assert out["result"]["correct"] is True
    assert out["units"] == cell.mix["trace_units"]
    per_unit, checks = out["per_unit"], out["checks"]
    # the CPU has no device intervals: the window is one idle gap, so the
    # idle order and the device accounting are checked on the card only
    assert out["program"]["busy_s"] == 0 and "device_rel_gap" not in checks
    if name.startswith("recipenlg"):
        assert per_unit["search.query"] == 1.0 and per_unit["search.gemm"] >= 1.0
        assert checks["units_are_calls"] is True and "idle_order_holds" in checks
        assert out["span_readings"]["search_idle_program_ms"] > 0
    else:
        epoch = "sgd.epoch" if "sgd" in name else "als.epoch"
        assert per_unit[epoch] == cell.mix["epochs_per_job"]
        assert "units_are_calls" not in checks
    if "als" in name:
        assert per_unit["spd.leaf"] >= per_unit["als.normal_eq"] > 0
        assert checks["als_parts_within_busy"] is True
        assert out["span_readings"]["als_normal_eq_ms.inclusive"] == 0.0


def test_trace_spans_tool_names_the_kernels_of_each_span():
    """``kernels_by_span``: a kernel counts in the innermost span its
    launch lies in, for its device time inside the window; a launch in no
    span counts outside."""
    spec = importlib.util.spec_from_file_location("trace_spans",
                                                  ROOT / "tools" / "trace_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def X(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [X("mf:als.normal_eq", "cpu_op", 0, 100),
              X("mf:als.gram_kernel", "cpu_op", 10, 80),
              X("cudaLaunchKernel", "cuda_runtime", 20, 1, 1),
              X("cudaLaunchKernel", "cuda_runtime", 95, 1, 2),
              X("cudaLaunchKernel", "cuda_runtime", 200, 1, 3),
              X("normal_eq_kernel", "kernel", 30, 40, 1),
              X("reduce_kernel", "kernel", 96, 10, 2),
              X("gemm", "kernel", 201, 2_000, 3)]
    got = tool.kernels_by_span(events, 0, 1_000)
    assert got == {"als.gram_kernel": [["normal_eq_kernel", 40e-6]],
                   "als.normal_eq": [["reduce_kernel", 10e-6]],
                   "(outside)": [["gemm", 799e-6]]}


def test_trace_spans_tool_sums_each_span_inclusively():
    """``inclusive_device_s``: a launch counts in every span that holds
    it, once a name; memory copies count as device work; a launch in no
    span counts in none."""
    spec = importlib.util.spec_from_file_location("trace_spans",
                                                  ROOT / "tools" / "trace_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def X(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [X("mf:als.epoch", "cpu_op", 0, 500),
              X("mf:als.normal_eq", "cpu_op", 0, 100),
              X("mf:als.gram_kernel", "cpu_op", 10, 80),
              X("mf:als.normal_eq", "cpu_op", 300, 50),
              X("cudaLaunchKernel", "cuda_runtime", 20, 1, 1),
              X("cudaLaunchKernel", "cuda_runtime", 95, 1, 2),
              X("cudaMemcpyAsync", "cuda_runtime", 310, 1, 3),
              X("cudaLaunchKernel", "cuda_runtime", 600, 1, 4),
              X("normal_eq_kernel", "kernel", 30, 40, 1),
              X("reduce_kernel", "kernel", 96, 10, 2),
              X("Memcpy DtoD", "gpu_memcpy", 320, 5, 3),
              X("gemm", "kernel", 601, 2_000, 4)]
    got = tool.inclusive_device_s(events, 0, 1_000)
    assert got == pytest.approx({"als.epoch": 55e-6, "als.normal_eq": 55e-6,
                                 "als.gram_kernel": 40e-6})
