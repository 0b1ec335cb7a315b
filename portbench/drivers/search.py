"""Driver of ``retrieval/search.py``'s dense search: one closed-loop
caller sends ``batch`` queries a call, to ``search_topk_batch`` (batch
retrieval, as the offline and hybrid evaluations call it) or, at one
query, to ``search_topk`` (as ``serve/service.py`` calls it for each
request).

Set-up makes the catalog's unit rows on the device and puts them in a
``DenseItemIndex`` (host rows, item ids equal to positions), which the
program copies to the device once (``device_embeddings``); it makes a
pool of queries and warms up a few calls. A unit is one call, timed from
the call until its host arrays are back. Every answer is kept; after the
window a sample of the calls, drawn from the seed, is judged against the
plain reference:

* ``score_gap``: the largest gap between a returned score and the exact
  (float64) score of the returned row for that query: a wrong row or a
  wrong score;
* ``rank_gap``: the largest amount by which the j-th returned row's exact
  score lies below the exact j-th best score of the catalog: a row that
  should not be there;
* ``order_faults``: pairs of neighbours out of the one tie rule (score
  descending, then position ascending): an exact count, limit 0.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from matrix_factorization_tpu_torch.retrieval.index import DenseItemIndex
from matrix_factorization_tpu_torch.retrieval.search import (
    device_embeddings,
    search_topk,
    search_topk_batch,
)
from portbench import gen
from portbench.common import Checks, sub_seed
from portbench.reference import search as ref
from portbench.roofline import gemm_work, search_work, topk_work

S_SAMPLE = 30


def setup(cell) -> dict:
    c, m = cell.config, cell.mix
    st = {"cell": cell}
    t0 = time.perf_counter()
    emb = gen.catalog(c, cell.seed, cell.device)
    B = m["batch"]
    q = gen.queries(emb, B * m["pool_calls"], m, cell.seed)
    st["pool"] = q.cpu().numpy().reshape(m["pool_calls"], B, c["dim"])
    st["host"] = emb.cpu().numpy()
    del emb, q
    t1 = time.perf_counter()
    st["index"] = DenseItemIndex(item_ids=list(range(c["n_items"])), texts=[],
                                 embeddings=st["host"])
    device_embeddings(st["index"], cell.device)
    st["setup_parts"] = {"inputs_s": t1 - t0, "index_s": time.perf_counter() - t1}
    st["answers"] = []  # (pool call, scores (B, k), positions (B, k))
    for j in range(m["warm_calls"]):
        unit(st, j)
    st["answers"].clear()
    return st


def _call(st, qb: np.ndarray):
    cell = st["cell"]
    k = cell.mix["k"]
    if qb.shape[0] == 1:
        rows = search_topk(st["index"], qb[0], k, device=cell.device)
        return (np.asarray([[s for _, s in rows]], np.float64),
                np.asarray([[i for i, _ in rows]], np.int64))
    vals, pos = search_topk_batch(st["index"], qb, k, device=cell.device)
    return vals, pos


def unit(st, j: int) -> dict:
    pj = j % len(st["pool"])
    qb = st["pool"][pj]
    t0 = time.perf_counter()
    vals, pos = _call(st, qb)
    ms = (time.perf_counter() - t0) * 1e3
    st["answers"].append((pj, vals, pos))
    return {"queries": qb.shape[0], "latency_ms": ms, "calls": 1}


def end_to_end(st, units, window_s: float) -> dict:
    lat = [u["latency_ms"] for u in units]
    return {"search_queries_per_s": sum(u["queries"] for u in units) / window_s,
            "search_p95_ms": float(np.percentile(lat, 95, method="linear"))}


def trace_work(st, units) -> dict:
    c, m = st["cell"].config, st["cell"].mix
    B, N, D, k = m["batch"], c["n_items"], c["dim"], m["k"]
    return {"calls": sum(u["calls"] for u in units),
            "call_work": search_work(B, N, D, k), "gemm_work": gemm_work(B, N, D),
            "topk_work": topk_work(B, N, k)}


def judge(emb: torch.Tensor, q: torch.Tensor, vals: torch.Tensor,
          pos: torch.Tensor, k: int, limits: dict, checks: Checks) -> Checks:
    """The three numbers of the module docstring for (B, k) answers."""
    B = q.shape[0]
    if tuple(vals.shape) != (B, k) or tuple(pos.shape) != (B, k):
        checks.fail(f"answers of shape {tuple(vals.shape)} for {B} queries at k={k}")
        return checks
    if bool(((pos < 0) | (pos >= emb.shape[0])).any()):
        checks.fail("a returned position lies outside the catalog")
        return checks
    exact = ref.exact_scores(emb, q, pos)
    best = ref.topk_scores(emb, q, k)
    checks.add("score_gap", float((vals.double() - exact).abs().max()),
               limits["score_gap"])
    checks.add("rank_gap", float((best - exact).max().clamp(min=0)),
               limits["rank_gap"])
    v, p = vals[:, :-1], vals[:, 1:]
    faults = (v < p) | ((v == p) & (pos[:, :-1] >= pos[:, 1:]))
    checks.add("order_faults", int(faults.sum()), limits["order_faults"])
    return checks


def _sample(st) -> list:
    cell = st["cell"]
    n = len(st["answers"])
    g = np.random.default_rng(sub_seed(cell.seed, S_SAMPLE))
    m = min(n, cell.mix["check_calls"])
    return sorted(g.choice(n, size=m, replace=False).tolist())


def check(st, control: bool = False) -> Checks:
    """Judge a seeded sample of the window's answers; with ``control``,
    judge the control's answers to the same queries instead."""
    cell = st["cell"]
    m = cell.mix
    checks = Checks()
    if not st["answers"]:
        checks.fail("no call was answered")
        return checks
    picked = [st["answers"][x] for x in _sample(st)]
    # the program's device copy dies with its index
    st.pop("index", None)
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    emb = torch.from_numpy(st["host"]).to(cell.device)
    q = torch.from_numpy(np.concatenate([st["pool"][pj] for pj, _, _ in picked])
                         ).to(cell.device)
    if control:
        vals, pos = ref.search(emb, q, m["k"])
    else:
        vals = torch.from_numpy(np.concatenate([v for _, v, _ in picked])).to(cell.device)
        pos = torch.from_numpy(np.concatenate([p for _, _, p in picked])).to(cell.device)
    return judge(emb, q, vals, pos, m["k"], m["limits"], checks)
