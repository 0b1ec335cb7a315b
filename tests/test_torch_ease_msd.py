"""EASE at the Million Song Dataset's size, on the CPU: the int8 gram's
layout and arithmetic (the plain versions of ``csrc/ease_gram.cu``'s
steps) against the exact-f32 gram, the item budget of a CUDA card, the
fit's two calls and spans, the benchmark's plain reference
(``portbench/reference/ease.py``) against the port, and the benchmark's
``msd-ease-fit`` cell cut to the CPU."""

from __future__ import annotations

import types

import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu_torch import EASE
from matrix_factorization_tpu_torch.ops import cuda_gram
from matrix_factorization_tpu_torch.ops import ease as ops
from portbench import common, roofline_ease, run
from portbench.reference import ease as ref
from portbench.tests.tiny import tiny_cell
from portbench.trace import Profiled, TraceView, reduce_trace


def _plays(n_users, n_items, n_pairs, seed, weights="binary"):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_users * n_items, n_pairs))
    u, i = (key // n_items).astype(np.int64), (key % n_items).astype(np.int64)
    w = {"binary": np.ones(len(u), np.float32),
         "small": rng.integers(-127, 128, len(u)).astype(np.float32),
         "real": rng.uniform(0.5, 5.0, len(u)).astype(np.float32)}[weights]
    return u, i, w


@pytest.mark.parametrize("n", [8, 128, 136, 1_000, 41_144])
def test_tile_order_covers_each_upper_tile_once(n):
    t = cuda_gram.tile_order(n)
    side = -(-n // cuda_gram.TILE)
    assert t.dtype == np.int32 and len(t) == side * (side + 1) // 2
    assert len({(a, b) for a, b in t.tolist()}) == len(t)
    assert (t[:, 0] <= t[:, 1]).all() and t.max() < side
    # groups of GROUP tile rows, each walked column by column
    groups = t[:, 0] // cuda_gram.GROUP
    assert (np.diff(groups) >= 0).all()


@pytest.mark.parametrize("n_users,n_items,cu,weights", [
    (300, 40, 128, "binary"), (700, 300, 256, "binary"), (1_000, 257, 384, "small"),
    (129, 500, 128, "binary")])
def test_plain_int8_gram_is_the_f32_gram_bit_for_bit(n_users, n_items, cu, weights):
    """The kernels' steps in plain PyTorch (slab, upper tiles, finish),
    over ragged items and users and several chunks, equal the exact-f32
    scan."""
    u, i, w = _plays(n_users, n_items, n_users * n_items // 8, n_users, weights)
    ip = ops.round8(n_items)
    lu, ii, ww, bounds = ops._gram_chunks(u, i, w, n_users, cu)
    lu, ii, ww = (torch.from_numpy(a) for a in (lu, ii, ww))
    G8 = cuda_gram.int8_gram(lu, ii, ww, bounds, ip, cu,
                             torch.from_numpy(cuda_gram.tile_order(ip)))
    Gf = ops.item_gram(u, i, w, n_users, n_items, 100, device="cpu")
    assert G8.dtype == torch.float32 and torch.equal(G8, Gf)
    assert ops.int8_exact(i, w, n_items) and ops._pairs_unique(lu, ii, ww, bounds, cu, ip)


def test_int8_path_conditions():
    u, i, w = _plays(400, 60, 5_000, 3)
    assert ops.int8_exact(i, w, 60)
    assert not ops.int8_exact(i, w * 0.5, 60)  # non-integer weights
    assert not ops.int8_exact(i, np.full_like(w, 128.0), 60)
    # one item's sum of w^2 at 2^24 or more would not convert exactly:
    # 1,040 plays of 127 make 16,774,160, 1,041 make 16,790,289
    for plays, ok in ((1_040, True), (1_041, False)):
        assert ops.int8_exact(np.zeros(plays, np.int64),
                              np.full(plays, 127.0, np.float32), 1) is ok
    lu, ii, ww, bounds = ops._gram_chunks(np.append(u, u[0]), np.append(i, i[0]),
                                          np.append(w, 1.0), 400, 128)
    lu, ii, ww = (torch.from_numpy(a) for a in (lu, ii, ww))
    assert not ops._pairs_unique(lu, ii, ww, bounds, 128, 64)
    chunk = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    same = np.flatnonzero((chunk * 128 + lu.numpy() == u[0]) & (ii.numpy() == i[0]))
    assert len(same) == 2
    ww[same[1]] = 0.0  # a repeat of weight 0 writes nothing
    assert ops._pairs_unique(lu, ii, ww, bounds, 128, 64)
    # the CPU always takes the f32 path, whatever the weights
    pack = ops.gram_pack(u, i, w, 400, 60, 128, device="cpu")
    assert pack.tiles is None and pack.cu == 128


def test_cuda_item_budget_and_the_cpu_tiers(monkeypatch):
    """On one data rank of a CUDA card the budget is the largest multiple
    of 8 whose fit peak, with the plays' resident bytes, fits in 90% of the
    card; the CPU and the mesh keep the JAX package's tiers."""
    gib80, plays = 80 * 10**9, 33_633_450

    def card(total):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: types.SimpleNamespace(total_memory=total))

    def peak(n):
        return ops.FIT_PEAK_COPIES * 4 * n**2 + ops.PLAY_BYTES * plays

    card(gib80)
    lim = ops.device_item_limit(1, torch.device("cuda", 0), plays)
    assert lim % 8 == 0
    assert peak(lim) <= ops.BUDGET_SHARE * gib80 < peak(lim + 8)
    assert lim >= ops.round8(41_140)  # the Million Song Dataset fits
    # the plays' bytes come off the room the items have
    assert lim < ops.device_item_limit(1, "cuda")
    card(16 * 10**9)
    assert ops.device_item_limit(1, "cuda", plays) < lim
    assert ops.device_item_limit(1, "cuda", 10**10) == 0  # no room at all
    assert ops.device_item_limit(4, "cuda", plays) == 32_768
    assert [ops.device_item_limit(n, "cpu", plays) for n in (1, 4, 8)] == \
        [16_384, 32_768, 65_536]
    with pytest.raises(ValueError, match=f"budget here is {lim} items"):
        ops.check_item_budget(lim + 1, lim)
    ops.check_item_budget(41_140, lim)


def _frame(u, i, w=None):
    X = pd.DataFrame({"user_id": [f"u{x}" for x in u], "item_id": [f"i{x}" for x in i]})
    return X, pd.Series(np.ones(len(u)) if w is None else w)


def test_fit_is_the_pack_then_fit_packed_and_records_its_spans():
    u, i, _ = _plays(200, 90, 3_000, 11)
    X, y = _frame(u, i)
    with Profiled(torch, "cpu") as prof:
        m = EASE(reg=30.0, device="cpu").fit(X, y)
    names = [e["name"] for e in prof.events if e.get("cat") == "cpu_op"]
    for span in ("mf:ease.gram", "mf:ease.inverse", "mf:ease.closed_form"):
        assert names.count(span) == 1, span
    ui, ii = m.user_vocab.encode(X["user_id"].to_numpy()), m.item_vocab.encode(
        X["item_id"].to_numpy())
    w = np.ones(len(ui), np.float32)
    B = ops.fit_packed(ops.gram_pack(ui, ii, w, m.n_users, m.n_items, device="cpu"), 30.0)
    assert torch.equal(B, m._params.item_weights)
    G = ops.item_gram(ui, ii, w, m.n_users, m.n_items, device="cpu")
    G0 = G.clone()
    assert torch.equal(ops.ease_weights(G, 30.0), B) and torch.equal(G, G0)


def _ref_B(u, i, w, n_users, n_items, lam):
    t = [torch.from_numpy(np.asarray(a)) for a in (u, i, w)]
    return ref.weights(ref.gram(t[0], t[1], t[2].double(), n_users, n_items), lam)


@pytest.mark.parametrize("seed,lam", [(0, 50.0), (1, 200.0), (2, 5.0)])
def test_the_port_s_fit_holds_to_the_float64_reference(seed, lam):
    n_users, n_items = 400, 150
    u, i, w = _plays(n_users, n_items, 8_000, seed)
    B = ops.fit_packed(ops.gram_pack(u, i, w, n_users, n_items, device="cpu"), lam)
    R = _ref_B(u, i, w, n_users, n_items, lam)
    gap, top = ref.max_abs_gap(B, R)
    assert gap / top < 1e-4
    assert torch.equal(B[n_items:], torch.zeros_like(B[n_items:]))
    assert torch.equal(B.diagonal(), torch.zeros(B.shape[0]))


@pytest.mark.parametrize("seed", [3, 4])
def test_served_lists_are_the_reference_s_on_the_same_weights(seed):
    """The port's top-k unseen (its scores, mask and tie rule) against the
    reference's serving of the same ``B``, item for item."""
    n_users, n_items, k = 300, 120, 20
    u, i, w = _plays(n_users, n_items, 5_000, seed)
    B = ops.fit_packed(ops.gram_pack(u, i, w, n_users, n_items, device="cpu"), 40.0)
    t = [torch.from_numpy(a) for a in (u, i, w)]
    users = ref.sample_users(n_users, np.bincount(u, minlength=n_users), 64, seed)
    X = ref.history_block(torch.from_numpy(users), *t, n_users, n_items)
    order, starts, counts = ref.histories(*t, n_users)
    L = int(counts[torch.from_numpy(users)].max())
    ids, ws = ref.padded(torch.from_numpy(users), L, t[1][order], t[2][order], starts, counts)
    vals, idx = ops.history_topk_unseen(B, ids.numpy().astype(np.int32),
                                        ws.numpy().astype(np.float32), k, n_items)
    rv, ri = ref.serve(X, B[:n_items, :n_items].double(), k)
    np.testing.assert_array_equal(idx, ri.numpy())
    np.testing.assert_allclose(vals, rv.numpy(), rtol=1e-5, atol=1e-6)


def test_tied_scores_go_to_the_lower_item_in_both():
    """Weights in sixteenths make every score exact in f32 and float64, so
    ties are ties in both, and the tie rule decides."""
    n = 48
    rng = np.random.default_rng(7)
    B = torch.from_numpy(rng.integers(-2, 3, (n, n)).astype(np.float32) / 16)
    B[:, 30:40] = B[:, 20:21]  # ten columns tied with column 20
    ids = np.array([[0, 1, 2, 3], [4, 5, 0, 0]], np.int32)
    w = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    vals, idx = ops.history_topk_unseen(B, ids, w, 15, n)
    X = torch.zeros((2, n), dtype=torch.float64)
    X[0, :4] = 1
    X[1, 4:6] = 1
    rv, ri = ref.serve(X, B.double(), 15)
    np.testing.assert_array_equal(idx, ri.numpy())
    np.testing.assert_array_equal(vals, rv.numpy().astype(np.float32))
    tied = [x for x in idx[0] if x == 20 or 30 <= x < 40]
    assert tied == sorted(tied) and len(tied) > 1


def test_gram_roofline_reader_and_least_times_by_hand():
    read = common.load_module(common.metric_path("ease_gram_roofline"), "m_egr").read
    U, n = 571_355, 41_140
    least = roofline_ease.gram_least_s(U, n)
    assert least == pytest.approx(U * n * (n + 1) / 1979e12)
    assert 0.48 < least < 0.50
    flops, nbytes = roofline_ease.fit_work(n, 3.5e9, 33_633_450)
    assert flops == n**3 + 7e9 and nbytes == 8 * 33_633_450 + 8 * n * n
    base = dict(window_s=2.0, busy_s=1.9, device_ops={}, kernel_launches={},
                spans=[], busy_in_spans={}, idle_gaps=[])
    t = TraceView(kernel_ops={"void (anonymous namespace)::ease_gram_tile_kernel(...)": 0.8,
                              "ease_gram_slab_kernel": 0.1, "ease_gram_finish_kernel": 0.1,
                              "sm90_xmma_gemm_f32f32": 3.0, "gj_inverse_kernel<16, 8, 1>": 1.0},
                  host_calls={"mf:ease.gram": 1}, work={"ease_gram_bound_s": 0.5}, **base)
    assert read(t, None) == pytest.approx(50.0)
    assert read(TraceView(kernel_ops=t.kernel_ops, host_calls={}, work=t.work, **base),
                None) is None
    assert read(TraceView(kernel_ops={}, host_calls=t.host_calls, work=t.work, **base),
                None) is None


@pytest.mark.parametrize("trace", [False, True])
def test_the_msd_cell_cut_to_the_cpu_runs_correct(trace):
    m = common.load_manifest()
    cell = tiny_cell(m, "msd-ease-fit")
    assert (cell.config["n_users"], cell.config["n_items"]) == (300, 200)
    assert cell.mix["k"] == 10 and cell.mix["trace_units"] == 1
    out, checks = run.run_cell(m, "msd-ease-fit", cell.seed, 0.2, trace, device="cpu",
                               cell=cell)
    assert out["correct"] is True, checks.lines()
    assert set(checks.rows) == {"b_gap", "score_gap", "rank_gap", "order_faults"}
    assert checks.rows["order_faults"]["value"] == 0
    if trace:
        # the CPU runs no gram kernel: the new metric has nothing to read
        assert set(out["metrics"]) == {"train_mfu", "device_idle_share.train"}
    else:
        assert set(out["metrics"]) == {"train_ratings_per_s", "setup_s"}
        assert out["attempted"] >= 1


def test_the_msd_cell_on_a_trace_counts_one_gram_a_fit():
    m = common.load_manifest()
    cell = tiny_cell(m, "msd-ease-fit")
    d = common.load_module(common.driver_path("ease"), "d_ease_msd")
    st = d.setup(cell)
    with Profiled(torch, "cpu") as prof:
        units = [d.unit(st, j) for j in range(2)]
    t = reduce_trace(prof.events, work=d.trace_work(st, units))
    assert t.host_calls["mf:ease.gram"] == 2 == t.work["epochs"]
    assert t.work["ease_gram_bound_s"] == pytest.approx(
        2 * roofline_ease.gram_least_s(300, 200))


@pytest.mark.parametrize("fault", ["chunk", "lam"])
def test_a_planted_fault_is_not_correct_under_the_cell_s_limits(fault):
    """``portbench/calibrate_ease.py``'s faults (a user chunk dropped from
    the gram, lambda 1% off) read past the cell's limits, the sound fit
    inside them."""
    from portbench import calibrate_ease

    m = common.load_manifest()
    cell = tiny_cell(m, "msd-ease-fit")
    rows = calibrate_ease.readings(m, "msd-ease-fit", cell.seed, [1], (), [fault], [2],
                                   device="cpu", cell=cell)
    assert {r["kind"]: r["correct"] for r in rows} == {"program": True,
                                                       f"fault:{fault}": False}
