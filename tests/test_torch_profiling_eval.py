"""The port's ``utils/profiling.py``, ``eval/topk_eval.py`` and
``eval/evaluator.py`` on the spec of ``tests/test_evaluator_profiling.py``,
and held to the JAX package: one KernelMF fitted in JAX and carried into
the port through a checkpoint gives JAX's recommended lists, item for
item, and JAX's metrics (ranking metrics, coverage and diversity within
1e-12, rmse and mae within 1e-5)."""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu import KernelMF as JKernelMF
from matrix_factorization_tpu.core import checkpoint as jckpt
from matrix_factorization_tpu.eval import evaluator as jevaluator
from matrix_factorization_tpu.eval import topk_eval as jtopk
from matrix_factorization_tpu_torch import BaselineModel, KernelMF
from matrix_factorization_tpu_torch.core import checkpoint as ckpt
from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings
from matrix_factorization_tpu_torch.eval import topk_eval
from matrix_factorization_tpu_torch.eval.evaluator import RecommenderEvaluator
from matrix_factorization_tpu_torch.utils.profiling import (
    EpochLogger,
    ThroughputMeter,
    Timer,
    force_completion,
    trace,
)

K = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the CPU steps here are small, and with the
    test workers sharing the cores, threads that wait on each other at
    every op make them crawl."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split():
    X, y = lowrank_ratings(n_users=60, n_items=40, density=0.5, seed=21)
    n = len(X)
    cut = int(0.8 * n)
    return X.iloc[:cut], y.iloc[:cut], X.iloc[cut:], y.iloc[cut:]


def test_evaluator_report_fields():
    Xtr, ytr, Xte, yte = _split()
    model = BaselineModel(method="als", n_epochs=10, reg=0.5,
                          device="cpu").fit(Xtr, ytr)
    rep = RecommenderEvaluator(k=5, positive_threshold=3.0).evaluate(
        model, Xtr, Xte, yte)
    d = rep.as_dict()
    assert set(d) == {"rmse", "mae", "precision", "recall", "f1", "ndcg",
                      "coverage", "diversity", "n_users"}
    assert d["rmse"] > 0 and 0 <= d["coverage"] <= 1
    assert 0 <= d["diversity"] <= 1


def test_evaluator_compare_table():
    Xtr, ytr, Xte, yte = _split()
    ev = RecommenderEvaluator(k=5, positive_threshold=3.0, max_users=20)
    table = ev.compare(
        {
            "baseline": BaselineModel(method="als", n_epochs=5, reg=0.5,
                                      device="cpu"),
            "kernel_mf": KernelMF(n_factors=6, n_epochs=10, lr=0.02,
                                  reg=0.02, batch_size=128, device="cpu"),
        },
        Xtr, ytr, Xte, yte,
    )
    assert list(table.index) == ["baseline", "kernel_mf"]
    assert "rmse" in table.columns


def test_throughput_meter_and_timer():
    m = ThroughputMeter(n_chips=4)
    m.record(1_000_000, 0.5)
    m.record(1_000_000, 0.5)
    assert m.updates_per_sec == 2_000_000
    assert m.updates_per_sec_per_chip == 500_000
    with Timer() as t:
        sum(range(1000))
    assert t.seconds >= 0

    log = EpochLogger(verbose=0)
    log.log(1, 0.95, n_updates=100, seconds=0.1)
    assert log.history[0]["updates_per_sec"] == 1000

    with trace(None):  # no-op path
        pass


def test_force_completion_and_timer_sync():
    import torch

    a = torch.arange(4, dtype=torch.float32)
    assert force_completion(a, np.ones(3)) == 9.0
    with Timer(sync_arrays=[a]) as t:
        a.mul_(2)
    assert t.seconds >= 0 and float(a.sum()) == 12.0


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """One KernelMF fitted in JAX, its rating frame, and the port's model
    loaded from JAX's checkpoint."""
    X, y = lowrank_ratings(n_users=40, n_items=30, density=0.5, seed=8)
    df = X.copy()
    df["rating"] = y.clip(lower=0.5)
    jmodel = JKernelMF(n_factors=6, n_epochs=12, lr=0.03, reg=0.02,
                       batch_size=64, seed=0).fit(df[["user_id", "item_id"]],
                                                  df["rating"])
    path = tmp_path_factory.mktemp("carried") / "ckpt"
    jckpt.save_model(jmodel, path)
    return df, jmodel, ckpt.load_model(path, device="cpu")


def _recording(model):
    """Wrap ``model.recommend`` so that each call's (user, known items,
    recommended ids) is kept; returns the list."""
    calls = []
    inner = model.recommend

    def recommend(user, amount=10, items_known=None, **kw):
        out = inner(user=user, amount=amount, items_known=items_known, **kw)
        calls.append((user, set(items_known or ()), list(out["item_id"])))
        return out

    model.recommend = recommend
    return calls


def _assert_cuts_apart(pmodel, calls, k):
    """No recorded list has two of its k + 1 best unseen scores within
    1e-5, so that both packages' lists are free of ties."""
    items = np.asarray(pmodel.item_vocab.raw_ids)
    for user, known, _ in calls:
        keep = [it for it in items if it not in known]
        s = np.asarray(pmodel.predict(pd.DataFrame(
            {"user_id": [user] * len(keep), "item_id": keep}),
            bound_ratings=False), np.float64)
        top = np.sort(s)[::-1][:k + 1]
        assert np.all(-np.diff(top) > 1e-5), (user, top)


def test_evaluate_topk_matches_jax(carried):
    df, jmodel, pmodel = carried
    want_calls, got_calls = _recording(jmodel), _recording(pmodel)
    kw = dict(k=K, positive_threshold=3.0, n_test=2, seed=0)
    want = jtopk.evaluate_topk(df, jmodel, **kw)
    got = topk_eval.evaluate_topk(df, pmodel, **kw)
    assert got.n_users == want.n_users > 0
    _assert_cuts_apart(pmodel, got_calls, K)
    assert got_calls == want_calls
    for name in ("precision", "recall", "ndcg"):
        assert getattr(got, name) == pytest.approx(getattr(want, name), abs=1e-12)


def test_evaluator_matches_jax(carried):
    df, jmodel, pmodel = carried
    n = len(df)
    Xtr, Xte = df.iloc[: int(0.7 * n)], df.iloc[int(0.7 * n):]
    cols = ["user_id", "item_id"]
    want_calls, got_calls = _recording(jmodel), _recording(pmodel)
    want = jevaluator.RecommenderEvaluator(k=K, positive_threshold=3.0).evaluate(
        jmodel, Xtr[cols], Xte[cols], Xte["rating"]).as_dict()
    got = RecommenderEvaluator(k=K, positive_threshold=3.0).evaluate(
        pmodel, Xtr[cols], Xte[cols], Xte["rating"]).as_dict()
    assert got["n_users"] == want["n_users"] > 1
    _assert_cuts_apart(pmodel, got_calls, K)
    assert got_calls == want_calls
    for name in ("precision", "recall", "f1", "ndcg", "coverage", "diversity"):
        assert got[name] == pytest.approx(want[name], abs=1e-12), name
    for name in ("rmse", "mae"):
        assert got[name] == pytest.approx(want[name], abs=1e-5), name


@pytest.mark.parametrize("max_users", [1, 7, 25])
def test_max_users_groups_only_the_evaluated_users(carried, max_users):
    """The port groups only the first ``max_users`` users' rows: each
    group equals JAX's whole-frame group, and the result JAX's."""
    df, jmodel, pmodel = carried
    df = df.sample(frac=1.0, random_state=3)  # users in no sorted order
    users, by_user = topk_eval.users_and_histories(df, max_users)
    every = dict(tuple(df.groupby("user_id")))
    assert list(users) == list(df["user_id"].unique()[:max_users])
    assert sorted(by_user) == sorted(users)
    for u in users:
        pd.testing.assert_frame_equal(by_user[u], every[u])
    kw = dict(k=K, positive_threshold=3.0, n_test=2, seed=4, max_users=max_users)
    got = topk_eval.evaluate_topk(df, pmodel, **kw)
    want = jtopk.evaluate_topk(df, jmodel, **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
