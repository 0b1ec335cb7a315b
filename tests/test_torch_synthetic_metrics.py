"""The port's copies of ``data/synthetic.py`` and ``utils/metrics.py``:
the same seed gives equal frames, and every metric the same value."""

import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu.data import synthetic as jsyn
from matrix_factorization_tpu.utils import metrics as jmetrics
from matrix_factorization_tpu_torch.data import synthetic
from matrix_factorization_tpu_torch.utils import metrics


@pytest.mark.parametrize("fn, kw", [
    ("lowrank_ratings", dict(n_users=40, n_items=30, density=0.4, seed=3)),
    ("lowrank_ratings", dict()),
    ("movielens_shaped", dict(n_users=60, n_items=50, n_ratings=2_000, seed=1)),
    ("movielens_shaped", dict(n_users=20, n_items=10, n_ratings=199, seed=4)),
    ("clustered_interactions", dict(n_users=50, n_items=40, seed=2)),
])
def test_synthetic_frames_equal(fn, kw):
    X, y = getattr(synthetic, fn)(**kw)
    jX, jy = getattr(jsyn, fn)(**kw)
    pd.testing.assert_frame_equal(X, jX)
    pd.testing.assert_series_equal(y, jy)


def test_movielens_shaped_rejects_too_many_ratings():
    with pytest.raises(ValueError):
        synthetic.movielens_shaped(n_users=3, n_items=3, n_ratings=10)


def test_metrics_equal():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=50), rng.normal(size=50)
    assert metrics.rmse(a, b) == jmetrics.rmse(a, b)
    assert metrics.mae(a, b) == jmetrics.mae(a, b)
    recs = {u: list(rng.permutation(20)[:8]) for u in range(12)}
    rel = {u: set(rng.choice(20, size=int(rng.integers(0, 5)), replace=False))
           for u in range(10)}
    for k in (0, 1, 5, 10):
        for u in range(10):
            for name in ("precision_at_k", "recall_at_k", "ndcg_at_k"):
                assert getattr(metrics, name)(recs[u], rel[u], k) == \
                    getattr(jmetrics, name)(recs[u], rel[u], k)
        assert metrics.topk_report(recs, rel, k) == jmetrics.topk_report(recs, rel, k)
    assert metrics.topk_report({}, {}, 5) == jmetrics.topk_report({}, {}, 5)
    for p, r in ((0.0, 0.0), (0.5, 0.25), (1.0, 1.0)):
        assert metrics.f1_score(p, r) == jmetrics.f1_score(p, r)
