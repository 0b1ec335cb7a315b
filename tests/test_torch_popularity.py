"""The port's ``Popularity`` (host numpy, copied from the JAX package)
against the JAX package: scores, predictions and recommendation lists
equal in both modes, after ``fit`` and after ``update_users``, and
checkpoints in both directions."""

import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu import Popularity as JaxPopularity
from matrix_factorization_tpu.core import checkpoint as jax_ckpt
from matrix_factorization_tpu_torch import Popularity, load_model, save_model


def _ratings(n=400, n_users=50, n_items=35, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(n_users * n_items, n, replace=False)
    X = pd.DataFrame({"user_id": flat // n_items,
                      "item_id": [f"i{k}" for k in flat % n_items]})
    # half stars: count ties and mean ties both occur
    return X, pd.Series(np.round(rng.uniform(0.5, 5, n) * 2) / 2)


def _same(got, want):
    for col in ("user_id", "item_id"):
        assert list(got[col]) == list(want[col])
    np.testing.assert_array_equal(got.rating_pred.to_numpy(),
                                  want.rating_pred.to_numpy())


@pytest.mark.parametrize("score", ["count", "mean"])
def test_matches_jax_through_fit_update_and_serving(score):
    X, y = _ratings()
    want = JaxPopularity(score=score, damping=3.0).fit(X, y)
    got = Popularity(score=score, damping=3.0).fit(X, y)
    np.testing.assert_array_equal(got.item_scores_, want.item_scores_)
    probe = pd.DataFrame({"user_id": [0, 1, 999], "item_id": ["i1", "nope", "i2"]})
    for bound in (True, False):
        assert got.predict(probe, bound) == want.predict(probe, bound)
        assert got.predictions_possible == want.predictions_possible
    known = {0: ["i1", "i2", "i3"], 5: ["i4"]}
    _same(got.recommend(0, amount=7, items_known=known[0]),
          want.recommend(0, amount=7, items_known=known[0]))
    _same(got.recommend(12345, amount=5), want.recommend(12345, amount=5))
    _same(got.recommend_batch([0, 5, 7], amount=6, items_known_map=known),
          want.recommend_batch([0, 5, 7], amount=6, items_known_map=known))
    upd = pd.DataFrame({"user_id": [0, 777, 777, 778],
                        "item_id": ["i1", "i5", "unknown", "i5"]})
    ry = pd.Series([5.0, 1.0, 3.0, 2.0])
    got.update_users(upd, ry)
    want.update_users(upd, ry)
    np.testing.assert_array_equal(got.item_scores_, want.item_scores_)
    assert got.global_mean == want.global_mean
    assert got.contains_user(778) and got.n_users == want.n_users
    _same(got.recommend_batch([777, 3], amount=8),
          want.recommend_batch([777, 3], amount=8))


def test_checkpoints_cross_both_ways(tmp_path):
    X, y = _ratings()
    want = JaxPopularity(score="mean").fit(X, y)
    jax_ckpt.save_model(want, tmp_path / "jax")
    got = load_model(tmp_path / "jax")
    assert isinstance(got, Popularity) and got.score == "mean"
    np.testing.assert_array_equal(got.item_scores_, want.item_scores_)
    _same(got.recommend_batch([0, 1], amount=5),
          want.recommend_batch([0, 1], amount=5))
    save_model(got, tmp_path / "port")
    back = jax_ckpt.load_model(tmp_path / "port")
    np.testing.assert_array_equal(back.item_scores_, want.item_scores_)
    assert back.get_params() == want.get_params()


def test_invalid_score_raises():
    with pytest.raises(ValueError, match="score"):
        Popularity(score="median")
