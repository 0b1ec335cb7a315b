"""The port's content-based recommender against the JAX package, on the
CPU: both fit modes (user means, feature-weighted profiles), both
``predict_mode``s, partial feature tables and the missing ``item_id``
raise; profiles, similarity matrix and predictions atol 1e-5 (f32 both,
the profile sums in the same order)."""

import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.models.content_based import (
    ContentBasedRecommender as JaxContent,
)
from matrix_factorization_tpu_torch import ContentBasedRecommender


@pytest.fixture(scope="module")
def data():
    X, y = lowrank_ratings(n_users=25, n_items=20, density=0.5, seed=4)
    return X, y.clip(lower=0.5)


def _features(X, n_cols=6, keep=1.0, seed=11):
    items = np.sort(X["item_id"].unique())
    items = items[: int(round(len(items) * keep))]
    rng = np.random.default_rng(seed)
    feats = pd.DataFrame(rng.integers(0, 2, (len(items), n_cols)).astype(float),
                         columns=[f"g{j}" for j in range(n_cols)])
    feats.insert(0, "item_id", items)
    # a feature row of an item nobody rated is ignored
    return pd.concat([feats, pd.DataFrame(
        [[-99] + [1.0] * n_cols], columns=feats.columns)], ignore_index=True)


def _pairs(X):
    return pd.concat([X.iloc[:40], pd.DataFrame(
        {"user_id": [-1, X["user_id"].iloc[0]],
         "item_id": [X["item_id"].iloc[0], 10**6]})], ignore_index=True)


@pytest.mark.parametrize("mode", ["profile_mean", "similarity"])
@pytest.mark.parametrize("keep", [None, 1.0, 0.5])
def test_matches_jax(data, keep, mode):
    X, y = data
    feats = None if keep is None else _features(X, keep=keep)
    got = ContentBasedRecommender(predict_mode=mode, min_rating=0.5,
                                  device="cpu").fit(X, y, item_features=feats)
    want = JaxContent(predict_mode=mode, min_rating=0.5).fit(
        X, y, item_features=feats)
    pairs = _pairs(X)
    for bound in (True, False):
        np.testing.assert_allclose(got.predict(pairs, bound_ratings=bound),
                                   want.predict(pairs, bound_ratings=bound),
                                   atol=1e-5)
    assert got.predictions_possible == want.predictions_possible
    assert got.predictions_possible[-2:] == [False, False]
    for k, v in want.user_profiles.items():
        np.testing.assert_allclose(got.user_profiles[k], v, atol=1e-5)
    assert len(got.user_profiles) == got.n_users
    if keep is None:
        assert got.item_similarity_matrix is None
    else:
        np.testing.assert_allclose(got.item_similarity_matrix,
                                   want.item_similarity_matrix, atol=1e-5)
        assert got.item_similarity_matrix.shape == (got.n_items, got.n_items)
    user = X["user_id"].iloc[2]
    np.testing.assert_allclose(got.recommend(user, amount=4)["rating_pred"],
                               want.recommend(user, amount=4)["rating_pred"],
                               atol=1e-5)


def test_no_features_profile_is_user_mean(data):
    X, y = data
    m = ContentBasedRecommender(device="cpu").fit(X, y)
    u0 = X["user_id"].iloc[0]
    got = m.predict(pd.DataFrame({"user_id": [u0],
                                  "item_id": [X["item_id"].iloc[0]]}),
                    bound_ratings=False)[0]
    np.testing.assert_allclose(got, y[X["user_id"] == u0].mean(), atol=1e-5)


def test_bad_arguments(data):
    X, y = data
    with pytest.raises(ValueError, match="item_id"):
        ContentBasedRecommender(device="cpu").fit(
            X, y, item_features=pd.DataFrame({"g": [1.0]}))
    with pytest.raises(ValueError, match="predict_mode"):
        ContentBasedRecommender(predict_mode="knn", device="cpu")
    assert ContentBasedRecommender(device="cpu").user_profiles == {}
    assert ContentBasedRecommender(device="cpu").predict(X.iloc[:0]) == []
