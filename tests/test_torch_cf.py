"""The port's neighbourhood models (``ops/similarity.py``,
``models/collaborative.py``) against the JAX package, on the CPU.

Predictions atol 1e-4 against the JAX models (f32 both, sums in other
orders), the similarity matrix, means and rating matrix atol 1e-6; the
float64 oracles of ``tests/test_cf.py`` at its bar, atol 6e-3 (f32
similarities can swap borderline neighbours). A tie at the k-th
neighbour is decided as ``lax.top_k`` decides it: the lower index wins.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.models.collaborative import ItemItemCF as JaxItemCF
from matrix_factorization_tpu.models.collaborative import UserUserCF as JaxUserCF
from matrix_factorization_tpu.ops import similarity as jsim
from matrix_factorization_tpu_torch import ItemItemCF, UserUserCF
from matrix_factorization_tpu_torch.ops import similarity as sim

MODELS = {"user": (UserUserCF, JaxUserCF), "item": (ItemItemCF, JaxItemCF)}


@pytest.fixture(scope="module")
def small():
    X, y = lowrank_ratings(n_users=30, n_items=24, density=0.45, seed=9)
    return X, y.clip(lower=0.5)  # ratings > 0: `rated = r > 0` is meaningful


def _cosine(m):
    normed = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
    return normed @ normed.T


def _oracle(R, q, c, n_neighbors, mode):
    """``tests/test_cf.py``'s float64 neighbourhood formula: ``q`` the
    query entity (user for ``mode='user'``), ``c`` the other side."""
    if mode == "item":
        R = R.T
    means = R.mean(axis=1)
    sims = _cosine(R - means[:, None])[q].copy()
    ratings = R[:, c]
    mask = ratings > 0
    mask[q] = False
    if not mask.any():
        return means[q]
    s, r, m = sims[mask], ratings[mask], means[mask]
    if len(s) > n_neighbors:
        top = np.argsort(s)[-n_neighbors:]
        s, r, m = s[top], r[top], m[top]
    den = np.abs(s).sum()
    return means[q] if den == 0 else means[q] + (s * (r - m)).sum() / den


def _pairs(X, n=60, seed=0):
    """Known pairs, some unrated, plus an unknown user and an unknown
    item."""
    rng = np.random.default_rng(seed)
    users = X["user_id"].unique()
    items = X["item_id"].unique()
    return pd.DataFrame({
        "user_id": np.concatenate([rng.choice(users, n), [10**6, users[0]]]),
        "item_id": np.concatenate([rng.choice(items, n), [items[0], -7]]),
    })


@pytest.mark.parametrize("metric", ["cosine", "pearson"])
@pytest.mark.parametrize("n_neighbors", [3, 50])
@pytest.mark.parametrize("mode", ["user", "item"])
def test_model_matches_jax(small, mode, n_neighbors, metric):
    X, y = small
    cls, jcls = MODELS[mode]
    got = cls(n_neighbors=n_neighbors, similarity_metric=metric,
              device="cpu").fit(X, y)
    want = jcls(n_neighbors=n_neighbors, similarity_metric=metric).fit(X, y)
    pairs = _pairs(X)
    for bound in (True, False):
        np.testing.assert_allclose(got.predict(pairs, bound_ratings=bound),
                                   want.predict(pairs, bound_ratings=bound),
                                   atol=1e-4)
    assert got.predictions_possible == want.predictions_possible
    np.testing.assert_allclose(got.user_item_matrix, want.user_item_matrix,
                               atol=1e-6)
    for view in (f"{mode}_similarity_matrix", f"{mode}_mean_ratings"):
        np.testing.assert_allclose(getattr(got, view), getattr(want, view),
                                   atol=1e-6)
    assert got.global_mean == pytest.approx(want.global_mean, abs=1e-6)
    user = X["user_id"].iloc[3]
    a = got.recommend(user, amount=5, items_known=list(X["item_id"][:4]))
    b = want.recommend(user, amount=5, items_known=list(X["item_id"][:4]))
    np.testing.assert_allclose(a["rating_pred"], b["rating_pred"], atol=1e-4)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_model_matches_float64_oracle(small, mode):
    X, y = small
    model = MODELS[mode][0](n_neighbors=5, device="cpu").fit(X, y)
    u = model.user_vocab.encode(X["user_id"].to_numpy())
    i = model.item_vocab.encode(X["item_id"].to_numpy())
    R = np.zeros((model.n_users, model.n_items))
    R[u, i] = y
    pairs = pd.DataFrame({"user_id": X["user_id"].iloc[:40].to_numpy(),
                          "item_id": X["item_id"].iloc[5:45].to_numpy()})
    got = model.predict(pairs, bound_ratings=False)
    pu = model.user_vocab.encode(pairs["user_id"].to_numpy())
    pi = model.item_vocab.encode(pairs["item_id"].to_numpy())
    want = [_oracle(R, a, b, 5, "user") if mode == "user"
            else _oracle(R, b, a, 5, "item") for a, b in zip(pu, pi)]
    np.testing.assert_allclose(got, want, atol=6e-3)
    assert np.median(np.abs(np.asarray(got) - np.asarray(want))) < 2e-4


@pytest.mark.parametrize("k", [1, 2, 3])
def test_a_tie_at_the_kth_neighbour_goes_to_the_lower_index(k):
    """Candidates 0, 2 and 3 tie at 0.5 behind candidate 1 (0.9); their
    ratings differ, so which of them fill the last places moves the
    prediction. ``lax.top_k`` keeps the lower index; so does the port."""
    sims = np.array([[0.5, 0.9, 0.5, 0.5, 0.2, 0.7]], np.float32)
    ratings = np.array([[1.0, 4.0, 5.0, 2.0, 3.0, 0.0]], np.float32)
    means = np.array([2.0, 3.0, 3.5, 2.5, 3.0, 3.0], np.float32)
    args = (sims, ratings, means[None, :], np.array([3.0], np.float32),
            np.array([5], np.int32))
    want = jsim._neighborhood_predict(*(jnp.asarray(a) for a in args), k)
    got = sim._neighborhood_predict(
        torch.from_numpy(sims), torch.from_numpy(ratings),
        torch.from_numpy(means), torch.tensor([3.0]), torch.tensor([5]), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # by hand: candidate 1, then 0, then 2 (5 is the query itself)
    picked = [1, 0, 2][:k]
    s, r, m = sims[0, picked], ratings[0, picked], means[picked]
    assert got.item() == pytest.approx(
        3.0 + float((s * (r - m)).sum() / np.abs(s).sum()), abs=1e-6)


def test_unknown_ids_bounds_and_arguments(small):
    X, y = small
    model = UserUserCF(n_neighbors=5, device="cpu").fit(X, y)
    preds = model.predict(pd.DataFrame({"user_id": [424242],
                                        "item_id": [X["item_id"].iloc[0]]}),
                          bound_ratings=False)
    np.testing.assert_allclose(preds, [float(np.mean(y))], atol=1e-5)
    assert model.predictions_possible == [False]
    assert model.predict(X.iloc[:0]) == []
    bounded = ItemItemCF(n_neighbors=5, min_rating=2.0, max_rating=3.0,
                         device="cpu").fit(X, y)
    assert all(2.0 <= p <= 3.0 for p in bounded.predict(X.iloc[:20]))
    with pytest.raises(ValueError, match="metric"):
        UserUserCF(similarity_metric="jaccard", device="cpu")
    with pytest.raises(NotImplementedError, match="slice 6"):
        ItemItemCF(mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="not fitted"):
        UserUserCF(device="cpu").predict(X.iloc[:3])


def test_prediction_chunks_cover_long_inputs(small, monkeypatch):
    """Chunks of the predictor's size, the last padded with -1: the
    results do not depend on where the chunks fall."""
    from matrix_factorization_tpu_torch.models import collaborative

    X, y = small
    model = ItemItemCF(n_neighbors=4, device="cpu").fit(X, y)
    pairs = pd.concat([X] * 3, ignore_index=True)
    whole = model.predict(pairs)
    monkeypatch.setattr(collaborative, "_PREDICT_CHUNK", 37)
    assert model.predict(pairs) == whole


def test_rating_matrix_and_cosine():
    u = torch.tensor([0, 2, 1])
    i = torch.tensor([1, 0, 1])
    R = sim.build_rating_matrix(u, i, torch.tensor([4.0, 2.0, 5.0]), 3, 2)
    assert R.tolist() == [[0.0, 4.0], [0.0, 5.0], [2.0, 0.0]]
    S = sim.cosine_rows(torch.tensor([[3.0, 4.0], [0.0, 0.0], [4.0, -3.0]]))
    np.testing.assert_allclose(S.numpy(), [[1, 0, 0], [0, 0, 0], [0, 0, 1]],
                               atol=1e-7)
