"""The port's rank layer (recipe features, hard filters, diversity, hybrid
blend, reranker) against the JAX package's on the same inputs.

The host copies must give equal outputs. The two rerankers train with
``torch.optim.Adam`` where JAX uses optax's Adam (the same update, other
rounding): the logistic regression from zeros is held to JAX's ``coef_`` /
``intercept_`` within 1e-3 (relative 1e-3) after 300 full-batch steps; the
MLP, started from JAX's own first weights, is held to JAX's
``decision_function`` within 2e-4 after 20 steps. Its objective is not
convex and Adam normalizes small gradients, so the two roundings drift
apart as the steps go on."""

import dataclasses
import random

import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu.rank import diversity as jdiv
from matrix_factorization_tpu.rank import filters as jfilters
from matrix_factorization_tpu.rank import hybrid as jhybrid
from matrix_factorization_tpu.rank import recipe_features as jrf
from matrix_factorization_tpu.rank import reranker as jrr
from matrix_factorization_tpu_torch import KernelMF
from matrix_factorization_tpu_torch.core.artifacts import reranker_from_numpy
from matrix_factorization_tpu_torch.rank import diversity, filters, hybrid
from matrix_factorization_tpu_torch.rank import recipe_features as rf
from matrix_factorization_tpu_torch.rank import reranker as rr

TEXTS = [
    "title: grilled chicken salad\ningredients: chicken breast; lettuce; olive oil\ndirections: grill chicken 10-15 minutes and toss",
    "title: peanut butter cookies\ningredients: peanut butter; sugar; flour; eggs\ndirections: bake 12 minutes",
    "title: creamy salmon pasta\ningredients: salmon; cream; pasta; cheese\ndirections: cook pasta 1 hour",
    "title: tofu stir fry\ningredients: tofu; soy sauce; broccoli\ndirections: fry tofu 5 minutes",
    "title: walnut brownies\ningredients: walnut; chocolate; butter; sugar\ndirections: bake 30 minutes",
    "title: light steamed cod\ningredients: cod, low-fat yogurt，lemon；dill\ndirections: steam 2 hours then rest 5 mins",
    "title: mystery\ningredients: \ndirections: ",
    "no structure at all, just words: milk nuts",
]
IDS = ["a", "b", "c", "d", "e", "f", "g", "h"]
QUERIES = ["high protein lunch under 20 minutes", "dinner under 10 minutes",
           "low calorie breakfast no dairy", "low protein snack", "",
           "ready in 45 minutes chicken", "protein shake", "x " * 30]
META = pd.DataFrame(
    {"time_min": [15, 12, 60, 5, 30, None, 8, 3],
     "protein_score": [3.0, 0.0, 2.0, 2.5, 0.0, 1.0, None, 4.0],
     "low_calorie_score": [2.0, 0.0, 0.0, 1.5, 0.0, 3.0, 1.0, None]},
    index=IDS)


@pytest.mark.parametrize("fn", [
    "extract_ingredient_phrases", "extract_directions_text",
    "extract_time_minutes", "featurize_item_text"])
def test_text_parsers_equal(fn):
    for t in TEXTS + [None, ""]:
        assert getattr(rf, fn)(t) == getattr(jrf, fn)(t)


def test_flags_scores_and_terms_equal():
    for t in TEXTS:
        ings = jrf.extract_ingredient_phrases(t)
        assert dataclasses.astuple(rf.compute_flags(ings)) == \
            dataclasses.astuple(jrf.compute_flags(ings))
        assert rf.compute_protein_score(ings) == jrf.compute_protein_score(ings)
        d = jrf.extract_directions_text(t)
        assert rf.compute_low_calorie_score(ingredients=ings, directions=d) \
            == jrf.compute_low_calorie_score(ingredients=ings, directions=d)
    for q in QUERIES:
        assert rf.parse_query_intent(q) == jrf.parse_query_intent(q)
        assert filters.parse_time_constraint_from_query(q) \
            == jfilters.parse_time_constraint_from_query(q)
        assert rf.split_terms(q) == jrf.split_terms(q)
    for terms in (["milk"], ["nuts", "peanut"], ["Nut", " dairy "], [], ["egg"]):
        for enable in (True, False):
            assert rf.expand_avoid_terms(terms, enable=enable) \
                == jrf.expand_avoid_terms(terms, enable=enable)
    sets = [set(), {"a"}, {"a", "b"}, {"b", "c", "d"}]
    for a in sets:
        for b in sets:
            assert rf.jaccard(a, b) == jrf.jaccard(a, b)


def test_hard_filters_equal():
    cands = [(i, IDS[i], 1.0 - 0.1 * i) for i in range(len(IDS))]
    cases = [
        dict(avoid_terms=["peanut"], meta=META, max_time_min=30,
             require_high_protein=True),
        dict(must_terms=["tofu"]),
        dict(avoid_terms=rf.expand_avoid_terms(["milk"], enable=True),
             meta=META, require_low_calorie=True),
        dict(meta=None, max_time_min=10, require_high_protein=True),
        dict(),
    ]
    for kw in cases:
        got = filters.apply_hard_filters(cands, TEXTS, **kw)
        assert got == jfilters.apply_hard_filters(cands, TEXTS, **kw)
    got = [c[1] for c in filters.apply_hard_filters(
        cands[:5], TEXTS, avoid_terms=["peanut"], meta=META, max_time_min=30,
        require_high_protein=True)]
    assert "b" not in got and "c" not in got and "a" in got and "d" in got


def test_diversity_equal():
    rng = np.random.default_rng(0)
    sets = [jrf.extract_ingredient_phrases(t) for t in TEXTS] + \
        [{"a", "b"}, {"a", "b"}, {"c", "d"}, set()]
    for trial in range(6):
        scores = rng.uniform(size=len(sets))
        carried = [{"a", "b"}] if trial % 2 else None
        for n in (0, 1, 3, len(sets) + 2):
            kw = dict(base_score=scores, cand_sets=sets, n=n,
                      diversity_penalty=float(trial) / 3)
            # each call extends the carried list it is given: one copy each
            assert diversity.select_diverse_greedy(
                **kw, already_selected_sets=carried and list(carried)) == \
                jdiv.select_diverse_greedy(
                    **kw, already_selected_sets=carried and list(carried))
    sel, _ = diversity.select_diverse_greedy(
        base_score=np.array([1.0, 0.99, 0.5]),
        cand_sets=[{"a", "b"}, {"a", "b"}, {"c", "d"}], n=2,
        diversity_penalty=1.0)
    assert sel == [0, 2]


def test_hybrid_equal_and_model_scores_call_the_port():
    for x in (np.array([2.0, 2.0]), np.array([0.0, 10.0, 3.0]), np.array([])):
        np.testing.assert_array_equal(hybrid.minmax(x), jhybrid.minmax(x))
    a, b = np.array([0.0, 10.0, 4.0]), np.array([1.0, 0.0, 0.5])
    np.testing.assert_array_equal(hybrid.blend(a, b, 0.3), jhybrid.blend(a, b, 0.3))
    cands = [("x", 0.9), ("y", 0.5), ("z", 0.1)]
    assert hybrid.hybrid_rank(cands, None, None, 0.5, 2) == \
        jhybrid.hybrid_rank(cands, None, None, 0.5, 2)

    rng = np.random.default_rng(1)
    X = pd.DataFrame({"user_id": rng.integers(0, 6, 80),
                      "item_id": rng.integers(0, 12, 80)}).drop_duplicates()
    y = pd.Series(rng.uniform(1, 5, len(X)))
    m = KernelMF(n_factors=3, n_epochs=3, batch_size=16, device="cpu").fit(X, y)
    items = [0, 3, 99, 5]
    ms = hybrid.model_scores(m, 2, items)
    want = m.predict(pd.DataFrame({"user_id": [2] * 4, "item_id": items}),
                     bound_ratings=False)
    np.testing.assert_array_equal(ms, np.asarray(want, np.float32))
    assert ms.any()
    np.testing.assert_array_equal(hybrid.model_scores(m, "ghost", items), 0.0)
    np.testing.assert_array_equal(hybrid.model_scores(None, 2, items), 0.0)
    ranked = hybrid.hybrid_rank([(i, 0.1 * n) for n, i in enumerate(items)],
                                m, 2, 0.5, 3)
    assert len(ranked) == 3


def test_featurize_and_keyword_overlap_exact():
    for q in QUERIES:
        for pos, t in enumerate(TEXTS):
            assert rr.keyword_overlap(q, t) == jrr.keyword_overlap(q, t)
            for meta_row in (None, META.iloc[pos], pd.Series({"time_min": "x"})):
                got = rr.featurize(q, t, 0.37, meta_row)
                want = jrr.featurize(q, t, 0.37, meta_row)
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert rr.FEATURE_NAMES == jrr.FEATURE_NAMES


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_queries_equal(seed):
    a, b = random.Random(seed), random.Random(seed)
    for t in TEXTS * 2:
        assert rr.generate_queries(t, a) == jrr.generate_queries(t, b)


def _separable(n=400, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    w_true = np.zeros(d)
    w_true[:3] = [2.0, -1.0, 0.5]
    y = (X @ w_true + 0.1 * rng.normal(size=n) > 0).astype(np.int32)
    return X, y


def test_logistic_regression_matches_jax():
    X, y = _separable()
    X[:, 3] = X[:, 3] * 50 + 7  # a badly scaled column: standardization
    got = rr.TorchLogisticRegression(max_iter=300, device="cpu").fit(X, y)
    want = jrr.JaxLogisticRegression(max_iter=300).fit(X, y)
    np.testing.assert_allclose(got._mean, want._mean, rtol=1e-6)
    np.testing.assert_allclose(got._scale, want._scale, rtol=1e-6)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.intercept_, want.intercept_, rtol=1e-3, atol=1e-3)
    assert got.coef_.shape == (1, 5) and got.intercept_.shape == (1,)
    np.testing.assert_allclose(got.predict_proba(X), want.predict_proba(X), atol=1e-3)
    assert (got.predict(X) == y).mean() > 0.95
    np.testing.assert_allclose(got.predict_proba(X).sum(axis=1), 1.0, atol=1e-5)


def _jax_initial(d, hidden, seed):
    """JAX's first MLP weights, drawn as ``JaxMLPReranker.fit`` draws them."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {
        "w1": np.asarray(jax.random.normal(k1, (d, hidden), jnp.float32)
                         * (2.0 / d) ** 0.5),
        "b1": np.zeros((hidden,), np.float32),
        "w2": np.asarray(jax.random.normal(k2, (hidden,), jnp.float32)
                         * (1.0 / hidden) ** 0.5),
        "b2": np.float32(0.0),
    }


@pytest.mark.parametrize("val_frac", [0.0, 0.25])
def test_mlp_from_jax_initial_weights_matches_jax(val_frac):
    rng = np.random.default_rng(1)
    X = rng.normal(0, 1, (300, 4)).astype(np.float32)
    y = ((X[:, 0] * X[:, 1]) > 0).astype(np.int32)
    kw = dict(hidden=16, max_iter=20, lr=0.02, seed=3, val_frac=val_frac)
    want = jrr.JaxMLPReranker(**kw).fit(X, y)
    got = rr.TorchMLPReranker(**kw, device="cpu").fit(
        X, y, init_params=_jax_initial(4, 16, 3))
    np.testing.assert_allclose(got.decision_function(X),
                               want.decision_function(X), atol=2e-4)
    np.testing.assert_allclose(got.predict_proba(X), want.predict_proba(X),
                               atol=2e-4)
    for k in ("w1", "b1", "w2", "b2"):
        assert np.asarray(got._params[k]).shape == np.asarray(want._params[k]).shape


def test_mlp_default_draws_are_seeded_and_learn():
    rng = np.random.default_rng(1)
    X = rng.normal(0, 1, (600, 4)).astype(np.float32)
    y = ((X[:, 0] * X[:, 1]) > 0).astype(np.int32)
    a = rr.TorchMLPReranker(hidden=16, max_iter=600, lr=0.05, device="cpu")
    b = rr.TorchMLPReranker(hidden=16, max_iter=600, lr=0.05, device="cpu")
    np.testing.assert_array_equal(a.initial_params(4)["w1"], b.initial_params(4)["w1"])
    a.fit(X, y)
    assert (a.predict(X) == y).mean() > 0.9  # the XOR that logreg cannot fit


def test_rerank_scores_with_jax_state():
    """A reranker built from the JAX model's numpy state scores as JAX's."""
    X, y = _separable(d=len(jrr.FEATURE_NAMES), n=200, seed=2)
    jm = jrr.JaxLogisticRegression(max_iter=50).fit(X, y)
    pm = reranker_from_numpy("logreg", {
        k: getattr(jm, k) for k in ("coef_", "intercept_", "_mean", "_scale")})
    rows = [(t, 0.1 * n) for n, t in enumerate(TEXTS)]
    meta_map = {i: META.loc[i] for i in IDS[:4]}
    for q in QUERIES[:4]:
        got = rr.rerank_scores({"model": pm}, q, rows, meta_map, IDS)
        want = jrr.rerank_scores({"model": jm}, q, rows, meta_map, IDS)
        np.testing.assert_array_equal(got, want)
    X2 = np.random.default_rng(5).normal(size=(50, 4)).astype(np.float32)
    jmlp = jrr.JaxMLPReranker(hidden=8, max_iter=20).fit(X2, (X2[:, 0] > 0).astype(int))
    pmlp = reranker_from_numpy("mlp", {k: getattr(jmlp, k)
                                       for k in ("_params", "_mean", "_scale")})
    np.testing.assert_array_equal(pmlp.decision_function(X2),
                                  jmlp.decision_function(X2))
    with pytest.raises(ValueError, match="no attribute"):
        reranker_from_numpy("logreg", {"weights": 1})
