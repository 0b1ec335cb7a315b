"""The port's ``eval/hybrid_eval.py`` and ``eval/judge.py`` on the
single-device spec of ``tests/test_eval.py``, and held to the JAX package:
``evaluate_hybrid`` on a dense index of seeded unit rows (no ties) and on a
TF-IDF index gives JAX's metrics within 1e-9, and ``evaluate_case`` JAX's
report (floats within 1e-6). ``mesh=`` is held to the mesh-free call at
one rank."""

import numpy as np
import pytest

from matrix_factorization_tpu import KernelMF as JKernelMF
from matrix_factorization_tpu.core import checkpoint as jckpt
from matrix_factorization_tpu.eval import hybrid_eval as jhybrid
from matrix_factorization_tpu.eval import judge as jjudge
from matrix_factorization_tpu.retrieval import index as jindex
from matrix_factorization_tpu_torch import BaselineModel
from matrix_factorization_tpu_torch.core import checkpoint as ckpt
from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings
from matrix_factorization_tpu_torch.eval.hybrid_eval import evaluate_hybrid
from matrix_factorization_tpu_torch.eval.judge import (
    ItemEval,
    diversity_score,
    evaluate_case,
    keywords_judge,
    sanitize_violations,
)
from matrix_factorization_tpu_torch.eval.topk_eval import evaluate_topk
from matrix_factorization_tpu_torch.retrieval.encode import hash_embed
from matrix_factorization_tpu_torch.retrieval.index import build_dense_index, build_tfidf_index

TEXTS = [
    "title: grilled chicken salad\ningredients: chicken breast; lettuce\ndirections: grill 10 minutes",
    "title: peanut cookies\ningredients: peanut butter; sugar\ndirections: bake 12 minutes",
    "title: salmon pasta\ningredients: salmon; cream; pasta\ndirections: cook 20 minutes",
    "title: tofu bowl\ningredients: tofu; rice\ndirections: steam 15 minutes",
]
IDS = ["a", "b", "c", "d"]
HYBRID = dict(k=5, candidate_k=20, positive_threshold=3.0, n_test=2)


def _ratings():
    X, y = lowrank_ratings(n_users=40, n_items=30, density=0.5, seed=8)
    df = X.copy()
    df["rating"] = y.clip(lower=0.5)
    return df


def _item_texts(df):
    items = sorted(df["item_id"].unique())
    return [str(i) for i in items], [
        f"item text number {i} with words w{i} w{i%5}" for i in items]


def test_evaluate_topk_runs_and_bounds():
    df = _ratings()
    model = BaselineModel(method="als", n_epochs=10, reg=0.5, device="cpu").fit(
        df[["user_id", "item_id"]], df["rating"])
    res = evaluate_topk(df, model, k=5, positive_threshold=3.0, n_test=2, seed=0)
    assert res.n_users > 0
    for v in (res.precision, res.recall, res.ndcg):
        assert 0.0 <= v <= 1.0


@pytest.mark.parametrize("family", ["dense", "tfidf"])
def test_evaluate_hybrid_embedding_only(family):
    df = _ratings()
    ids, texts = _item_texts(df)
    index = (build_dense_index(ids, texts, hash_embed(texts)) if family == "dense"
             else build_tfidf_index(ids, texts, min_df=1))
    res = evaluate_hybrid(df, index, model=None, alpha=0.0, device="cpu", **HYBRID)
    assert res.n_users > 0
    assert 0.0 <= res.precision <= 1.0


def test_keywords_judge_scoring():
    ev = keywords_judge(query="chicken salad", item_id="a", text=TEXTS[0],
                        must_include=["chicken"], avoid=["peanut"])
    assert ev.relevance == 4.0  # 1 + 2 (must hit) + 1 (query hit)
    assert ev.violations == []
    ev2 = keywords_judge(query="chicken", item_id="b", text=TEXTS[1],
                         must_include=["chicken"], avoid=["peanut"])
    assert "contains_avoid_term" in ev2.violations
    assert "missing_must_include" in ev2.violations


def test_sanitize_violations_strips_inapplicable_labels():
    judged = [ItemEval("x", 3.0, ["missing_must_include", "contains_avoid_term"], "r")]
    out = sanitize_violations(judged, must_include=[], avoid=["p"])
    assert out[0].violations == ["contains_avoid_term"]


def test_diversity_score_range():
    assert diversity_score([TEXTS[0]]) == 1.0
    assert diversity_score([TEXTS[0], TEXTS[0]]) < 1.0
    for n in (2, 3, 4):
        assert diversity_score(TEXTS[:n]) == jjudge.diversity_score(TEXTS[:n])


def test_evaluate_case_keywords_with_must_include():
    """Regression for the reference's `_contains_any` NameError
    (evaluate_llm.py:181): keywords provider + non-empty must_include."""
    index = build_tfidf_index(IDS, TEXTS, min_df=1)
    rep = evaluate_case(index=index, query="chicken salad", k=2, candidate_k=4,
                        provider="keywords", must_include=["chicken"],
                        avoid=["peanut"], device="cpu")
    assert rep.n_after_filter >= 1
    assert rep.avg_relevance > 0
    assert rep.violation_rate == 0.0
    assert rep.to_jsonable()["items"]


def _recipes(n=30, seed=5):
    rng = np.random.default_rng(seed)
    words = ["chicken", "rice", "peanut", "salmon", "tofu", "beef", "egg",
             "noodle", "milk", "lettuce", "potato", "curry"]
    texts = []
    for i in range(n):
        ings = rng.choice(words, size=int(rng.integers(2, 5)), replace=False)
        texts.append(f"title: {ings[0]} dish {i}\ningredients: {'; '.join(ings)}\n"
                     f"directions: cook {int(rng.integers(5, 60))} minutes")
    return [f"r{i}" for i in range(n)], texts


def _same_report(got, want):
    """Equal reports, floats within 1e-6."""
    g, w = got.to_jsonable(), want.to_jsonable()
    for key in ("diversity", "avg_relevance", "violation_rate"):
        assert g.pop(key) == pytest.approx(w.pop(key), abs=1e-6), key
    for gi, wi in zip(g["items"], w["items"]):
        assert gi.pop("relevance") == pytest.approx(wi.pop("relevance"), abs=1e-6)
    assert g == w


@pytest.mark.parametrize("query, must, avoid, k", [
    ("chicken rice dinner", ["chicken"], ["peanut"], 5),
    ("salmon", [], ["milk"], 3),
    ("tofu curry bowl", [], [], 8),
])
def test_evaluate_case_matches_jax_dense(query, must, avoid, k):
    """Seeded unit rows: the query's sims are apart (asserted), so both
    packages retrieve the same candidates in the same order."""
    from matrix_factorization_tpu_torch.retrieval import search

    ids, texts = _recipes()
    emb = np.random.default_rng(7).normal(size=(len(ids), 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    index = build_dense_index(ids, texts, emb, normalize=False)
    sims = [s for _, _, s in search.search_topk_pos(
        index, search.encode_query_for_index(index, query), 21, device="cpu")]
    assert np.all(-np.diff(sims) > 1e-5)
    got = evaluate_case(index=index, query=query,
                        k=k, candidate_k=20, must_include=must, avoid=avoid,
                        device="cpu")
    want = jjudge.evaluate_case(index=jindex.build_dense_index(ids, texts, emb,
                                                               normalize=False),
                                query=query, k=k, candidate_k=20,
                                must_include=must, avoid=avoid)
    assert got.n_after_filter > 0
    _same_report(got, want)


def test_evaluate_case_matches_jax_tfidf():
    """The query hits one recipe and the filter keeps only it: the
    zero-score ties below it never reach the report."""
    got = evaluate_case(index=build_tfidf_index(IDS, TEXTS, min_df=1),
                        query="chicken salad", k=2, candidate_k=4,
                        must_include=["chicken"], avoid=["peanut"], device="cpu")
    want = jjudge.evaluate_case(index=jindex.build_tfidf_index(IDS, TEXTS, min_df=1),
                                query="chicken salad", k=2, candidate_k=4,
                                must_include=["chicken"], avoid=["peanut"])
    _same_report(got, want)


@pytest.fixture(scope="module")
def hybrid_inputs(tmp_path_factory):
    """Ratings, the JAX-fitted KernelMF and its port copy (checkpoint), a
    dense index of seeded unit rows in both packages, a TF-IDF index."""
    df = _ratings()
    ids, texts = _item_texts(df)
    emb = np.random.default_rng(11).normal(size=(len(ids), 24)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    jmodel = JKernelMF(n_factors=6, n_epochs=12, lr=0.03, reg=0.02,
                       batch_size=64, seed=0).fit(df[["user_id", "item_id"]],
                                                  df["rating"])
    path = tmp_path_factory.mktemp("hyb") / "ckpt"
    jckpt.save_model(jmodel, path)
    return {"df": df, "ids": ids, "texts": texts, "emb": emb, "jmodel": jmodel,
            "pmodel": ckpt.load_model(path, device="cpu")}


def _hybrid_pair(h, family, alpha, with_model, max_users=0):
    df, ids, texts = h["df"], h["ids"], h["texts"]
    if family == "dense":
        pidx = build_dense_index(ids, texts, h["emb"], normalize=False)
        jidx = jindex.build_dense_index(ids, texts, h["emb"], normalize=False)
    else:
        pidx = build_tfidf_index(ids, texts, min_df=1)
        jidx = jindex.build_tfidf_index(ids, texts, min_df=1)
    kw = dict(alpha=alpha, max_users=max_users, **HYBRID)
    got = evaluate_hybrid(df, pidx, model=h["pmodel"] if with_model else None,
                          device="cpu", **kw)
    want = jhybrid.evaluate_hybrid(df, jidx, model=h["jmodel"] if with_model
                                   else None, **kw)
    return got, want


@pytest.mark.parametrize("family, alpha, with_model, max_users", [
    ("dense", 0.0, False, 0), ("dense", 0.5, True, 0), ("dense", 0.5, True, 9),
    ("tfidf", 0.0, False, 0), ("tfidf", 0.0, False, 9)])
def test_evaluate_hybrid_matches_jax(hybrid_inputs, family, alpha, with_model,
                                     max_users):
    got, want = _hybrid_pair(hybrid_inputs, family, alpha, with_model, max_users)
    assert got.n_users == want.n_users > 0
    for name in ("precision", "recall", "ndcg"):
        assert getattr(got, name) == pytest.approx(getattr(want, name), abs=1e-9)


def test_dense_profile_topk_has_no_ties(hybrid_inputs):
    """The dense case above is tie-free: every profile's sims are apart by
    more than 1e-5 (so both packages order the candidates alike)."""
    from matrix_factorization_tpu_torch.eval.hybrid_eval import _profile_topk

    h = hybrid_inputs
    idx = build_dense_index(h["ids"], h["texts"], h["emb"], normalize=False)
    profiles = [h["emb"][j:j + 3].mean(axis=0) for j in range(0, 27, 3)]
    sims, pos = _profile_topk(idx, profiles, k=len(h["ids"]), device="cpu")
    assert np.all(-np.diff(sims, axis=1) > 1e-5)
    jsims, jpos = jhybrid._profile_topk(
        jindex.build_dense_index(h["ids"], h["texts"], h["emb"], normalize=False),
        profiles, k=len(h["ids"]))
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    np.testing.assert_allclose(sims, np.asarray(jsims), atol=1e-6)


@pytest.mark.parametrize("family", ["dense", "tfidf"])
def test_evaluate_hybrid_mesh_names_slice_6(family):
    """JAX's mesh-sharded candidate scoring (``mesh=``) at one rank, a gloo
    world of this process alone: the dense index gives the mesh-free
    metrics exactly; the TF-IDF index, whose mesh path scores on the
    device under ``stable_topk``'s tie rule while the mesh-free path is
    JAX's host product and ``argsort``, within JAX's 0.05
    (``tests/test_eval.py:132``), the same users. Wider meshes:
    ``tests/test_torch_parallel_retrieval.py``."""
    from matrix_factorization_tpu_torch.parallel.launch import world_of_one
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    df = _ratings()
    ids, texts = _item_texts(df)
    index = (build_dense_index(ids, texts, hash_embed(texts)) if family == "dense"
             else build_tfidf_index(ids, texts, min_df=1))
    want = evaluate_hybrid(df, index, model=None, alpha=0.0, device="cpu", **HYBRID)
    with world_of_one():
        got = evaluate_hybrid(df, index, model=None, alpha=0.0, mesh=make_mesh(1),
                              device="cpu", **HYBRID)
    assert got.n_users == want.n_users > 0
    if family == "dense":
        assert got == want
    else:
        np.testing.assert_allclose([got.precision, got.recall, got.ndcg],
                                   [want.precision, want.recall, want.ndcg],
                                   atol=0.05)
