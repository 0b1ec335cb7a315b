"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (``matrix_factorization_tpu``), at run time or in its sources."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "matrix_factorization_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "matrix_factorization_tpu"}

_DRIVE = r"""
import sys, tempfile
import numpy as np
import matrix_factorization_tpu_torch as mf
from matrix_factorization_tpu_torch.core.ids import IdVocab

m = mf.KernelMF(n_factors=6, kernel="rbf", device="cpu")
cfg = m._cfg()
rng = np.random.default_rng(0)
P = np.zeros((8, cfg.padded_factors), np.float32)
Q = np.zeros((8, cfg.padded_factors), np.float32)
P[:, :6] = rng.normal(size=(8, 6))
Q[:, :6] = rng.normal(size=(8, 6))
m.user_vocab, m.item_vocab = IdVocab(range(8)), IdVocab("abcdefgh")
m._params = mf.params_from_numpy(P, Q, 3.0, device="cpu", cfg=cfg)
with tempfile.TemporaryDirectory() as d:
    mf.save_model(m, d + "/ckpt")
    back = mf.load_model(d + "/ckpt", device="cpu")
assert len(back.recommend(3, amount=4)) == 4
assert len(back.recommend_batch([1, 2], amount=3)) == 6
co = mf.CoalescingRecommender(back)
assert len(co.recommend(5, amount=2)) == 2
co.close()
import pandas as pd
X = pd.DataFrame({"user_id": np.arange(60) % 9, "item_id": np.arange(60) // 9})
t = mf.KernelMF(n_factors=6, n_epochs=2, batch_size=16, device="cpu")
t.fit(X, pd.Series(rng.uniform(1, 5, 60)))
t.update_users(X.iloc[::9][:5].assign(user_id=99), pd.Series(np.ones(5)), n_epochs=1)
assert len(t.train_rmse) == 1
a = mf.KernelMF(n_factors=4, n_epochs=2, method="als", reg=0.1, device="cpu")
a.fit(X, pd.Series(rng.uniform(1, 5, 60)))
a.update_users(X.iloc[::9][:5].assign(user_id=98), pd.Series(np.ones(5)))
w = mf.KernelMF(n_factors=4, n_epochs=1, kernel="sigmoid", als_warm_start=1,
                batch_size=16, device="cpu")
w.fit(X, pd.Series(rng.uniform(1, 5, 60)))
im = mf.ImplicitALS(n_factors=4, n_epochs=2, device="cpu")
im.fit(X, pd.Series(rng.uniform(0, 3, 60)))
im.update_users(X.iloc[::9][:3].assign(user_id=97), pd.Series(np.ones(3)))
assert len(a.train_rmse) == 2 and len(im.train_loss) == 2
assert len(im.recommend(97, amount=2)) == 2
ry = pd.Series(rng.uniform(1, 5, 60))
for method in ("sgd", "als"):
    b = mf.BaselineModel(method=method, n_epochs=2, batch_size=16, device="cpu")
    b.fit(X, ry).update_users(X.iloc[::9][:4].assign(user_id=96), ry.iloc[:4])
    assert len(b.recommend(96, amount=3)) == 3
for cls in (mf.UserUserCF, mf.ItemItemCF):
    assert len(cls(n_neighbors=3, device="cpu").fit(X, ry).predict(X)) == 60
feats = pd.DataFrame({"item_id": range(7), "g0": [1.0, 0, 1, 0, 1, 0, 1]})
c = mf.ContentBasedRecommender(predict_mode="similarity", device="cpu")
assert len(c.fit(X, ry, item_features=feats).predict(X)) == 60
g, res = mf.grid_search_kernel_mf(X, ry, X, ry, lrs=[0.01], regs=[0.1, 0.2],
                                  n_epochs=1, n_factors=4, batch_size=16,
                                  device="cpu")
assert len(res) == 2 and len(g.recommend(1, amount=2)) == 2
with tempfile.TemporaryDirectory() as d:
    X.assign(rating=ry).to_csv(d + "/r.csv", index=False)
    assert mf.load_ratings_csv(d + "/r.csv").backend == "native"
for cls in (mf.TopKItemItemCF, mf.TopKUserUserCF):
    assert len(cls(n_neighbors=3, device="cpu").fit(X, ry).predict(X)) == 60
e = mf.EASE(reg=5.0, device="cpu").fit(X, ry)
assert len(e.recommend(1, amount=2)) == 2
with tempfile.TemporaryDirectory() as d:
    mf.save_model(e, d + "/ease")
    assert len(mf.load_model(d + "/ease", device="cpu").predict(X)) == 60
ge, res = mf.grid_search_ease(X, ry, regs=[1.0, 10.0], device="cpu")
assert len(res) == 2
fams = [mf.BPR(n_factors=4, n_epochs=2, batch_size=16, device="cpu").fit(X),
        mf.SVDpp(n_factors=4, n_epochs=2, batch_size=16, device="cpu").fit(X, ry),
        mf.NMF(n_factors=4, n_epochs=2, batch_size=16, device="cpu").fit(X, ry),
        mf.Popularity(score="mean").fit(X, ry)]
assert fams[0].auc(X.iloc[:10], n_neg=3) >= 0
for m in fams:
    m.update_users(X.iloc[::9][:4].assign(user_id=95), ry.iloc[:4])
    assert len(m.recommend_batch([1, 95], amount=2)) == 4
    with tempfile.TemporaryDirectory() as d:
        mf.save_model(m, d + "/m")
        back = mf.load_model(d + "/m", device="cpu")
        assert back.predict(X.iloc[:5]) == m.predict(X.iloc[:5])
import json, pickle, random, threading, urllib.request
from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings
from matrix_factorization_tpu_torch.utils.metrics import rmse, topk_report
from matrix_factorization_tpu_torch.retrieval import index as rix, search
from matrix_factorization_tpu_torch.retrieval.encode import hash_embed
from matrix_factorization_tpu_torch.retrieval.sparse_scoring import tfidf_batch_topk
from matrix_factorization_tpu_torch.rank import filters, diversity, hybrid
from matrix_factorization_tpu_torch.rank import recipe_features as rf
from matrix_factorization_tpu_torch.rank import reranker as rr
from matrix_factorization_tpu_torch.serve.service import RecommendService
from matrix_factorization_tpu_torch.serve.planner import PlanRequest, plan_meals
from matrix_factorization_tpu_torch.serve.api import serve
Xs, ys = lowrank_ratings(n_users=12, n_items=10, seed=1)
assert rmse(ys, ys) == 0.0 and topk_report({1: [2]}, {1: {2}}, 1)["precision"] == 1.0
texts = [f"title: dish {i}\ningredients: egg; rice; p{i % 3}\ndirections: fry {i + 5} minutes"
         for i in range(12)]
ids = [f"r{i}" for i in range(12)]
dense = rix.build_dense_index(ids, texts, hash_embed(texts, dim=64))
tf = rix.build_tfidf_index(ids, texts, min_df=1)
assert len(search.search_topk(dense, search.encode_query_for_index(dense, "dish 3"), 4, device="cpu")) == 4
assert tfidf_batch_topk(tf, ["egg rice", "p1"], 3, vocab_block=4, device="cpu")[1].shape == (2, 3)
cands = search.search_topk_pos(dense, search.encode_query_for_index(dense, "rice"), 6, device="cpu")
cands = filters.apply_hard_filters(cands, texts, avoid_terms=rf.expand_avoid_terms(["milk"], enable=True))
feats = [rr.featurize(q, texts[p], s) for q in rr.generate_queries(texts[0], random.Random(0))
         for p, _, s in cands]
clf = rr.TorchLogisticRegression(max_iter=5, device="cpu").fit(
    np.vstack(feats), np.arange(len(feats)) % 2)
mlp = rr.TorchMLPReranker(hidden=4, max_iter=3, device="cpu").fit(
    np.vstack(feats), np.arange(len(feats)) % 2)
assert diversity.select_diverse_greedy(base_score=np.ones(3), cand_sets=[{"a"}, {"a"}, {"b"}],
                                       n=2, diversity_penalty=1.0)[0] == [0, 2]
with tempfile.TemporaryDirectory() as d:
    rix.save_item_index(dense, d + "/item_index.pkl")
    X2 = pd.DataFrame({"user_id": np.arange(48) // 8, "item_id": [ids[j % 12] for j in range(48)]})
    with open(d + "/model.pkl", "wb") as f:
        pickle.dump(mf.KernelMF(n_factors=3, n_epochs=1, batch_size=16, device="cpu").fit(
            X2, pd.Series(rng.uniform(1, 5, 48))), f)
    with open(d + "/reranker.pkl", "wb") as f:
        pickle.dump({"model": clf}, f)
    svc = RecommendService.from_artifacts(d, device="cpu")
    assert svc.health()["has_model"] and svc.health()["has_reranker"]
    res = svc.recommend("egg rice", user_id=1, k=3)
    assert len(res) == 3 and res[0]["reason"].startswith("hybrid")
    assert hybrid.model_scores(svc.model, 1, ids[:3]).any()
    assert plan_meals(svc, PlanRequest(meals=["早餐"], per_meal_k=2, user_id=1))
    httpd = serve(svc, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/health") as r:
        assert json.loads(r.read())["n_items"] == 12
    httpd.shutdown()
    httpd.server_close()
from matrix_factorization_tpu_torch.utils.profiling import Timer, trace
from matrix_factorization_tpu_torch.eval import evaluator, hybrid_eval, judge, topk_eval
from matrix_factorization_tpu_torch.serve import app
from matrix_factorization_tpu_torch.pipeline import (
    build_item_embeddings, build_recipe_metadata, build_structured_features,
    build_text_enrichment, build_tfidf_index, common, download_movielens_small,
    evaluate, evaluate_hybrid, evaluate_llm, export_artifacts, prepare_data,
    prepare_recipes, prepare_steam, run_all, train, train_reranker)
with tempfile.TemporaryDirectory() as d:
    with trace(d + "/tr"), Timer() as t:
        sys.argv = ["run_all", "--root", d + "/w", "--synthetic", "--epochs", "1",
                    "--skip-reranker", "--platform", "cpu"]
        run_all.main()
    ev = X.assign(rating=ry.to_numpy())
    assert topk_eval.evaluate_topk(ev, b, k=3, positive_threshold=1.0).n_users > 0
    assert hybrid_eval.evaluate_hybrid(ev.assign(item_id=ev["item_id"].map(lambda j: ids[j])),
                                       dense, alpha=0.0, k=3, candidate_k=5,
                                       positive_threshold=1.0, device="cpu").n_users > 0
    assert judge.evaluate_case(index=dense, query="egg rice", k=3, device="cpu").items
print("\n".join(sorted(sys.modules)))
"""


def _top(name: str) -> str:
    return name.split(".")[0]


def test_port_runs_without_jax_modules():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(PORT.parent)
    proc = subprocess.run([sys.executable, "-c", _DRIVE], capture_output=True,
                          text=True, env=env, cwd=PORT.parent, timeout=240)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "matrix_factorization_tpu_torch.serve.coalesce" in loaded
    assert "matrix_factorization_tpu_torch.ops.cuda_sgd" in loaded
    assert "matrix_factorization_tpu_torch.ops.cuda_spd" in loaded
    for name in ("ops.segment_sum", "ops.als", "ops.similarity", "ops.sweep",
                 "models.baseline", "models.collaborative",
                 "models.content_based", "models.grid_search", "data.loader",
                 "ops.sparse_gram", "models.cf_topk", "ops.ease", "models.ease",
                 "ops.bpr", "models.bpr", "ops.svdpp", "models.svdpp",
                 "ops.nmf", "models.nmf", "models.popularity",
                 "data.synthetic", "utils.metrics", "core.artifacts",
                 "retrieval.encode", "retrieval.index", "retrieval.search",
                 "retrieval.sparse_scoring", "rank.recipe_features",
                 "rank.filters", "rank.diversity", "rank.hybrid",
                 "rank.reranker", "serve.service", "serve.planner",
                 "serve.api", "utils.profiling", "eval.topk_eval",
                 "eval.evaluator", "eval.judge", "eval.hybrid_eval",
                 "serve.app", "pipeline.common", "pipeline.run_all",
                 "pipeline.train", "pipeline.evaluate",
                 "pipeline.evaluate_hybrid", "pipeline.evaluate_llm",
                 "pipeline.train_reranker", "pipeline.export_artifacts",
                 "pipeline.build_item_embeddings", "pipeline.prepare_recipes",
                 "pipeline.prepare_steam", "pipeline.prepare_data"):
        assert f"matrix_factorization_tpu_torch.{name}" in loaded
    bad = sorted(m for m in loaded if _top(m) in FORBIDDEN)
    assert not bad, bad


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    PORT.parent / "chip_smoke.py"], ids=lambda p: str(p.relative_to(PORT.parent)))
def test_sources_import_no_jax(path):
    bad = [m for m in _imports(path) if _top(m) in FORBIDDEN]
    assert not bad, (path, bad)
