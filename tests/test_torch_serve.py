"""The port's serving (service core, stdlib HTTP API, meal planner) on the
specs of ``tests/test_serve_checkpoint.py``, and crossed with the JAX
package: a service whose index and reranker the JAX package wrote and
whose model came from a JAX checkpoint gives JAX's ``recommend`` ids and
scores (within 1e-5) and JAX's ``plan_meals`` rows; a JAX-pickled
``model.pkl`` degrades to retrieval only without importing JAX."""

import json
import os
import pickle
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu import KernelMF as JKernelMF
from matrix_factorization_tpu.core import checkpoint as jckpt
from matrix_factorization_tpu.pipeline.train_reranker import train_reranker
from matrix_factorization_tpu.rank.recipe_features import featurize_item_text
from matrix_factorization_tpu.retrieval import index as jindex
from matrix_factorization_tpu.retrieval.encode import hash_embed
from matrix_factorization_tpu.serve import planner as jplanner
from matrix_factorization_tpu.serve.service import RecommendService as JService
from matrix_factorization_tpu_torch import BaselineModel
from matrix_factorization_tpu_torch.core import checkpoint as ckpt
from matrix_factorization_tpu_torch.core.artifacts import load_pickle
from matrix_factorization_tpu_torch.rank.reranker import TorchLogisticRegression
from matrix_factorization_tpu_torch.retrieval.index import build_tfidf_index, save_item_index
from matrix_factorization_tpu_torch.serve.api import serve
from matrix_factorization_tpu_torch.serve.planner import (
    PlanRequest,
    build_query_from_needs,
    plan_meals,
)
from matrix_factorization_tpu_torch.serve.service import RecommendService

TEXTS = [
    "title: grilled chicken bowl\ningredients: chicken breast; rice\ndirections: grill 15 minutes",
    "title: peanut noodles\ningredients: peanut butter; noodle\ndirections: boil 10 minutes",
    "title: salmon salad\ningredients: salmon; lettuce\ndirections: bake 20 minutes",
    "title: tofu curry\ningredients: tofu; curry; rice\ndirections: simmer 25 minutes",
    "title: beef stew\ningredients: beef; potato; carrot\ndirections: cook 2 hours",
    "title: egg fried rice\ningredients: egg; rice; soy sauce\ndirections: fry 8 minutes",
]
IDS = ["r1", "r2", "r3", "r4", "r5", "r6"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    art = root / "artifacts"
    art.mkdir()
    save_item_index(build_tfidf_index(IDS, TEXTS, min_df=1), art / "item_index.pkl")
    rng = np.random.default_rng(0)
    n = 60
    X = pd.DataFrame({"user_id": rng.integers(0, 10, n),
                      "item_id": [IDS[j % len(IDS)] for j in range(n)]}
                     ).drop_duplicates()
    y = pd.Series(rng.uniform(1, 5, len(X)))
    model = BaselineModel(method="als", n_epochs=5, device="cpu").fit(X, y)
    with (art / "model.pkl").open("wb") as f:
        pickle.dump(model, f)
    return art


def test_service_health_and_recommend(artifacts):
    svc = RecommendService.from_artifacts(artifacts, device="cpu")
    h = svc.health()
    assert h["status"] == "ok" and h["index_type"] == "tfidf"
    assert h["has_model"]
    res = svc.recommend("grilled chicken rice", user_id=0, k=3, alpha=0.5)
    assert len(res) == 3
    assert res[0]["item_id"] == "r1"
    assert "hybrid" in res[0]["reason"]
    res2 = svc.recommend("peanut noodles", k=2)
    assert res2[0]["item_id"] == "r2"
    assert res2[0]["reason"] == "embedding similarity recall"


def test_missing_artifacts_actionable_error(tmp_path):
    with pytest.raises(FileNotFoundError, match="build_tfidf_index"):
        RecommendService.from_artifacts(tmp_path, device="cpu")


def test_device_none_raises_without_gpu(artifacts):
    """``device=None`` means CUDA: without a GPU the service does not
    start, instead of loading the model nowhere and degrading."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RecommendService.from_artifacts(artifacts)


def _post(url, body):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _status(url, body=None):
    try:
        if body is None:
            urllib.request.urlopen(url)
        else:
            urllib.request.urlopen(urllib.request.Request(url, data=body))
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_http_api(artifacts):
    svc = RecommendService.from_artifacts(artifacts, device="cpu")
    httpd = serve(svc, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health") as r:
            assert json.loads(r.read())["status"] == "ok"
        out = _post(f"{base}/recommend",
                    json.dumps({"query": "salmon salad", "k": 2}).encode())
        assert out["results"][0]["item_id"] == "r3"
        assert _status(f"{base}/recommend", b"{}") == 422  # missing query
        assert _status(f"{base}/recommend",
                       json.dumps({"query": "x", "k": 999}).encode()) == 422
        assert _status(f"{base}/recommend", b"{not json") == 422
        assert _status(f"{base}/nope") == 404
        assert _status(f"{base}/nope", b"{}") == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_http_batch_and_plan_endpoints(artifacts):
    svc = RecommendService.from_artifacts(artifacts, device="cpu")
    httpd = serve(svc, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = _post(f"{base}/recommend_batch", json.dumps(
            {"queries": ["salmon salad", "tofu curry"], "k": 2}).encode())
        assert out["results"][0][0]["item_id"] == "r3"
        assert out["results"][1][0]["item_id"] == "r4"
        plan = _post(f"{base}/plan", json.dumps(
            {"meals": ["午餐"], "per_meal_k": 2, "avoid": ["peanut"],
             "use_reranker": False}).encode())["plan"]
        assert plan and all(row["item_id"] != "r2" for row in plan)
        assert _status(f"{base}/plan", json.dumps({"nope": 1}).encode()) == 422
        assert _status(f"{base}/recommend_batch", b'{"queries": []}') == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
    t.join(timeout=10)


def test_planner_daily_plan(artifacts):
    svc = RecommendService.from_artifacts(artifacts, device="cpu")
    req = PlanRequest(goal="", meals=["早餐", "午餐"], avoid=["peanut"],
                      per_meal_k=2, candidate_k=6, use_reranker=False,
                      strict_filters=True)
    rows = plan_meals(svc, req)
    assert rows, "planner returned no rows"
    assert all(r["item_id"] != "r2" for r in rows)  # peanut filtered
    assert {r["meal"] for r in rows} <= {"早餐", "午餐"}
    ids = [r["item_id"] for r in rows]
    assert len(ids) == len(set(ids))  # cross-meal diversity: no repeat


def test_build_query_from_needs_matches_jax():
    cases = [
        dict(goal="增肌/高蛋白", meal_type="午餐", cuisines=["日式"],
             dietary=["素食"], must_include=["tofu"], avoid=["milk"],
             max_time_min=30),
        dict(),
        dict(goal="something else", meal_type="brunch", extra="  spicy "),
    ]
    for kw in cases:
        assert build_query_from_needs(**kw) == jplanner.build_query_from_needs(**kw)
    q = build_query_from_needs(**cases[0])
    assert "high protein" in q and "ready in 30 minutes" in q
    assert PlanRequest.__dataclass_fields__.keys() == \
        jplanner.PlanRequest.__dataclass_fields__.keys()


def test_service_degrades_on_corrupt_model(tmp_path):
    art = tmp_path / "artifacts"
    art.mkdir()
    save_item_index(build_tfidf_index(IDS, TEXTS, min_df=1), art / "item_index.pkl")
    (art / "model.pkl").write_bytes(b"not a pickle at all")
    svc = RecommendService.from_artifacts(art, device="cpu")
    assert svc.health()["has_model"] is False
    assert svc.recommend("salmon salad", k=2)[0]["item_id"] == "r3"


def test_service_model_exception_falls_back_to_zeros(artifacts):
    class Exploding:
        def contains_user(self, u):
            return True

        def predict(self, X, bound_ratings=True):
            raise RuntimeError("boom")

    svc = RecommendService.from_artifacts(artifacts, device="cpu")
    svc.model = Exploding()
    res = svc.recommend("salmon salad", user_id=1, k=2, alpha=0.9)
    assert res[0]["item_id"] == "r3"  # similarity still ranks


# ------------------------- crossed with the JAX package ----------------------

_WORDS = ["chicken", "rice", "tofu", "salmon", "beef", "egg", "milk", "peanut",
          "walnut", "lettuce", "potato", "carrot", "noodle", "curry", "cheese",
          "butter", "lentils", "beans", "spinach", "yogurt"]


def _recipes(n=40, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n):
        ings = rng.choice(_WORDS, size=rng.integers(2, 5), replace=False)
        verb = rng.choice(["grill", "bake", "boil", "steam", "fry"])
        texts.append(f"title: {ings[0]} {verb} dish {i}\n"
                     f"ingredients: {'; '.join(ings)}\n"
                     f"directions: {verb} {int(rng.integers(5, 90))} minutes")
    return [f"rec{i}" for i in range(n)], texts


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Artifact dirs of the two packages over one dense index and one
    reranker, both written by the JAX package, and one KernelMF: pickled
    whole for JAX, through a JAX checkpoint into the port for the port."""
    root = tmp_path_factory.mktemp("crossed")
    ids, texts = _recipes()
    idx = jindex.build_dense_index(ids, texts, hash_embed(texts, dim=128))
    meta = pd.DataFrame([{"item_id": i, **featurize_item_text(t)}
                         for i, t in zip(ids, texts)])
    payload = train_reranker(items=pd.DataFrame({"item_id": ids, "text": texts}),
                             index=idx, meta=meta, n_seed_items=25,
                             candidate_k=10, seed=0)
    rng = np.random.default_rng(1)
    X = pd.DataFrame({"user_id": rng.integers(0, 12, 300),
                      "item_id": rng.choice(ids, 300)}).drop_duplicates()
    y = pd.Series(rng.uniform(1, 5, len(X)))
    jmodel = JKernelMF(n_factors=6, n_epochs=8, lr=0.03, batch_size=64,
                       seed=0).fit(X, y)
    jckpt.save_model(jmodel, root / "ckpt")
    pmodel = ckpt.load_model(root / "ckpt", device="cpu")
    feats = root / "features"
    feats.mkdir()
    meta.to_parquet(feats / "recipe_meta.parquet")
    dirs = {}
    for name, model in (("jax", jmodel), ("port", pmodel)):
        art = root / name
        art.mkdir()
        jindex.save_item_index(idx, art / "item_index.pkl")
        with (art / "reranker.pkl").open("wb") as f:
            pickle.dump(payload, f)
        with (art / "model.pkl").open("wb") as f:
            pickle.dump(model, f)
        dirs[name] = art
    return dirs, feats, texts, sorted(X["user_id"].unique().tolist())


def _same_rows(got, want, key):
    """Equal ids where the scores are separated by more than 1e-5 (JAX's
    sort is unstable among ties), scores within 1e-5."""
    gs = np.array([r[key] for r in got])
    ws = np.array([r[key] for r in want])
    np.testing.assert_allclose(gs, ws, atol=1e-5)
    gap = np.abs(np.diff(ws)) > 1e-5
    sep = np.concatenate([gap, [True]]) & np.concatenate([[True], gap])
    assert [r["item_id"] for r, s in zip(got, sep) if s] == \
        [r["item_id"] for r, s in zip(want, sep) if s]


def test_crossed_service_matches_jax(crossed):
    dirs, feats, texts, users = crossed
    port = RecommendService.from_artifacts(dirs["port"], feats, device="cpu")
    jax_svc = JService.from_artifacts(dirs["jax"], feats)
    assert port.health() == jax_svc.health()
    assert port.health()["has_model"] and port.health()["has_reranker"]
    assert isinstance(port.reranker["model"], TorchLogisticRegression)
    for n, user in enumerate(users[:6] + [None, "ghost"]):
        q = texts[3 * n].splitlines()[0].replace("title: ", "")
        got = port.recommend(q, user_id=user, k=8, candidate_k=20, alpha=0.5)
        want = jax_svc.recommend(q, user_id=user, k=8, candidate_k=20, alpha=0.5)
        assert [r["reason"] for r in got] == [r["reason"] for r in want]
        _same_rows(got, want, "score")


@pytest.mark.parametrize("goal, avoid", [("增肌/高蛋白", ["milk"]),
                                         ("控糖/低碳", ["peanut"]),
                                         ("", ["egg", "cheese"])])
def test_crossed_plan_matches_jax(crossed, goal, avoid):
    dirs, feats, _, users = crossed
    port = RecommendService.from_artifacts(dirs["port"], feats, device="cpu")
    jax_svc = JService.from_artifacts(dirs["jax"], feats)
    # every item a candidate: hash embeddings of short texts tie, and
    # JAX's order among ties at the cut is arbitrary
    kw = dict(goal=goal, avoid=avoid, per_meal_k=3, candidate_k=40,
              alpha=0.3, user_id=users[0], use_reranker=True)
    got = plan_meals(port, PlanRequest(**kw))
    want = jplanner.plan_meals(jax_svc, jplanner.PlanRequest(**kw))
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in ("score", "sim")} == \
            {k: v for k, v in w.items() if k not in ("score", "sim")}
        assert g["score"] == pytest.approx(w["score"], abs=1e-5)
        assert g["sim"] == pytest.approx(w["sim"], abs=1e-5)


def test_port_model_pickle_holds_host_tensors(tmp_path):
    """``model.pkl`` of the port: host tensors inside, and the tensors
    land on the device named at load time."""
    rng = np.random.default_rng(2)
    X = pd.DataFrame({"user_id": rng.integers(0, 8, 60),
                      "item_id": rng.integers(0, 9, 60)}).drop_duplicates()
    m = BaselineModel(method="als", n_epochs=3, device="cpu").fit(
        X, pd.Series(rng.uniform(1, 5, len(X))))
    state = m.__getstate__()
    assert all(t.device.type == "cpu" for t in state["_params"])
    with (tmp_path / "model.pkl").open("wb") as f:
        pickle.dump(m, f)
    back = load_pickle(tmp_path / "model.pkl", device="cpu")
    assert back.device == "cpu" and back._device == torch.device("cpu")
    assert back.predict(X) == m.predict(X)
    if not torch.cuda.is_available():
        m.device = None  # a model fitted on the card, loaded here
        with (tmp_path / "cuda.pkl").open("wb") as f:
            pickle.dump(m, f)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pickle(tmp_path / "cuda.pkl")
        assert load_pickle(tmp_path / "cuda.pkl", device="cpu").predict(X) \
            == m.predict(X)


_NO_JAX = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "optax", "matrix_factorization_tpu"):
            raise ImportError(name + " blocked")
sys.meta_path.insert(0, _Block())
import pickle
from matrix_factorization_tpu_torch.core.artifacts import load_pickle
from matrix_factorization_tpu_torch.serve.service import RecommendService
art = sys.argv[1]
try:
    load_pickle(art + "/model.pkl", device="cpu")
except pickle.UnpicklingError as e:
    print("refused:", "matrix_factorization_tpu" in str(e))
svc = RecommendService.from_artifacts(art, device="cpu")
h = svc.health()
res = svc.recommend("chicken rice", user_id=0, k=3)
print(h["has_model"], h["has_reranker"], type(svc.reranker["model"]).__name__,
      len(res), res[0]["reason"] == "embedding similarity recall",
      sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")))
"""


def test_jax_pickled_model_degrades_without_jax(crossed):
    dirs, _, _, _ = crossed
    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(dirs["jax"])],
                          capture_output=True, text=True, env=env, cwd=repo,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "refused: True"
    assert lines[1] == "False True TorchLogisticRegression 3 True []"
