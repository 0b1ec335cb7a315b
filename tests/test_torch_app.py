"""The port's meal-planner frontends (``serve/app.py``): ``streamlit_main``
on the fake-``st`` spec of ``tests/test_streamlit_app.py``, and ``main
--json`` beside JAX's on one set of artifacts that the JAX package wrote
(a dense index and a reranker, no model): the same plan rows."""

import json
import pickle

import numpy as np
import pandas as pd
import pytest

from chip_smoke import run_cli
from matrix_factorization_tpu.pipeline.train_reranker import train_reranker
from matrix_factorization_tpu.rank.recipe_features import featurize_item_text
from matrix_factorization_tpu.retrieval import index as jindex
from matrix_factorization_tpu.serve import app as japp
from matrix_factorization_tpu_torch.models.baseline import BaselineModel
from matrix_factorization_tpu_torch.retrieval.index import (
    build_tfidf_index,
    save_item_index,
)
from matrix_factorization_tpu_torch.serve import app
from matrix_factorization_tpu_torch.serve.app import streamlit_main

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
    art = tmp_path_factory.mktemp("st") / "artifacts"
    art.mkdir()
    save_item_index(build_tfidf_index(IDS, TEXTS, min_df=1), art / "item_index.pkl")
    rng = np.random.default_rng(0)
    n = 60
    X = pd.DataFrame({
        "user_id": rng.integers(0, 10, n),
        "item_id": [IDS[j % len(IDS)] for j in range(n)],
    }).drop_duplicates()
    y = pd.Series(rng.uniform(1, 5, len(X)))
    with (art / "model.pkl").open("wb") as f:
        pickle.dump(BaselineModel(method="als", n_epochs=5, device="cpu").fit(X, y), f)
    return art


class _Tab:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class FakeStreamlit:
    """Minimal recording implementation of the widget API streamlit_main
    uses (as ``tests/test_streamlit_app.py``'s): ``inputs`` presets fields
    by label; every button is pressed; dataframes and warnings are kept."""

    def __init__(self, inputs):
        self.inputs = dict(inputs)
        self.sidebar = self
        self.dataframes = []
        self.warnings = []
        self.widgets = []
        self.cache_resource_calls = 0

    def title(self, text):
        self.widgets.append(("title", text))

    def text_input(self, label, default=""):
        self.widgets.append(("text_input", label))
        return self.inputs.get(label, default)

    def slider(self, label, lo, hi, default):
        self.widgets.append(("slider", label))
        return self.inputs.get(label, default)

    def checkbox(self, label, default=False):
        self.widgets.append(("checkbox", label))
        return self.inputs.get(label, default)

    def number_input(self, label, lo, hi, default):
        self.widgets.append(("number_input", label))
        return self.inputs.get(label, default)

    def selectbox(self, label, options):
        self.widgets.append(("selectbox", label))
        return self.inputs.get(label, options[0])

    def button(self, label, key=None):
        self.widgets.append(("button", label))
        return True

    def tabs(self, names):
        self.widgets.append(("tabs", tuple(names)))
        return [_Tab() for _ in names]

    def cache_resource(self, fn):
        self.cache_resource_calls += 1
        return fn

    def dataframe(self, df):
        self.dataframes.append(df)

    def warning(self, msg):
        self.warnings.append(msg)


def test_streamlit_app_questionnaire_and_freetext(artifacts):
    st = FakeStreamlit({
        "artifacts dir": str(artifacts),
        "features dir": "does/not/exist",
        "free-text query": "chicken rice",
        "must include (comma separated)": "",
    })
    streamlit_main(st=st, device="cpu")
    assert ("tabs", ("问卷推荐", "自由检索")) in st.widgets
    assert st.cache_resource_calls == 1
    assert len(st.dataframes) == 2, (st.warnings, st.widgets)
    plan_df, free_df = st.dataframes
    for df in (plan_df, free_df):
        assert {"meal", "rank", "item_id", "score"} <= set(df.columns)
        assert len(df) > 0
    assert set(plan_df["meal"]) == {"早餐", "午餐", "晚餐"}


def test_streamlit_app_hard_filters_respected(artifacts):
    st = FakeStreamlit({
        "artifacts dir": str(artifacts),
        "features dir": "does/not/exist",
        "avoid (comma separated)": "chicken, beef",
        "free-text query": "noodle",
    })
    streamlit_main(st=st, device="cpu")
    assert st.dataframes
    for df in st.dataframes:
        previews = " ".join(str(p) for p in df.get("preview", []))
        assert "chicken" not in previews and "beef" not in previews


def _recipes(n=40, seed=0):
    rng = np.random.default_rng(seed)
    words = ["chicken", "rice", "peanut", "salmon", "tofu", "beef", "egg",
             "noodle", "milk", "lettuce", "potato", "curry", "cheese"]
    texts = []
    for i in range(n):
        ings = rng.choice(words, size=int(rng.integers(2, 5)), replace=False)
        verb = rng.choice(["grill", "bake", "boil", "steam", "fry"])
        texts.append(f"title: {ings[0]} {verb} dish {i}\n"
                     f"ingredients: {'; '.join(ings)}\n"
                     f"directions: {verb} {int(rng.integers(5, 90))} minutes")
    return [f"rec{i}" for i in range(n)], texts


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """A dense index and a reranker written by the JAX package, the
    recipes' metadata, no model."""
    root = tmp_path_factory.mktemp("app")
    ids, texts = _recipes()
    emb = np.random.default_rng(3).normal(size=(len(ids), 64)).astype(np.float32)
    idx = jindex.build_dense_index(ids, texts, emb)
    meta = pd.DataFrame([{"item_id": i, **featurize_item_text(t)}
                         for i, t in zip(ids, texts)])
    payload = train_reranker(items=pd.DataFrame({"item_id": ids, "text": texts}),
                             index=idx, meta=meta, n_seed_items=25,
                             candidate_k=10, seed=0)
    art, feats = root / "artifacts", root / "features"
    art.mkdir()
    feats.mkdir()
    jindex.save_item_index(idx, art / "item_index.pkl")
    with (art / "reranker.pkl").open("wb") as f:
        pickle.dump(payload, f)
    meta.to_parquet(feats / "recipe_meta.parquet")
    return art, feats


def _plan_rows(module, argv):
    return json.loads(run_cli(module, argv).strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [
    ["--query", "chicken rice dinner", "--avoid", "peanut"],
    ["--goal", "增肌/高蛋白", "--avoid", "milk", "--per-meal-k", "2"],
    ["--goal", "", "--no-reranker", "--max-time-min", "60"],
])
def test_app_main_json_matches_jax(jax_artifacts, extra):
    art, feats = jax_artifacts
    argv = ["--artifacts", str(art), "--features", str(feats), "--json"] + extra
    got = _plan_rows(app, argv + ["--platform", "cpu"])
    want = _plan_rows(japp, argv)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in ("score", "sim")} == \
            {k: v for k, v in w.items() if k not in ("score", "sim")}
        assert g["score"] == pytest.approx(w["score"], abs=1e-5)
        assert g["sim"] == pytest.approx(w["sim"], abs=1e-5)
    for meal in {r["meal"] for r in got}:
        ids = [r["item_id"] for r in got if r["meal"] == meal]
        assert len(ids) == len(set(ids))


def test_app_main_without_platform_needs_a_gpu(jax_artifacts, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art, feats = jax_artifacts
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _plan_rows(app, ["--artifacts", str(art), "--json", "--query", "rice"])
