"""The port's batch pipeline CLIs on the specs of
``tests/test_pipeline_e2e.py`` and ``tests/test_prepare_datasets.py``, all
with ``--platform cpu``, and held to the JAX package: both packages run
the host-only stages on copies of one synthetic root and write equal
frames (``items_emb`` bitwise, the TF-IDF matrix equal), and the
``evaluate`` JSON of a deterministic model (BaselineModel by ALS) is JAX's
within 1e-6. Without ``--platform`` a stage runs on the GPU, and raises
where there is none."""

import json
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest

from chip_smoke import run_cli
from matrix_factorization_tpu.pipeline import (
    build_item_embeddings as jbuild_item_embeddings,
    build_recipe_metadata as jbuild_recipe_metadata,
    build_structured_features as jbuild_structured_features,
    build_text_enrichment as jbuild_text_enrichment,
    build_tfidf_index as jbuild_tfidf_index,
    download_movielens_small as jdownload,
    evaluate as jevaluate,
    train as jtrain,
)
from matrix_factorization_tpu_torch.pipeline import (
    build_item_embeddings,
    build_recipe_metadata,
    build_structured_features,
    build_text_enrichment,
    build_tfidf_index,
    download_movielens_small,
    evaluate as evaluate_cli,
    evaluate_hybrid as hybrid_cli,
    evaluate_llm,
    export_artifacts,
    run_all,
    train as train_cli,
    train_reranker,
)

CPU = ["--platform", "cpu"]


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


def _last_json(out):
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def _recipe_texts(root):
    """Recipe-style texts so the metadata/judge stages have structure to
    parse (as ``tests/test_pipeline_e2e.py`` writes them)."""
    items = pd.read_parquet(root / "data" / "items.parquet")
    ings = ["chicken; rice", "peanut butter; sugar", "salmon; cream",
            "tofu; broccoli", "beef; beans"]
    items["text"] = [
        f"title: dish {iid}\ningredients: {ings[j % len(ings)]}\n"
        f"directions: cook {10 + (j % 4) * 10} minutes"
        for j, iid in enumerate(items["item_id"])]
    items.to_parquet(root / "data" / "items.parquet", index=False)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    run_cli(download_movielens_small, ["--root", str(root), "--synthetic",
                                       "--seed", "3", "--min-interactions", "5"]
            + CPU)
    _recipe_texts(root)
    return root


def test_full_pipeline(workdir):
    root = str(workdir)
    base = ["--root", root] + CPU
    run_cli(build_tfidf_index, base + ["--min-df", "1"])
    run_cli(build_recipe_metadata, base)
    run_cli(build_structured_features, base)
    run_cli(build_text_enrichment, base + ["--max-rows", "50"])

    run_cli(train_cli, base + ["--model", "baseline", "--method", "als",
                               "--epochs", "5"])
    metrics = _last_json(run_cli(evaluate_cli, base + [
        "--k", "5", "--positive-threshold", "3.0", "--max-users", "30"]))
    assert set(metrics) >= {"precision", "recall", "ndcg"}

    # dense index + hybrid ablation
    run_cli(build_item_embeddings, base + ["--dim", "64"])
    run_cli(export_artifacts, base)
    rep = _last_json(run_cli(hybrid_cli, base + [
        "--k", "5", "--candidate-k", "20", "--positive-threshold", "3.0",
        "--max-users", "20"]))
    assert "embedding_only" in rep

    # reranker needs the tfidf index artifact: rebuild it (export overwrote)
    run_cli(build_tfidf_index, base + ["--min-df", "1"])
    run_cli(train_reranker, base + ["--n-seed-items", "40", "--candidate-k", "10",
                                    "--log-every", "0"])
    assert (workdir / "artifacts" / "reranker.pkl").exists()

    # MLP upgrade: same payload schema, model_type recorded
    run_cli(train_reranker, base + ["--n-seed-items", "40", "--candidate-k", "10",
                                    "--log-every", "0", "--model-type", "mlp"])
    from matrix_factorization_tpu_torch.core.artifacts import load_pickle
    from matrix_factorization_tpu_torch.rank.reranker import TorchMLPReranker

    payload = load_pickle(workdir / "artifacts" / "reranker.pkl", "cpu")
    assert payload["model_type"] == "mlp"
    assert isinstance(payload["model"], TorchMLPReranker)
    assert payload["train_stats"]["n_samples"] > 0
    probs = payload["model"].predict_proba(
        np.zeros((3, len(payload["feature_names"])), np.float32))
    assert probs.shape == (3, 2)

    run_cli(evaluate_llm, base + ["--query", "chicken rice dinner",
                                  "--must-include", "chicken", "--avoid", "peanut"])
    report = json.loads((workdir / "artifacts" / "llm_eval_report.json").read_text())
    assert report["n_cases"] == 1
    assert 0.0 <= report["violation_rate"] <= 1.0


@pytest.mark.parametrize("model, argv, history", [
    ("kernel_mf", ["--factors", "8", "--epochs", "4", "--lr", "0.01",
                   "--batch-size", "4096"], "train_rmse"),
    ("implicit", ["--factors", "8", "--epochs", "3"], "train_loss"),
    ("bpr", ["--factors", "8", "--epochs", "5", "--lr", "0.05",
             "--batch-size", "4096"], "train_loss"),
])
def test_random_init_trainers_learn(workdir, model, argv, history):
    """The trainers that start from random tables: the model pickled is
    the port's, with host tensors, and its loss / RMSE falls. On the
    first 20,000 ratings, a few batches an epoch: many small CPU steps
    crawl when the test workers share the cores."""
    import matrix_factorization_tpu_torch as mf
    from matrix_factorization_tpu_torch.core.artifacts import load_pickle

    run_cli(train_cli, ["--root", str(workdir), "--model", model,
                        "--max-rows", "20000"] + argv + CPU)
    m = load_pickle(workdir / "artifacts" / "model.pkl", "cpu")
    assert isinstance(m, {"kernel_mf": mf.KernelMF, "implicit": mf.ImplicitALS,
                          "bpr": mf.BPR}[model])
    h = getattr(m, history)
    assert h[-1] < h[0], h


def test_default_platform_is_the_gpu(workdir, monkeypatch):
    """No ``--platform``: the stage asks for CUDA, and without a GPU it
    raises instead of running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(train_cli, ["--root", str(workdir), "--model", "baseline",
                            "--epochs", "1"])


def test_mesh_devices_names_slice_6(workdir, tmp_path):
    """``--mesh-devices 2 --platform cpu``: the stage starts two gloo ranks
    on the CPU, the candidates are scored item-sharded over them, and rank
    0 prints the mesh-free run's report (a dense index and a BaselineModel
    of the module's synthetic root, copied)."""
    root = tmp_path / "root"
    shutil.copytree(workdir / "data", root / "data")
    base = ["--root", str(root)] + CPU
    run_cli(build_item_embeddings, base + ["--dim", "32"])
    run_cli(export_artifacts, base)
    run_cli(train_cli, base + ["--model", "baseline", "--method", "als",
                               "--epochs", "2"])
    argv = base + ["--k", "5", "--candidate-k", "20", "--positive-threshold",
                   "3.0", "--max-users", "20"]
    want = _last_json(run_cli(hybrid_cli, argv))
    got = _last_json(run_cli(hybrid_cli, argv + ["--mesh-devices", "2"]))
    assert got == want and want["embedding_only"]["n_users"] > 0


def test_run_all_synthetic(tmp_path):
    assert "pipeline complete" in run_cli(
        run_all, ["--root", str(tmp_path / "w"), "--synthetic", "--epochs", "3"] + CPU)


@pytest.fixture(scope="module")
def both_roots(tmp_path_factory):
    """One synthetic root prepared by each package from the same seed,
    then the same recipe texts, and every host-only stage run by each
    package on its own copy."""
    roots = {}
    for name, dl in (("jax", jdownload), ("port", download_movielens_small)):
        root = tmp_path_factory.mktemp(name)
        run_cli(dl, ["--root", str(root), "--synthetic", "--seed", "5",
                     "--min-interactions", "5", "--sample-users", "300"]
                + (CPU if name == "port" else []))
        _recipe_texts(root)
        roots[name] = root
    stages = [
        (jbuild_recipe_metadata, build_recipe_metadata, []),
        (jbuild_structured_features, build_structured_features, []),
        (jbuild_text_enrichment, build_text_enrichment, ["--max-rows", "300"]),
        (jbuild_item_embeddings, build_item_embeddings, ["--dim", "32"]),
        (jbuild_tfidf_index, build_tfidf_index, ["--min-df", "1"]),
    ]
    for jmod, pmod, argv in stages:
        run_cli(jmod, ["--root", str(roots["jax"])] + argv)
        run_cli(pmod, ["--root", str(roots["port"])] + argv + CPU)
    return roots


@pytest.mark.parametrize("rel", [
    "data/ratings.parquet", "data/items.parquet", "features/recipe_meta.parquet",
    "features/user_features.parquet", "features/item_features.parquet",
    "features/items_text_enriched.parquet", "features/items_emb.parquet"])
def test_host_stages_write_jax_frames(both_roots, rel):
    got = pd.read_parquet(both_roots["port"] / rel)
    want = pd.read_parquet(both_roots["jax"] / rel)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_tfidf_index_matches_jax(both_roots):
    from matrix_factorization_tpu_torch.retrieval.index import load_item_index

    got = load_item_index(both_roots["port"] / "artifacts" / "item_index.pkl")
    want = load_item_index(both_roots["jax"] / "artifacts" / "item_index.pkl")
    assert got.item_ids == want.item_ids and got.texts == want.texts
    assert got.matrix.shape == want.matrix.shape
    assert (got.matrix != want.matrix).nnz == 0


def test_evaluate_json_of_baseline_als_matches_jax(both_roots, tmp_path):
    """BaselineModel by ALS is deterministic: both packages fit it on the
    same ratings and their ``evaluate`` JSONs agree within 1e-6."""
    out = {}
    for name, train_mod, eval_mod, extra in (
            ("jax", jtrain, jevaluate, []), ("port", train_cli, evaluate_cli, CPU)):
        root = tmp_path / name
        shutil.copytree(both_roots[name] / "data", root / "data")
        base = ["--root", str(root)] + extra
        run_cli(train_mod, base + ["--model", "baseline", "--method", "als",
                                   "--epochs", "5"])
        out[name] = _last_json(run_cli(eval_mod, base + [
            "--k", "5", "--positive-threshold", "3.0", "--max-users", "60"]))
    assert set(out["port"]) == set(out["jax"])
    assert out["port"]["n_users"] == out["jax"]["n_users"] > 0
    for key, value in out["jax"].items():
        assert out["port"][key] == pytest.approx(value, abs=1e-6), key


def test_model_pickle_is_the_ports(both_roots, tmp_path):
    """``model.pkl`` of the port is a whole-model pickle of host tensors."""
    import torch

    root = tmp_path / "p"
    shutil.copytree(both_roots["port"] / "data", root / "data")
    run_cli(train_cli, ["--root", str(root), "--model", "popularity"] + CPU)
    run_cli(train_cli, ["--root", str(root), "--model", "kernel_mf",
                        "--factors", "4", "--epochs", "1", "--max-rows", "5000",
                        "--batch-size", "4096"] + CPU)
    m = pickle.loads((root / "artifacts" / "model.pkl").read_bytes())
    assert type(m).__module__.startswith("matrix_factorization_tpu_torch.")
    assert m._params.item_features.device == torch.device("cpu")


def test_prepare_recipes(tmp_path):
    from matrix_factorization_tpu_torch.pipeline import prepare_recipes
    from matrix_factorization_tpu_torch.rank.recipe_features import (
        extract_ingredient_phrases,
        extract_time_minutes,
    )

    csv = tmp_path / "full_dataset.csv"
    pd.DataFrame({
        "title": ["Pancakes", "Soup"],
        "ingredients": ['["flour", "milk", "eggs"]', '["water", "salt"]'],
        "directions": ['["Mix well.", "Cook 10 minutes."]', '["Boil 1 hour."]'],
        "link": ["a", "b"],
        "NER": ['["flour"]', '["salt"]'],
    }).to_csv(csv, index=False)
    run_cli(prepare_recipes, ["--root", str(tmp_path), "--csv", str(csv)] + CPU)
    items = pd.read_parquet(tmp_path / "data" / "items.parquet")
    assert len(items) == 2
    t = items["text"].iloc[0]
    assert t.startswith("title: Pancakes")
    assert "ingredients: flour; milk; eggs" in t
    assert "directions: Mix well. Cook 10 minutes." in t
    assert extract_ingredient_phrases(t) == {"flour", "milk", "eggs"}
    assert extract_time_minutes(t) == 10
    assert extract_time_minutes(items["text"].iloc[1]) == 60


def test_prepare_steam(tmp_path):
    from matrix_factorization_tpu_torch.pipeline import prepare_steam

    csv = tmp_path / "steam-200k.csv"
    rows = [
        "101,Half-Life,purchase,1.0,0",
        "101,Half-Life,play,50.0,0",
        "101,Half-Life,play,10.0,0",  # dedup by max -> 50
        "102,Portal,play,5.0,0",
        "103,Portal,purchase,1.0,0",  # purchase only: no rating row
    ]
    csv.write_text("\n".join(rows) + "\n")
    run_cli(prepare_steam, ["--root", str(tmp_path), "--csv", str(csv)] + CPU)
    ratings = pd.read_parquet(tmp_path / "data" / "ratings.parquet")
    items = pd.read_parquet(tmp_path / "data" / "items.parquet")
    assert len(ratings) == 2  # two (user, game) play pairs after dedup
    assert set(items["item_id"]) == {"Half-Life", "Portal"}
    # log1p + minmax onto [0.5, 5]: max hours (50) -> 5.0, min (5) -> 0.5
    by_user = ratings.set_index("user_id")["rating"]
    assert by_user[101] == 5.0
    assert by_user[102] == 0.5


def test_prepare_data_csv(tmp_path):
    from matrix_factorization_tpu_torch.pipeline import prepare_data

    r = tmp_path / "r.csv"
    pd.DataFrame({"u": [1, 2], "i": [7, 8], "score": [4.0, 2.5]}).to_csv(r, index=False)
    run_cli(prepare_data, ["--root", str(tmp_path), "--ratings-csv", str(r),
                           "--user-col", "u", "--item-col", "i",
                           "--rating-col", "score"] + CPU)
    got = pd.read_parquet(tmp_path / "data" / "ratings.parquet")
    assert list(got.columns) == ["user_id", "item_id", "rating"]
    assert got["rating"].tolist() == [4.0, 2.5]
