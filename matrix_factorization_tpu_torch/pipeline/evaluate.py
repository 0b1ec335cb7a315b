"""Offline Top-K evaluation CLI (reference evaluate.py:61-165; PyTorch port
of ``matrix_factorization_tpu/pipeline/evaluate.py``: ``model.pkl`` loads onto
``--platform``'s device, default the GPU)."""

from __future__ import annotations

import argparse
import json

import pandas as pd

from matrix_factorization_tpu_torch.core.artifacts import load_pickle
from matrix_factorization_tpu_torch.eval.topk_eval import evaluate_topk
from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup


def main() -> None:
    p = argparse.ArgumentParser(description="Top-K offline evaluation")
    add_paths_arg(p)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--positive-threshold", type=float, default=4.0)
    p.add_argument("--n-test", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-users", type=int, default=0)
    a = p.parse_args()
    paths = cli_setup(a)
    ratings = pd.read_parquet(paths.data / "ratings.parquet")
    model = load_pickle(paths.artifacts / "model.pkl", a.platform)
    res = evaluate_topk(
        ratings, model, k=a.k, positive_threshold=a.positive_threshold,
        n_test=a.n_test, seed=a.seed, max_users=a.max_users,
    )
    print(json.dumps(
        {"precision": res.precision, "recall": res.recall, "ndcg": res.ndcg,
         "n_users": res.n_users, "k": a.k}
    ))


if __name__ == "__main__":
    main()
