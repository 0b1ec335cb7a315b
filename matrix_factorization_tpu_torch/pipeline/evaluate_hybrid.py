"""Hybrid ablation CLI (reference evaluate_hybrid.py:82-218): embedding-only
vs alpha-blended Top-K metrics side by side. PyTorch port of
``matrix_factorization_tpu/pipeline/evaluate_hybrid.py``: a dense index
scores and ``model.pkl`` loads on ``--platform``'s device (default: the GPU);
``--mesh-devices`` comes with slice 6 of the port and raises."""

from __future__ import annotations

import argparse
import json

import pandas as pd

from matrix_factorization_tpu_torch.core.artifacts import load_pickle
from matrix_factorization_tpu_torch.eval.hybrid_eval import evaluate_hybrid
from matrix_factorization_tpu_torch.ops.segment_sgd import SLICE_6_GRAM
from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup
from matrix_factorization_tpu_torch.retrieval.index import load_item_index


def main() -> None:
    p = argparse.ArgumentParser(description="Hybrid Top-K evaluation/ablation")
    add_paths_arg(p)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--candidate-k", type=int, default=100)
    p.add_argument("--positive-threshold", type=float, default=4.0)
    p.add_argument("--n-test", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-users", type=int, default=0)
    p.add_argument("--no-model", action="store_true",
                   help="embedding-only arm")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard candidate scoring over an n-device mesh "
                        "(comes with slice 6 of the port; > 0 raises)")
    a = p.parse_args()
    if a.mesh_devices:
        raise NotImplementedError(f"--mesh-devices comes with {SLICE_6_GRAM}")
    paths = cli_setup(a)
    ratings = pd.read_parquet(paths.data / "ratings.parquet")
    index = load_item_index(paths.artifacts / "item_index.pkl")
    model = None
    if not a.no_model and (paths.artifacts / "model.pkl").exists():
        model = load_pickle(paths.artifacts / "model.pkl", a.platform)

    report = {}
    for name, alpha, m in (
        ("embedding_only", 0.0, None),
        (f"blended_alpha_{a.alpha}", a.alpha, model),
    ):
        res = evaluate_hybrid(
            ratings, index, model=m, alpha=alpha, k=a.k,
            candidate_k=a.candidate_k, positive_threshold=a.positive_threshold,
            n_test=a.n_test, seed=a.seed, max_users=a.max_users,
            device=a.platform,
        )
        report[name] = {
            "precision": res.precision, "recall": res.recall,
            "ndcg": res.ndcg, "n_users": res.n_users,
        }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
