"""ratings.parquet -> artifacts/model.pkl (reference train.py:14-48).

Models: baseline | kernel_mf | item_cf | user_cf | content_based |
implicit (confidence-weighted ALS over interaction strengths — the
rating column is read as a non-negative strength).
Checkpointing uses the framework's own format (core.checkpoint) plus a
reference-compatible whole-model pickle.

PyTorch port of ``matrix_factorization_tpu/pipeline/train.py``: the model
trains on ``--platform``'s device (default: the GPU) and ``model.pkl``
holds host tensors, which ``core.artifacts.load_pickle(path, device)``
puts back on a device. ``Popularity`` is host numpy and takes no device.
"""

from __future__ import annotations

import argparse
import pickle

import pandas as pd

from matrix_factorization_tpu_torch import (
    BPR,
    EASE,
    BaselineModel,
    ContentBasedRecommender,
    ImplicitALS,
    ItemItemCF,
    KernelMF,
    NMF,
    Popularity,
    SVDpp,
    UserUserCF,
)
from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns


def build_model(name: str, args, device=None) -> object:
    """The model ``name`` with ``args``' hyper-parameters, its tensors on
    ``device`` (``None`` = CUDA)."""
    if name == "baseline":
        return BaselineModel(method=args.method, n_epochs=args.epochs,
                             reg=args.reg, lr=args.lr, device=device)
    if name == "kernel_mf":
        return KernelMF(n_factors=args.factors, n_epochs=args.epochs,
                        kernel=args.kernel, lr=args.lr, reg=args.reg,
                        batch_size=args.batch_size, device=device)
    if name == "user_cf":
        return UserUserCF(n_neighbors=args.neighbors, device=device)
    if name == "item_cf":
        return ItemItemCF(n_neighbors=args.neighbors, device=device)
    if name == "content_based":
        return ContentBasedRecommender(device=device)
    if name == "implicit":
        return ImplicitALS(n_factors=args.factors, n_epochs=args.epochs,
                           reg=args.reg, alpha=args.alpha, device=device)
    if name == "bpr":
        return BPR(n_factors=args.factors, n_epochs=args.epochs,
                   lr=args.lr, reg=args.reg, batch_size=args.batch_size,
                   device=device)
    if name == "svdpp":
        return SVDpp(n_factors=args.factors, n_epochs=args.epochs,
                     lr=args.lr, reg=args.reg, batch_size=args.batch_size,
                     device=device)
    if name == "nmf":
        return NMF(n_factors=args.factors, n_epochs=args.epochs,
                   reg=args.reg, batch_size=args.batch_size, device=device)
    if name == "ease":
        # EASE's lam is inverse-conditioning-scale (paper: 100-1000),
        # NOT SGD-scale like the shared --reg default of 0.005
        return EASE(reg=args.ease_reg, device=device)
    if name == "popularity":
        return Popularity(score=args.pop_score)
    raise ValueError(f"unknown model {name!r}")


def train_model(ratings: pd.DataFrame, model) -> object:
    require_columns(ratings, ["user_id", "item_id", "rating"], "ratings")
    X = ratings[["user_id", "item_id"]]
    y = ratings["rating"]
    return model.fit(X, y)


def main() -> None:
    p = argparse.ArgumentParser(description="Train a rating model")
    add_paths_arg(p)
    p.add_argument("--model", default="kernel_mf",
                   choices=["baseline", "kernel_mf", "item_cf", "user_cf",
                            "content_based", "implicit", "bpr", "svdpp",
                            "nmf", "ease", "popularity"])
    p.add_argument("--kernel", default="linear")
    p.add_argument("--method", default="als")
    p.add_argument("--factors", type=int, default=100)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--reg", type=float, default=0.005)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--ease-reg", type=float, default=250.0,
                   help="EASE ridge lam (inverse-scale, not SGD reg)")
    p.add_argument("--neighbors", type=int, default=50)
    p.add_argument("--alpha", type=float, default=40.0,
                   help="implicit confidence scale (c = 1 + alpha*s)")
    p.add_argument("--pop-score", default="count", choices=["count", "mean"],
                   help="popularity ranking statistic")
    p.add_argument("--max-rows", type=int, default=0)
    a = p.parse_args()
    paths = cli_setup(a)
    ratings = pd.read_parquet(paths.data / "ratings.parquet")
    if a.max_rows:
        ratings = ratings.head(a.max_rows)
    model = train_model(ratings, build_model(a.model, a, a.platform))
    paths.artifacts.mkdir(parents=True, exist_ok=True)
    out = paths.artifacts / "model.pkl"
    with out.open("wb") as f:
        pickle.dump(model, f)
    print(f"wrote {out} ({a.model}, {len(ratings)} ratings)")


if __name__ == "__main__":
    main()
