"""ratings.parquet -> user_features.parquet / item_features.parquet
(reference build_structured_features.py:28-71): per-entity
count/mean/std/min/max plus global stats. Host-only; a copy of
``matrix_factorization_tpu/pipeline/build_structured_features.py``."""

from __future__ import annotations

import argparse

import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns


def build_features(ratings: pd.DataFrame, key: str) -> pd.DataFrame:
    g = ratings.groupby(key)["rating"]
    out = g.agg(["count", "mean", "std", "min", "max"]).reset_index()
    out.columns = [key] + [f"rating_{c}" for c in ("count", "mean", "std", "min", "max")]
    out["rating_std"] = out["rating_std"].fillna(0.0)
    out["global_mean"] = float(ratings["rating"].mean())
    out["global_count"] = int(len(ratings))
    return out


def main() -> None:
    p = argparse.ArgumentParser(description="Build structured user/item features")
    add_paths_arg(p)
    a = p.parse_args()
    paths = cli_setup(a)
    ratings = pd.read_parquet(paths.data / "ratings.parquet")
    require_columns(ratings, ["user_id", "item_id", "rating"], "ratings")
    paths.features.mkdir(parents=True, exist_ok=True)
    build_features(ratings, "user_id").to_parquet(
        paths.features / "user_features.parquet", index=False
    )
    build_features(ratings, "item_id").to_parquet(
        paths.features / "item_features.parquet", index=False
    )
    print(f"wrote user/item features to {paths.features}")


if __name__ == "__main__":
    main()
