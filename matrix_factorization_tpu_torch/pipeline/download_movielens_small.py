"""MovieLens-small preparation (reference download_movielens_small.py;
PyTorch port of ``matrix_factorization_tpu/pipeline/download_movielens_small.py``,
host-only).

Downloads the grouplens ml-latest-small zip when the environment has
network access; in zero-egress environments ``--synthetic`` produces a
MovieLens-100K-shaped synthetic dataset instead (same schema) so the rest
of the pipeline stays exercisable.  Supports the reference's user sampling
and minimum-interaction filtering (``:67-78``).
"""

from __future__ import annotations

import argparse
import io
import zipfile
from pathlib import Path
import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup

ML_SMALL_URL = "https://files.grouplens.org/datasets/movielens/ml-latest-small.zip"


def _filter(ratings: pd.DataFrame, sample_users: int, min_interactions: int,
            seed: int) -> pd.DataFrame:
    if min_interactions > 0:
        counts = ratings.groupby("user_id")["item_id"].transform("count")
        ratings = ratings[counts >= min_interactions]
    if sample_users > 0:
        users = ratings["user_id"].unique()
        rng = np.random.default_rng(seed)
        keep = set(rng.choice(users, size=min(sample_users, len(users)),
                              replace=False).tolist())
        ratings = ratings[ratings["user_id"].isin(keep)]
    return ratings


def prepare_movielens_small(
    out_dir: Path,
    sample_users: int = 0,
    min_interactions: int = 0,
    seed: int = 0,
    synthetic: bool = False,
    url: str = ML_SMALL_URL,
) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    if synthetic:
        from matrix_factorization_tpu_torch.data.synthetic import movielens_shaped

        X, y = movielens_shaped(n_users=610, n_items=9700, n_ratings=100_000,
                                seed=seed)
        ratings = X.copy()
        ratings["rating"] = y
        items = pd.DataFrame(
            {
                "item_id": [str(i) for i in sorted(X["item_id"].unique())],
            }
        )
        items["text"] = ["synthetic movie #" + i for i in items["item_id"]]
    else:
        import urllib.request

        with urllib.request.urlopen(url, timeout=60) as resp:
            blob = resp.read()
        zf = zipfile.ZipFile(io.BytesIO(blob))
        with zf.open("ml-latest-small/ratings.csv") as f:
            ratings = pd.read_csv(f).rename(
                columns={"userId": "user_id", "movieId": "item_id"}
            )[["user_id", "item_id", "rating"]]
        with zf.open("ml-latest-small/movies.csv") as f:
            movies = pd.read_csv(f)
        items = pd.DataFrame(
            {
                "item_id": movies["movieId"].astype(str),
                "text": movies["title"].fillna("") + " | "
                + movies["genres"].fillna("").str.replace("|", " ", regex=False),
            }
        )

    ratings = _filter(ratings, sample_users, min_interactions, seed)
    ratings["item_id"] = ratings["item_id"].astype(str)
    ratings.to_parquet(out_dir / "ratings.parquet", index=False)
    items.to_parquet(out_dir / "items.parquet", index=False)
    print(
        f"wrote {len(ratings)} ratings / {len(items)} items to {out_dir} "
        f"({'synthetic' if synthetic else 'downloaded'})"
    )


def main() -> None:
    p = argparse.ArgumentParser(description="Prepare MovieLens-small parquet")
    add_paths_arg(p)
    p.add_argument("--sample-users", type=int, default=0)
    p.add_argument("--min-interactions", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset (zero-egress envs)")
    p.add_argument("--url", default=ML_SMALL_URL)
    a = p.parse_args()
    paths = cli_setup(a)
    prepare_movielens_small(
        paths.data, a.sample_users, a.min_interactions, a.seed, a.synthetic,
        a.url,
    )


if __name__ == "__main__":
    main()
