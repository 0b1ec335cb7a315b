"""Generic CSV -> parquet preparation (reference prepare_data.py:21-45).
Host-only; a copy of ``matrix_factorization_tpu/pipeline/prepare_data.py``.

ratings CSV (user, item, rating columns) -> data/ratings.parquet
items CSV (item, text columns)          -> data/items.parquet
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns


def prepare_from_csv(
    ratings_csv: Optional[Path],
    items_csv: Optional[Path],
    out_dir: Path,
    user_col: str = "user_id",
    item_col: str = "item_id",
    rating_col: str = "rating",
    text_col: str = "text",
) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    if ratings_csv:
        df = pd.read_csv(ratings_csv)
        require_columns(df, [user_col, item_col, rating_col], "ratings csv")
        out = df[[user_col, item_col, rating_col]].rename(
            columns={user_col: "user_id", item_col: "item_id", rating_col: "rating"}
        )
        out.to_parquet(out_dir / "ratings.parquet", index=False)
        print(f"wrote {out_dir / 'ratings.parquet'} ({len(out)} rows)")
    if items_csv:
        df = pd.read_csv(items_csv)
        require_columns(df, [item_col, text_col], "items csv")
        out = df[[item_col, text_col]].rename(
            columns={item_col: "item_id", text_col: "text"}
        )
        out["item_id"] = out["item_id"].astype(str)
        out["text"] = out["text"].fillna("").astype(str)
        out.to_parquet(out_dir / "items.parquet", index=False)
        print(f"wrote {out_dir / 'items.parquet'} ({len(out)} rows)")


def main() -> None:
    p = argparse.ArgumentParser(description="Prepare ratings/items parquet from CSV")
    add_paths_arg(p)
    p.add_argument("--ratings-csv", type=str, default=None)
    p.add_argument("--items-csv", type=str, default=None)
    p.add_argument("--user-col", default="user_id")
    p.add_argument("--item-col", default="item_id")
    p.add_argument("--rating-col", default="rating")
    p.add_argument("--text-col", default="text")
    a = p.parse_args()
    paths = cli_setup(a)
    prepare_from_csv(
        Path(a.ratings_csv) if a.ratings_csv else None,
        Path(a.items_csv) if a.items_csv else None,
        paths.data,
        a.user_col, a.item_col, a.rating_col, a.text_col,
    )


if __name__ == "__main__":
    main()
