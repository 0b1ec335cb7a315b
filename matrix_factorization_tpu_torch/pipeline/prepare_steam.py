"""Steam-200k preparation (reference prepare_steam_light.py).
Host-only; a copy of ``matrix_factorization_tpu/pipeline/prepare_steam.py``.

steam-200k.csv rows are (user_id, game, behavior, value):
* ``play`` hours become implicit ratings, optionally ``log1p``-compressed
  then min-maxed onto the rating range (reference ``:138-148``);
* duplicate (user, game) rows are deduped by max hours (``:159``);
* optional store metadata joins into the item text (``:216-245``).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup


def load_steam_200k(csv_path: Path) -> pd.DataFrame:
    df = pd.read_csv(
        csv_path, header=None,
        names=["user_id", "game", "behavior", "value", "zero"],
        usecols=[0, 1, 2, 3],
    )
    return df


def build_ratings(
    df: pd.DataFrame,
    use_log1p: bool = True,
    min_rating: float = 0.5,
    max_rating: float = 5.0,
) -> pd.DataFrame:
    plays = df[df["behavior"] == "play"].copy()
    # dedup by max hours per (user, game)
    plays = (
        plays.groupby(["user_id", "game"], as_index=False)["value"].max()
    )
    hours = plays["value"].to_numpy(np.float64)
    if use_log1p:
        hours = np.log1p(hours)
    lo, hi = hours.min(), hours.max()
    scaled = (
        np.full_like(hours, (min_rating + max_rating) / 2)
        if hi - lo < 1e-12
        else min_rating + (hours - lo) / (hi - lo) * (max_rating - min_rating)
    )
    return pd.DataFrame(
        {
            "user_id": plays["user_id"].to_numpy(),
            "item_id": plays["game"].astype(str).to_numpy(),
            "rating": scaled.astype(np.float32),
        }
    )


def build_items(
    df: pd.DataFrame, metadata_csv: Optional[Path] = None
) -> pd.DataFrame:
    games = sorted(df["game"].astype(str).unique())
    items = pd.DataFrame({"item_id": games, "text": games})
    if metadata_csv and Path(metadata_csv).exists():
        meta = pd.read_csv(metadata_csv)
        name_col = next((c for c in meta.columns if c.lower() in ("name", "title", "game")), None)
        if name_col:
            meta["_key"] = meta[name_col].astype(str)
            text_cols = [c for c in meta.columns if c not in (name_col, "_key")]
            meta["_text"] = meta[text_cols].astype(str).agg(" | ".join, axis=1)
            # dedup metadata names BEFORE merging — a duplicate name would
            # expand the merge and misalign every subsequent item's text
            meta = meta.drop_duplicates(subset="_key", keep="first")
            joined = items.merge(
                meta[["_key", "_text"]], left_on="item_id", right_on="_key",
                how="left",
            )
            assert len(joined) == len(items)
            items["text"] = (
                joined["item_id"] + " | " + joined["_text"].fillna("")
            ).str.rstrip(" |")
    return items


def main() -> None:
    p = argparse.ArgumentParser(description="Prepare steam-200k parquet")
    add_paths_arg(p)
    p.add_argument("--csv", type=str, required=True)
    p.add_argument("--metadata-csv", type=str, default=None)
    p.add_argument("--no-log1p", action="store_true")
    a = p.parse_args()
    paths = cli_setup(a)
    df = load_steam_200k(Path(a.csv))
    ratings = build_ratings(df, use_log1p=not a.no_log1p)
    items = build_items(df, Path(a.metadata_csv) if a.metadata_csv else None)
    ratings.to_parquet(paths.data / "ratings.parquet", index=False)
    items.to_parquet(paths.data / "items.parquet", index=False)
    print(f"wrote {len(ratings)} ratings / {len(items)} items to {paths.data}")


if __name__ == "__main__":
    main()
