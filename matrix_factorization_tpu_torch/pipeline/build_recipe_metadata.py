"""items.parquet -> features/recipe_meta.parquet
(reference build_recipe_metadata.py:38-86): time_min, 8 allergen flags,
protein / low-calorie scores, ingredients_count per item. Host-only; a copy
of ``matrix_factorization_tpu/pipeline/build_recipe_metadata.py``."""

from __future__ import annotations

import argparse

import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns
from matrix_factorization_tpu_torch.rank.recipe_features import featurize_item_text


def build_recipe_metadata(items: pd.DataFrame) -> pd.DataFrame:
    rows = [featurize_item_text(t) for t in items["text"].fillna("")]
    meta = pd.DataFrame(rows)
    meta.insert(0, "item_id", items["item_id"].astype(str).to_numpy())
    return meta


def main() -> None:
    p = argparse.ArgumentParser(description="Build recipe metadata features")
    add_paths_arg(p)
    p.add_argument("--max-rows", type=int, default=0)
    a = p.parse_args()
    paths = cli_setup(a)
    items = pd.read_parquet(paths.data / "items.parquet")
    require_columns(items, ["item_id", "text"], "items")
    if a.max_rows:
        items = items.head(a.max_rows)
    meta = build_recipe_metadata(items)
    paths.features.mkdir(parents=True, exist_ok=True)
    out = paths.features / "recipe_meta.parquet"
    meta.to_parquet(out, index=False)
    print(f"wrote {out} ({len(meta)} rows)")


if __name__ == "__main__":
    main()
