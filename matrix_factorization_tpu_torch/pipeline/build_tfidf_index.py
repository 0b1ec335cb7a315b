"""items.parquet -> artifacts/item_index.pkl (TF-IDF)
(reference build_tfidf_index.py:14-52). Host-only (sklearn); a copy of
``matrix_factorization_tpu/pipeline/build_tfidf_index.py``."""

from __future__ import annotations

import argparse

import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns
from matrix_factorization_tpu_torch.retrieval.index import build_tfidf_index, save_item_index


def main() -> None:
    p = argparse.ArgumentParser(description="Build TF-IDF item index")
    add_paths_arg(p)
    p.add_argument("--max-features", type=int, default=50_000)
    p.add_argument("--min-df", type=int, default=2)
    p.add_argument("--max-rows", type=int, default=0)
    a = p.parse_args()
    paths = cli_setup(a)
    items = pd.read_parquet(paths.data / "items.parquet")
    require_columns(items, ["item_id", "text"], "items")
    if a.max_rows:
        items = items.head(a.max_rows)
    idx = build_tfidf_index(
        items["item_id"].astype(str).tolist(),
        items["text"].fillna("").astype(str).tolist(),
        max_features=a.max_features,
        min_df=a.min_df,
    )
    out = paths.artifacts / "item_index.pkl"
    save_item_index(idx, out)
    print(f"wrote {out} (n_items={len(idx.item_ids)}, vocab={idx.matrix.shape[1]})")


if __name__ == "__main__":
    main()
