"""items + items_emb -> artifacts/item_index.pkl (dense)
(reference export_artifacts.py:13-33). Host-only; the port of
``matrix_factorization_tpu/pipeline/export_artifacts.py``."""

from __future__ import annotations

import argparse

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns
from matrix_factorization_tpu_torch.retrieval.index import build_dense_index, save_item_index


def main() -> None:
    p = argparse.ArgumentParser(description="Export dense item index")
    add_paths_arg(p)
    a = p.parse_args()
    paths = cli_setup(a)
    items = pd.read_parquet(paths.data / "items.parquet")
    require_columns(items, ["item_id", "text"], "items")
    emb_df = pd.read_parquet(paths.features / "items_emb.parquet")
    emb_cols = [c for c in emb_df.columns if c.startswith("e")]
    merged = items.merge(emb_df, on="item_id", how="inner")
    idx = build_dense_index(
        merged["item_id"].astype(str).tolist(),
        merged["text"].fillna("").astype(str).tolist(),
        merged[emb_cols].to_numpy(np.float32),
    )
    out = paths.artifacts / "item_index.pkl"
    save_item_index(idx, out)
    print(f"wrote {out} (n_items={len(idx.item_ids)})")


if __name__ == "__main__":
    main()
