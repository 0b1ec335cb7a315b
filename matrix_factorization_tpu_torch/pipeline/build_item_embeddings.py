"""items.parquet -> features/items_emb.parquet (normalized embeddings)
(reference build_item_embeddings.py:22-50; sentence-transformers swapped
for the gated transformer / hermetic hash encoder — see retrieval.encode).
Host-only; the port of ``matrix_factorization_tpu/pipeline/build_item_embeddings.py``,
whose frame it builds in one piece instead of a column at a time."""

from __future__ import annotations

import argparse

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns
from matrix_factorization_tpu_torch.retrieval.encode import embed_texts


def main() -> None:
    p = argparse.ArgumentParser(description="Build dense item embeddings")
    add_paths_arg(p)
    p.add_argument("--model", type=str, default=None,
                   help="HF model name; omit for the hermetic hash encoder")
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--max-rows", type=int, default=0)
    a = p.parse_args()
    paths = cli_setup(a)
    items = pd.read_parquet(paths.data / "items.parquet")
    require_columns(items, ["item_id", "text"], "items")
    if a.max_rows:
        items = items.head(a.max_rows)
    emb = embed_texts(items["text"].fillna("").astype(str).tolist(),
                      model_name=a.model, dim=a.dim)
    out = pd.concat(
        [pd.DataFrame({"item_id": items["item_id"].astype(str).to_numpy()}),
         pd.DataFrame(np.asarray(emb, np.float32),
                      columns=[f"e{j}" for j in range(emb.shape[1])])],
        axis=1)
    paths.features.mkdir(parents=True, exist_ok=True)
    out.to_parquet(paths.features / "items_emb.parquet", index=False)
    print(f"wrote {paths.features / 'items_emb.parquet'} dim={emb.shape[1]}")


if __name__ == "__main__":
    main()
