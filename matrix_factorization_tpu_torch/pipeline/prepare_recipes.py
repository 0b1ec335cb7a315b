"""Recipes full-dataset preparation (reference
prepare_recipes_full_dataset.py:71-141): the 2.2M-row recipes CSV
(title/ingredients/directions/link/NER) becomes items.parquet with
``text = "title: ...\\ningredients: a; b\\ndirections: ..."``, written in
chunks through pyarrow so memory stays bounded. Host-only; a copy of
``matrix_factorization_tpu/pipeline/prepare_recipes.py``.
"""

from __future__ import annotations

import argparse
import ast
import json
from pathlib import Path
import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup


def _as_list(x) -> list:
    """Recipes CSV stores list columns as JSON-ish strings."""
    if isinstance(x, list):
        return x
    if not isinstance(x, str) or not x.strip():
        return []
    for parser in (json.loads, ast.literal_eval):
        try:
            v = parser(x)
            return v if isinstance(v, list) else [str(v)]
        except Exception:
            continue
    return [x]


def _row_text(title, ingredients, directions) -> str:
    ing = "; ".join(str(s).strip() for s in _as_list(ingredients) if str(s).strip())
    dirs = " ".join(str(s).strip() for s in _as_list(directions) if str(s).strip())
    return f"title: {str(title).strip()}\ningredients: {ing}\ndirections: {dirs}"


def prepare_items_parquet(
    csv_path: Path,
    out_path: Path,
    max_rows: int = 0,
    chunksize: int = 100_000,
) -> int:
    import pyarrow as pa
    import pyarrow.parquet as pq

    schema = pa.schema([("item_id", pa.string()), ("text", pa.string())])
    out_path.parent.mkdir(parents=True, exist_ok=True)
    writer = pq.ParquetWriter(out_path, schema)
    written = 0
    try:
        for chunk in pd.read_csv(csv_path, chunksize=chunksize):
            cols = {c.lower(): c for c in chunk.columns}
            title_c = cols.get("title")
            ing_c = cols.get("ingredients")
            dir_c = cols.get("directions")
            texts = [
                _row_text(t, i, d)
                for t, i, d in zip(chunk[title_c], chunk[ing_c], chunk[dir_c])
            ]
            ids = [str(written + j) for j in range(len(texts))]
            writer.write_table(
                pa.table({"item_id": ids, "text": texts}, schema=schema)
            )
            written += len(texts)
            if max_rows and written >= max_rows:
                break
    finally:
        writer.close()
    print(f"wrote {written} items to {out_path}")
    return written


def main() -> None:
    p = argparse.ArgumentParser(description="Prepare recipes items.parquet")
    add_paths_arg(p)
    p.add_argument("--csv", type=str, required=True)
    p.add_argument("--max-rows", type=int, default=0)
    p.add_argument("--chunksize", type=int, default=100_000)
    a = p.parse_args()
    paths = cli_setup(a)
    prepare_items_parquet(Path(a.csv), paths.data / "items.parquet",
                          a.max_rows, a.chunksize)


if __name__ == "__main__":
    main()
