"""items.parquet -> features/items_text_enriched.parquet (tags + summary)
(reference build_text_enrichment.py:119-148): TF-IDF top-k keyword tags by
default (``:42-64``), optional LLM JSON extraction behind OPENAI_API_KEY
(``:75-116``). Host-only (sklearn; openai for the LLM provider); a copy of
``matrix_factorization_tpu/pipeline/build_text_enrichment.py``."""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns


def keyword_tags(texts: List[str], top_k: int = 8) -> List[List[str]]:
    from sklearn.feature_extraction.text import TfidfVectorizer

    vec = TfidfVectorizer(max_features=20_000, min_df=1, stop_words="english")
    m = vec.fit_transform(texts)
    vocab = np.asarray(vec.get_feature_names_out())
    out = []
    for row in range(m.shape[0]):
        r = m.getrow(row)
        if r.nnz == 0:
            out.append([])
            continue
        order = np.argsort(-r.data)[:top_k]
        out.append(vocab[r.indices[order]].tolist())
    return out


def llm_enrich(texts: List[str], model: str) -> List[dict]:
    from openai import OpenAI  # gated optional dep

    client = OpenAI(api_key=os.environ["OPENAI_API_KEY"])
    out = []
    for t in texts:
        try:
            resp = client.chat.completions.create(
                model=model,
                messages=[{
                    "role": "user",
                    "content": "Extract JSON {\"tags\": [..], \"summary\": \"..\"} "
                    "from this recipe:\n" + t[:2000],
                }],
                response_format={"type": "json_object"},
            )
            out.append(json.loads(resp.choices[0].message.content))
        except Exception:
            out.append({"tags": [], "summary": ""})
    return out


def main() -> None:
    p = argparse.ArgumentParser(description="Enrich item texts with tags/summary")
    add_paths_arg(p)
    p.add_argument("--provider", choices=["keywords", "openai"], default="keywords")
    p.add_argument("--openai-model", default="gpt-4o-mini")
    p.add_argument("--top-k", type=int, default=8)
    p.add_argument("--max-rows", type=int, default=0)
    a = p.parse_args()
    paths = cli_setup(a)
    items = pd.read_parquet(paths.data / "items.parquet")
    require_columns(items, ["item_id", "text"], "items")
    if a.max_rows:
        items = items.head(a.max_rows)
    texts = items["text"].fillna("").astype(str).tolist()

    if a.provider == "openai":
        rich = llm_enrich(texts, a.openai_model)
        tags = [r.get("tags", []) for r in rich]
        summaries = [r.get("summary", "") for r in rich]
    else:
        tags = keyword_tags(texts, a.top_k)
        summaries = [
            (t.splitlines()[0][:120] if t.strip() else "") for t in texts
        ]

    out = pd.DataFrame(
        {
            "item_id": items["item_id"].astype(str).to_numpy(),
            "tags": [json.dumps(t) for t in tags],
            "summary": summaries,
        }
    )
    paths.features.mkdir(parents=True, exist_ok=True)
    dest = paths.features / "items_text_enriched.parquet"
    out.to_parquet(dest, index=False)
    print(f"wrote {dest} ({len(out)} rows, provider={a.provider})")


if __name__ == "__main__":
    main()
