"""Weak-supervision reranker training CLI
(reference train_reranker.py:222-330): synthesize queries from seed items,
positives = the seed's own retrieval hit, hard negatives from the same
top-k, 17 features, balanced logistic regression (PyTorch port of
``matrix_factorization_tpu/pipeline/train_reranker.py``: the reranker
trains and a dense index retrieves on ``--platform``'s device, default the
GPU; the payload schema is JAX's, with the port's
``TorchLogisticRegression`` / ``TorchMLPReranker`` as its model)."""

from __future__ import annotations

import argparse
import pickle
import random
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup, require_columns
from matrix_factorization_tpu_torch.rank.reranker import (
    FEATURE_NAMES,
    TorchLogisticRegression,
    TorchMLPReranker,
    featurize,
    generate_queries,
)
from matrix_factorization_tpu_torch.retrieval.index import TfidfItemIndex, load_item_index
from matrix_factorization_tpu_torch.retrieval.search import (
    encode_query_for_index,
    search_topk_pos,
)


def train_reranker(
    *,
    items: pd.DataFrame,
    index,
    meta: Optional[pd.DataFrame] = None,
    n_seed_items: int = 200,
    candidate_k: int = 30,
    n_neg: int = 3,
    seed: int = 0,
    embedding_model: Optional[str] = None,
    log_every: int = 0,
    model_type: str = "logreg",
    device=None,
) -> Dict[str, Any]:
    """``model_type``: 'logreg' (reference parity) or 'mlp' (one-hidden-
    layer upgrade, same payload schema — rank.reranker.TorchMLPReranker);
    ``device``: where a dense index retrieves and the reranker trains
    (``None`` = CUDA)."""
    if model_type not in ("logreg", "mlp"):
        raise ValueError("model_type must be 'logreg' or 'mlp'")
    require_columns(items, ["item_id", "text"], "items")
    items = items.copy()
    items["item_id"] = items["item_id"].astype(str)
    items["text"] = items["text"].fillna("").astype(str)
    if n_seed_items > 0:
        items = items.head(n_seed_items)

    index_type = "tfidf" if isinstance(index, TfidfItemIndex) else "dense"
    emb_model = None if index_type == "tfidf" else embedding_model

    meta_map: Dict[str, pd.Series] = {}
    if meta is not None and "item_id" in meta.columns:
        meta = meta.copy()
        meta["item_id"] = meta["item_id"].astype(str)
        meta_map = {r["item_id"]: r for _, r in meta.iterrows()}

    rng = random.Random(seed)
    X_rows, y_rows = [], []
    for i_row, (_, row) in enumerate(items.iterrows(), start=1):
        seed_id, seed_text = row["item_id"], row["text"]
        if log_every and (i_row == 1 or i_row % log_every == 0):
            print(f"[progress] seed_items={i_row}/{len(items)} "
                  f"samples={len(y_rows)} index_type={index_type}")
        for q in generate_queries(seed_text, rng):
            qvec = encode_query_for_index(index, q, model_name=emb_model)
            cand = search_topk_pos(index, qvec, k=candidate_k, device=device)
            hit = next((c for c in cand if str(c[1]) == seed_id), None)
            if hit is None:
                continue
            pos, _, sim = hit
            X_rows.append(
                featurize(q, index.texts[pos], float(sim), meta_map.get(seed_id))
            )
            y_rows.append(1)
            negs = [c for c in cand if str(c[1]) != seed_id]
            rng.shuffle(negs)
            for npos, nid, nsim in negs[:n_neg]:
                X_rows.append(
                    featurize(q, index.texts[npos], float(nsim),
                              meta_map.get(str(nid)))
                )
                y_rows.append(0)

    if not X_rows:
        raise RuntimeError(
            "No training samples: queries could not retrieve their seed items"
            " (check index type / corpus language / candidate_k)."
        )
    X = np.vstack(X_rows).astype(np.float32)
    y = np.asarray(y_rows, np.int32)
    if model_type == "mlp":
        clf = TorchMLPReranker(seed=seed, device=device).fit(X, y)
    else:
        clf = TorchLogisticRegression(device=device).fit(X, y)

    return {
        "model_type": model_type,
        "index_type": index_type,
        "feature_names": FEATURE_NAMES,
        "model": clf,
        "config": {
            "n_seed_items": n_seed_items,
            "candidate_k": candidate_k,
            "n_neg": n_neg,
            "seed": seed,
            "embedding_model": emb_model,
            "meta_used": bool(meta_map),
        },
        "train_stats": {"n_samples": int(X.shape[0]),
                        "pos_rate": float(y.mean())},
    }


def main() -> None:
    p = argparse.ArgumentParser(description="Train the weak-supervision reranker")
    add_paths_arg(p)
    p.add_argument("--n-seed-items", type=int, default=200)
    p.add_argument("--candidate-k", type=int, default=30)
    p.add_argument("--n-neg", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--embedding-model", type=str, default=None)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--model-type", choices=["logreg", "mlp"],
                   default="logreg")
    a = p.parse_args()
    paths = cli_setup(a)
    items = pd.read_parquet(paths.data / "items.parquet")
    index = load_item_index(paths.artifacts / "item_index.pkl")
    meta_path = paths.features / "recipe_meta.parquet"
    meta = pd.read_parquet(meta_path) if meta_path.exists() else None
    payload = train_reranker(
        items=items, index=index, meta=meta, n_seed_items=a.n_seed_items,
        candidate_k=a.candidate_k, n_neg=a.n_neg, seed=a.seed,
        embedding_model=a.embedding_model, log_every=a.log_every,
        model_type=a.model_type, device=a.platform,
    )
    out = paths.artifacts / "reranker.pkl"
    with out.open("wb") as f:
        pickle.dump(payload, f)
    print(f"wrote {out} ({payload['train_stats']})")


if __name__ == "__main__":
    main()
