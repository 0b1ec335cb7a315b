"""Top-K ranking evaluation via per-user holdout + ``model.recommend``
(PyTorch port of ``matrix_factorization_tpu/eval/topk_eval.py``; the
model's ``recommend`` runs where the model's tensors are).

Reference: ``project_template/pipeline/evaluate.py:40-111`` — per user,
sample ``n_test`` positives (rating >= threshold, falling back to the
highest-rated) as the relevant set, exclude the rest as ``items_known``,
recommend, and average Precision/Recall/NDCG@K over users.

With ``max_users`` set only the evaluated users' rows are grouped (JAX
groups every user's: 162,000 frames at MovieLens-25M for a run that
evaluates 2,000). Each group holds the same rows in the same order, and
the users are split in the same order with the same ``RandomState``
draws, so the result is JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.core.config import require_columns


@dataclass(frozen=True)
class TopKResult:
    precision: float
    recall: float
    ndcg: float
    n_users: int = 0


def _ndcg_from_hits(hits: np.ndarray, k: int) -> float:
    dcg = float(np.sum(hits / np.log2(np.arange(2, hits.size + 2))))
    ideal_n = min(k, int(hits.sum())) if hits.sum() > 0 else 0
    if ideal_n == 0:
        return 0.0
    idcg = float(np.sum(1.0 / np.log2(np.arange(2, ideal_n + 2))))
    return dcg / idcg


def pick_test_items(
    user_hist: pd.DataFrame,
    n_test: int,
    positive_threshold: float,
    rng: np.random.RandomState,
) -> Tuple[List, List]:
    """Split one user's history into (train_items, test_items)."""
    if user_hist.shape[0] <= n_test:
        return [], []
    pos = user_hist[user_hist["rating"] >= positive_threshold]
    if pos.shape[0] >= n_test:
        test = pos.sample(n=n_test, random_state=rng)
    else:
        test = user_hist.sort_values("rating", ascending=False).head(n_test)
    test_items = test["item_id"].tolist()
    train_items = user_hist.loc[
        ~user_hist["item_id"].isin(test_items), "item_id"
    ].tolist()
    return train_items, test_items


def users_and_histories(ratings: pd.DataFrame, max_users: int = 0):
    """The users to evaluate (first-appearance order, the first
    ``max_users`` when it is set) and ``{user: history frame}`` of those
    users alone."""
    users = ratings["user_id"].unique()
    if max_users:
        users = users[:max_users]
        ratings = ratings[ratings["user_id"].isin(users)]
    return users, dict(tuple(ratings.groupby("user_id")))


def evaluate_topk(
    ratings: pd.DataFrame,
    model,
    k: int = 10,
    positive_threshold: float = 4.0,
    n_test: int = 2,
    seed: int = 0,
    max_users: int = 0,
) -> TopKResult:
    require_columns(ratings, ["user_id", "item_id", "rating"], "ratings")
    users, by_user = users_and_histories(ratings, max_users)
    rng = np.random.RandomState(seed)

    precisions, recalls, ndcgs = [], [], []
    for u in users:
        train_items, test_items = pick_test_items(
            by_user[u], n_test=n_test, positive_threshold=positive_threshold,
            rng=rng,
        )
        if not train_items or not test_items:
            continue
        relevant = set(test_items)
        rec = model.recommend(
            user=u, amount=k, items_known=train_items, include_user=False
        )
        hits = np.asarray(
            [1 if it in relevant else 0 for it in rec["item_id"]], np.int32
        )
        precisions.append(float(hits.mean()) if hits.size else 0.0)
        recalls.append(float(hits.sum() / max(1, len(relevant))))
        ndcgs.append(_ndcg_from_hits(hits, k))

    if not precisions:
        return TopKResult(0.0, 0.0, 0.0, 0)
    return TopKResult(
        precision=float(np.mean(precisions)),
        recall=float(np.mean(recalls)),
        ndcg=float(np.mean(ndcgs)),
        n_users=len(precisions),
    )
