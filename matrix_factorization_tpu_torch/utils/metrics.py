"""Rating + ranking metrics (a copy of
``matrix_factorization_tpu/utils/metrics.py``).

RMSE/MAE mirror the reference's evaluation in notebooks/examples
(``examples/example.py:40-43``); ranking metrics mirror
``project_template/pipeline/evaluate.py:21-111`` (Precision/Recall/NDCG@K).
All are numpy — no per-user python loops on the hot path.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def rmse(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def mae(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs(y_true - y_pred)))


def precision_at_k(recommended: Sequence, relevant: set, k: int) -> float:
    if k == 0:
        return 0.0
    top = list(recommended)[:k]
    return sum(1 for r in top if r in relevant) / k


def recall_at_k(recommended: Sequence, relevant: set, k: int) -> float:
    if not relevant:
        return 0.0
    top = list(recommended)[:k]
    return sum(1 for r in top if r in relevant) / len(relevant)


def ndcg_at_k(recommended: Sequence, relevant: set, k: int) -> float:
    """Binary-relevance NDCG@K (reference evaluate.py:21-30)."""
    top = list(recommended)[:k]
    dcg = sum(1.0 / np.log2(idx + 2.0) for idx, r in enumerate(top) if r in relevant)
    ideal = sum(1.0 / np.log2(idx + 2.0) for idx in range(min(len(relevant), k)))
    return float(dcg / ideal) if ideal > 0 else 0.0


def f1_score(p: float, r: float) -> float:
    return 0.0 if (p + r) == 0 else 2 * p * r / (p + r)


def topk_report(per_user_recs: Dict, per_user_relevant: Dict, k: int) -> Dict[str, float]:
    """Aggregate P/R/F1/NDCG@K over users that have any relevant items."""
    ps, rs, ns = [], [], []
    for user, recs in per_user_recs.items():
        rel = per_user_relevant.get(user, set())
        if not rel:
            continue
        ps.append(precision_at_k(recs, rel, k))
        rs.append(recall_at_k(recs, rel, k))
        ns.append(ndcg_at_k(recs, rel, k))
    if not ps:
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0, "ndcg": 0.0, "n_users": 0}
    p, r = float(np.mean(ps)), float(np.mean(rs))
    return {
        "precision": p,
        "recall": r,
        "f1": f1_score(p, r),
        "ndcg": float(np.mean(ns)),
        "n_users": len(ps),
    }
