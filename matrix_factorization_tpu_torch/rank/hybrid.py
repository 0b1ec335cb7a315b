"""Hybrid scoring: alpha-blend of model predictions and retrieval sims (a
copy of ``matrix_factorization_tpu/rank/hybrid.py``; ``model_scores``
calls the port's models).

Reference: ``project_template/app/api.py:100-134`` — both score vectors
are min-max normalized onto [0, 1] and blended as
``alpha * model + (1 - alpha) * sim``; model scoring degrades softly to
zeros on any exception (``api.py:43-52``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import pandas as pd


def minmax(x: np.ndarray) -> np.ndarray:
    """Min-max onto [0,1]; constant vectors map to zeros."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-8:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def model_scores(model, user_id, item_ids: Sequence) -> np.ndarray:
    """Unbounded model predictions for (user, candidates); zeros if the
    user is unknown or prediction fails (reference api.py:43-52)."""
    if model is None or user_id is None:
        return np.zeros(len(item_ids), np.float32)
    try:
        if not model.contains_user(user_id):
            return np.zeros(len(item_ids), np.float32)
        X = pd.DataFrame(
            {"user_id": [user_id] * len(item_ids), "item_id": list(item_ids)}
        )
        preds = model.predict(X, bound_ratings=False)
        return np.asarray(preds, np.float32)
    except Exception:
        return np.zeros(len(item_ids), np.float32)


def blend(
    model_s: np.ndarray, sim_s: np.ndarray, alpha: float
) -> np.ndarray:
    return alpha * minmax(model_s) + (1.0 - alpha) * minmax(sim_s)


def hybrid_rank(
    candidates: List[Tuple[object, float]],
    model,
    user_id,
    alpha: float,
    k: int,
) -> List[Tuple[object, float]]:
    """Rank retrieval candidates [(item_id, sim)] by the blended score."""
    if not candidates:
        return []
    ids = [c[0] for c in candidates]
    sims = np.asarray([c[1] for c in candidates], np.float32)
    score = blend(model_scores(model, user_id, ids), sims, alpha)
    order = np.argsort(-score)[:k]
    return [(ids[int(i)], float(score[int(i)])) for i in order]
