"""Cross-model evaluation harness: RMSE/MAE + P/R/F1@K + coverage +
diversity on one holdout split (PyTorch port of
``matrix_factorization_tpu/eval/evaluator.py``; the model's ``predict``
and ``recommend`` run where the model's tensors are).

Reference counterpart: the ``RecommenderEvaluator`` class defined in
``examples/recommender-evaluation.ipynb`` (cells 19-20), which produced
the published model-comparison table (SURVEY.md §6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.utils.metrics import (
    f1_score,
    mae,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
    rmse,
)


@dataclass
class EvalReport:
    rmse: float
    mae: float
    precision: float
    recall: float
    f1: float
    ndcg: float
    coverage: float
    diversity: float
    n_users: int

    def as_dict(self) -> Dict[str, float]:
        return dict(self.__dict__)


class RecommenderEvaluator:
    """Evaluate a fitted model on a test split.

    Ranking protocol (as in the reference notebook): per test user, items
    rated >= ``positive_threshold`` in the test split are relevant;
    recommendations exclude the user's *train* items; coverage = fraction
    of the catalog that appears in any top-K list; diversity = 1 - mean
    pairwise overlap of users' recommendation lists (Jaccard).
    """

    def __init__(self, k: int = 10, positive_threshold: float = 4.0,
                 max_users: int = 0):
        self.k = k
        self.positive_threshold = positive_threshold
        self.max_users = max_users

    def evaluate(
        self,
        model,
        X_train: pd.DataFrame,
        X_test: pd.DataFrame,
        y_test: pd.Series,
    ) -> EvalReport:
        preds = model.predict(X_test)
        r = rmse(y_test, preds)
        m = mae(y_test, preds)

        test = X_test.copy()
        test["rating"] = np.asarray(y_test)
        train_items_by_user = X_train.groupby("user_id")["item_id"].agg(set)
        # one groupby instead of a full-column scan per user
        relevant_by_user = (
            test.loc[test["rating"] >= self.positive_threshold]
            .groupby("user_id")["item_id"]
            .agg(set)
        )

        users = test["user_id"].unique()
        if self.max_users:
            users = users[: self.max_users]

        ps, rs, ns = [], [], []
        rec_lists: List[set] = []
        recommended_all: set = set()
        for u in users:
            rel = relevant_by_user.get(u, set())
            if not rel or not model.contains_user(u):
                continue
            known = train_items_by_user.get(u, set())
            recs = model.recommend(user=u, amount=self.k, items_known=known)
            rec_items = list(recs["item_id"])
            ps.append(precision_at_k(rec_items, rel, self.k))
            rs.append(recall_at_k(rec_items, rel, self.k))
            ns.append(ndcg_at_k(rec_items, rel, self.k))
            rec_lists.append(set(rec_items))
            recommended_all.update(rec_items)

        if not ps:
            return EvalReport(r, m, 0, 0, 0, 0, 0, 0, 0)

        p, rc = float(np.mean(ps)), float(np.mean(rs))
        coverage = len(recommended_all) / max(1, model.n_items)
        if len(rec_lists) > 1:
            sims = []
            sample = rec_lists[:200]  # bound the O(n^2) pair loop
            for i in range(len(sample)):
                for j in range(i + 1, len(sample)):
                    inter = len(sample[i] & sample[j])
                    union = len(sample[i] | sample[j])
                    sims.append(inter / union if union else 0.0)
            diversity = 1.0 - float(np.mean(sims)) if sims else 1.0
        else:
            diversity = 1.0
        return EvalReport(
            rmse=r, mae=m, precision=p, recall=rc, f1=f1_score(p, rc),
            ndcg=float(np.mean(ns)), coverage=coverage, diversity=diversity,
            n_users=len(ps),
        )

    def compare(self, models: Dict[str, object], X_train, y_train, X_test,
                y_test) -> pd.DataFrame:
        """Fit + evaluate several models on the same split -> table."""
        rows = {}
        for name, model in models.items():
            model.fit(X_train, y_train)
            rows[name] = self.evaluate(model, X_train, X_test, y_test).as_dict()
        return pd.DataFrame(rows).T
