"""Popularity baseline: rank items by interaction count or damped mean
rating (PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/popularity.py``, copied:
host numpy, as there, since fitting is one ``bincount`` over the rating
stream and serving an argsort over ``n_items`` floats, with nothing for a
device to do. It has no ``device`` argument.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.models.base import RecommenderBase


class _ScoreMode(str):
    """The ranking mode read back from ``Popularity.score``: equal to the
    string the constructor took, and callable as sklearn's
    ``score(X, y)`` (R^2 of ``predict``), which the constructor's
    argument of the same name would otherwise hide."""

    def __new__(cls, mode, model):
        obj = super().__new__(cls, mode)
        obj._model = model
        return obj

    def __call__(self, X, y, sample_weight=None):
        try:
            from sklearn.base import RegressorMixin
        except ImportError as e:
            raise TypeError("Popularity.score(X, y) needs sklearn") from e
        return RegressorMixin.score(self._model, X, y, sample_weight=sample_weight)


class _ScoreParam:
    """Data descriptor of ``Popularity.score``: stores the constructor's
    argument unchanged (sklearn's ``clone`` checks identity) and reads it
    back as a :class:`_ScoreMode`."""

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return _ScoreMode(obj.__dict__["_score_mode"], obj)

    def __set__(self, obj, value):
        obj.__dict__["_score_mode"] = value


class Popularity(RecommenderBase):
    """Non-personalized popularity ranker.

    ``score``: 'count' ranks by raw interaction count (the
    implicit-feedback baseline); 'mean' by the damped item mean rating
    ``(sum_r + damping * global_mean) / (count + damping)``. ``damping``
    is the pseudo-count ('mean' only). ``predict`` is user-independent;
    ``bound_ratings`` clamps only in 'mean' mode (counts are not on the
    rating scale).
    """

    def __init__(self, score: str = "count", damping: float = 10.0,
                 min_rating: float = 0, max_rating: float = 5,
                 verbose: int = 0):
        super().__init__(min_rating=min_rating, max_rating=max_rating,
                         verbose=verbose)
        if score not in ("count", "mean"):
            raise ValueError(f"score must be 'count' or 'mean', got {score!r}")
        self.score = score
        self.damping = damping

    score = _ScoreParam()

    def get_params(self, deep: bool = True) -> dict:
        """sklearn's parameters, ``score`` as the constructor took it."""
        params = super().get_params(deep=deep)
        params["score"] = self._score_mode
        return params

    def _recompute_scores(self) -> None:
        if self.score == "mean":
            self.item_scores_ = (
                self._item_sums + self.damping * self.global_mean
            ) / (self._item_counts + self.damping)
        else:
            self.item_scores_ = self._item_counts.astype(np.float32)

    # -- lifecycle ----------------------------------------------------------
    def fit(self, X: pd.DataFrame, y: pd.Series):
        _u, i, r = self._preprocess_fit(X, y)
        n = self.n_items
        self._item_counts = np.bincount(i, minlength=n).astype(np.float32)
        self._item_sums = np.bincount(i, weights=r, minlength=n).astype(np.float32)
        self.global_mean = float(r.mean()) if len(r) else 0.0
        self._recompute_scores()
        return self

    def update_users(self, X: pd.DataFrame, y: pd.Series, **_ignored):
        """Fold new ratings into the item statistics; new users are
        registered in the vocabulary, ratings of unknown items dropped."""
        self._require_fitted()
        _u, i, r, _known, _new = self._preprocess_update(X, y)
        if len(i):
            n = self.n_items
            self._item_counts += np.bincount(i, minlength=n).astype(np.float32)
            self._item_sums += np.bincount(i, weights=r, minlength=n).astype(np.float32)
            total = self._item_counts.sum()
            if total > 0:
                self.global_mean = float(self._item_sums.sum() / total)
        self._recompute_scores()
        return self

    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        self._require_fitted()
        u, i = self._preprocess_predict(X)
        preds, possible = self._predict_dense(u, i, bound_ratings=bound_ratings)
        self.predictions_possible = possible.tolist()
        return preds.tolist()

    def _predict_dense(self, u, i, bound_ratings: bool):
        i = np.asarray(i)
        known = i >= 0
        fallback = self.global_mean if self.score == "mean" else 0.0
        preds = np.where(known, self.item_scores_[np.clip(i, 0, None)], fallback)
        preds = preds.astype(np.float32)
        if bound_ratings and self.score == "mean":
            preds = np.clip(preds, self.min_rating, self.max_rating)
        return preds, known

    # -- serving ------------------------------------------------------------
    def recommend(self, user, amount: int = 10, items_known=None,
                  include_user: bool = True, bound_ratings: bool = True):
        # the generic clip to [min_rating, max_rating] would flatten counts
        if self.score == "count":
            bound_ratings = False
        return super().recommend(user, amount=amount, items_known=items_known,
                                 include_user=include_user,
                                 bound_ratings=bound_ratings)

    def recommend_batch(self, users, amount: int = 10, items_known_map=None,
                        bound_ratings: bool = True) -> pd.DataFrame:
        """One ranking of the catalog, cut per user after masking that
        user's known items (the JAX package's batched catalog path)."""
        self._require_fitted()
        if self.score == "count":
            bound_ratings = False
        items_known_map = items_known_map or {}
        raw_items = self.item_vocab.raw_ids
        frames = []
        for user in users:
            s = self.item_scores_
            known = items_known_map.get(user)
            if known:
                kd = self.item_vocab.encode(np.asarray(list(known), dtype=object))
                s = s.copy()
                s[kd[kd >= 0]] = -np.inf
            order = np.argsort(-s, kind="stable")[:amount]
            order = order[np.isfinite(s[order])]
            preds = s[order]
            if bound_ratings:
                preds = np.clip(preds, self.min_rating, self.max_rating)
            frames.append(pd.DataFrame({
                "user_id": [user] * len(order),
                "item_id": [raw_items[x] for x in order],
                "rating_pred": preds,
            }))
        return pd.concat(frames, ignore_index=True)
