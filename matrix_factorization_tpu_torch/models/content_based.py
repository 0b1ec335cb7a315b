"""Content-based recommender over item feature vectors (PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/content_based.py``.
Reference: ``matrix_factorization/content_based.py``: ``fit`` takes an
optional ``item_features`` DataFrame (``:39-70``); with features it builds
an item-item cosine-similarity matrix (``:136-148``) and rating-weighted
user profiles (``:89-134``); without them a user's profile is their mean
rating (``:72-87``).

The profiles are segment sums over the ratings sorted by user (the
deterministic kernel of ``ops/segment_sum.py``, one column for the means,
one a feature for the weighted profiles); the similarity matrix is one
f32 product (``ops/similarity.py::cosine_rows``); the profiles, feature
matrix and predictions stay on ``device`` (``None`` = CUDA).

As in the JAX package: ``predict`` returns the **mean of the user's
profile vector** whatever the item (the reference's contract, ``:191-223``)
unless ``predict_mode='similarity'``, which scores the cosine of the
profile and the item's features mapped onto the rating range; the
reference's rating-misalignment bug (``content_based.py:51``) is not
reproduced (PARITY.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.models.base import RecommenderBase
from matrix_factorization_tpu_torch.ops.segment_sum import segment_sums, sorted_order
from matrix_factorization_tpu_torch.ops.similarity import cosine_rows


class ContentBasedRecommender(RecommenderBase):
    def __init__(
        self,
        min_rating: float = 0,
        max_rating: float = 5,
        verbose: int = 0,
        predict_mode: str = "profile_mean",
        device=None,
    ):
        if predict_mode not in ("profile_mean", "similarity"):
            raise ValueError("predict_mode must be 'profile_mean' or 'similarity'")
        super().__init__(min_rating=min_rating, max_rating=max_rating, verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.predict_mode = predict_mode
        self.item_features: Optional[pd.DataFrame] = None
        self.item_similarity_matrix: Optional[np.ndarray] = None
        self._profiles = None  # (U,) scalar profiles or (U, D) vectors
        self._feature_matrix = None  # (I, D) dense-id aligned, 0 for missing
        self._has_features = None  # (I,) bool

    def fit(self, X: pd.DataFrame, y: pd.Series, item_features: pd.DataFrame = None):
        u, i, r = self._preprocess_fit(X, y)
        self.global_mean = float(np.mean(r))
        dev = self._device
        ut = torch.from_numpy(u).to(dev)
        it = torch.from_numpy(i).to(dev).long()
        rt = torch.tensor(r, device=dev)
        by_user = sorted_order(ut)

        if item_features is None:
            # profile = the user's mean rating (reference :72-87)
            s = segment_sums(rt, by_user, self.n_users)
            n = segment_sums(torch.ones_like(rt), by_user, self.n_users)
            self._profiles = torch.where(n > 0, s / n.clamp(min=1),
                                         self.global_mean)
            return self

        if "item_id" not in item_features.columns:
            raise ValueError("item_features must contain 'item_id' column")
        self.item_features = item_features.copy()
        feat_cols = [c for c in item_features.columns if c != "item_id"]
        dense = self.item_vocab.encode(item_features["item_id"].to_numpy())
        keep = dense >= 0
        F = np.zeros((self.n_items, len(feat_cols)), np.float32)
        F[dense[keep]] = item_features[feat_cols].to_numpy(np.float32)[keep]
        has = np.zeros(self.n_items, bool)
        has[dense[keep]] = True
        F_t = torch.from_numpy(F).to(dev)
        has_t = torch.from_numpy(has).to(dev)
        self._feature_matrix = F_t
        self._has_features = has_t

        # item-item cosine similarity over feature rows, dense-id aligned
        self.item_similarity_matrix = cosine_rows(F_t).cpu().numpy()

        # rating-weighted profile: weight = rating - min_rating, items
        # without features skipped entirely (reference :114-132)
        w = (rt - self.min_rating) * has_t[it].float()
        num = segment_sums(w[:, None] * F_t[it], by_user, self.n_users)
        den = segment_sums(w, by_user, self.n_users)
        self._profiles = torch.where(den[:, None] > 0,
                                     num / den[:, None].clamp(min=1e-12), 0.0)
        return self

    # -- prediction ----------------------------------------------------------
    def _predict_arrays(self, u: np.ndarray, i: np.ndarray, bound_ratings: bool):
        self._require_fitted()
        if self._profiles is None:
            raise RuntimeError("Model is not fitted")
        dev = self._device
        ut = torch.from_numpy(np.asarray(u, np.int64)).to(dev)
        iv = torch.from_numpy(np.asarray(i, np.int64)).to(dev)
        possible = (ut >= 0) & (iv >= 0)
        us = ut.clamp(min=0)
        if self._profiles.dim() == 1:  # no-feature mode: scalar profiles
            pred = self._profiles[us]
        elif self.predict_mode == "similarity":
            isafe = iv.clamp(min=0)
            prof = self._profiles[us]
            feat = self._feature_matrix[isafe]
            pn = torch.linalg.vector_norm(prof, dim=1)
            fn = torch.linalg.vector_norm(feat, dim=1)
            cos = torch.sum(prof * feat, dim=1) / (pn * fn).clamp(min=1e-12)
            # map cosine [0, 1] onto the rating range
            pred = self.min_rating + cos * (self.max_rating - self.min_rating)
            pred = torch.where(self._has_features[isafe], pred, self.global_mean)
        else:  # reference parity: mean of the profile vector (:213-215)
            prof = self._profiles[us]
            pred = (prof.mean(dim=1) if prof.shape[1] > 0
                    else torch.full((prof.shape[0],), self.global_mean,
                                    device=dev))
        pred = torch.where(possible, pred, self.global_mean)
        if bound_ratings:
            pred = pred.clamp(self.min_rating, self.max_rating)
        return (pred.cpu().numpy().astype(np.float64),
                possible.cpu().numpy())

    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        if X.shape[0] == 0:
            return []
        u, i = self._preprocess_predict(X)
        preds, possible = self._predict_arrays(u, i, bound_ratings)
        self.predictions_possible = possible.tolist()
        return preds.tolist()

    def _predict_dense(self, u, i, bound_ratings):
        return self._predict_arrays(
            np.asarray(u, np.int32), np.asarray(i, np.int32), bound_ratings
        )

    @property
    def user_profiles(self) -> dict:
        """Reference-compatible ``{dense_user_id: profile}`` view."""
        if self._profiles is None:
            return {}
        prof = self._profiles.cpu().numpy()
        return {idx: prof[idx] for idx in range(self.n_users)}
