"""Implicit-feedback matrix factorization, confidence-weighted ALS
(PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/implicit.py``. The model
takes interaction strengths (counts, hours, clicks) rather than ratings:
preferences are binary (interacted or not), confidences grow with the
strength (``c = 1 + alpha * s``) and every unobserved pair is a weak
negative, the formulation of Hu, Koren and Volinsky (2008). Each sweep is
one shared k x k gram plus a batch of SPD solves
(``ops/ials.py::implicit_sweep``), whose Gauss-Jordan leaf is the
hand-written kernel of ``ops/cuda_spd.py`` on the GPU.

The lifecycle is ``RecommenderBase``'s: ``fit / predict / recommend /
update_users``. Predictions are preference scores in ~[0, 1], not
ratings; ``update_users`` solves the named users' rows exactly with the
item side frozen. ``device=None`` means CUDA; the initial tables come from
a ``torch.Generator`` seeded with ``seed`` (the JAX package's layout and
distribution, not its random bits).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.models.base import RecommenderBase, predict_on_device
from matrix_factorization_tpu_torch.ops import ials, scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd


class ImplicitALS(RecommenderBase):
    def __init__(
        self,
        n_factors: int = 64,
        n_epochs: int = 15,
        reg: float = 0.1,
        alpha: float = 40.0,
        init_sd: float = 0.01,
        verbose: int = 0,
        seed: int = 0,
        serving_dtype: str = "float32",
        device=None,
    ):
        """``alpha`` scales interaction strength into confidence
        (``c = 1 + alpha * strength``); strengths must be >= 0.
        ``serving_dtype``: 'float32' or 'bfloat16', the bf16 serving
        tables of ``KernelMF``. ``device``: where the tables live, ``None``
        meaning CUDA (``RuntimeError`` without a GPU)."""
        if serving_dtype not in ("float32", "bfloat16"):
            raise ValueError("serving_dtype must be 'float32' or 'bfloat16'")
        # preference scores live in ~[0, 1]
        super().__init__(min_rating=0.0, max_rating=1.0, verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.n_factors = n_factors
        self.n_epochs = n_epochs
        self.reg = reg
        self.alpha = alpha
        self.init_sd = init_sd
        self.seed = seed
        self.serving_dtype = serving_dtype
        self._params: Optional[sgd.MFParams] = None
        self._serving_cache = None
        self.train_loss: list = []

    def _cfg(self, compute_epoch_rmse: bool = True) -> SGDConfig:
        return SGDConfig(
            kernel="linear",
            n_factors=self.n_factors,
            reg=self.reg,
            min_rating=self.min_rating,
            max_rating=self.max_rating,
            compute_epoch_rmse=compute_epoch_rmse,
        )

    def fit(self, X: pd.DataFrame, y: pd.Series):
        """``y`` holds non-negative interaction strengths; zeros are
        observed but weak (c = 1). ``train_loss`` holds the exact
        confidence-weighted loss after each epoch."""
        u, i, r = self._preprocess_fit(X, y)
        if (r < 0).any():
            raise ValueError("implicit strengths must be non-negative")
        cfg = self._cfg()
        params = sgd.init_params(
            torch.Generator(device=self._device).manual_seed(self.seed),
            self.n_users, self.n_items, cfg, global_mean=0.0,
            init_sd=self.init_sd)
        by_user = ials.group_by_entity(u, i, r, self.n_users, device=self._device)
        by_item = ials.group_by_entity(i, u, r, self.n_items, device=self._device)
        params, loss = ials.implicit_als_train(params, by_user, by_item, cfg,
                                               self.n_epochs, self.alpha)
        self._params = params
        self.train_loss = loss.cpu().tolist()
        self.global_mean = 0.0
        if self.verbose:
            for e, v in enumerate(self.train_loss):
                print(f"Epoch {e + 1} implicit loss: {v:.2f}")
        return self

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray,
                        bound_ratings: bool):
        self._require_fitted()
        return predict_on_device(self._params, self._cfg(), u, i,
                                 bound_ratings, self._device)

    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        """Preference scores (~[0, 1], clipped when ``bound_ratings``)."""
        if X.shape[0] == 0:
            return []
        u, i = self._preprocess_predict(X)
        preds, possible = self._predict_arrays(u, i, bound_ratings)
        self.predictions_possible = possible.tolist()
        return preds.tolist()

    def _predict_dense(self, u, i, bound_ratings):
        return self._predict_arrays(
            np.asarray(u, np.int32), np.asarray(i, np.int32), bound_ratings)

    def update_users(self, X: pd.DataFrame, y: pd.Series, lr: float = 0.0,
                     n_epochs: int = 1, verbose: int = 0):
        """Exact closed-form solve of the named users' rows with the item
        side frozen (``lr`` and ``n_epochs`` are accepted for the
        lifecycle's signature and unused: there is no gradient path).
        Known users are re-solved from scratch (a row depends only on its
        strengths given Q); only the named users are grouped, as a compact
        block written back at their dense ids."""
        self._require_fitted()
        u, i, r, _known, _new = self._preprocess_update(X, y)
        if len(r) == 0:  # every interaction named an unknown item
            return self
        if (r < 0).any():
            raise ValueError("implicit strengths must be non-negative")
        cfg = self._cfg(compute_epoch_rmse=False)
        cap = self._params.user_features.shape[0]
        if self.n_users > cap:
            grown = sgd.round_up(self.n_users, 1024)
            fresh = sgd.fresh_user_rows(
                torch.Generator(device=self._device).manual_seed(self.seed + 1),
                grown - cap, cfg, 0.0, self.init_sd)
            self._params = self._params._replace(user_features=torch.cat(
                [self._params.user_features, fresh]))
        uniq, local = np.unique(u, return_inverse=True)
        grouped = ials.group_by_entity(local.astype(np.int32), i, r, len(uniq),
                                       device=self._device)
        P, Q = self._params.user_features, self._params.item_features
        block = ials.implicit_sweep(
            torch.zeros((len(uniq), P.shape[1]), dtype=torch.float32,
                        device=self._device),
            Q, grouped, self.n_items, cfg, self.alpha)
        k = cfg.n_factors
        P = P.clone()
        P[torch.from_numpy(uniq.astype(np.int64)).to(self._device), :k] = block[:, :k]
        self._params = self._params._replace(user_features=P)
        return self

    # -- catalog serving ----------------------------------------------------
    def _catalog_scores_batch(self, u_dense: np.ndarray) -> np.ndarray:
        return scoring.catalog_scores(self._cfg(), self._cached_serving_params(),
                                      self.n_items, u_dense)

    def _catalog_scores(self, u_dense: int) -> np.ndarray:
        return self._catalog_scores_batch(np.asarray([u_dense], np.int32))[0]

    def _catalog_topk(self, u_dense: np.ndarray, k: int):
        """Top-``k`` catalog scores per user on the device
        (``ops.scoring.catalog_topk``)."""
        return scoring.catalog_topk(self._cfg(), self._cached_serving_params(),
                                    self.n_items, u_dense, k)

    # -- parameter views ------------------------------------------------------
    @property
    def user_features(self) -> np.ndarray:
        return self._params.user_features[: self.n_users, : self.n_factors].cpu().numpy()

    @property
    def item_features(self) -> np.ndarray:
        return self._params.item_features[: self.n_items, : self.n_factors].cpu().numpy()
