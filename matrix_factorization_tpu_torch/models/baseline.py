"""Bias-only baseline model, r_ui ~= mu + b_u + b_i (PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/baseline.py``: ``fit``
(with ``warm_start``) by exact ALS sweeps or mini-batch SGD
(``ops/als.py``), data-parallel on a ``mesh`` (``parallel/mesh.py``),
``update_users`` (SGD on the user biases, item side frozen, on the rank's
own device), ``predict``, and ``recommend`` / ``recommend_batch`` as a
device top-k over ``mu + b_u + b_i``. Every reduction by id is the
deterministic segment-sum kernel (``ops/segment_sum.py``).

Reference: ``matrix_factorization/baseline_model.py`` (SGD ``:215-280``,
ALS ``:283-362``, predict ``:365-417``, ``update_users`` ``:136-180``).
The constructor takes the JAX package's arguments, so that a checkpoint's
``config`` constructs either package's model, plus ``device`` (``None`` =
CUDA). Random streams are ``torch.Generator``s seeded from ``seed``: the
same seed gives the same model bit for bit, though not the JAX package's
random bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.core.ids import check_no_duplicates
from matrix_factorization_tpu_torch.models.base import RecommenderBase, chunked_predict
from matrix_factorization_tpu_torch.ops import als as als_ops
from matrix_factorization_tpu_torch.ops import scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.parallel.mesh import data_size_of


class BaselineModel(RecommenderBase):
    """Explicit-rating bias model with ``method='sgd'`` or ``'als'``.

    Defaults match the reference constructor (``baseline_model.py:41-61``):
    ``n_epochs=100, reg=1, lr=0.01``. With a ``mesh`` (a ``DeviceMesh``
    from ``parallel.mesh.make_mesh``) every rank calls ``fit`` with the
    same ratings and trains data-parallel on its columns of every
    mini-batch (the batch size rounded up to a multiple of the data
    ranks): ALS by ``ops.als.dp_als_train``, SGD by
    ``dp_bias_sgd_train``, whose epochs visit the batches in one seeded
    order on every rank (the single-device SGD permutes every element).
    The biases end whole on every rank; ``update_users`` stays on the
    rank's device, as the JAX package's does."""

    def __init__(
        self,
        method: str = "sgd",
        n_epochs: int = 100,
        reg: float = 1.0,
        lr: float = 0.01,
        min_rating: float = 0,
        max_rating: float = 5,
        verbose: int = 0,
        batch_size: int = 1024,
        seed: int = 0,
        mesh=None,
        device=None,
    ):
        if method not in ("sgd", "als"):
            raise ValueError("Method param must be either 'sgd' or 'als'")
        super().__init__(min_rating=min_rating, max_rating=max_rating, verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.method = method
        self.n_epochs = n_epochs
        self.reg = reg
        self.lr = lr
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self._params: Optional[als_ops.BiasParams] = None
        self.train_rmse: list = []

    # -- capacity -----------------------------------------------------------
    def _ensure_user_capacity(self, n_needed: int) -> None:
        """Grow the user biases to hold ``n_needed`` (by half again,
        rounded to 1024), the new ones zero."""
        cap = self._params.user_biases.shape[0]
        if n_needed <= cap:
            return
        new_cap = sgd.round_up(max(n_needed, int(cap * 1.5) + 1), 1024)
        pad = torch.zeros(new_cap - cap, dtype=torch.float32, device=self._device)
        self._params = self._params._replace(
            user_biases=torch.cat([self._params.user_biases, pad]))

    # -- lifecycle ----------------------------------------------------------
    def fit(self, X: pd.DataFrame, y: pd.Series, n_epochs: int = None,
            warm_start: bool = False):
        """Exact ALS sweeps or SGD epochs; ``warm_start=True`` continues
        from the current biases (same id space). SGD's per-epoch
        permutations come from a generator seeded with (``seed``, epochs
        done so far), so a continued fit draws fresh ones."""
        if warm_start and self._params is not None:
            users = X["user_id"].to_numpy()
            items = X["item_id"].to_numpy()
            check_no_duplicates(users, items)
            u = self.user_vocab.encode(users, strict=True)
            i = self.item_vocab.encode(items, strict=True)
            r = np.asarray(y, dtype=np.float32)
            params = self._params
        else:
            u, i, r = self._preprocess_fit(X, y)
            self.global_mean = float(np.mean(r))
            params = als_ops.init_bias_params(
                sgd.round_up(self.n_users, 1024), self.n_items,
                self.global_mean, device=self._device)
            self.train_rmse = []
        n_epochs = n_epochs or self.n_epochs
        if self.mesh is not None:
            params, rmse_hist = self._fit_mesh(params, u, i, r, n_epochs)
        elif self.method == "als":
            data = sgd.pack_ratings(u, i, r, self.batch_size, device=self._device)
            params, rmse_hist = als_ops.als_train(params, data, self.reg, n_epochs)
        else:
            data = sgd.pack_ratings(u, i, r, self.batch_size, device=self._device)
            gen = sgd.seeded_generator(self._device, self.seed,
                                       len(self.train_rmse))
            params, rmse_hist = als_ops.bias_sgd_train(
                params, data, gen, self.lr, self.reg, n_epochs, self.batch_size)
        self._params = params
        self.train_rmse = list(self.train_rmse) + rmse_hist.cpu().tolist()
        if self.verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    def _fit_mesh(self, params, u, i, r, n_epochs):
        """The data-parallel fit of every rank (JAX ``baseline.py:111-131``):
        the pack of the batch size rounded up to the data ranks, packed on
        the host (``aggregate=False``) and cut to this rank's columns on its
        device, then ``dp_als_train`` or ``dp_bias_sgd_train``. SGD's batch
        orders come from a host generator seeded with (``seed``, epochs
        done so far, epoch), the same on every rank."""
        bs = sgd.round_up(self.batch_size, data_size_of(self.mesh))
        data = als_ops.shard_bias_data(
            sgd.pack_ratings(u, i, r, bs, aggregate=False, device="cpu"),
            self.mesh, self._device)
        if self.method == "als":
            return als_ops.dp_als_train(params, data, self.reg, n_epochs,
                                        self.mesh)
        done = len(self.train_rmse)
        orders = [torch.randperm(data.n_batches, generator=sgd.seeded_generator(
            "cpu", self.seed, done, e)) for e in range(n_epochs)]
        return als_ops.dp_bias_sgd_train(params, data, orders, self.lr,
                                         self.reg, self.mesh)

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray, bound_ratings: bool):
        self._require_fitted()

        def run(uu, ii):
            p, ok = als_ops.bias_predict(
                self._params,
                torch.from_numpy(uu.astype(np.int64)).to(self._device),
                torch.from_numpy(ii.astype(np.int64)).to(self._device),
                self.min_rating, self.max_rating, bound_ratings)
            return p.cpu().numpy(), ok.cpu().numpy()

        return chunked_predict(run, u, i)

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

    def update_users(
        self,
        X: pd.DataFrame,
        y: pd.Series,
        lr: float = 0.01,
        n_epochs: int = 20,
        verbose: int = 0,
    ):
        """Refit the user biases of new and updated users, item side
        frozen (reference ``baseline_model.py:136-180``). Known users named
        in X restart from 0, the reference's "pass all their ratings
        again" contract. ``train_rmse`` becomes this run's history."""
        self._require_fitted()
        u, i, r, known_users, _new_users = self._preprocess_update(X, y)
        self._ensure_user_capacity(self.n_users)

        if known_users:
            idx = torch.from_numpy(self.user_vocab.encode(
                np.asarray(known_users, dtype=object)).astype(np.int64))
            bu = self._params.user_biases.clone()
            bu[idx.to(self._device)] = 0.0
            self._params = self._params._replace(user_biases=bu)

        pack_bs = min(self.batch_size, max(1, len(r)))
        data = sgd.pack_ratings(u, i, r, pack_bs, device=self._device)
        params, rmse_hist = als_ops.bias_sgd_train(
            self._params, data, sgd.seeded_generator(self._device, self.seed + 1),
            lr, self.reg, n_epochs, pack_bs, update_item_params=False)
        self._params = params
        self.train_rmse = rmse_hist.cpu().tolist()
        if verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    # -- catalog serving ----------------------------------------------------
    def _catalog_scores(self, u_dense: int) -> np.ndarray:
        """Unbounded mu + b_u + b_i over the whole catalog."""
        return (self.global_mean
                + float(self._params.user_biases[int(u_dense)])
                + self.item_biases)

    def _catalog_topk(self, u_dense: np.ndarray, k: int):
        """Top-``k`` of ``mu + b_u + b_i`` per user on the device, ties to
        the lower index; only (B, k) values and indices reach the host."""
        p = self._params

        def run(ud, kk):
            u = torch.as_tensor(np.asarray(ud, np.int64)).to(self._device)
            s = (p.global_mean + p.user_biases[u][:, None]
                 + p.item_biases[None, : self.n_items])
            return scoring.stable_topk(s, kk)

        return scoring.topk_harness(run, self.n_items, u_dense, k)

    # -- reference-parity parameter views ------------------------------------
    @property
    def user_biases(self) -> np.ndarray:
        return self._params.user_biases[: self.n_users].cpu().numpy()

    @property
    def item_biases(self) -> np.ndarray:
        return self._params.item_biases[: self.n_items].cpu().numpy()
