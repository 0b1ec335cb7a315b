"""SVD++: explicit-rating matrix factorization with implicit-feedback
factor terms (Koren, KDD 2008), PyTorch port.

Counterpart of ``matrix_factorization_tpu/models/svdpp.py``, single
device: ``fit(X, y)`` (``ops/svdpp.py::svdpp_train_batched`` on a
user-primary pack, its scatters the hand-written ``mf_segment_apply`` on
the card), ``predict`` clamped to the rating range, ``recommend`` /
``recommend_batch`` on the catalog scorer over the effective user table
``P + S``, and ``update_users``, which re-trains the named users' rows
against frozen item and implicit tables (``user_refit``).

The constructor takes the JAX package's arguments plus ``device``
(``None`` = CUDA). With a ``mesh`` (``parallel/mesh.py``) of more than one
data rank every rank calls ``fit`` with the same ratings and trains
data-parallel (``ops/svdpp.py::dp_svdpp_train_batched`` for
``dp_layout='tiled'``, ``dp_svdpp_train`` for ``'flat'``), then holds the
gathered tables. Random streams are ``torch.Generator``s seeded from
``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.models.base import (RecommenderBase, check_mesh_args,
                                                    predict_on_device)
from matrix_factorization_tpu_torch.ops import scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import svdpp as svdpp_ops
from matrix_factorization_tpu_torch.parallel.mesh import data_size_of, device_index


class SVDpp(RecommenderBase):
    def __init__(
        self,
        n_factors: int = 64,
        n_epochs: int = 20,
        lr: float = 0.01,
        reg: float = 0.02,
        lr_y: Optional[float] = None,
        reg_y: Optional[float] = None,
        batch_size: int = 8192,
        min_rating: float = 0,
        max_rating: float = 5,
        init_sd: float = 0.1,
        verbose: int = 0,
        seed: int = 0,
        mesh=None,
        overlap_psum: bool = False,
        serving_dtype: str = "float32",
        dp_layout: str = "tiled",
        psum_every=1,
        device=None,
    ):
        """Arguments as in the JAX package's ``SVDpp``, validated the same
        way, plus ``device``. ``lr_y`` / ``reg_y`` (default ``lr`` /
        ``reg``) drive the implicit table's deferred epoch update.
        ``mesh``: with more than one data rank, ``fit`` trains
        data-parallel (P, S and the accumulator sharded by user range, the
        Q deltas all-reduced, one more all-reduce an epoch for the Y
        gradient) and gathers the tables. ``dp_layout``: ``'tiled'`` (each
        rank's segment of the user-primary device-major pack) or
        ``'flat'`` (each rank's user range of the stream).
        ``overlap_psum`` runs each Q all-reduce under the next step or
        window; ``psum_every`` sets the tiled layout's window, and the flat
        layout ignores it, as the JAX package's does."""
        check_mesh_args(serving_dtype, mesh, overlap_psum, dp_layout,
                        psum_every)
        super().__init__(min_rating=min_rating, max_rating=max_rating,
                         verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.n_factors = n_factors
        self.n_epochs = n_epochs
        self.lr = lr
        self.reg = reg
        self.lr_y = lr_y
        self.reg_y = reg_y
        self.batch_size = batch_size
        self.init_sd = init_sd
        self.seed = seed
        self.mesh = mesh
        self.overlap_psum = overlap_psum
        self.serving_dtype = serving_dtype
        self.dp_layout = dp_layout
        self.psum_every = psum_every
        self._params: Optional[svdpp_ops.SVDppParams] = None
        self._serving_cache = None
        self._mf_cache = None
        self.train_rmse: list = []

    def _cfg(self) -> SGDConfig:
        return SGDConfig(kernel="linear", n_factors=self.n_factors,
                         lr=self.lr, reg=self.reg,
                         min_rating=self.min_rating,
                         max_rating=self.max_rating,
                         batch_size=self.batch_size)

    # -- lifecycle ----------------------------------------------------------
    def fit(self, X: pd.DataFrame, y: pd.Series):
        """Train ``n_epochs`` epochs from tables seeded with ``seed``; the
        batch orders come from a generator seeded with (``seed``, 1), on a
        mesh with (``seed``, 1, epoch, rank). ``train_rmse`` is the
        per-epoch train RMSE."""
        u, i, r = self._preprocess_fit(X, y)
        self.global_mean = float(np.mean(r))
        cfg = self._cfg()
        # 'is None', not 'or': an explicit 0.0 is a legitimate setting
        lr_y = self.lr if self.lr_y is None else self.lr_y
        reg_y = self.reg if self.reg_y is None else self.reg_y
        dev = self._device
        params = svdpp_ops.init_params(
            torch.Generator(device=dev).manual_seed(self.seed), self.n_users,
            self.n_items, cfg, self.global_mean, init_sd=self.init_sd)
        deg = np.zeros(params.item_features.shape[0], np.float32)
        deg[: self.n_items] = np.bincount(i, minlength=self.n_items)
        deg = torch.from_numpy(deg).to(dev)
        if self.mesh is not None and data_size_of(self.mesh) > 1:
            params, hist = self._fit_mesh(params, u, i, r, deg, cfg, lr_y,
                                          reg_y)
        else:
            data = sgd.pack_ratings(u.astype(np.int32), i.astype(np.int32),
                                    r.astype(np.float32), self.batch_size,
                                    shuffle_seed=self.seed, order="user",
                                    device=dev)
            wvec = svdpp_ops._neighbor_weights(u, self.n_users,
                                               params.user_features.shape[0])
            params, hist = svdpp_ops.svdpp_train_batched(
                params, data, torch.from_numpy(wvec).to(dev), deg,
                sgd.seeded_generator(dev, self.seed, 1), cfg, self.n_epochs,
                lr_y, reg_y)
        self._params = params
        self._serving_cache = None
        self.train_rmse = hist.cpu().tolist()
        if self.verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    def _fit_mesh(self, params, u, i, r, deg, cfg, lr_y, reg_y):
        """The data-parallel fit of every rank (JAX ``svdpp.py:119-180``):
        the user capacity ``round_up(n_users, 8 * N)`` (P grown by fresh
        rows, S by zero rows, which hold no user), this rank's rows of P, S
        and ``wvec`` (computed over that capacity) with a whole Q, Y and
        ``deg``, its part of the ratings, the trainer, then P and S
        all-gathered (Q and Y are whole already). Returns (params,
        history)."""
        from matrix_factorization_tpu_torch.parallel import distributed as pdist
        from matrix_factorization_tpu_torch.parallel.mesh import data_group

        dev = self._device
        n, d = data_size_of(self.mesh), device_index(self.mesh)
        ucap = sgd.round_up(self.n_users, 8 * n)
        cap = params.user_features.shape[0]
        if ucap > cap:
            fresh = sgd.fresh_user_rows(sgd.seeded_generator(dev, self.seed, 0),
                                        ucap - cap, cfg, 0.0, self.init_sd)
            params = params._replace(
                user_features=torch.cat([params.user_features, fresh]),
                user_implicit_sums=torch.cat([params.user_implicit_sums,
                                              torch.zeros_like(fresh)]))
        rows = slice(d * ucap // n, (d + 1) * ucap // n)
        local = params._replace(
            user_features=params.user_features[rows].clone(),
            user_implicit_sums=params.user_implicit_sums[rows].clone())
        wvec = torch.from_numpy(
            svdpp_ops._neighbor_weights(u, self.n_users, ucap)[rows]).to(dev)
        bs = min(self.batch_size, max(1, len(u)))
        key = (self.seed, 1)
        if self.dp_layout == "tiled":
            data = sgd.pack_ratings(
                u.astype(np.int32), i.astype(np.int32), r.astype(np.float32),
                bs, shuffle_seed=self.seed, order="user", n_dev=n,
                users_per_dev=ucap // n, segment=d, device=dev)
            local, hist = svdpp_ops.dp_svdpp_train_batched(
                local, data, wvec, deg, cfg, self.n_epochs, lr_y, reg_y,
                self.mesh, overlap_psum=self.overlap_psum,
                psum_every=self.psum_every, key=key)
        else:
            _, bs, stream = pdist.dp_fit_plumbing(u, i, r, self.n_users,
                                                  self.mesh, self.batch_size)
            local, hist = svdpp_ops.dp_svdpp_train(
                local, pdist.local_ratings(stream, d, n, dev), wvec, deg, cfg,
                self.n_epochs, lr_y, reg_y, bs, len(u), self.mesh,
                overlap_psum=self.overlap_psum, key=key)
        group = data_group(self.mesh)
        return local._replace(
            user_features=pdist.all_gather_rows(local.user_features, group),
            user_implicit_sums=pdist.all_gather_rows(local.user_implicit_sums,
                                                     group)), hist

    def _mf_view(self) -> sgd.MFParams:
        """The effective table view ``P + S``, cached on the identity of
        ``_params`` so that it is not rebuilt on every call."""
        c = self._mf_cache
        if c is None or c[0] is not self._params:
            self._mf_cache = c = (self._params, self._params.as_mf)
        return c[1]

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray,
                        bound_ratings: bool):
        self._require_fitted()
        return predict_on_device(self._mf_view(), self._cfg(), u, i,
                                 bound_ratings, self._device)

    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        if X.shape[0] == 0:
            return []
        u, i = self._preprocess_predict(X)
        preds, possible = self._predict_arrays(u, i, bound_ratings)
        self.predictions_possible = possible.tolist()
        return preds.tolist()

    def _predict_dense(self, u, i, bound_ratings):
        return self._predict_arrays(
            np.asarray(u, np.int32), np.asarray(i, np.int32), bound_ratings)

    def update_users(self, X: pd.DataFrame, y: pd.Series,
                     lr: float = None, n_epochs: int = None,
                     verbose: int = 0):
        """Re-train the named users' rows (fresh random init) against
        frozen Q and Y. The user table grows (to a multiple of 1,024 rows)
        with fresh rows, the sums with zero rows; the cohort's implicit
        sums come from the update interactions."""
        u, i, r, known_users, _new = self._preprocess_update(X, y)
        if len(r) == 0:  # every rating named an unknown item
            return self
        cfg = dataclasses.replace(self._cfg(), compute_epoch_rmse=False)
        dev = self._device
        cap = self._params.user_features.shape[0]
        if self.n_users > cap:
            grown = sgd.round_up(self.n_users, 1024)
            fresh = sgd.fresh_user_rows(
                sgd.seeded_generator(dev, self.seed + 1), grown - cap, cfg,
                0.0, self.init_sd)
            self._params = self._params._replace(
                user_features=torch.cat([self._params.user_features, fresh]),
                user_implicit_sums=torch.cat(
                    [self._params.user_implicit_sums, torch.zeros_like(fresh)]))
        if known_users:
            idx = torch.from_numpy(self.user_vocab.encode(
                np.asarray(known_users, dtype=object)).astype(np.int64)).to(dev)
            fresh = sgd.fresh_user_rows(
                sgd.seeded_generator(dev, self.seed + 2), len(known_users),
                cfg, 0.0, self.init_sd)
            uf = self._params.user_features.clone()
            uf[idx] = fresh
            self._params = self._params._replace(user_features=uf)
        up, ip, rp, wp, bs = svdpp_ops.pack_pairs(
            u, i, r, min(self.batch_size, max(1, len(u))))
        wvec = svdpp_ops._neighbor_weights(
            u, self.n_users, self._params.user_features.shape[0])
        if lr is not None:
            cfg = dataclasses.replace(cfg, lr=lr)
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        self._params = svdpp_ops.user_refit(
            self._params, put(up), put(ip), put(rp), put(wp), put(wvec),
            sgd.seeded_generator(dev, self.seed, 2), cfg,
            n_epochs or self.n_epochs, bs)
        self._serving_cache = None
        return self

    # -- serving ------------------------------------------------------------
    def _catalog_topk(self, u_dense: np.ndarray, k: int):
        """Top-``k`` on the catalog scorer over ``P + S`` (optionally a
        bf16 copy of it)."""
        return scoring.catalog_topk(
            self._cfg(), self._cached_serving_params(self._mf_view),
            self.n_items, u_dense, k)

    # -- parameter views ----------------------------------------------------
    def _cols(self, table, n, cols):
        return table[:n, cols].cpu().numpy()

    @property
    def user_features(self) -> np.ndarray:
        return self._cols(self._params.user_features, self.n_users,
                          slice(0, self.n_factors))

    @property
    def item_features(self) -> np.ndarray:
        return self._cols(self._params.item_features, self.n_items,
                          slice(0, self.n_factors))

    @property
    def implicit_features(self) -> np.ndarray:
        return self._cols(self._params.implicit_features, self.n_items,
                          slice(0, self.n_factors))

    @property
    def user_biases(self) -> np.ndarray:
        return self._cols(self._params.user_features, self.n_users,
                          sgd.bias_col(self._cfg(), "user"))

    @property
    def item_biases(self) -> np.ndarray:
        return self._cols(self._params.item_features, self.n_items,
                          sgd.bias_col(self._cfg(), "item"))
