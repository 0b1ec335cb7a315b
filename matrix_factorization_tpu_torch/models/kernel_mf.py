"""Kernel matrix factorization, r_ui ~= K(p_u, q_i) for K in
{linear, sigmoid, rbf} (PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/kernel_mf.py``, single
device: ``fit`` (with ``warm_start``), ``update_users``, ``predict``,
``recommend`` and ``recommend_batch``, trained by mini-batch SGD,
``method='als'`` (exact alternation, ``ops/ials.py``) or SGD after
``als_warm_start`` ALS sweeps. A model is trained here or arrives fitted
through ``core.checkpoint.load_model`` (a checkpoint of either package) or
``ops.segment_sgd.params_from_numpy``. On the GPU, SGD runs the
hand-written step and apply kernels of ``ops/cuda_sgd.py``, the ALS solves
the Gauss-Jordan leaf of ``ops/cuda_spd.py``, and serving the catalog
scorer of ``ops/cuda_scores.py``.

Reference: ``matrix_factorization/kernel_matrix_factorization.py``
(fit ``:320-445``, update_users ``:165-237``, predict ``:130-163``). The
constructor takes the JAX package's arguments, so that a checkpoint's
``config`` constructs either package's model, plus ``device`` (``None``
= CUDA; see ``core.device``). Random streams are ``torch.Generator``s
seeded from ``seed``: the same seed gives the same model bit for bit,
though not the JAX package's random bits.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.core.ids import check_no_duplicates
from matrix_factorization_tpu_torch.models.base import RecommenderBase, chunked_predict
from matrix_factorization_tpu_torch.ops import ials, scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd


def _als_needs_buckets(u, i, n_users: int, n_items: int,
                       budget_rows: int = 30_000_000) -> bool:
    """One padded block per side materialises (E, L_max) tables; switch to
    count-bucketed sweeps when that passes the row budget."""
    lu = int(np.bincount(u, minlength=n_users).max()) if len(u) else 1
    li = int(np.bincount(i, minlength=n_items).max()) if len(i) else 1
    return n_users * lu > budget_rows or n_items * li > budget_rows


class KernelMF(RecommenderBase):
    def __init__(
        self,
        n_factors: int = 100,
        n_epochs: int = 100,
        kernel: str = "linear",
        gamma: Union[str, float] = "auto",
        reg: float = 1.0,
        lr: float = 0.01,
        init_mean: float = 0.0,
        init_sd: float = 0.1,
        min_rating: float = 0,
        max_rating: float = 5,
        verbose: int = 0,
        batch_size: int = 1024,
        seed: int = 0,
        mesh=None,
        method: str = "sgd",
        epoch_order: str = "shuffle",
        keep_sharded: bool = False,
        overlap_psum: bool = False,
        reg_scale: str = "absolute",
        als_warm_start: int = 0,
        als_warm_reg: Optional[float] = None,
        serving_dtype: str = "float32",
        dp_layout: str = "auto",
        psum_every=1,
        device=None,
    ):
        """Arguments as in the JAX package's ``KernelMF``; they are
        validated the same way. ``serving_dtype='bfloat16'`` keeps a bf16
        copy of the tables for the catalog scorers (``recommend`` /
        ``recommend_batch``), which halves the bytes they stream; sums stay
        f32 and ``predict`` reads the f32 tables. ``device``: where the
        tables live, ``None`` meaning CUDA (``RuntimeError`` without a
        GPU). ``mesh`` raises ``NotImplementedError`` until slice 6 ports
        it; ``keep_sharded`` needs a mesh.

        ``method='als'``: exact alternating least squares for factors and
        biases (linear kernel), ``reg_scale`` 'absolute' or 'per_obs' (see
        ``ops.ials._reg_diag``). ``als_warm_start``: that many exact linear
        ALS sweeps (ridge ``als_warm_reg``, default ``reg``, scaled per
        observation) before the SGD epochs of a fresh fit; a sigmoid model
        fits its pre-activation to logit targets."""
        if kernel not in ("linear", "sigmoid", "rbf"):
            raise ValueError("Kernel must be one of linear, sigmoid, or rbf")
        if method not in ("sgd", "als"):
            raise ValueError("Method must be 'sgd' or 'als'")
        if epoch_order not in ("shuffle", "item", "user", "auto",
                               "block"):
            raise ValueError(
                "epoch_order must be 'shuffle', 'item', 'user', 'auto' "
                "or 'block'")
        if method == "als" and kernel != "linear":
            raise ValueError("method='als' requires the linear kernel")
        if reg_scale not in ("absolute", "per_obs"):
            raise ValueError("reg_scale must be 'absolute' or 'per_obs'")
        if als_warm_start:
            if als_warm_start < 0:
                raise ValueError("als_warm_start must be >= 0")
            if kernel == "rbf":
                raise ValueError(
                    "als_warm_start requires a linear pre-activation "
                    "(kernel 'linear' or 'sigmoid'); rbf has none")
            if method == "als":
                raise ValueError(
                    "als_warm_start is an SGD initializer; method='als' "
                    "is already exact alternation")
            if mesh is not None:
                raise ValueError(
                    "als_warm_start is not supported with a mesh yet "
                    "(the dp/tp trainers own their init)")
        if overlap_psum and mesh is None:
            raise ValueError(
                "overlap_psum=True requires a mesh: without one there is "
                "no delta all-reduce to overlap"
            )
        if overlap_psum and method == "als":
            raise ValueError(
                "overlap_psum applies to the mesh SGD trainers; "
                "method='als' has no per-step delta psum"
            )
        if psum_every != 1:
            if mesh is None:
                raise ValueError(
                    "psum_every requires a mesh: without one there is no "
                    "delta all-reduce to window")
            if method == "als":
                raise ValueError(
                    "psum_every applies to the mesh SGD trainers; "
                    "method='als' has no per-step delta psum")
        if keep_sharded and mesh is None:
            raise ValueError(
                "keep_sharded=True requires a mesh: without one the item "
                "table cannot stay resident sharded and serving would "
                "silently gather the full catalog to one device"
            )
        if serving_dtype not in ("float32", "bfloat16"):
            raise ValueError("serving_dtype must be 'float32' or 'bfloat16'")
        if dp_layout not in ("auto", "tiled", "flat"):
            raise ValueError("dp_layout must be 'auto', 'tiled' or 'flat'")
        if mesh is not None:
            raise NotImplementedError(f"KernelMF(mesh=) comes with {sgd.SLICE_6}")
        super().__init__(min_rating=min_rating, max_rating=max_rating, verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.n_factors = n_factors
        self.n_epochs = n_epochs
        self.kernel = kernel
        self.gamma = 1.0 / n_factors if gamma == "auto" else gamma
        self.reg = reg
        self.lr = lr
        self.init_mean = init_mean
        self.init_sd = init_sd
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self.method = method
        self.reg_scale = reg_scale
        self.als_warm_start = als_warm_start
        self.als_warm_reg = als_warm_reg
        self.epoch_order = epoch_order
        self.keep_sharded = keep_sharded
        self.overlap_psum = overlap_psum
        self.psum_every = psum_every
        self.dp_layout = dp_layout
        self.serving_dtype = serving_dtype
        self._params: Optional[sgd.MFParams] = None
        self._serving_cache = None  # (source MFParams, bf16 MFParams)
        self.train_rmse: list = []

    def _cfg(
        self,
        batch_size: Optional[int] = None,
        update_item_params: bool = True,
        compute_epoch_rmse: bool = True,
    ) -> SGDConfig:
        return SGDConfig(
            kernel=self.kernel,
            n_factors=self.n_factors,
            lr=self.lr,
            reg=self.reg,
            gamma=self.gamma,
            min_rating=self.min_rating,
            max_rating=self.max_rating,
            batch_size=batch_size or self.batch_size,
            update_item_params=update_item_params,
            compute_epoch_rmse=compute_epoch_rmse,
        )

    # -- capacity -----------------------------------------------------------
    def _ensure_user_capacity(self, n_needed: int,
                              generator: torch.Generator) -> None:
        """Grow the user table to hold ``n_needed`` rows (by half again,
        rounded to 1024), the new rows fresh from ``generator``."""
        cap = self._params.user_features.shape[0]
        if n_needed <= cap:
            return
        new_cap = sgd.round_up(max(n_needed, int(cap * 1.5) + 1), 1024)
        fresh = sgd.fresh_user_rows(
            generator, new_cap - cap, self._cfg(), self.init_mean, self.init_sd)
        self._params = self._params._replace(
            user_features=torch.cat([self._params.user_features, fresh]))

    # -- lifecycle ----------------------------------------------------------
    def fit(self, X: pd.DataFrame, y: pd.Series, n_epochs: int = None,
            warm_start: bool = False):
        """Train by mini-batch SGD, or by ALS sweeps (``method='als'``, an
        epoch being one user and one item sweep); ``warm_start=True``
        continues from the current tables (same id space) instead of
        re-initialising, the building block of
        ``core.checkpoint.fit_resumable``. The ``als_warm_start`` sweeps
        run on a fresh fit only, never on a continuation.

        The initial tables come from a generator seeded with ``seed``; the
        epochs' batch orders from one seeded with (``seed``, epochs done
        so far + 1), so a continued fit draws fresh orders.
        ``train_rmse`` gains one entry an epoch."""
        cfg = self._cfg()
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
            params = sgd.init_params(
                torch.Generator(device=self._device).manual_seed(self.seed),
                self.n_users, self.n_items, cfg, self.global_mean,
                self.init_mean, self.init_sd)
            self.train_rmse = []
        n_epochs = n_epochs or self.n_epochs
        if self.method == "als":
            # the pack only feeds the RMSE pass: no per-batch sorts
            data = sgd.pack_ratings(u, i, r, cfg.batch_size,
                                    order=self.epoch_order, aggregate=False,
                                    device=self._device)
            params, rmse_hist = self._als(params, u, i, r, cfg, data,
                                          n_epochs, self.reg_scale)
        else:
            data = sgd.pack_ratings(u, i, r, cfg.batch_size,
                                    order=self.epoch_order, device=self._device)
            if self.als_warm_start and not warm_start:
                params = self._run_als_warm_start(params, u, i, r, cfg, data)
            shuffle = sgd.seeded_generator("cpu", self.seed,
                                           len(self.train_rmse) + 1)
            params, rmse_hist = sgd.sgd_train(params, data, shuffle, cfg,
                                              n_epochs, self.lr)
        self._params = params
        self.train_rmse = list(self.train_rmse) + rmse_hist.cpu().tolist()
        if self.verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    def _als(self, params, u, i, r, cfg, data, n_epochs, reg_scale):
        """``n_epochs`` ALS epochs on (u, i, r): count-bucketed sweeps when
        one padded block per side would pass ``_als_needs_buckets``'
        budget, else the grouped sweeps."""
        if _als_needs_buckets(u, i, self.n_users, self.n_items):
            bu, bi = ials.group_both_sides_bucketed(
                u, i, r, self.n_users, self.n_items, device=self._device)
            return ials.ials_train_bucketed(params, bu, bi, data, cfg, n_epochs,
                                            reg_scale=reg_scale)
        by_user = ials.group_by_entity(u, i, r, self.n_users, device=self._device)
        by_item = ials.group_by_entity(i, u, r, self.n_items, device=self._device)
        return ials.ials_train(params, by_user, by_item, data, cfg, n_epochs,
                               reg_scale=reg_scale)

    def _run_als_warm_start(self, params, u, i, r, cfg, data):
        """Exact linear ALS sweeps as the SGD init. Sigmoid fits the
        pre-activation x in logit space: pred = a + c*sigma(x), so the
        target is logit((r - a)/c), clipped to [0.01, 0.99] before the
        transform; the free bias columns absorb the offset, so
        ``global_mean`` keeps its meaning. The ridge is per observation,
        as the SGD objective's L2 is."""
        if self.kernel == "sigmoid":
            frac = np.clip((np.asarray(r, np.float64) - cfg.a) / cfg.c,
                           0.01, 0.99)
            t = np.log(frac / (1.0 - frac)).astype(np.float32)
        else:
            t = np.asarray(r, np.float32)
        warm_reg = cfg.reg if self.als_warm_reg is None else self.als_warm_reg
        lin = SGDConfig(kernel="linear", n_factors=cfg.n_factors, lr=cfg.lr,
                        reg=warm_reg, min_rating=cfg.min_rating,
                        max_rating=cfg.max_rating, batch_size=cfg.batch_size,
                        compute_epoch_rmse=False)
        params, _ = self._als(params, u, i, t, lin, data, self.als_warm_start,
                              "per_obs")
        return params

    def update_users(self, X: pd.DataFrame, y: pd.Series, lr: float = 0.01,
                     n_epochs: int = 20, verbose: int = 0):
        """Partial fit for new and updated users with the item side frozen
        (reference ``kernel_matrix_factorization.py:165-237``): known users
        named in X are re-initialised (bias 0, fresh random factors,
        ``:189-199``), new users get fresh rows, then SGD runs with
        ``update_item_params=False``. The pack is primary-item, so the
        step kernel's primary side is the frozen one here and only the
        apply kernel writes (the user table). With ``method='als'`` the
        named users are solved exactly instead, ``min(n_epochs, 2)`` (at
        least 1) user sweeps against the frozen items
        (``_als_update_users``). ``train_rmse`` becomes this run's
        history."""
        self._require_fitted()
        u, i, r, known_users, _new_users = self._preprocess_update(X, y)
        self._ensure_user_capacity(
            self.n_users, sgd.seeded_generator(self._device, self.seed + 1, 0))

        if known_users:
            idx = torch.from_numpy(self.user_vocab.encode(
                np.asarray(known_users, dtype=object)).astype(np.int64))
            fresh = sgd.fresh_user_rows(
                sgd.seeded_generator(self._device, self.seed + 1, 1),
                len(known_users), self._cfg(), self.init_mean, self.init_sd)
            uf = self._params.user_features.clone()
            uf[idx.to(self._device)] = fresh
            self._params = self._params._replace(user_features=uf)

        pack_bs = min(self.batch_size, max(1, len(r)))
        cfg = self._cfg(batch_size=pack_bs, update_item_params=False)
        if self.method == "als":
            params, rmse_hist = self._als_update_users(u, i, r, cfg,
                                                       max(1, min(n_epochs, 2)))
        else:
            data = sgd.pack_ratings(u, i, r, pack_bs, device=self._device)
            params, rmse_hist = sgd.sgd_train(
                self._params, data,
                sgd.seeded_generator("cpu", self.seed + 1, 2), cfg, n_epochs, lr)
        self._params = params
        self.train_rmse = rmse_hist.cpu().tolist()
        if verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    def _als_update_users(self, u, i, r, cfg, n_epochs):
        """Exact user sweeps with the item side frozen, over the users
        named in (u, i, r) only: they are grouped as a compact block, solved
        against Q and written back at their dense ids. (The JAX package
        groups all ``n_users``, which at 162,000 users and k=200 would
        materialise 26 GB of grams; a user without data keeps their row in
        both, and a named user's solve depends only on Q and their
        ratings, so the results are the same.)"""
        if len(u) == 0:  # every rating named an unknown item
            return self._params, torch.zeros(n_epochs)
        uniq, local = np.unique(u, return_inverse=True)
        local = local.astype(np.int32)
        rows = torch.from_numpy(uniq.astype(np.int64)).to(self._device)
        block = self._params._replace(
            user_features=self._params.user_features[rows])
        by_user = ials.group_by_entity(local, i, r, len(uniq), device=self._device)
        data = sgd.pack_ratings(local, i, r, cfg.batch_size, aggregate=False,
                                device=self._device)
        block, rmse_hist = ials.ials_train(
            block, by_user, None, data, cfg, n_epochs,
            update_item_params=False, reg_scale=self.reg_scale)
        uf = self._params.user_features.clone()
        uf[rows] = block.user_features
        return self._params._replace(user_features=uf), rmse_hist

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray, bound_ratings: bool):
        self._require_fitted()
        cfg = self._cfg()

        def run(uu, ii):
            p, ok = sgd.predict_pairs(
                self._params, torch.from_numpy(uu.astype(np.int64)).to(self._device),
                torch.from_numpy(ii.astype(np.int64)).to(self._device), cfg,
                bound_ratings)
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

    # -- catalog serving ----------------------------------------------------
    def _catalog_scores_batch(self, u_dense: np.ndarray) -> np.ndarray:
        """(B, n_items) unbounded scores for a whole user cohort."""
        return scoring.catalog_scores(self._cfg(), self._cached_serving_params(),
                                      self.n_items, u_dense)

    def _catalog_scores(self, u_dense: int) -> np.ndarray:
        """Unbounded scores of every known item for one user."""
        return self._catalog_scores_batch(np.asarray([u_dense], np.int32))[0]

    def _catalog_topk(self, u_dense: np.ndarray, k: int):
        """Top-``k`` catalog scores per user; only (B, k) values and
        indices reach the host (``ops.scoring.catalog_topk``)."""
        return scoring.catalog_topk(self._cfg(), self._cached_serving_params(),
                                    self.n_items, u_dense, k)

    # -- reference-parity parameter views ------------------------------------
    # (biases live in extension columns of the factor tables — see
    # ops/segment_sgd.py module docstring)
    @property
    def user_features(self) -> np.ndarray:
        return self._params.user_features[: self.n_users, : self.n_factors].cpu().numpy()

    @property
    def item_features(self) -> np.ndarray:
        return self._params.item_features[: self.n_items, : self.n_factors].cpu().numpy()

    @property
    def user_biases(self) -> np.ndarray:
        col = sgd.bias_col(self._cfg(), "user")
        return self._params.user_features[: self.n_users, col].cpu().numpy()

    @property
    def item_biases(self) -> np.ndarray:
        col = sgd.bias_col(self._cfg(), "item")
        return self._params.item_features[: self.n_items, col].cpu().numpy()
