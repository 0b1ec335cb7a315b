"""Kernel matrix factorization, r_ui ~= K(p_u, q_i) for K in
{linear, sigmoid, rbf} (PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/kernel_mf.py``, single
device and SGD: ``fit`` (with ``warm_start``), ``update_users``,
``predict``, ``recommend`` and ``recommend_batch``. A model is trained
here or arrives fitted through ``core.checkpoint.load_model`` (a
checkpoint of either package) or ``ops.segment_sgd.params_from_numpy``.
On the GPU, training runs the hand-written step and apply kernels of
``ops/cuda_sgd.py`` and serving the catalog scorer of
``ops/cuda_scores.py``.

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
from matrix_factorization_tpu_torch.ops import scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

_SLICE_3 = "slice 3 of the PyTorch port (ALS)"


def _generator(device, *entropy) -> torch.Generator:
    """A generator on ``device`` seeded from integers, as ``fold_in`` keys
    the JAX package's streams (numpy's ``SeedSequence`` mixes them)."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0] & (2**63 - 1))
    return torch.Generator(device=device).manual_seed(seed)


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
        GPU). ``mesh`` (slice 6), ``method='als'`` and ``als_warm_start``
        (slice 3) raise ``NotImplementedError`` until the slices that
        port them; ``keep_sharded`` needs a mesh."""
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
        for flag, unported, where in (
                ("mesh=", mesh is not None, sgd.SLICE_6),
                ("method='als'", method == "als", _SLICE_3),
                ("als_warm_start", bool(als_warm_start), _SLICE_3)):
            if unported:
                raise NotImplementedError(f"KernelMF({flag}) comes with {where}")
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
        """Train by mini-batch SGD; ``warm_start=True`` continues from the
        current tables (same id space) instead of re-initialising, the
        building block of ``core.checkpoint.fit_resumable``.

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
        shuffle = _generator("cpu", self.seed, len(self.train_rmse) + 1)
        data = sgd.pack_ratings(u, i, r, cfg.batch_size,
                                order=self.epoch_order, device=self._device)
        params, rmse_hist = sgd.sgd_train(params, data, shuffle, cfg,
                                          n_epochs, self.lr)
        self._params = params
        self.train_rmse = list(self.train_rmse) + rmse_hist.cpu().tolist()
        if self.verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    def update_users(self, X: pd.DataFrame, y: pd.Series, lr: float = 0.01,
                     n_epochs: int = 20, verbose: int = 0):
        """Partial fit for new and updated users with the item side frozen
        (reference ``kernel_matrix_factorization.py:165-237``): known users
        named in X are re-initialised (bias 0, fresh random factors,
        ``:189-199``), new users get fresh rows, then SGD runs with
        ``update_item_params=False``. The pack is primary-item, so the
        step kernel's primary side is the frozen one here and only the
        apply kernel writes (the user table). ``train_rmse`` becomes this
        run's history."""
        self._require_fitted()
        u, i, r, known_users, _new_users = self._preprocess_update(X, y)
        self._ensure_user_capacity(
            self.n_users, _generator(self._device, self.seed + 1, 0))

        if known_users:
            idx = torch.from_numpy(self.user_vocab.encode(
                np.asarray(known_users, dtype=object)).astype(np.int64))
            fresh = sgd.fresh_user_rows(
                _generator(self._device, self.seed + 1, 1), len(known_users),
                self._cfg(), self.init_mean, self.init_sd)
            uf = self._params.user_features.clone()
            uf[idx.to(self._device)] = fresh
            self._params = self._params._replace(user_features=uf)

        pack_bs = min(self.batch_size, max(1, len(r)))
        cfg = self._cfg(batch_size=pack_bs, update_item_params=False)
        data = sgd.pack_ratings(u, i, r, pack_bs, device=self._device)
        params, rmse_hist = sgd.sgd_train(
            self._params, data, _generator("cpu", self.seed + 1, 2), cfg,
            n_epochs, lr)
        self._params = params
        self.train_rmse = rmse_hist.cpu().tolist()
        if verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

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
