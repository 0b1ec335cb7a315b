"""Non-negative matrix factorization recommender, PyTorch port.

Counterpart of ``matrix_factorization_tpu/models/nmf.py``, single device:
``r_ui ~= p_u . q_i`` with ``p, q >= 0``, trained by alternating
multiplicative updates (``ops/nmf.py``, whose accumulators are the
hand-written ``mf_segment_sum`` on the card), served on the catalog
scorer. Surprise's defaults (n_factors=15, n_epochs=50, reg=0.06);
ratings must be non-negative; cold-start pairs predict the global mean
rating, clipped.

The constructor takes the JAX package's arguments plus ``device``
(``None`` = CUDA). With a ``mesh`` (``parallel/mesh.py``) of more than one
data rank every rank calls ``fit`` with the same ratings and trains with
``ops.nmf.dp_nmf_train`` (its user rows of P, a whole Q, one item
accumulator all-reduced an epoch), then holds the gathered tables. The
initial tables come from ``torch.Generator``s seeded from ``seed``: the
mesh-free fit's tables, so the two fits differ only in where the sums
regroup.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.models.base import RecommenderBase, predict_on_device
from matrix_factorization_tpu_torch.ops import nmf as nmf_ops
from matrix_factorization_tpu_torch.ops import scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.parallel.mesh import data_size_of, device_index


class NMF(RecommenderBase):
    """Explicit-rating NMF. ``reg_pu`` / ``reg_qi`` default to ``reg``;
    the L2 term is scaled by each entity's observation count."""

    def __init__(
        self,
        n_factors: int = 15,
        n_epochs: int = 50,
        reg: float = 0.06,
        reg_pu: Optional[float] = None,
        reg_qi: Optional[float] = None,
        init_low: float = 0.0,
        init_high: float = 1.0,
        min_rating: float = 0,
        max_rating: float = 5,
        verbose: int = 0,
        batch_size: int = 131_072,
        seed: int = 0,
        serving_dtype: str = "float32",
        mesh=None,
        device=None,
    ):
        if serving_dtype not in ("float32", "bfloat16"):
            raise ValueError("serving_dtype must be 'float32' or 'bfloat16'")
        if init_low < 0 or init_high <= init_low:
            raise ValueError("need 0 <= init_low < init_high")
        super().__init__(min_rating=min_rating, max_rating=max_rating,
                         verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.n_factors = n_factors
        self.n_epochs = n_epochs
        self.reg = reg
        self.reg_pu = reg_pu
        self.reg_qi = reg_qi
        self.init_low = init_low
        self.init_high = init_high
        self.batch_size = batch_size
        self.seed = seed
        self.serving_dtype = serving_dtype
        self.mesh = mesh
        self._params: Optional[sgd.MFParams] = None
        self._serving_cache = None
        self.train_rmse: list = []
        self.global_mean: float = 0.0

    def _regs(self) -> tuple:
        """(reg_pu, reg_qi) with the ``reg`` default resolved."""
        return (self.reg if self.reg_pu is None else self.reg_pu,
                self.reg if self.reg_qi is None else self.reg_qi)

    def _cfg(self, batch_size: Optional[int] = None) -> SGDConfig:
        # linear kernel + zero global mean + zero biases: the score is p.q
        return SGDConfig(kernel="linear", n_factors=self.n_factors,
                         reg=self._regs()[0], min_rating=self.min_rating,
                         max_rating=self.max_rating,
                         batch_size=batch_size or self.batch_size)

    def _counts(self, ids: np.ndarray, cap: int) -> torch.Tensor:
        return torch.from_numpy(
            np.bincount(ids, minlength=cap).astype(np.float32)).to(self._device)

    def _pack(self, u, i, r, bs, order):
        return sgd.pack_ratings(u, i, r, bs, order=order, device=self._device)

    # -- lifecycle ----------------------------------------------------------
    def fit(self, X: pd.DataFrame, y: pd.Series, n_epochs: int = None):
        """Train from tables seeded with ``seed`` on a pack of the side with
        more ids (``order='auto'``); ``train_rmse`` is the per-epoch train
        RMSE."""
        u, i, r = self._preprocess_fit(X, y)
        if len(r) and r.min() < 0:
            raise ValueError(
                "NMF requires non-negative ratings (multiplicative updates "
                f"preserve sign only for r >= 0; got min {r.min()})")
        self.global_mean = float(np.mean(r)) if len(r) else 0.0
        cfg = self._cfg()
        reg_pu, reg_qi = self._regs()
        params = nmf_ops.init_nmf_params(
            torch.Generator(device=self._device).manual_seed(self.seed),
            self.n_users, self.n_items, cfg, self.init_low, self.init_high)
        n_epochs = n_epochs or self.n_epochs
        if self.mesh is not None and data_size_of(self.mesh) > 1:
            params, hist = self._fit_mesh(params, u, i, r, cfg, n_epochs)
        else:
            data = self._pack(u, i, r, cfg.batch_size, "auto")
            params, hist = nmf_ops.nmf_train(
                params, data, self._counts(u, params.user_features.shape[0]),
                self._counts(i, params.item_features.shape[0]), cfg,
                n_epochs, reg_pu, reg_qi)
        self._params = params
        self._serving_cache = None
        self.train_rmse = hist.cpu().tolist()
        if self.verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    def _fit_mesh(self, params, u, i, r, cfg, n_epochs):
        """The data-parallel fit of every rank (JAX ``nmf.py:135-171``): the
        user capacity ``round_up(n_users, 8 * N)`` (the seeded tables grown
        by fresh rows, which hold no user), this rank's P rows and a whole Q
        (``place_params``), its segment of the device-major pack, its users'
        counts and the global item counts, ``dp_nmf_train``, then the whole
        tables on every rank (``gather_params``). Returns (params,
        history)."""
        from matrix_factorization_tpu_torch.parallel import distributed as pdist

        n, d = data_size_of(self.mesh), device_index(self.mesh)
        ucap = sgd.round_up(self.n_users, 8 * n)
        cap = params.user_features.shape[0]
        if ucap > cap:
            fresh = nmf_ops.fresh_nmf_user_rows(
                sgd.seeded_generator(self._device, self.seed, 0), ucap - cap,
                cfg, self.init_low, self.init_high)
            params = params._replace(user_features=torch.cat(
                [params.user_features, fresh]))
        rows = ucap // n
        data = sgd.pack_ratings(u, i, r, cfg.batch_size, order="auto",
                                n_dev=n, users_per_dev=rows, segment=d,
                                device=self._device)
        reg_pu, reg_qi = self._regs()
        local, hist = nmf_ops.dp_nmf_train(
            pdist.place_params(params, self.mesh, self._device), data,
            self._counts(u, ucap)[d * rows:(d + 1) * rows],
            self._counts(i, params.item_features.shape[0]), cfg, n_epochs,
            reg_pu, reg_qi, self.mesh)
        return pdist.gather_params(local, self.mesh, q_sharded=False), hist

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray,
                        bound_ratings: bool):
        self._require_fitted()
        preds, possible = predict_on_device(self._params, self._cfg(), u, i,
                                            bound_ratings, self._device)
        # cold start: the global mean rating, not the factor model's 0
        fb = self.global_mean
        if bound_ratings:
            fb = float(np.clip(fb, self.min_rating, self.max_rating))
        return np.where(possible, preds, fb), possible

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

    def update_users(self, X: pd.DataFrame, y: pd.Series, lr: float = 0.0,
                     n_epochs: int = 20, verbose: int = 0):
        """Partial fit for new and updated users, item side frozen: the user
        table grows (by half again, to a multiple of 1,024 rows), known
        users named in X are re-initialised to fresh non-negative rows,
        then ``n_epochs`` user-side updates run against the frozen items on
        a user-primary pack. ``lr`` is unused (the updates are
        multiplicative; kept for the lifecycle signature)."""
        u, i, r, known_users, _new = self._preprocess_update(X, y)
        if len(r) and r.min() < 0:
            raise ValueError("NMF requires non-negative ratings")
        dev = self._device
        cap = self._params.user_features.shape[0]
        if self.n_users > cap:
            new_cap = sgd.round_up(max(self.n_users, int(cap * 1.5) + 1), 1024)
            fresh = nmf_ops.fresh_nmf_user_rows(
                sgd.seeded_generator(dev, self.seed + 1, 0), new_cap - cap,
                self._cfg(), self.init_low, self.init_high)
            self._params = self._params._replace(user_features=torch.cat(
                [self._params.user_features, fresh]))
        if known_users:
            idx = torch.from_numpy(self.user_vocab.encode(
                np.asarray(known_users, dtype=object)).astype(np.int64)).to(dev)
            fresh = nmf_ops.fresh_nmf_user_rows(
                sgd.seeded_generator(dev, self.seed + 1, 1), len(known_users),
                self._cfg(), self.init_low, self.init_high)
            uf = self._params.user_features.clone()
            uf[idx] = fresh
            self._params = self._params._replace(user_features=uf)
        pack_bs = min(self.batch_size, max(1, len(r)))
        cfg = self._cfg(batch_size=pack_bs)
        reg_pu, reg_qi = self._regs()
        params, hist = nmf_ops.nmf_train(
            self._params, self._pack(u, i, r, pack_bs, "user"),
            self._counts(u, self._params.user_features.shape[0]),
            torch.zeros(self._params.item_features.shape[0], device=dev),
            cfg, n_epochs, reg_pu, reg_qi, update_item_params=False)
        self._params = params
        self._serving_cache = None
        self.train_rmse = hist.cpu().tolist()
        if verbose:
            for e, v in enumerate(self.train_rmse):
                print(f"Epoch {e + 1} train RMSE: {v:.4f}")
        return self

    # -- serving ------------------------------------------------------------
    def _catalog_topk(self, u_dense: np.ndarray, k: int):
        return scoring.catalog_topk(self._cfg(), self._cached_serving_params(),
                                    self.n_items, u_dense, k)

    # -- parameter views ----------------------------------------------------
    @property
    def user_features(self) -> np.ndarray:
        return self._params.user_features[: self.n_users, : self.n_factors].cpu().numpy()

    @property
    def item_features(self) -> np.ndarray:
        return self._params.item_features[: self.n_items, : self.n_factors].cpu().numpy()
