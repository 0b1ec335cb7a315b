"""BPR: pairwise-ranking matrix factorization for implicit feedback
(PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/bpr.py``, single device:
``fit`` (with ``warm_start``) on an interaction table (``y`` optional; a
given ``y`` only keeps the rows with strength > 0 as positives),
``predict`` of unbounded ranking scores, ``recommend`` /
``recommend_batch`` on the catalog scorer (``ops/cuda_scores.py`` on the
card), ``update_users`` with the item side frozen, and the sampled
``auc``. Training is ``ops/bpr.py::bpr_train_tiled`` on a user-primary
pack, its applies the hand-written ``mf_segment_apply`` on the card.

The constructor takes the JAX package's arguments, so that a checkpoint's
``config`` constructs either package's model, plus ``device`` (``None`` =
CUDA). With a ``mesh`` (``parallel/mesh.py``) of more than one data rank
every rank calls ``fit`` with the same interactions and trains
data-parallel (``ops/bpr.py::dp_bpr_train_tiled`` for ``dp_layout=
'tiled'``, ``dp_bpr_train`` for ``'flat'``), then holds the gathered
tables and serves as a single-device model does. Random streams are
``torch.Generator``s seeded from ``seed``: the same seed gives the same
model bit for bit, though not the JAX package's random bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.core.ids import check_no_duplicates
from matrix_factorization_tpu_torch.models.base import (RecommenderBase, check_mesh_args,
                                                    predict_on_device)
from matrix_factorization_tpu_torch.ops import bpr as bpr_ops
from matrix_factorization_tpu_torch.ops import scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.parallel.mesh import data_size_of, device_index


class BPR(RecommenderBase):
    def __init__(
        self,
        n_factors: int = 64,
        n_epochs: int = 30,
        lr: float = 0.05,
        reg: float = 0.002,
        batch_size: int = 8192,
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
        """Arguments as in the JAX package's ``BPR``, validated the same
        way, plus ``device``. ``mesh``: with more than one data rank,
        ``fit`` trains data-parallel (P sharded by user range, the item
        deltas all-reduced) and gathers the tables. ``dp_layout``:
        ``'tiled'`` (each rank's segment of the user-primary device-major
        pack) or ``'flat'`` (each rank's user range of the stream).
        ``overlap_psum`` runs each item all-reduce under the next step or
        window; ``psum_every`` sets the tiled layout's window, and the
        flat layout ignores it, as the JAX package's does."""
        check_mesh_args(serving_dtype, mesh, overlap_psum, dp_layout,
                        psum_every)
        # ranking scores are unbounded; +-inf makes every clamp a no-op
        super().__init__(min_rating=float("-inf"), max_rating=float("inf"),
                         verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.n_factors = n_factors
        self.n_epochs = n_epochs
        self.lr = lr
        self.reg = reg
        self.batch_size = batch_size
        self.init_sd = init_sd
        self.seed = seed
        self.mesh = mesh
        self.overlap_psum = overlap_psum
        self.serving_dtype = serving_dtype
        self.dp_layout = dp_layout
        self.psum_every = psum_every
        self._params: Optional[sgd.MFParams] = None
        self._serving_cache = None
        self.train_loss: list = []

    def _cfg(self) -> SGDConfig:
        # the rating bounds enter SGDConfig only through the sigmoid/rbf
        # epilogues and the clamp; BPR serves the linear kernel unbounded
        return SGDConfig(kernel="linear", n_factors=self.n_factors,
                         reg=self.reg, min_rating=0.0, max_rating=1.0)

    def _pack(self, u, i, bs):
        return sgd.pack_ratings(u.astype(np.int32), i.astype(np.int32),
                                np.ones(len(u), np.float32), bs,
                                shuffle_seed=self.seed, order="user",
                                device=self._device)

    # -- lifecycle ----------------------------------------------------------
    def fit(self, X: pd.DataFrame, y: pd.Series = None,
            n_epochs: int = None, warm_start: bool = False):
        """Train on the interaction table (``y`` only gates which rows are
        positives, > 0). ``warm_start=True`` continues from the current
        tables (same id space, strict encode), the building block of
        ``core.checkpoint.fit_resumable``, and keeps the earlier training
        positives for ``auc``'s rejection; it trains on the single-device
        path even with a mesh, as in the JAX package. The initial tables
        come from a generator seeded with ``seed``; the epochs' batch
        orders and negatives from one seeded with (``seed``, 1 + epochs
        done), on a mesh with (``seed``, 1 + epochs done, epoch, rank)."""
        if y is None:
            y = pd.Series(np.ones(len(X), np.float32))
        prev_pairs = None
        if warm_start and self._params is not None:
            users = X["user_id"].to_numpy()
            items = X["item_id"].to_numpy()
            check_no_duplicates(users, items)
            u = self.user_vocab.encode(users, strict=True)
            i = self.item_vocab.encode(items, strict=True)
            r = np.asarray(y, dtype=np.float32)
            prev_pairs = self._train_pairs
        else:
            warm_start = False
            u, i, r = self._preprocess_fit(X, y)
            self.train_loss = []
        keep = r > 0
        u, i = u[keep], i[keep]
        if len(u) == 0:
            raise ValueError("BPR needs at least one positive interaction")
        cfg = self._cfg()
        n_epochs = n_epochs or self.n_epochs
        if prev_pairs is None:  # auc's negative rejection
            self._train_pairs = (u.copy(), i.copy())
        else:
            self._train_pairs = (np.concatenate([prev_pairs[0], u]),
                                 np.concatenate([prev_pairs[1], i]))
        fit_key = (self.seed, 1 + len(self.train_loss))
        if warm_start:
            params = self._params
        else:
            params = sgd.init_params(
                torch.Generator(device=self._device).manual_seed(self.seed),
                self.n_users, self.n_items, cfg, global_mean=0.0,
                init_sd=self.init_sd)
        if not warm_start and self.mesh is not None \
                and data_size_of(self.mesh) > 1:
            params, hist = self._fit_mesh(params, u, i, cfg, n_epochs, fit_key)
        else:
            data = self._pack(u, i, min(self.batch_size, max(1, len(u))))
            params, hist = bpr_ops.bpr_train_tiled(
                params, data, sgd.seeded_generator(self._device, *fit_key),
                cfg, n_epochs, self.lr, self.n_items)
        self._params = params
        self.global_mean = 0.0
        done = len(self.train_loss)
        self.train_loss = self.train_loss + hist.cpu().tolist()
        if self.verbose:
            for e, v in enumerate(self.train_loss[done:], start=done):
                print(f"Epoch {e + 1} BPR loss: {v:.4f}")
        return self

    def _fit_mesh(self, params, u, i, cfg, n_epochs, fit_key):
        """The data-parallel fit of every rank (JAX ``bpr.py:145-192``): the
        user capacity ``round_up(n_users, 8 * N)`` (the seeded tables grown
        by fresh rows, which hold no user, so the real rows start where a
        mesh-free fit's do), this rank's P rows and a whole Q
        (``place_params``), its part of the positives, the trainer, then
        the whole tables on every rank (``gather_params``). Returns
        (params, history)."""
        from matrix_factorization_tpu_torch.parallel import distributed as pdist

        n, d = data_size_of(self.mesh), device_index(self.mesh)
        ucap = sgd.round_up(self.n_users, 8 * n)
        cap = params.user_features.shape[0]
        if ucap > cap:
            fresh = sgd.fresh_user_rows(
                sgd.seeded_generator(self._device, self.seed, 0), ucap - cap,
                cfg, 0.0, self.init_sd)
            params = params._replace(user_features=torch.cat(
                [params.user_features, fresh]))
        local = pdist.place_params(params, self.mesh, self._device)
        ones = np.ones(len(u), np.float32)
        bs = min(self.batch_size, max(1, len(u)))
        if self.dp_layout == "tiled":
            data = sgd.pack_ratings(
                u.astype(np.int32), i.astype(np.int32), ones, bs,
                shuffle_seed=self.seed, order="user", n_dev=n,
                users_per_dev=ucap // n, segment=d, device=self._device)
            local, hist = bpr_ops.dp_bpr_train_tiled(
                local, data, cfg, n_epochs, self.lr, self.n_items, self.mesh,
                overlap_psum=self.overlap_psum, psum_every=self.psum_every,
                key=fit_key)
        else:
            _, bs, stream = pdist.dp_fit_plumbing(u, i, ones, self.n_users,
                                                  self.mesh, self.batch_size)
            local, hist = bpr_ops.dp_bpr_train(
                local, pdist.local_ratings(stream, d, n, self._device), cfg,
                n_epochs, self.lr, self.n_items, bs, len(u), self.mesh,
                overlap_psum=self.overlap_psum, key=fit_key)
        return pdist.gather_params(local, self.mesh, q_sharded=False), hist

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray,
                        bound_ratings: bool):
        self._require_fitted()
        # bound_ratings is a no-op on (-inf, inf): the unbounded path
        return predict_on_device(self._params, self._cfg(), u, i, False,
                                 self._device)

    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        """Unbounded ranking scores (higher = preferred). A cold-start pair
        takes the cold row of its unknown side (an unknown user scores the
        item's bias, an unknown item 0), with ``predictions_possible``
        False."""
        if X.shape[0] == 0:
            return []
        u, i = self._preprocess_predict(X)
        preds, possible = self._predict_arrays(u, i, bound_ratings)
        self.predictions_possible = possible.tolist()
        return preds.tolist()

    def _predict_dense(self, u, i, bound_ratings):
        return self._predict_arrays(
            np.asarray(u, np.int32), np.asarray(i, np.int32), bound_ratings)

    def update_users(self, X: pd.DataFrame, y: pd.Series = None,
                     lr: float = None, n_epochs: int = None,
                     verbose: int = 0):
        """Re-train the named users' rows (fresh random init) with the item
        side frozen. The table grows (to a multiple of 1,024 rows) before
        any early return, since new users are already in the vocabulary;
        only the known users who keep positives after the ``y > 0`` filter
        are re-initialised, so a known user with none keeps their row."""
        if y is None:
            y = pd.Series(np.ones(len(X), np.float32))
        u, i, r, known_users, _new = self._preprocess_update(X, y)
        cfg = self._cfg()
        cap = self._params.user_features.shape[0]
        if self.n_users > cap:
            grown = sgd.round_up(self.n_users, 1024)
            fresh = sgd.fresh_user_rows(
                sgd.seeded_generator(self._device, self.seed + 1),
                grown - cap, cfg, 0.0, self.init_sd)
            self._params = self._params._replace(user_features=torch.cat(
                [self._params.user_features, fresh]))
            self._serving_cache = None
        keep = r > 0
        u, i = u[keep], i[keep]
        if len(u) == 0:
            return self
        if known_users:
            enc = np.asarray(
                self.user_vocab.encode(np.asarray(known_users, dtype=object)))
            enc = enc[np.isin(enc, np.unique(np.asarray(u)))]
            if enc.size:
                fresh = sgd.fresh_user_rows(
                    sgd.seeded_generator(self._device, self.seed + 2),
                    int(enc.size), cfg, 0.0, self.init_sd)
                uf = self._params.user_features.clone()
                uf[torch.from_numpy(enc.astype(np.int64)).to(self._device)] = fresh
                self._params = self._params._replace(user_features=uf)
        data = self._pack(u, i, min(self.batch_size, max(1, len(u))))
        params, hist = bpr_ops.bpr_train_tiled(
            self._params, data, sgd.seeded_generator(self._device, self.seed, 2),
            cfg, n_epochs or self.n_epochs, lr or self.lr, self.n_items,
            update_item_params=False)
        self._params = params
        self._serving_cache = None
        if verbose:
            for e, v in enumerate(hist.cpu().tolist()):
                print(f"Epoch {e + 1} BPR loss: {v:.4f}")
        return self

    # -- serving ------------------------------------------------------------
    def _catalog_topk(self, u_dense: np.ndarray, k: int):
        return scoring.catalog_topk(self._cfg(), self._cached_serving_params(),
                                    self.n_items, u_dense, k)

    def auc(self, X: pd.DataFrame, n_neg: int = 20, seed: int = 0) -> float:
        """Sampled pairwise AUC on held-out positives. The negative draws
        reject the training positives and the evaluated pairs."""
        self._require_fitted()
        u = self.user_vocab.encode(X["user_id"].to_numpy())
        i = self.item_vocab.encode(X["item_id"].to_numpy())
        keep = (u >= 0) & (i >= 0)
        if not keep.any():
            raise ValueError("no known (user, item) pairs to score")
        tu, ti = self._train_pairs
        observed = (np.concatenate([tu, u[keep]]),
                    np.concatenate([ti, i[keep]]))
        return bpr_ops.auc_sampled(self._params, u[keep], i[keep],
                                   self.n_items, self._cfg(), seed=seed,
                                   n_neg=n_neg, observed=observed)

    # -- parameter views ----------------------------------------------------
    @property
    def user_features(self) -> np.ndarray:
        return self._params.user_features[: self.n_users, : self.n_factors].cpu().numpy()

    @property
    def item_features(self) -> np.ndarray:
        return self._params.item_features[: self.n_items, : self.n_factors].cpu().numpy()

    @property
    def item_biases(self) -> np.ndarray:
        col = sgd.bias_col(self._cfg(), "item")
        return self._params.item_features[: self.n_items, col].cpu().numpy()
