"""EASE recommender: the closed-form item-item linear model (Steck 2019),
PyTorch port.

Counterpart of ``matrix_factorization_tpu/models/ease.py``. Training is
one regularized SPD inverse of the item gram (``ops/ease.py``), whose
Gauss-Jordan leaves run in the hand-written kernel of ``csrc/spd_gj.cu``
on the GPU: no epochs, no learning rate, no randomness. Predictions are
preference scores (about [0, 1] for binary histories), not ratings.
``update_users`` only records histories: ``B`` does not depend on the
users. ``device`` is where the state lives (``None`` = CUDA).

``mesh`` (a ``parallel.mesh`` mesh; every rank calls every method): on
more than one data rank ``fit`` builds the gram data-parallel
(``dp_item_gram``) and inverts it with ``ease_weights_sharded`` (the
Schur recursion below 16,384 items, the row-sharded Newton-Schulz inverse
from there), under the item budget of the data ranks; on one data rank it
takes the single-device path, as the JAX model does.

On one data rank ``fit`` is two calls of ``ops/ease.py``: ``gram_pack``
(the host sorts the pairs by user, notes where each user chunk starts and
puts them on the device) and ``fit_packed`` (the gram's scan, exact on the
int8 tensor cores of a CUDA card for binary or small-integer weights, then
the inverse and the closed form). Its item budget is
``ops/ease.py::device_item_limit``: on a CUDA card as many items as 90% of
its memory holds at the fit's measured peak for its plays, on the CPU and
on a mesh the JAX package's tiers. The fitted ``B``
stays row-sharded over the mesh's first axis (the data axis of
``make_mesh``): a rank holds rows ``[lo, hi)`` of it
(``ops/spd.py::ns_layout``), and scoring sums the ranks' partial
products with one ``all_reduce`` (``ops/ease.py::score_history_rows``)
instead of gathering ``B``. ``save_model`` and pickling gather the whole
``B`` (a collective), so a mesh checkpoint loads without a mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.models.base import RecommenderBase
from matrix_factorization_tpu_torch.ops import ease as ease_ops
from matrix_factorization_tpu_torch.ops.scoring import stable_topk, topk_harness

_SCORE_COHORT = 256  # users scored at once by predict


class EASE(RecommenderBase):
    """``s_u = x_u B`` with ``B = I - (G + lam I)^{-1} / diag``.

    ``reg`` (lam) is the only training hyperparameter. ``binarize=True``
    scores histories as 0/1 interactions; ``False`` keeps the ``y`` values
    as interaction weights. ``serving_dtype='bfloat16'`` serves from a
    bf16 copy of ``B`` (the checkpointed state stays f32)."""

    def __init__(
        self,
        reg: float = 250.0,
        binarize: bool = True,
        min_rating: float = 0,
        max_rating: float = 1,
        verbose: int = 0,
        gram_chunk_users: int = 2048,
        serving_dtype: str = "float32",
        mesh=None,
        device=None,
    ):
        if reg <= 0:
            raise ValueError("reg must be positive (it conditions the inverse)")
        if serving_dtype not in ("float32", "bfloat16"):
            raise ValueError("serving_dtype must be 'float32' or 'bfloat16'")
        super().__init__(min_rating=min_rating, max_rating=max_rating,
                         verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.reg = reg
        self.binarize = binarize
        self.gram_chunk_users = gram_chunk_users
        self.serving_dtype = serving_dtype
        self.mesh = mesh
        self._params: Optional[ease_ops.EASEParams] = None
        self._sharding: Optional[str] = None  # "rows": B row-sharded on the mesh
        self._serving_cache = None
        # per-user histories, a CSR over dense user ids
        self._indptr: Optional[np.ndarray] = None
        self._hist_i: Optional[np.ndarray] = None
        self._hist_w: Optional[np.ndarray] = None

    # -- histories -----------------------------------------------------------
    def _weights(self, r: np.ndarray) -> np.ndarray:
        if self.binarize:
            return np.ones_like(r, dtype=np.float32)
        if (r < 0).any():
            raise ValueError("interaction weights must be non-negative")
        return r.astype(np.float32)

    def _set_histories(self, u: np.ndarray, i: np.ndarray, w: np.ndarray):
        order = np.argsort(u, kind="stable")
        u, i, w = u[order], i[order], w[order]
        self._indptr = np.zeros(self.n_users + 1, np.int64)
        np.cumsum(np.bincount(u, minlength=self.n_users), out=self._indptr[1:])
        self._hist_i = i.astype(np.int32)
        self._hist_w = w.astype(np.float32)

    def _history_block(self, u_dense: np.ndarray):
        """Padded (B, L) item ids and weights of a user cohort, L the
        cohort's longest history as a power of two (at least 8); users
        outside the vocabulary get empty rows (all scores 0)."""
        lens = [int(self._indptr[u + 1] - self._indptr[u])
                if 0 <= u < self.n_users else 0 for u in u_dense]
        L = 1 << max(3, (max(lens + [1]) - 1).bit_length())
        ids = np.zeros((len(u_dense), L), np.int32)
        w = np.zeros((len(u_dense), L), np.float32)
        for row, (u, ln) in enumerate(zip(u_dense, lens)):
            if ln:
                s = self._indptr[u]
                ids[row, :ln] = self._hist_i[s:s + ln]
                w[row, :ln] = self._hist_w[s:s + ln]
        return ids, w

    # -- lifecycle -----------------------------------------------------------
    def fit(self, X: pd.DataFrame, y: pd.Series):
        u, i, r = self._preprocess_fit(X, y)
        w = self._weights(r)
        n_dev = 1
        if self.mesh is not None:
            from matrix_factorization_tpu_torch.parallel.mesh import data_size_of

            n_dev = data_size_of(self.mesh)
        ease_ops.check_item_budget(
            self.n_items, ease_ops.device_item_limit(n_dev, self._device, len(u)))
        if n_dev > 1:
            # the gram goes in as an argument alone, so that the
            # Newton-Schulz path can free it before its steps
            B = ease_ops.ease_weights_sharded(
                ease_ops.dp_item_gram(u, i, w, self.n_users, self.n_items,
                                      self.mesh, self.gram_chunk_users,
                                      device=self._device),
                self.reg, self.mesh)
            self._sharding = "rows"
        else:
            # two calls: the host pack, then the device's scan, inverse
            # and closed form (the benchmark times the second alone)
            pack = ease_ops.gram_pack(u, i, w, self.n_users, self.n_items,
                                      self.gram_chunk_users, device=self._device)
            B = ease_ops.fit_packed(pack, self.reg)
            del pack
            self._sharding = None
        self._params = ease_ops.EASEParams(B)
        self._serving_cache = None
        self._set_histories(u, i, w)
        if self.verbose:
            print(f"EASE: {self.n_items} items, reg={self.reg}, "
                  f"serving {self.serving_dtype}")
        return self

    def _serving_B(self) -> torch.Tensor:
        """``B`` as served: the f32 state, or its bf16 copy, rebuilt
        whenever ``_params`` is replaced (identity is the staleness
        check)."""
        p = self._params
        if self.serving_dtype == "float32":
            return p.item_weights
        c = self._serving_cache
        if c is None or c[0] is not p:
            self._serving_cache = c = (p, p.item_weights.to(torch.bfloat16))
        return c[1]

    def _b_rows(self):
        """(lo, hi, group): the rows of ``B`` this rank holds and the group
        its partial products are summed over; None for a whole ``B``."""
        if self._sharding is None:
            return None
        from matrix_factorization_tpu_torch.ops.spd import ns_layout

        lay = ns_layout(self._params.item_weights.shape[1], self.mesh)
        return lay.lo, lay.hi, lay.group

    def _whole_params(self):
        """``EASEParams`` with the whole ``B``: the ranks' rows all-gathered
        over the mesh's first axis when ``B`` is row-sharded (a
        collective), else the params themselves."""
        rows = self._b_rows()
        if rows is None:
            return self._params
        from matrix_factorization_tpu_torch.ops.spd import ns_layout
        from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows

        B = self._params.item_weights
        ip = B.shape[1]
        lay = ns_layout(ip, self.mesh)
        pad = B.new_zeros((lay.dl, ip))
        pad[:B.shape[0]] = B
        return ease_ops.EASEParams(all_gather_rows(pad, lay.group)[:ip])

    def _block_scores(self, ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(nb, I_p) f32 catalog scores of padded histories on the device:
        one product with a whole ``B``, the ranks' partial products summed
        with a row-sharded one."""
        B = self._serving_B()
        rows = self._b_rows()
        if rows is None:
            return ease_ops.score_history_block(B, ids, w)
        lo, _, group = rows
        return ease_ops.score_history_rows(B, lo, ids, w, B.shape[1], group)

    def _scores_for(self, u_dense: np.ndarray) -> np.ndarray:
        """(B, n_items) host scores of a user cohort."""
        ids, w = self._history_block(np.asarray(u_dense, np.int64))
        dev = self._params.item_weights.device
        s = self._block_scores(torch.from_numpy(ids).to(dev),
                               torch.from_numpy(w).to(dev))
        return s[:, :self.n_items].cpu().numpy()

    def _pair_scores(self, u: np.ndarray, i: np.ndarray):
        """Unbounded scores and ``possible`` of dense (u, i) pairs: columns
        of the queried users' catalog rows, scored in cohorts of 256; an
        unknown user or item scores 0.0."""
        preds = np.zeros(len(u), np.float32)
        possible = (u >= 0) & (i >= 0)
        uniq, inv = np.unique(u[possible], return_inverse=True)
        pos = np.flatnonzero(possible)
        for lo in range(0, len(uniq), _SCORE_COHORT):
            chunk = uniq[lo:lo + _SCORE_COHORT]
            rows = self._scores_for(chunk)
            sel = (inv >= lo) & (inv < lo + len(chunk))
            preds[pos[sel]] = rows[inv[sel] - lo, i[pos[sel]]]
        return preds, possible

    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        """Preference scores of (user, item) pairs; an unknown user or item
        scores 0.0 with ``possible`` False."""
        self._require_fitted()
        if X.shape[0] == 0:
            return []
        u, i = self._preprocess_predict(X)
        preds, possible = self._pair_scores(u, i)
        if bound_ratings:
            preds = np.clip(preds, self.min_rating, self.max_rating)
        self.predictions_possible = possible.tolist()
        return preds.tolist()

    def _predict_dense(self, u, i, bound_ratings):
        """``recommend``'s path for a user outside the vocabulary: float64
        scores, as the JAX model's generic path (``predict``'s Python
        floats) gives them."""
        preds, possible = self._pair_scores(np.asarray(u, np.int64),
                                            np.asarray(i, np.int64))
        if bound_ratings:
            preds = np.clip(preds, self.min_rating, self.max_rating)
        return preds.astype(np.float64), possible

    def update_users(self, X: pd.DataFrame, y: pd.Series, lr: float = 0.0,
                     n_epochs: int = 0, verbose: int = 0):
        """Record histories of new users and replace known users' (the
        reference's "pass all ratings for old users" semantics).
        ``lr`` / ``n_epochs`` are accepted for API parity and unused: ``B``
        does not depend on the users, so this is bookkeeping only."""
        u, i, r, known, _new = self._preprocess_update(X, y)
        if len(r) == 0:
            return self
        w = self._weights(r)
        n_old = len(self._indptr) - 1
        pair_u = np.repeat(np.arange(n_old, dtype=np.int64), np.diff(self._indptr))
        keep = np.ones(len(pair_u), bool)
        if known:
            drop = self.user_vocab.encode(np.asarray(known, dtype=object))
            keep = ~np.isin(pair_u, drop)
        self._set_histories(
            np.concatenate([pair_u[keep], u.astype(np.int64)]),
            np.concatenate([self._hist_i[keep], i.astype(np.int32)]),
            np.concatenate([self._hist_w[keep], w]))
        return self

    # -- serving -------------------------------------------------------------
    def _catalog_scores(self, u_dense: int) -> np.ndarray:
        return self._scores_for(np.asarray([u_dense], np.int64))[0]

    def _catalog_scores_batch(self, u_dense: np.ndarray) -> np.ndarray:
        return self._scores_for(np.asarray(u_dense, np.int64))

    def _catalog_topk(self, u_dense: np.ndarray, k: int):
        """Device top-k: the cohort's history rows (the harness's ``prep``
        hook), the catalog product and a stable top-k; the pad item
        columns score ``-inf``. Only (B, k) reaches the host."""
        n_items = self.n_items
        dev = self._params.item_weights.device

        def prep(ud):
            ids, w = self._history_block(np.asarray(ud, np.int64))
            return torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)

        def run(ud, kk, ids, w):
            s = self._block_scores(ids, w)
            s[:, n_items:] = float("-inf")
            return stable_topk(s, kk)

        return topk_harness(run, n_items, u_dense, k, prep=prep)
