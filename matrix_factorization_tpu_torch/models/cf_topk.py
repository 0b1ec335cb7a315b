"""Scalable neighbourhood CF with precomputed top-k neighbour lists
(PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/cf_topk.py``, single
device. ``UserUserCF`` / ``ItemItemCF`` (``models/collaborative.py``)
hold dense rating and similarity matrices; these variants scale to
MovieLens-25M (``BASELINE.json`` config 4):

* ``fit``: top-k centered-cosine neighbour lists from the block-tiled
  sparse gram (``ops/sparse_gram.py``), no dense matrix formed;
* ``predict``: ``pred = mean_e + sum(sim * (r - mean_n)) / sum(|sim|)``
  over the neighbours the row has rated, on the device: the ratings live
  as a CSR of row-sorted candidate ids (sorted on the host by the native
  two-pass counting sort ``mf_lexsort_pair``), and each (pair, neighbour)
  lookup is a binary search with a fixed number of steps, in plain tensor
  ops, over chunks of pairs (``models/base.py::chunked_predict``).

As in the JAX package, neighbours come from each entity's global top-k
list rather than from all raters of each prediction, the standard
truncation of production neighbourhood CF; set ``n_neighbors`` to about
10x the neighbour budget the exact classes would get for near parity.
``mesh``: the similarity fit splits its user blocks over every rank of
the mesh and all-reduces each gram strip once
(``ops/sparse_gram.py::similarity_topk``); every rank calls ``fit`` and
keeps the whole neighbour lists, O(entities x k), so prediction needs no
collective. ``device`` is where the state lives (``None`` = CUDA).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.data.loader import host_lib
from matrix_factorization_tpu_torch.models.base import RecommenderBase, chunked_predict
from matrix_factorization_tpu_torch.ops.sparse_gram import similarity_topk


def _topk_cf_predict(flat_q, flat_r, offsets, nb_ids, nb_sims, means, ent,
                     rows, possible, global_mean: float, iters: int,
                     bound: bool, min_r: float, max_r: float) -> torch.Tensor:
    """Predictions of B pairs: ``ent`` (B,) the entity whose neighbour list
    is read, ``rows`` (B,) the CSR row whose ratings are searched (both
    clipped to >= 0), ``possible`` (B,) bool. ``flat_q`` (n,) int32 holds
    each row's candidate ids ascending, ``flat_r`` (n,) their ratings,
    ``offsets`` (n_rows + 1,) the rows' bounds."""
    n_flat = flat_q.shape[0]
    nb = nb_ids[ent]  # (B, k)
    sim = nb_sims[ent]
    lo = offsets[rows][:, None]
    hi = offsets[rows + 1][:, None]
    l, h = lo, hi
    for _ in range(iters):  # lower bound, a fixed number of steps
        active = l < h
        mid = (l + h) // 2
        v = flat_q[mid.clamp(0, n_flat - 1)]
        go_right = active & (v < nb)
        l = torch.where(go_right, mid + 1, l)
        h = torch.where(active & ~go_right, mid, h)
    pos = l.clamp(0, n_flat - 1)
    found = (l < hi) & (flat_q[pos] == nb)
    nb_safe = nb.clamp(0, means.shape[0] - 1)
    dev = flat_r[pos] - means[nb_safe]
    zero = sim.new_zeros(())
    num = torch.where(found, sim * dev, zero).sum(dim=1)
    den = torch.where(found, sim.abs(), zero).sum(dim=1)
    base = means[ent]
    pred = torch.where(den > 0, base + num / den.clamp_min(1e-12), base)
    pred = torch.where(possible, pred, pred.new_tensor(global_mean))
    if bound:
        pred = pred.clamp(min_r, max_r)
    return pred


class _TopKNeighborCF(RecommenderBase):
    _mode = "item"  # or "user"

    def __init__(
        self,
        min_rating: float = 0,
        max_rating: float = 5,
        n_neighbors: int = 50,
        user_block: int = 4096,
        item_tile: int = 4096,
        mesh=None,
        verbose: int = 0,
        device=None,
    ):
        super().__init__(min_rating=min_rating, max_rating=max_rating,
                         verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.n_neighbors = n_neighbors
        self.user_block = user_block
        self.item_tile = item_tile
        self.mesh = mesh
        self._neighbor_sims: Optional[torch.Tensor] = None
        self._neighbor_ids: Optional[torch.Tensor] = None
        self._means: Optional[torch.Tensor] = None
        self._flat_q: Optional[torch.Tensor] = None
        self._flat_r: Optional[torch.Tensor] = None
        self._offsets: Optional[torch.Tensor] = None
        self._iters: int = 1

    def fit(self, X: pd.DataFrame, y: pd.Series):
        u, i, r = self._preprocess_fit(X, y)
        self.global_mean = float(np.mean(r))
        kw = dict(user_block=self.user_block, item_tile=self.item_tile,
                  mesh=self.mesh, device=self._device)
        if self._mode == "item":
            sims, ids, means, _ = similarity_topk(
                u, i, r, self.n_users, self.n_items, self.n_neighbors, **kw)
            rows, cands, n_rows = u, i, self.n_users
        else:  # user-user: the axes swap roles
            sims, ids, means, _ = similarity_topk(
                i, u, r, self.n_items, self.n_users, self.n_neighbors, **kw)
            rows, cands, n_rows = i, u, self.n_items
        dev = self._device
        self._neighbor_sims = torch.from_numpy(sims).to(dev)
        self._neighbor_ids = torch.from_numpy(ids).to(dev)
        self._means = torch.from_numpy(np.asarray(means, np.float32)).to(dev)

        # the CSR of (row -> candidate ids ascending, ratings): the native
        # two-pass counting sort, equal to np.lexsort((cands, rows))
        counts = np.bincount(rows, minlength=n_rows)
        n = len(rows)
        cands_s = np.empty(n, np.int32)
        r_s = np.empty(n, np.float32)
        if n:
            host_lib().mf_lexsort_pair(
                np.ascontiguousarray(rows, np.int32),
                np.ascontiguousarray(cands, np.int32),
                np.ascontiguousarray(r, np.float32), n, n_rows,
                int(cands.max()) + 1, cands_s, r_s)
        self._flat_q = torch.from_numpy(cands_s).to(dev)
        self._flat_r = torch.from_numpy(r_s).to(dev)
        self._offsets = torch.from_numpy(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
        max_len = int(counts.max()) if len(counts) else 1
        self._iters = max(1, int(np.ceil(np.log2(max_len + 1))) + 1)
        return self

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray, bound_ratings: bool):
        self._require_fitted()
        dev = self._device

        def fn(uu, ii):
            uu = torch.from_numpy(np.ascontiguousarray(uu, np.int64)).to(dev)
            ii = torch.from_numpy(np.ascontiguousarray(ii, np.int64)).to(dev)
            possible = (uu >= 0) & (ii >= 0)
            if self._mode == "item":
                ent, rows = ii.clamp_min(0), uu.clamp_min(0)
            else:
                ent, rows = uu.clamp_min(0), ii.clamp_min(0)
            pred = _topk_cf_predict(
                self._flat_q, self._flat_r, self._offsets, self._neighbor_ids,
                self._neighbor_sims, self._means, ent, rows, possible,
                self.global_mean, self._iters, bool(bound_ratings),
                float(self.min_rating), float(self.max_rating))
            return pred.cpu().numpy(), possible.cpu().numpy()

        return chunked_predict(fn, np.asarray(u, np.int32), np.asarray(i, np.int32))

    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        if X.shape[0] == 0:
            return []
        u, i = self._preprocess_predict(X)
        preds, possible = self._predict_arrays(u, i, bound_ratings)
        self.predictions_possible = possible.tolist()
        return preds.tolist()

    def _predict_dense(self, u, i, bound_ratings):
        return self._predict_arrays(np.asarray(u, np.int32),
                                    np.asarray(i, np.int32), bound_ratings)


class TopKItemItemCF(_TopKNeighborCF):
    """Item-item CF at sparse 25M-rating scale."""

    _mode = "item"


class TopKUserUserCF(_TopKNeighborCF):
    """User-user CF at sparse 25M-rating scale."""

    _mode = "user"
