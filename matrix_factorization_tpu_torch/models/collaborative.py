"""User-user and item-item collaborative filtering (PyTorch port).

Counterpart of ``matrix_factorization_tpu/models/collaborative.py``,
single device. Reference: ``matrix_factorization/collaborative_filtering.py``
(UserUserCF ``:14-190``, ItemItemCF ``:193-369``). The rating matrix is
written onto the device once, the similarity matrix is one f32 product,
and prediction is a batched masked top-k (``ops/similarity.py``) over
chunks of 4,096 pairs.

As in the JAX package, the reference's rating-misalignment bug (its
``fit`` shuffles X and re-attaches the unshuffled ratings,
``collaborative_filtering.py:58-59``; PARITY.md) is not reproduced, and
``similarity_metric='pearson'`` is centred cosine, the same computation
(``:90-94``). ``device`` is where the state lives (``None`` = CUDA).

``mesh`` (every rank calls every method): the (E, E) similarity matrix is
row-sharded over every rank of the mesh, as JAX lays it out
(``Pspec(tuple(mesh.axis_names))``): rank r of N computes its
``round_up(E, N) / N`` rows against the whole replicated rating matrix,
and ``predict`` has the rank holding a pair's row (the user's in user
mode, the item's in item mode) predict it, the others add 0, summed by
one ``all_reduce``. The similarity-matrix views and pickling gather the
whole matrix (a collective).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.models.base import RecommenderBase
from matrix_factorization_tpu_torch.ops import similarity as simops

_PREDICT_CHUNK = 4096


class _NeighborhoodCF(RecommenderBase):
    """Shared machinery of the two CF variants."""

    _mode = "user"  # or "item"

    def __init__(
        self,
        min_rating: float = 0,
        max_rating: float = 5,
        n_neighbors: int = 50,
        similarity_metric: str = "cosine",
        mesh=None,
        verbose: int = 0,
        device=None,
    ):
        if similarity_metric not in ("cosine", "pearson"):
            raise ValueError(f"Unknown similarity metric: {similarity_metric}")
        super().__init__(min_rating=min_rating, max_rating=max_rating, verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.n_neighbors = n_neighbors
        self.similarity_metric = similarity_metric
        self.mesh = mesh
        self._state: Optional[simops.CFState] = None
        self._rows = None  # (lo, hi): the similarity rows held on a mesh

    def _row_range(self):
        """This rank's similarity rows ``[lo, hi)`` on the mesh: the
        entities split in ``round_up(E, N) / N`` rows a rank."""
        from matrix_factorization_tpu_torch.parallel.mesh import flat_index

        E = self.n_users if self._mode == "user" else self.n_items
        n = self.mesh.size()
        per = -(-E // n)
        r = flat_index(self.mesh)
        return min(r * per, E), min((r + 1) * per, E)

    def fit(self, X: pd.DataFrame, y: pd.Series):
        u, i, r = self._preprocess_fit(X, y)
        fit_fn = simops.user_cf_fit if self._mode == "user" else simops.item_cf_fit
        dev = self._device
        self._rows = None if self.mesh is None else self._row_range()
        self._state = fit_fn(torch.from_numpy(u).to(dev),
                             torch.from_numpy(i).to(dev),
                             torch.tensor(r, device=dev),
                             self.n_users, self.n_items, self._rows)
        self.global_mean = float(self._state.global_mean)
        return self

    def _whole_sim(self) -> torch.Tensor:
        """The whole similarity matrix: the ranks' rows all-gathered (a
        collective) on a mesh."""
        sim = self._state.sim
        if self._rows is None:
            return sim
        from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows

        E = sim.shape[1]
        pad = sim.new_zeros((-(-E // self.mesh.size()), E))
        pad[:sim.shape[0]] = sim
        return all_gather_rows(pad)[:E]

    def __getstate__(self):
        state = super().__getstate__()
        if self._rows is not None:  # a rank's rows: pickle the whole matrix
            state["_state"] = state["_state"]._replace(sim=self._whole_sim().cpu())
            state["_rows"] = None
        return state

    def _predict_arrays(self, u: np.ndarray, i: np.ndarray, bound_ratings: bool):
        """Chunks of ``_PREDICT_CHUNK`` pairs, the last padded with -1 (a
        cold pair), so every chunk has one shape."""
        self._require_fitted()
        pred_fn = (simops.user_cf_predict if self._mode == "user"
                   else simops.item_cf_predict)
        preds = np.empty(len(u), np.float32)
        possible = np.empty(len(u), bool)
        for lo in range(0, len(u), _PREDICT_CHUNK):
            hi = min(lo + _PREDICT_CHUNK, len(u))
            n = hi - lo
            uu = np.full(_PREDICT_CHUNK, -1, np.int64)
            ii = np.full(_PREDICT_CHUNK, -1, np.int64)
            uu[:n], ii[:n] = u[lo:hi], i[lo:hi]
            p, ok = pred_fn(self._state, torch.from_numpy(uu).to(self._device),
                            torch.from_numpy(ii).to(self._device),
                            self.n_neighbors, self.min_rating, self.max_rating,
                            bound_ratings, self._rows)
            preds[lo:hi] = p[:n].cpu().numpy()
            possible[lo:hi] = ok[:n].cpu().numpy()
        return preds, possible

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

    # -- reference-parity attribute views -----------------------------------
    @property
    def user_item_matrix(self) -> np.ndarray:
        return self._state.ratings.cpu().numpy()


class UserUserCF(_NeighborhoodCF):
    """Predict from the ratings of the top-k most similar users who rated
    the item: ``pred = mean_u + sum(sim*(r_v - mean_v)) / sum(|sim|)``."""

    _mode = "user"

    @property
    def user_similarity_matrix(self) -> np.ndarray:
        return self._whole_sim().cpu().numpy()

    @property
    def user_mean_ratings(self) -> np.ndarray:
        return self._state.means.cpu().numpy()


class ItemItemCF(_NeighborhoodCF):
    """Predict from the user's ratings of the top-k most similar items."""

    _mode = "item"

    @property
    def item_similarity_matrix(self) -> np.ndarray:
        return self._whole_sim().cpu().numpy()

    @property
    def item_mean_ratings(self) -> np.ndarray:
        return self._state.means.cpu().numpy()
