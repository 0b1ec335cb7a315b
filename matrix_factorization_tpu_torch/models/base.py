"""Abstract base for the port's recommender models.

Counterpart of ``matrix_factorization_tpu/models/base.py``, with the
reference's ``RecommenderBase`` surface (``recommender_base.py:14-271``):
the ``fit / predict / recommend / update_users`` lifecycle, arbitrary
hashable ids remapped to dense ints (unknown ids are ``-1``, cold start),
and full-catalog ``recommend`` / ``recommend_batch`` over one device
top-k. With sklearn importable the base is sklearn's ``BaseEstimator``
and ``RegressorMixin``, as in the JAX package (``clone``,
``set_params``, ``score``, ``GridSearchCV``); without it (sklearn is
optional) ``get_params`` is the port's own, with sklearn's convention
(every constructor argument, read back from the attribute of the same
name), which the checkpoint's ``config`` records.

A model pickles its tensors as host tensors (a CUDA pickle does not load
on a host without CUDA) and puts them back on the device named where it
is unpickled (``core.device.load_device``), else on its own ``device``.
A mesh is a runtime object and is not pickled (``strip_runtime_config``).
"""

from __future__ import annotations

import inspect
from abc import ABC, abstractmethod
from typing import Any, List, Optional, Tuple

import numpy as np
import pandas as pd

try:  # sklearn is optional; BaseEstimator enables GridSearchCV compat
    from sklearn.base import BaseEstimator, RegressorMixin

    _SKLEARN_BASES: tuple = (BaseEstimator, RegressorMixin)
except ImportError:
    _SKLEARN_BASES = ()

from matrix_factorization_tpu_torch.core.device import load_device_for, to_device
from matrix_factorization_tpu_torch.core.ids import IdVocab, check_no_duplicates

_MAX_PREDICT_CHUNK = 8192


def chunked_predict(fn, u: np.ndarray, i: np.ndarray):
    """Run a pair predictor ``fn(u, i) -> (preds, possible)`` over (u, i)
    in chunks of at most ``_MAX_PREDICT_CHUNK`` pairs, which bounds the
    device memory a call takes. Unknown ids are ``-1``
    (``bucketed_predict`` of the JAX package; eager PyTorch needs no
    shape buckets)."""
    n = len(u)
    preds = np.empty(n, np.float32)
    possible = np.empty(n, bool)
    for lo in range(0, n, _MAX_PREDICT_CHUNK):
        hi = min(n, lo + _MAX_PREDICT_CHUNK)
        p, ok = fn(u[lo:hi], i[lo:hi])
        preds[lo:hi] = p
        possible[lo:hi] = ok
    return preds, possible


def predict_on_device(params, cfg, u: np.ndarray, i: np.ndarray,
                      bound_ratings: bool, device):
    """``segment_sgd.predict_pairs`` of dense (u, i) on ``device``, in
    ``chunked_predict``'s chunks; host ``(preds, possible)``."""
    import torch

    from matrix_factorization_tpu_torch.ops.segment_sgd import predict_pairs

    def run(uu, ii):
        p, ok = predict_pairs(
            params, torch.from_numpy(uu.astype(np.int64)).to(device),
            torch.from_numpy(ii.astype(np.int64)).to(device), cfg,
            bound_ratings)
        return p.cpu().numpy(), ok.cpu().numpy()

    return chunked_predict(run, u, i)


def check_mesh_args(serving_dtype, mesh, overlap_psum, dp_layout,
                    psum_every) -> None:
    """The JAX package's argument checks of the SGD-trained families
    (BPR, SVD++)."""
    if serving_dtype not in ("float32", "bfloat16"):
        raise ValueError("serving_dtype must be 'float32' or 'bfloat16'")
    if overlap_psum and mesh is None:
        raise ValueError("overlap_psum=True requires a mesh")
    if dp_layout not in ("tiled", "flat"):
        raise ValueError(f"unknown dp_layout {dp_layout!r}")
    if psum_every != 1 and mesh is None:
        raise ValueError("psum_every requires a mesh")


class RecommenderBase(*_SKLEARN_BASES, ABC):
    """Abstract recommender with the reference's lifecycle contract.

    Data contract (reference ``recommender_base.py``): ``X`` is a DataFrame
    with columns ``user_id``/``item_id`` (ids may be any hashables), ``y``
    a Series of ratings aligned with ``X``.
    """

    def __init__(self, min_rating: float = 0, max_rating: float = 5, verbose: int = 0):
        self.min_rating = min_rating
        self.max_rating = max_rating
        self.verbose = verbose
        self.user_vocab: IdVocab = IdVocab()
        self.item_vocab: IdVocab = IdVocab()

    if not _SKLEARN_BASES:
        @classmethod
        def _get_param_names(cls) -> list:
            sig = inspect.signature(cls.__init__)
            return sorted(
                p.name for p in sig.parameters.values()
                if p.name != "self"
                and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD))

        def get_params(self, deep: bool = True) -> dict:
            """Constructor arguments by name (sklearn's convention; no
            parameter is itself an estimator, so ``deep`` changes
            nothing)."""
            return {name: getattr(self, name)
                    for name in self._get_param_names()}

    def _whole_params(self):
        """The model's whole tables (``KernelMF`` gathers the shards it
        keeps under ``keep_sharded``, a collective)."""
        return getattr(self, "_params", None)

    # -- pickling: host tensors in the pickle, the load device after -------
    def __getstate__(self):
        from matrix_factorization_tpu_torch.core.checkpoint import strip_runtime_config

        sup = getattr(super(), "__getstate__", None)
        state = strip_runtime_config(dict(sup() if sup is not None else self.__dict__))
        if "_topk_catalog" in state:  # derived from a mesh: never pickled
            state["_topk_catalog"] = None
        if state.get("_sharding") is not None:  # a rank's shards: pickle the whole
            state["_params"], state["_sharding"] = self._whole_params(), None
        return {k: to_device(v, "cpu") for k, v in state.items()}

    def __setstate__(self, state):
        sup = getattr(super(), "__setstate__", None)
        if sup is not None:
            sup(state)
        else:
            self.__dict__.update(state)
        if "_device" in self.__dict__:
            device, dev = load_device_for(self.__dict__.get("device"))
            self.device, self._device = device, dev
            for k, v in list(self.__dict__.items()):
                self.__dict__[k] = to_device(v, dev)

    # -- reference-parity id surface ---------------------------------------
    @property
    def user_id_map(self) -> dict:
        return self.user_vocab.as_dict()

    @property
    def item_id_map(self) -> dict:
        return self.item_vocab.as_dict()

    @property
    def known_users(self) -> set:
        return set(self.user_vocab.raw_ids)

    @property
    def known_items(self) -> set:
        return set(self.item_vocab.raw_ids)

    @property
    def n_users(self) -> int:
        return len(self.user_vocab)

    @property
    def n_items(self) -> int:
        return len(self.item_vocab)

    def _require_fitted(self) -> None:
        if len(self.user_vocab) == 0:
            raise RuntimeError(
                f"{type(self).__name__} is not fitted yet; call fit(X, y) first"
            )

    def contains_user(self, user_id: Any) -> bool:
        return user_id in self.user_vocab

    def contains_item(self, item_id: Any) -> bool:
        return item_id in self.item_vocab

    # -- preprocessing ------------------------------------------------------
    def _preprocess_fit(
        self, X: pd.DataFrame, y: pd.Series
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Build vocabularies and return dense (u, i, r) arrays.

        Raises ``ValueError`` on duplicate (user, item) pairs, as the
        reference does (``recommender_base.py:127-128``).
        """
        users = X["user_id"].to_numpy()
        items = X["item_id"].to_numpy()
        check_no_duplicates(users, items)
        self.user_vocab = IdVocab.from_values(users)
        self.item_vocab = IdVocab.from_values(items)
        u = self.user_vocab.encode(users)
        i = self.item_vocab.encode(items)
        r = np.asarray(y, dtype=np.float32)
        return u, i, r

    def _preprocess_update(
        self, X: pd.DataFrame, y: pd.Series
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Any], List[Any]]:
        """Drop unknown items, register new users; returns
        (u, i, r, known_users, new_users) — reference
        ``recommender_base.py:142-171``."""
        users = X["user_id"].to_numpy()
        items = X["item_id"].to_numpy()
        check_no_duplicates(users, items)
        i = self.item_vocab.encode(items)
        keep = i >= 0
        users, i = users[keep], i[keep]
        r = np.asarray(y, dtype=np.float32)[keep]

        uniq = pd.unique(users)
        known_users = [u_ for u_ in uniq if u_ in self.user_vocab]
        new_users = [u_ for u_ in uniq if u_ not in self.user_vocab]
        self.user_vocab.extend(new_users)
        u = self.user_vocab.encode(users)
        return u, i, r, known_users, new_users

    def _preprocess_predict(self, X: pd.DataFrame) -> Tuple[np.ndarray, np.ndarray]:
        """Dense ids with unknowns mapped to -1
        (reference ``recommender_base.py:166-168``)."""
        u = self.user_vocab.encode(X["user_id"].to_numpy())
        i = self.item_vocab.encode(X["item_id"].to_numpy())
        return u, i

    # -- lifecycle ----------------------------------------------------------
    @abstractmethod
    def fit(self, X: pd.DataFrame, y: pd.Series):
        """Train on (X, y); returns self."""

    @abstractmethod
    def predict(self, X: pd.DataFrame, bound_ratings: bool = True) -> list:
        """Predict ratings for each row of X, in input order."""

    @abstractmethod
    def _predict_dense(
        self, u: np.ndarray, i: np.ndarray, bound_ratings: bool
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense-id predictions ``(predictions, possible)``, used by
        ``recommend`` for users outside the vocabulary."""

    # -- shared top-k plumbing ------------------------------------------------
    def _cached_serving_params(self, source=None):
        """Identity-keyed cache of the serving-path tables: the live
        ``_params`` (or ``source()``, a model's serving view of them, as
        SVD++'s ``P + S``), or a bf16 copy of them when
        ``serving_dtype='bfloat16'``. Rebuilt whenever the tables are
        replaced, so identity is the staleness check."""
        import torch

        p = self._params if source is None else source()
        if self.serving_dtype == "float32":
            return p
        c = getattr(self, "_serving_cache", None)
        if c is None or c[0] is not p:
            mf = p._replace(
                user_features=p.user_features.to(torch.bfloat16),
                item_features=p.item_features.to(torch.bfloat16),
            )
            self._serving_cache = c = (p, mf)
        return c[1]

    def _encode_known_set(self, items) -> set:
        """Dense-id set for an iterable of raw item ids (unknown dropped)."""
        if not items:
            return set()
        kd = self.item_vocab.encode(np.asarray(list(items), dtype=object))
        return set(kd[kd >= 0].tolist())

    def _topk_fetch(self):
        """The (u_dense, k) -> (vals, idx) top-k fetcher, or None. A
        sharded catalog (``_topk_catalog``, ``KernelMF(keep_sharded=True)``)
        comes first; models with a device catalog expose ``_catalog_topk``
        (scoring and top-k on the device). Either way only (B, k) values
        and indices reach the host."""
        topk_cat = getattr(self, "_topk_catalog", None)
        if topk_cat is not None:
            return lambda ud, k: topk_cat.topk(self._topk_user_rows(ud), k)
        return getattr(self, "_catalog_topk", None)

    def _topk_row_frame(self, user, vals_row, idx_row, excluded, amount,
                        bound_ratings, raw_items) -> pd.DataFrame:
        """One user's (vals, idx) top-k row -> recommend DataFrame:
        exclusion filter, cut to ``amount``, optional clip."""
        keep = [j for j, g in enumerate(idx_row) if g not in excluded]
        keep = keep[:amount]
        preds = vals_row[keep]
        if bound_ratings:
            preds = np.clip(preds, self.min_rating, self.max_rating)
        return pd.DataFrame({
            "user_id": [user] * len(keep),
            "item_id": [raw_items[x] for x in idx_row[keep]],
            "rating_pred": preds,
        })

    def recommend(
        self,
        user: Any,
        amount: int = 10,
        items_known: Optional[list] = None,
        include_user: bool = True,
        bound_ratings: bool = True,
    ) -> pd.DataFrame:
        """Top-``amount`` unseen items for ``user``, scored over the whole
        catalog with ``bound_ratings=False`` then clipped — matching the
        reference's ordering semantics (``recommender_base.py:245-271``)."""
        self._require_fitted()
        raw_items = self.item_vocab.raw_ids
        u_dense = self.user_vocab.encode(np.asarray([user], dtype=object))[0]
        fetch = self._topk_fetch()
        if fetch is not None and u_dense >= 0:
            # device-side top-k: over-fetch by the exclusion count,
            # filter on host, cut — only k values+indices are fetched
            excluded = self._encode_known_set(items_known)
            k = min(self.n_items, amount + len(excluded))
            vals, idx = fetch(np.asarray([u_dense], np.int32), k)
            out = self._topk_row_frame(user, vals[0], idx[0], excluded,
                                       amount, bound_ratings, raw_items)
            self.predictions_possible = [True] * len(out)
            return out if include_user else out.drop(columns=["user_id"])
        # unknown user (or no device top-k): score the unseen catalog pair
        # by pair (an unknown user takes the cold row)
        item_ids = np.arange(self.n_items, dtype=np.int32)
        if items_known is not None:
            known = set(items_known)
            keep = np.fromiter(
                (raw not in known for raw in raw_items), bool, count=len(raw_items)
            )
            item_ids = item_ids[keep]
        u = np.full(item_ids.shape, u_dense, dtype=np.int32)
        preds, possible = self._predict_dense(u, item_ids, bound_ratings=False)
        self.predictions_possible = np.asarray(possible).tolist()

        order = np.argsort(-preds, kind="stable")[:amount]
        top_items = item_ids[order]
        top_preds = preds[order]
        if bound_ratings:
            top_preds = np.clip(top_preds, self.min_rating, self.max_rating)

        out = pd.DataFrame(
            {
                "user_id": [user] * len(top_items),
                "item_id": [raw_items[x] for x in top_items],
                "rating_pred": top_preds,
            }
        )
        if not include_user:
            out = out.drop(columns=["user_id"])
        return out

    def recommend_batch(
        self,
        users: list,
        amount: int = 10,
        items_known_map: Optional[dict] = None,
        bound_ratings: bool = True,
    ) -> pd.DataFrame:
        """Top-``amount`` unseen items for MANY users in one call.

        With every user known, one device top-k serves the whole cohort;
        else each user goes through ``recommend``.
        ``items_known_map``: optional {user: iterable of known items}.
        """
        self._require_fitted()
        items_known_map = items_known_map or {}
        fetch = self._topk_fetch()
        u_dense = self.user_vocab.encode(np.asarray(users, dtype=object))
        frames = []
        if fetch is not None and (u_dense >= 0).all():
            # one device top-k for the whole cohort: (B, k) values+indices
            # fetched instead of (B, n_items) scores; over-fetched by the
            # largest exclusion set so filtering never truncates < amount
            raw_items = self.item_vocab.raw_ids
            known_dense = {
                user: self._encode_known_set(items_known_map.get(user))
                for user in users if items_known_map.get(user)
            }
            extra = max((len(v) for v in known_dense.values()), default=0)
            k = min(self.n_items, amount + extra)
            vals, idx = fetch(u_dense.astype(np.int32), k)
            for row, user in enumerate(users):
                frames.append(self._topk_row_frame(
                    user, vals[row], idx[row], known_dense.get(user, ()),
                    amount, bound_ratings, raw_items))
            return pd.concat(frames, ignore_index=True)
        for user in users:
            frames.append(self.recommend(
                user, amount=amount,
                items_known=items_known_map.get(user),
                bound_ratings=bound_ratings,
            ))
        return pd.concat(frames, ignore_index=True)
