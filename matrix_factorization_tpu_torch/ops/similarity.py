"""Similarity matrices and neighbourhood scoring (PyTorch port).

Counterpart of ``matrix_factorization_tpu/ops/similarity.py``: one
``index_put_`` builds the dense rating matrix (the pairs are unique, so no
sum and no atomics), one normalised product gives the full similarity
matrix, and a batched masked top-k predicts. The reference's conventions
hold: missing ratings are 0, the per-row or per-column means are taken
over the **filled** matrix (divided by the full axis length), and
centring subtracts that mean everywhere (``collaborative_filtering.py:
62-96``).

The product is a plain f32 matrix product, which the JAX package leaves
to XLA outside any Pallas kernel; here it is ``torch.matmul`` with TF32
off. The top-k breaks ties to the lower index, as ``lax.top_k`` does
(``ops/scoring.py::stable_topk``): a tie at the k-th neighbour changes the
prediction.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple, Tuple

import torch

from matrix_factorization_tpu_torch.ops.scoring import stable_topk


class CFState(NamedTuple):
    """Dense CF state: ratings matrix, similarity matrix, means."""

    ratings: torch.Tensor  # (U, I) 0-filled
    sim: torch.Tensor  # (U, U) or (I, I)
    means: torch.Tensor  # (U,) or (I,)
    global_mean: torch.Tensor  # scalar


def build_rating_matrix(u: torch.Tensor, i: torch.Tensor, r: torch.Tensor,
                        n_users: int, n_items: int) -> torch.Tensor:
    """(n_users, n_items) f32, ``r`` at ``(u, i)`` and 0 elsewhere. The
    pairs must be unique (``core.ids.check_no_duplicates``): a write, not
    a sum."""
    R = torch.zeros((n_users, n_items), dtype=torch.float32, device=u.device)
    R[u.long(), i.long()] = r
    return R


@contextmanager
def _full_f32():
    """Products in full f32 on the card, whatever the caller set."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def cosine_rows(m: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine similarity: normalise, then one f32 product."""
    norms = torch.sqrt(torch.sum(m * m, dim=1, keepdim=True))
    normed = m / norms.clamp(min=1e-12)
    with _full_f32():
        return normed @ normed.T


def user_cf_fit(u, i, r, n_users: int, n_items: int) -> CFState:
    R = build_rating_matrix(u, i, r, n_users, n_items)
    means = torch.mean(R, dim=1)  # over the filled row, as the reference
    sim = cosine_rows(R - means[:, None])
    return CFState(R, sim, means, torch.mean(r))


def item_cf_fit(u, i, r, n_users: int, n_items: int) -> CFState:
    R = build_rating_matrix(u, i, r, n_users, n_items)
    means = torch.mean(R, dim=0)
    sim = cosine_rows((R - means[None, :]).T)
    return CFState(R, sim, means, torch.mean(r))


def _neighborhood_predict(
    sims: torch.Tensor,  # (B, N) similarity of the query entity to all N
    ratings: torch.Tensor,  # (B, N) candidate ratings (0 = missing)
    cand_means: torch.Tensor,  # (N,) means of the candidate entities
    self_mean: torch.Tensor,  # (B,) mean of the query-side entity
    self_idx: torch.Tensor,  # (B,) index to exclude (the query entity)
    n_neighbors: int,
) -> torch.Tensor:
    """pred = self_mean + sum(sim * (r - cand_mean)) / sum(|sim|) over the
    top-``n_neighbors`` raters by signed similarity, ties to the lower
    index (reference ``collaborative_filtering.py:173-188``)."""
    n = sims.shape[1]
    rated = ratings > 0
    col = torch.arange(n, device=sims.device)[None, :]
    valid = rated & (col != self_idx[:, None])
    masked = torch.where(valid, sims, float("-inf"))

    k = min(n_neighbors, n)
    top_sims, top_idx = stable_topk(masked, k)
    picked = top_sims > float("-inf")
    top_sims = torch.where(picked, top_sims, 0.0)
    top_r = torch.gather(ratings, 1, top_idx)
    top_m = cand_means[top_idx]

    num = torch.sum(top_sims * (top_r - top_m) * picked, dim=1)
    den = torch.sum(torch.abs(top_sims) * picked, dim=1)
    has_rater = torch.any(valid, dim=1)
    pred = self_mean + torch.where(den > 0, num / den.clamp(min=1e-12), 0.0)
    # no rater at all, or zero similarity mass -> the entity's mean
    return torch.where(has_rater & (den > 0), pred, self_mean)


def _finish(state: CFState, pred, uv, iv, min_rating, max_rating,
            bound_ratings):
    pred = torch.where(uv & iv, pred, state.global_mean)
    if bound_ratings:
        pred = pred.clamp(min_rating, max_rating)
    return pred, uv & iv


def user_cf_predict(
    state: CFState,
    u: torch.Tensor,
    i: torch.Tensor,
    n_neighbors: int,
    min_rating: float,
    max_rating: float,
    bound_ratings: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched UserUserCF prediction; an unknown id (-1) gets the global
    mean (reference ``collaborative_filtering.py:119-121``)."""
    uv, iv = u >= 0, i >= 0
    us, isafe = u.clamp(min=0).long(), i.clamp(min=0).long()
    sims = state.sim[us]  # (B, U)
    ratings = state.ratings.T[isafe]  # (B, U)
    pred = _neighborhood_predict(sims, ratings, state.means, state.means[us],
                                 us, n_neighbors)
    return _finish(state, pred, uv, iv, min_rating, max_rating, bound_ratings)


def item_cf_predict(
    state: CFState,
    u: torch.Tensor,
    i: torch.Tensor,
    n_neighbors: int,
    min_rating: float,
    max_rating: float,
    bound_ratings: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ItemItemCF prediction (reference ``:311-368``)."""
    uv, iv = u >= 0, i >= 0
    us, isafe = u.clamp(min=0).long(), i.clamp(min=0).long()
    sims = state.sim[isafe]  # (B, I)
    ratings = state.ratings[us]  # (B, I)
    pred = _neighborhood_predict(sims, ratings, state.means,
                                 state.means[isafe], isafe, n_neighbors)
    return _finish(state, pred, uv, iv, min_rating, max_rating, bound_ratings)
