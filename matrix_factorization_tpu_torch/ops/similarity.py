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

On a mesh (``rows=(lo, hi)``) a rank holds rows ``[lo, hi)`` of the
similarity matrix (against every entity) and the whole rating matrix, and
predicts the pairs whose similarity row it holds; one ``all_reduce`` of
the predictions, zero where another rank owns the pair, gives every rank
all of them exactly (a single non-zero addend per pair).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple, Optional, Tuple

import torch

from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.segment_sgd import round_up


class CFState(NamedTuple):
    """Dense CF state: ratings matrix, similarity matrix (or a rank's rows
    of it), means."""

    ratings: torch.Tensor  # (U, I) 0-filled
    sim: torch.Tensor  # (U, U) or (I, I); on a mesh (hi - lo, U) or (hi - lo, I)
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


# most rows of the similarity product computed at once (see cosine_rows)
ROW_CHUNK = 1024


def row_chunk(e: int) -> int:
    """Rows of one chunk of an (e, e) similarity product: ``e`` split into
    the fewest chunks of at most ``ROW_CHUNK`` rows, rounded up to 8. It
    depends on ``e`` alone, so a mesh rank's chunks have the whole
    matrix's shape."""
    n = max(1, -(-e // ROW_CHUNK))
    return max(8, round_up(-(-e // n), 8))


def cosine_rows(m: torch.Tensor, rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
    """Row-wise cosine similarity: normalise, then f32 products; rows
    ``[lo, hi)`` of it only, against every row, when ``rows`` is given.

    The product runs in chunks of :func:`row_chunk` rows, each copied into
    one zero-padded buffer of that size, so that every matrix product has
    the same shape, strides and alignment whichever rows are asked for: a
    row's similarities are then the same bits on a mesh rank as in the
    whole matrix (a library GEMM may round otherwise at another shape, and
    on ratings without signal a last-bit difference can change a top-k
    neighbour)."""
    norms = torch.sqrt(torch.sum(m * m, dim=1, keepdim=True))
    normed = m / norms.clamp(min=1e-12)
    lo, hi = (0, m.shape[0]) if rows is None else rows
    chunk = row_chunk(m.shape[0])
    out = torch.empty((hi - lo, m.shape[0]), dtype=m.dtype, device=m.device)
    buf = torch.zeros((chunk, m.shape[1]), dtype=m.dtype, device=m.device)
    with _full_f32():
        for c in range(lo, hi, chunk):
            n = min(chunk, hi - c)
            if n < chunk:
                buf[n:] = 0.0
            buf[:n] = normed[c:c + n]
            out[c - lo:c - lo + n] = (buf @ normed.T)[:n]
    return out


def user_cf_fit(u, i, r, n_users: int, n_items: int,
                rows: Optional[Tuple[int, int]] = None) -> CFState:
    R = build_rating_matrix(u, i, r, n_users, n_items)
    means = torch.mean(R, dim=1)  # over the filled row, as the reference
    sim = cosine_rows(R - means[:, None], rows)
    return CFState(R, sim, means, torch.mean(r))


def item_cf_fit(u, i, r, n_users: int, n_items: int,
                rows: Optional[Tuple[int, int]] = None) -> CFState:
    R = build_rating_matrix(u, i, r, n_users, n_items)
    means = torch.mean(R, dim=0)
    sim = cosine_rows((R - means[None, :]).T, rows)
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


def _owned(pred_rows, ent: torch.Tensor, rows, group) -> torch.Tensor:
    """Raw predictions of B pairs whose similarity row is ``ent``:
    ``pred_rows(sel, sim_rows)`` computes the pairs ``sel`` from the
    similarity rows ``sim_rows``. Without ``rows`` every pair is computed
    here; with ``rows=(lo, hi)`` only the pairs whose row this rank holds,
    the others are 0, and one ``all_reduce`` over ``group`` (None: the
    world) sums the ranks' predictions."""
    if rows is None:
        return pred_rows(slice(None), ent)
    import torch.distributed as dist

    lo, hi = rows
    pred = torch.zeros(ent.shape, dtype=torch.float32, device=ent.device)
    own = (ent >= lo) & (ent < hi)
    if bool(own.any()):
        pred[own] = pred_rows(own, ent[own] - lo)
    dist.all_reduce(pred, group=group)
    return pred


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
    rows: Optional[Tuple[int, int]] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched UserUserCF prediction; an unknown id (-1) gets the global
    mean (reference ``collaborative_filtering.py:119-121``). ``rows``: the
    similarity rows this rank holds (see the module docstring)."""
    uv, iv = u >= 0, i >= 0
    us, isafe = u.clamp(min=0).long(), i.clamp(min=0).long()

    def pred_rows(sel, sim_rows):
        # (B, U) similarities and the item's ratings by every user
        return _neighborhood_predict(state.sim[sim_rows], state.ratings.T[isafe[sel]],
                                     state.means, state.means[us[sel]], us[sel],
                                     n_neighbors)

    pred = _owned(pred_rows, us, rows, group)
    return _finish(state, pred, uv, iv, min_rating, max_rating, bound_ratings)


def item_cf_predict(
    state: CFState,
    u: torch.Tensor,
    i: torch.Tensor,
    n_neighbors: int,
    min_rating: float,
    max_rating: float,
    bound_ratings: bool,
    rows: Optional[Tuple[int, int]] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ItemItemCF prediction (reference ``:311-368``); ``rows`` as
    in :func:`user_cf_predict`."""
    uv, iv = u >= 0, i >= 0
    us, isafe = u.clamp(min=0).long(), i.clamp(min=0).long()

    def pred_rows(sel, sim_rows):
        # (B, I) similarities and the user's ratings of every item
        return _neighborhood_predict(state.sim[sim_rows], state.ratings[us[sel]],
                                     state.means, state.means[isafe[sel]],
                                     isafe[sel], n_neighbors)

    pred = _owned(pred_rows, isafe, rows, group)
    return _finish(state, pred, uv, iv, min_rating, max_rating, bound_ratings)
