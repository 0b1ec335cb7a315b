"""Full-catalog top-k over an item-sharded catalog.

Counterpart of ``matrix_factorization_tpu/parallel/topk.py``: each rank
scores its shard of the item rows with the catalog scorer
(``ops/scoring.py::score_catalog``, the ``score_catalog.cu`` kernel on
CUDA), masks its padding rows to ``-inf`` and takes a local top-k; the
(B, k) candidates of every rank are all-gathered and merged, an O(ranks x
k) merge instead of a gather of the (B, I) scores. The merge keeps the
port's one tie rule (``ops/scoring.py::stable_topk``): score descending,
then global item position ascending. Candidates are gathered in shard
order and each shard's come in position order among equal scores, so a
stable top-k of the gathered scores is that rule. ``merge_candidates`` is
that merge, the only one in the port: the sharded dense and TF-IDF
retrieval (``retrieval/search.py::dense_topk_mesh``,
``retrieval/sparse_scoring.py::tfidf_csr_topk``) call it too.

Reference counterpart: ``recommend`` scoring every item serially
(``recommender_base.py:245-271``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops.scoring import score_catalog, stable_topk
from matrix_factorization_tpu_torch.ops.segment_sgd import round_up
from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows


def shard_of(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's linear shard index, shard count) over ``axes``, which
    must be every axis of ``mesh``: the catalog is split over all of its
    ranks, the whole world."""
    if tuple(axes) != tuple(mesh.mesh_dim_names):
        raise ValueError(f"the catalog shards over every axis of the mesh, "
                         f"{mesh.mesh_dim_names}, not {tuple(axes)}")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shard, n = 0, 1
    for a in axes:
        shard = shard * sizes[a] + coord[a]
        n *= sizes[a]
    return shard, n


def catalog_shard(n: int, mesh) -> Tuple[int, int, int]:
    """``(start, stop, per)``: this rank's rows ``[start, stop)`` of an
    ``n``-row catalog split over every axis of ``mesh`` in its flat rank
    order, ``per = round_up(n, 8 * N) / N`` rows a rank of ``N``. The last
    ranks may hold fewer real rows than ``per``, or none (``stop ==
    start``); their missing rows are the padding, which scores ``-inf``."""
    shard, n_dev = shard_of(mesh, tuple(mesh.mesh_dim_names))
    per = round_up(max(n, 1), 8 * n_dev) // n_dev
    start = shard * per
    return start, max(start, min(start + per, n)), per


def pad_candidates(vals: torch.Tensor, gpos: torch.Tensor, kk: int,
                   stop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's (B, m) local top-k (``m <= kk``: a shard with fewer real
    rows than ``kk``) widened to (B, kk) with ``-inf`` candidates at
    positions ``stop, stop + 1, ...``, past the catalog's last row, so
    that every rank gives ``merge_candidates`` as many."""
    B, m = vals.shape
    if m == kk:
        return vals, gpos
    fill = torch.arange(stop, stop + kk - m, device=gpos.device)
    return (torch.cat([vals, vals.new_full((B, kk - m), float("-inf"))], 1),
            torch.cat([gpos, fill.expand(B, -1).to(gpos.dtype)], 1))


def distributed_topk(pu: torch.Tensor, Q_l: torch.Tensor, mu: torch.Tensor,
                     valid_l: torch.Tensor, k: int, cfg: SGDConfig, mesh,
                     axes: Tuple[str, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, global item indices), each (B, k), the same on every rank
    of the mesh (``axes``: all of its axes, in order).

    ``pu``: (B, Kp) queried users' extended rows, the same on every rank;
    ``Q_l``: this rank's (I_local, Kp) shard of the padded item rows, shard
    ``s`` holding rows ``[s * I_local, (s + 1) * I_local)`` with ``s`` this
    rank's linear index over ``axes``; ``valid_l``: (I_local,) 1/0. Rows
    whose ``valid_l`` is 0 score ``-inf``."""
    shard, _ = shard_of(mesh, tuple(axes))
    i_local = Q_l.shape[0]
    scores = score_catalog(cfg, mu, pu, Q_l)
    scores = torch.where(valid_l[None, :] > 0, scores, float("-inf"))
    vals, idx = stable_topk(scores, min(k, i_local))  # (B, kk)
    return merge_candidates(vals, idx + shard * i_local, k)


def merge_candidates(vals: torch.Tensor, gpos: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (B, k) top of every rank's candidates, the same on every rank of
    the world: a collective that each rank calls with
    its (B, kk) local top-k ``vals``, ordered as ``stable_topk`` orders
    them, and their **global** positions ``gpos``, the ranks in shard order
    (rank r holding the positions below rank r + 1's). The candidates are
    all-gathered, shard-major, and re-ranked by a stable top-k: score
    descending, then global position ascending, the port's one tie rule. A
    rank short of real rows gives ``-inf`` candidates at positions past the
    catalog; with ``k`` at most the catalog's size they never reach the
    result."""
    B, kk = vals.shape
    vals_g = all_gather_rows(vals).reshape(-1, B, kk)
    gpos_g = all_gather_rows(gpos).reshape(-1, B, kk)
    vals_g = vals_g.permute(1, 0, 2).reshape(B, -1)
    gpos_g = gpos_g.permute(1, 0, 2).reshape(B, -1)
    mvals, pos = stable_topk(vals_g, min(k, vals_g.shape[1]))
    return mvals, torch.gather(gpos_g, 1, pos)
