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
stable top-k of the gathered scores is that rule.

Reference counterpart: ``recommend`` scoring every item serially
(``recommender_base.py:245-271``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops.scoring import score_catalog, stable_topk
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
    gidx = idx + shard * i_local
    B, kk = vals.shape
    # gather every rank's candidates, shard-major, then merge
    vals_g = all_gather_rows(vals).reshape(-1, B, kk)
    gidx_g = all_gather_rows(gidx).reshape(-1, B, kk)
    vals_g = vals_g.permute(1, 0, 2).reshape(B, -1)
    gidx_g = gidx_g.permute(1, 0, 2).reshape(B, -1)
    mvals, pos = stable_topk(vals_g, min(k, vals_g.shape[1]))
    return mvals, torch.gather(gidx_g, 1, pos)
