"""Sharded-catalog serving: full-catalog top-k with the item rows split
over every rank of the mesh.

Counterpart of ``matrix_factorization_tpu/parallel/serving.py``. A
``ShardedCatalog`` holds this rank's shard of the padded item table
(shards over every mesh axis, slice-major as the mesh lays out its ranks)
and serves ``topk`` through ``parallel/topk.py::distributed_topk``: each
rank scores only its shard, and only (B, k) candidates cross ranks.

Under SPMD every rank calls ``topk`` with the same users (it is a
collective). The shard is cut from the item table a rank holds: the whole
table (``dp_fit``'s replicated Q, or the tables ``KernelMF`` gathers after
a mesh fit), or, with ``q_sharded=True``, ``dp_tp_fit``'s model shard. In
the latter case the catalog's shards (over every axis) do not line up with
the model shards, so one ``all_gather_into_tensor`` over the model group
assembles the table first; the whole table lives only while the shard is
cut from it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops.segment_sgd import MFParams
from matrix_factorization_tpu_torch.parallel import topk as ptopk
from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows
from matrix_factorization_tpu_torch.parallel.mesh import model_group


class ShardedCatalog:
    """This rank's shard of the item catalog, for sharded top-k."""

    def __init__(self, params: MFParams, n_items: int, cfg: SGDConfig, mesh,
                 dtype=None, q_sharded: bool = False):
        """``dtype``: the shard's storage type (``torch.bfloat16`` halves
        the bytes a query streams; the scorer sums in f32)."""
        self.cfg = cfg
        self.mesh = mesh
        self.dtype = dtype
        self.axes = tuple(mesh.mesh_dim_names)
        self.n_items = n_items
        lo, hi, i_local = ptopk.catalog_shard(n_items, mesh)
        Q = params.item_features
        if q_sharded:
            Q = all_gather_rows(Q, model_group(mesh))
        local = torch.zeros((i_local, Q.shape[1]), dtype=Q.dtype,
                            device=Q.device)
        local[:hi - lo] = Q[lo:hi]
        self.Q = local if dtype is None else local.to(dtype)
        self.valid = (torch.arange(lo, lo + i_local, device=Q.device)
                      < n_items).float()
        self.mu = params.global_mean

    def topk(self, pu, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, global item ids), each (B, k), scores descending, as
        host arrays. ``pu``: (B, Kp) extended user rows (an array or a
        tensor), the same on every rank. Batches are padded to powers of
        two (at least 8) as the JAX package pads them."""
        k = min(k, self.n_items)
        pu = torch.as_tensor(np.asarray(pu, np.float32)) if not torch.is_tensor(pu) \
            else pu.float()
        B = pu.shape[0]
        b = 1 << max(3, (B - 1).bit_length())
        pad = torch.zeros((b, pu.shape[1]), dtype=torch.float32,
                          device=self.Q.device)
        pad[:B] = pu.to(self.Q.device)
        vals, idx = ptopk.distributed_topk(
            pad.to(self.Q.dtype), self.Q, self.mu, self.valid, k, self.cfg,
            self.mesh, self.axes)
        return vals[:B].cpu().numpy(), idx[:B].cpu().numpy()
