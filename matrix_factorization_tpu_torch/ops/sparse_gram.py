"""Tiled sparse-dense similarity for CF at MovieLens-25M scale (PyTorch
port).

Counterpart of ``matrix_factorization_tpu/ops/sparse_gram.py``, single
device. The exact CF models (``ops/similarity.py``) hold the dense
user x item matrix and the full similarity matrix, which is impossible at
162,000 users x 59,392 items (the dense matrix alone is 38.5 GB of f32).
This module finds the top-k centered-cosine neighbours under the
reference's centering without ever forming the centered matrix, through
the rank-1 structure of centering:

    means over the 0-filled axis:      m_j = s_j / n           (s_j = col sum)
    centered gram:   <C_a, C_b> = <x_a, x_b> - n * m_a * m_b
    norms:           |C_j|^2     = <x_j, x_j> - n * m_j^2

The sparse gram ``<x_a, x_b>`` is a sum of dense products over user
blocks: the ratings are sorted by user on the host (the native counting
sort of ``csrc/host_loader.cpp``), laid out as padded per-block windows on
the device, and for each strip of item columns every block's dense
``(block, items_pad)`` tile is rebuilt and multiplied into the strip's
accumulator. A strip's peak memory is one tile, one accumulator and the
strip's cosine block and sort, whatever the size of the full similarity
matrix. The products are exact f32 (TF32 off); for half-star ratings
every product is a multiple of 0.25 and every gram entry stays far below
2^24 quarters, so the gram is exact in any summation order and ties in
the cosine are real: the top-k breaks them to the lower index
(``ops/scoring.py::stable_topk``), as ``lax.top_k`` does.

User-user similarity is the same call with the axes swapped.

With a ``mesh`` (JAX ``_shard_blocks`` / ``_strip_accumulate_sharded``)
the user blocks are split over every rank of the mesh jointly: the block
axis is padded to a multiple of the world with empty blocks and rank r
takes the contiguous blocks ``[r nb / N, (r + 1) nb / N)``, building only
their windows. A strip's accumulator is the sum of the rank's blocks,
then one ``all_reduce`` over the world; the top-k then runs on the
replicated strip on every rank. On one rank the blocks and their order
are the mesh-free call's and the reduce changes nothing, so the result is
equal to it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.data.loader import host_lib
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.segment_sgd import round_up
from matrix_factorization_tpu_torch.ops.spd import exact_f32


def _bucket_by_block(u, i, r, n_entities: int, block: int, device,
                     blocks=None):
    """COO entries grouped by entity block: the counterpart ids and
    ratings stably sorted by entity on the host (``mf_sort_pairs_by_key``),
    then laid out on ``device`` as padded ``(n_blocks, max_nnz)`` windows
    (``_build_buckets``). Returns ``(ub, ib, rb, block_counts)``: the
    block-local entity, the counterpart id (int32) and the rating (f32) of
    every window slot, and each block's number of real entries (host).
    ``blocks=(b0, b1)`` lays out only those blocks (a rank's share)."""
    if len(u) and (int(u.min()) < 0 or int(u.max()) >= n_entities):
        raise ValueError(f"entity ids must lie in [0, {n_entities})")
    n_blocks = (n_entities + block - 1) // block
    block_counts = np.bincount(u // block, minlength=n_blocks)
    # a power of two, as in the JAX package (there it kept compiled shapes
    # stable across datasets)
    max_nnz = max(8, int(block_counts.max(initial=0)))
    max_nnz = 1 << (max_nnz - 1).bit_length()
    block_start = np.concatenate([[0], np.cumsum(block_counts)]).astype(np.int64)
    entity_counts = np.bincount(u, minlength=n_entities)
    n = len(u)
    i_s = np.empty(n, np.int32)
    r_s = np.empty(n, np.float32)
    if n:
        host_lib().mf_sort_pairs_by_key(
            np.ascontiguousarray(u, np.int32), np.ascontiguousarray(i, np.int32),
            np.ascontiguousarray(r, np.float32), n, n_entities, i_s, r_s)

    if blocks is not None:
        b0, b1 = blocks
        e0, e1 = block_start[b0], block_start[b1]
        entity_counts = entity_counts[b0 * block:min(b1 * block, n_entities)]
        i_s, r_s = i_s[e0:e1], r_s[e0:e1]
        block_start = block_start[b0:b1 + 1] - e0
        block_counts = block_counts[b0:b1]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ub, ib, rb = _build_buckets(put(entity_counts), put(i_s), put(r_s),
                                put(block_start), max_nnz, block)
    return ub, ib, rb, block_counts


def _build_buckets(entity_counts, i_s, r_s, block_start, max_nnz: int,
                   block: int):
    """Entity-sorted flat stream -> padded windows, on the stream's device.

    The entries of a block are contiguous, so a block's window is the
    ``max_nnz`` entries of the stream from the block's offset, cut to the
    block's count; pad slots carry entity 0, id 0 and rating 0. The
    entity of every entry is rebuilt from the per-entity counts."""
    dev = i_s.device
    u_flat = torch.repeat_interleave(
        torch.arange(len(entity_counts), device=dev), entity_counts)
    u_loc = (u_flat % block).to(torch.int32)
    counts = block_start[1:] - block_start[:-1]
    slot = torch.arange(max_nnz, device=dev)
    keep = slot[None, :] < counts[:, None]
    pos = torch.where(keep, block_start[:-1, None] + slot[None, :], 0)

    def windows(vals):
        # one zero of room, so that an empty stream still has an entry 0
        vals = torch.cat([vals, vals.new_zeros(1)])
        return torch.where(keep, vals[pos], vals.new_zeros(()))

    return windows(u_loc), windows(i_s), windows(r_s)


def _strip_accumulate(ub, ib, rb, block_counts, tile_lo: int, n_cols: int,
                      block: int, n_items: int) -> torch.Tensor:
    """The gram strip of columns ``[tile_lo, tile_lo + n_cols)``, stored
    transposed: ``sum_b X_b[:, strip]^T @ X_b``, (n_cols, n_items).

    Each block's dense ``(block, n_items)`` tile is written from its real
    entries with ``index_put_`` (the (user, item) pairs are unique, so no
    value is summed there) and multiplied in exact f32. The transposed
    layout holds each strip column's gram against every item contiguously,
    the axis the top-k sorts."""
    acc = torch.zeros((n_cols, n_items), dtype=torch.float32, device=ub.device)
    Xb = torch.empty((block, n_items), dtype=torch.float32, device=ub.device)
    with exact_f32():
        for b, c in enumerate(block_counts):
            if not c:
                continue
            Xb.zero_()
            Xb.index_put_((ub[b, :c].long(), ib[b, :c].long()), rb[b, :c])
            acc.addmm_(Xb[:, tile_lo:tile_lo + n_cols].T, Xb)
    return acc


def _strip_topk(gram_t, col_ids, sums, n_users: int, norms, k: int,
                n_valid: int):
    """Centered-cosine top-k of one strip of columns, from its transposed
    gram ``gram_t`` (n_cols, n_items), which it overwrites. ``norms`` are
    the columns' centered norms, ``sqrt(max(|C_j|^2, 1e-24))``. Self pairs
    and pad rows score ``-inf``; ties go to the lower index. The
    arithmetic is the JAX package's, operation for operation."""
    n = float(n_users)
    m_all = sums / n
    m_cols = m_all[col_ids]
    centered = gram_t.sub_(n * m_all[None, :] * m_cols[:, None])
    cos = centered.div_(norms[None, :] * norms[col_ids][:, None])
    rows = torch.arange(cos.shape[1], device=cos.device)
    cos.masked_fill_(rows[None, :] == col_ids[:, None], float("-inf"))
    cos[:, n_valid:] = float("-inf")
    vals, idx = stable_topk(cos, k)
    return vals.clone(), idx.to(torch.int32)


def similarity_topk(
    u: np.ndarray,
    i: np.ndarray,
    r: np.ndarray,
    n_users: int,
    n_items: int,
    k: int,
    user_block: int = 4096,
    item_tile: int = 4096,
    group_budget_bytes: int = 0,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Top-k centered-cosine item neighbours from sparse COO ratings, on
    ``device`` (``None`` = CUDA).

    Returns host arrays ``(neighbor_sims (n_items, k), neighbor_ids
    (n_items, k), col_means (n_items,), col_norms (n_items,))``; ``k`` is
    cut to ``n_items - 1``. For user-user similarity call with
    ``(i, u, r)`` and the counts swapped. ``group_budget_bytes > 0``
    accumulates columns in groups as wide as that budget allows (fewer
    tile rebuilds, a larger accumulator); the default is one strip of
    ``item_tile`` columns per accumulation. The column sums and self-dots
    are numpy ``bincount``s, as in the JAX package, so the means and norms
    are equal to its. ``mesh``: the user blocks split over every rank of
    the mesh, one ``all_reduce`` a strip (see the module docstring); every
    rank calls it and gets the whole result."""
    dev = resolve_device(device)
    u = np.asarray(u, np.int32)
    i = np.asarray(i, np.int32)
    r = np.asarray(r, np.float32)
    k = min(k, n_items - 1)
    items_pad = round_up(n_items, max(8, item_tile))

    blocks = None
    if mesh is not None:
        import torch.distributed as dist

        from matrix_factorization_tpu_torch.parallel.mesh import flat_index

        n_dev, rank = mesh.size(), flat_index(mesh)
        nb = -(-n_users // user_block)
        per = round_up(nb, n_dev) // n_dev  # pad blocks hold no entry
        blocks = (min(rank * per, nb), min((rank + 1) * per, nb))
    ub, ib, rb, block_counts = _bucket_by_block(u, i, r, n_users, user_block, dev,
                                                blocks)
    sums = np.bincount(i, weights=r, minlength=items_pad
                       ).astype(np.float32)[:items_pad]
    self_dot = np.bincount(i, weights=r * r, minlength=items_pad
                           ).astype(np.float32)[:items_pad]
    means = sums / max(1, n_users)
    norms_sq = self_dot - n_users * means**2
    sums_t = torch.from_numpy(sums).to(dev)
    # the square roots on the host: numpy's f32 sqrt is correctly rounded,
    # as XLA's is; the CPU build of torch.sqrt was seen to differ from it
    norms_t = torch.from_numpy(np.sqrt(np.maximum(norms_sq, 1e-24))).to(dev)

    if group_budget_bytes > 0:
        group_cols = max(item_tile,
                         int(group_budget_bytes // max(1, items_pad * 4)))
        group_cols = (group_cols // item_tile) * item_tile
    else:
        group_cols = item_tile

    out_sims = np.empty((n_items, k), np.float32)
    out_ids = np.empty((n_items, k), np.int32)
    for glo in range(0, n_items, group_cols):
        gcols = min(group_cols, items_pad - glo)
        acc = _strip_accumulate(ub, ib, rb, block_counts, glo, gcols,
                                user_block, items_pad)
        if mesh is not None:
            dist.all_reduce(acc)
        for lo in range(glo, min(glo + gcols, n_items), item_tile):
            cols = min(item_tile, items_pad - lo)
            hi = min(lo + cols, n_items)
            col_ids = torch.arange(lo, lo + cols, device=dev)
            vals, idx = _strip_topk(acc[lo - glo:lo - glo + cols], col_ids,
                                    sums_t, n_users, norms_t, k, n_items)
            out_sims[lo:hi] = vals[:hi - lo].cpu().numpy()
            out_ids[lo:hi] = idx[:hi - lo].cpu().numpy()
        del acc
    return out_sims, out_ids, means[:n_items], np.sqrt(
        np.maximum(norms_sq[:n_items], 0.0))

