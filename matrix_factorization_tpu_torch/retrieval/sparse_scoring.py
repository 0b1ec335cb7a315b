"""Batched TF-IDF scoring on the device by blocked sparse-dense products
(PyTorch port).

Counterpart of ``matrix_factorization_tpu/retrieval/sparse_scoring.py``.
Single-query TF-IDF scoring stays on the host (``retrieval.search``). For
batched workloads this module scores B queries against the whole catalog
on the device by streaming the sparse matrix through dense vocab blocks:

    scores (B, items) = sum_over_vocab_blocks  Qd[:, blk] @ M[:, blk]^T

where ``Qd[:, blk]`` is the dense query block and ``M[:, blk]`` the
catalog's column block densified on the device. Peak memory is one query
block plus one (items, block) catalog block: ~9.1 GB at 2,231,142 items
and ``vocab_block=1024``, so a catalog that size takes a block of 1,024
(the default 8,192 would need ~73 GB), never the dense (items x vocab)
matrix.

The densify is exact and deterministic: a canonical CSR's (row, col)
pairs are unique (a non-canonical one has its duplicates summed first),
so writing each block's real entries with a non-accumulating
``index_put_`` gives the block bit for bit (JAX's ``.at[].add`` with
padding at (0, 0) adds zeros); no float atomics. The block product is
an f32 ``addmm_`` into the scores, TF32 off. Blocks no query touches are
skipped, as in JAX. Top-k is ``ops/scoring.py::stable_topk``, under
``retrieval.search``'s tie rule.

**On a mesh** (:func:`tfidf_csr_topk`, JAX ``:113-224``): the catalog's
rows split over every rank of the mesh (``parallel/topk.py::
catalog_shard``). A rank takes its rows of the CSR by ``indptr`` and
scores them with the same scorer (``tfidf_scores_device(row_range=)``), so its
largest buffer is one (rows of the rank, block) catalog block; the ranks' top-k
candidates merge in ``parallel/topk.py::merge_candidates``. JAX pads each
(device, vocab block) bucket of entries to one length for XLA's static
shapes; the port slices the rows and needs no padding.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.spd import exact_f32
from matrix_factorization_tpu_torch.retrieval.index import TfidfItemIndex


def _catalog_entries(matrix, device):
    """(rows, cols, vals) of a CSR's entries on ``device``, in CSR order.
    A non-canonical CSR (duplicate (row, col) entries, as one built from
    ``(data, indices, indptr)`` may hold) has its duplicates summed on a
    copy first, as JAX's ``.at[].add`` sums them."""
    m = matrix.tocsr()
    if not m.has_canonical_format:
        m = m.copy()
        m.sum_duplicates()
    indptr = torch.from_numpy(np.asarray(m.indptr, np.int64)).to(device)
    cols = torch.from_numpy(np.asarray(m.indices, np.int64)).to(device)
    vals = torch.from_numpy(np.asarray(m.data, np.float32)).to(device)
    rows = torch.repeat_interleave(
        torch.arange(m.shape[0], device=device), indptr.diff())
    return rows, cols, vals


def tfidf_scores_device(index: TfidfItemIndex, queries,
                        vocab_block: int = 8192, device=None,
                        row_range: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """(B, n_items) f32 cosine scores of a batch of queries, on ``device``
    (``None`` = CUDA). ``queries``: strings, which the index's vectorizer
    encodes, or their (B, vocab) sparse rows already encoded.
    ``row_range=(lo, hi)``: the scores of the catalog rows ``[lo, hi)``
    alone, (B, hi - lo), from those rows of the CSR (a mesh rank's
    share)."""
    dev = resolve_device(device)
    Qs = queries if hasattr(queries, "tocsr") else index.vectorizer.transform(queries)
    matrix = index.matrix
    n_all, vocab = (int(x) for x in matrix.shape)
    if row_range is not None and tuple(row_range) != (0, n_all):
        matrix = matrix.tocsr()[row_range[0]:row_range[1]]
    n_items = int(matrix.shape[0])
    B = Qs.shape[0]
    Qd = torch.from_numpy(np.asarray(Qs.todense(), np.float32)).to(dev)
    scores = torch.zeros((B, n_items), dtype=torch.float32, device=dev)
    if n_items == 0:
        return scores

    rows, cols, vals = _catalog_entries(matrix, dev)
    blk_of = cols // vocab_block
    order = torch.sort(blk_of, stable=True).indices
    rows, cols, vals = rows[order], cols[order], vals[order]
    n_blocks = (vocab + vocab_block - 1) // vocab_block
    offsets = np.concatenate([[0], np.cumsum(
        torch.bincount(blk_of, minlength=n_blocks).cpu().numpy())])
    touched = (Qd != 0).any(0).cpu().numpy()

    block = None
    with exact_f32():
        for b in range(n_blocks):
            lo, hi = int(offsets[b]), int(offsets[b + 1])
            c0 = b * vocab_block
            width = min(vocab_block, vocab - c0)
            if hi == lo or not touched[c0:c0 + width].any():
                continue  # an empty block, or no query touches it
            if block is None:
                block = torch.empty((n_items, vocab_block), dtype=torch.float32,
                                    device=dev)
            block.zero_()
            block.index_put_((rows[lo:hi], cols[lo:hi] - c0), vals[lo:hi])
            scores.addmm_(Qd[:, c0:c0 + width], block[:, :width].T)
    return scores


def tfidf_batch_scores(
    index: TfidfItemIndex,
    queries: List[str],
    vocab_block: int = 8192,
    device=None,
) -> np.ndarray:
    """(B, n_items) cosine scores for a batch of query strings (host)."""
    return tfidf_scores_device(index, queries, vocab_block, device).cpu().numpy()


def tfidf_batch_topk(
    index: TfidfItemIndex, queries: List[str], k: int,
    vocab_block: int = 8192, mesh=None, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k (scores, positions) per query, computed on the device; only
    (B, k) reaches the host. With ``mesh``, item-sharded over its ranks
    (:func:`tfidf_csr_topk`)."""
    if mesh is not None:
        return tfidf_csr_topk(index, index.vectorizer.transform(queries), k,
                              mesh, vocab_block=vocab_block, device=device)
    scores = tfidf_scores_device(index, queries, vocab_block, device)
    vals, idx = stable_topk(scores, k)
    return vals.cpu().numpy(), idx.cpu().numpy()


def tfidf_csr_topk(index: TfidfItemIndex, Qs, k: int, mesh,
                   vocab_block: int = 8192, device=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Item-sharded batched TF-IDF top-k of encoded queries ``Qs`` (a
    (B, vocab) sparse matrix): (scores, global positions), (B, k) host
    arrays, the same on every rank (JAX ``:113-224``). A collective: every
    rank of ``mesh`` calls it with the same ``Qs``.

    The catalog rows split over every axis of the mesh (``catalog_shard``:
    ``round_up(n, 8N) / N`` rows a rank). Each rank scores its rows on
    ``device`` (``None`` = CUDA) with ``tfidf_scores_device(row_range=)``: its
    rows' entries densified one (rows, ``vocab_block``) block at a time
    by the non-accumulating ``index_put_`` (a non-canonical CSR's
    duplicates summed first), each block's product added by ``addmm_``
    (TF32 off), blocks no query touches skipped. Then the local
    ``stable_topk``, the positions offset by the rank's first row, and
    ``parallel/topk.py::merge_candidates``. A rank's largest buffer is one
    block: at 2,231,142 items over 4 ranks, 2.3 GB a rank at
    ``vocab_block=1024``, 18.3 GB at 8,192. ``k`` is cut to the catalog's
    size."""
    from matrix_factorization_tpu_torch.parallel.topk import (
        catalog_shard,
        merge_candidates,
        pad_candidates,
    )

    dev = resolve_device(device)
    n = int(index.matrix.shape[0])
    k = min(k, n)
    start, stop, per = catalog_shard(n, mesh)
    scores = tfidf_scores_device(index, Qs, vocab_block, dev,
                                 row_range=(start, stop))
    kk = min(k, per)
    vals, idx = stable_topk(scores, kk)
    vals, gpos = pad_candidates(vals, idx + start, kk, stop)
    mvals, mpos = merge_candidates(vals, gpos, k)
    return mvals.cpu().numpy(), mpos.cpu().numpy()
