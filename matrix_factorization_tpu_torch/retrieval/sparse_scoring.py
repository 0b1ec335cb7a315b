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

``mesh=`` (``tfidf_csr_topk``, item-sharded) comes with slice 6 of the
port and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.segment_sgd import SLICE_6_GRAM
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


def tfidf_scores_device(index: TfidfItemIndex, queries: List[str],
                        vocab_block: int = 8192, device=None) -> torch.Tensor:
    """(B, n_items) f32 cosine scores of a batch of query strings, on
    ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)
    Qs = index.vectorizer.transform(queries)  # (B, vocab) CSR, l2-normed
    n_items, vocab = (int(x) for x in index.matrix.shape)
    B = len(queries)
    Qd = torch.from_numpy(np.asarray(Qs.todense(), np.float32)).to(dev)

    rows, cols, vals = _catalog_entries(index.matrix, dev)
    blk_of = cols // vocab_block
    order = torch.sort(blk_of, stable=True).indices
    rows, cols, vals = rows[order], cols[order], vals[order]
    n_blocks = (vocab + vocab_block - 1) // vocab_block
    offsets = np.concatenate([[0], np.cumsum(
        torch.bincount(blk_of, minlength=n_blocks).cpu().numpy())])
    touched = (Qd != 0).any(0).cpu().numpy()

    scores = torch.zeros((B, n_items), dtype=torch.float32, device=dev)
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
    (B, k) reaches the host."""
    if mesh is not None:
        raise NotImplementedError(f"tfidf_batch_topk(mesh=) comes with {SLICE_6_GRAM}")
    scores = tfidf_scores_device(index, queries, vocab_block, device)
    vals, idx = stable_topk(scores, k)
    return vals.cpu().numpy(), idx.cpu().numpy()
