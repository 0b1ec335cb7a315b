"""Query encoding + top-k search over item indexes (PyTorch port).

Counterpart of ``matrix_factorization_tpu/retrieval/search.py``, with its
return shapes ``[(item_id, sim)]`` / ``[(pos, item_id, sim)]``
(reference ``retrieval.py:64-115``). Dense scoring is ``emb @ q`` in f32
(TF32 off) on the device, against a device copy of the embeddings cached
per index and device; TF-IDF single queries score on the host
(``index.matrix @ q.T``: a query touches only its own term columns).

**Tie rule.** Every top-k here orders by score descending, then by
position ascending (``ops/scoring.py::stable_topk``, the port's one
top-k): a tie at the cut keeps the lower positions. The JAX
single-query path (``argpartition``, then an unstable ``argsort``) leaves
tied positions in no stated order; on tie-free scores the two agree.

**On a mesh** (``mesh=``, a ``DeviceMesh`` of ``parallel.mesh``): the
catalog splits by rows over every rank of the mesh, ``round_up(n, 8N) /
N`` rows a rank (``parallel/topk.py::catalog_shard``). A dense index is
scored by :func:`dense_topk_mesh`, a TF-IDF one by
``sparse_scoring.tfidf_csr_topk``: each rank takes the top-k of its own
rows, and the (B, k) candidates of every rank merge in
``parallel/topk.py::merge_candidates``, under the same tie rule. A mesh
call is a collective: every rank calls it with the same queries and gets
the same answer.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.spd import exact_f32
from matrix_factorization_tpu_torch.retrieval.encode import embed_texts
from matrix_factorization_tpu_torch.retrieval.index import (
    DenseItemIndex,
    TfidfItemIndex,
)
from matrix_factorization_tpu_torch.utils.profiling import span

IndexT = Union[DenseItemIndex, TfidfItemIndex]

# weak-keyed: entries die with their index (no id-reuse staleness, no
# device-memory leak across index reloads); one copy per device
_device_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# scores of a (B, n_items) block taken at once: the block and its 64-bit
# keys take ~20 bytes a score, ~2.7 GB at this budget
_TOPK_ELEMS = 1 << 27


def device_embeddings(index: DenseItemIndex, device=None) -> torch.Tensor:
    """The index's (n_items, dim) f32 embeddings on ``device`` (``None`` =
    CUDA), copied once per index and device."""
    dev = resolve_device(device)
    per_device = _device_cache.setdefault(index, {})
    arr = per_device.get(dev)
    if arr is None:
        arr = torch.from_numpy(
            np.ascontiguousarray(index.embeddings, np.float32)).to(dev)
        per_device[dev] = arr
    return arr


def dense_topk(emb: torch.Tensor, q: torch.Tensor, k: int):
    """(B, k) scores and positions of ``q @ emb.T`` on ``emb``'s device,
    in row blocks of at most ``_TOPK_ELEMS`` scores (device tensors)."""
    n = emb.shape[0]
    rows = max(1, _TOPK_ELEMS // max(n, 1))
    vals, idx = [], []
    with exact_f32():
        for lo in range(0, q.shape[0], rows):
            with span("search.gemm"):
                s = q[lo:lo + rows] @ emb.T
            v, i = stable_topk(s, k)
            vals.append(v)
            idx.append(i)
    with span("search.fetch"):
        return torch.cat(vals), torch.cat(idx)


def encode_query(text: str, model_name: Optional[str] = None,
                 dim: int = 512) -> np.ndarray:
    return embed_texts([text], model_name=model_name, dim=dim)[0]


def encode_query_for_index(
    index: IndexT, text: str, model_name: Optional[str] = None
) -> object:
    """TF-IDF -> sparse vector via the fitted vectorizer; dense -> embedding
    (reference retrieval.py:70-77)."""
    if isinstance(index, TfidfItemIndex):
        return index.vectorizer.transform([text])
    dim = index.embeddings.shape[1]
    return encode_query(text, model_name=model_name, dim=dim)


def search_topk(index: IndexT, query_vec: object, k: int, mesh=None,
                device=None) -> List[Tuple[object, float]]:
    rows = search_topk_pos(index, query_vec, k, mesh=mesh, device=device)
    return [(item_id, sim) for _, item_id, sim in rows]


def search_topk_pos(
    index: IndexT, query_vec: object, k: int, mesh=None, device=None
) -> List[Tuple[int, object, float]]:
    """Top-``k`` rows ``(pos, item_id, sim)`` of one query. Dense indexes
    score and take the top-k on ``device`` (``None`` = CUDA), only k
    values and positions reaching the host; TF-IDF on the host. With
    ``mesh``, the catalog is scored item-sharded over the mesh's ranks on
    ``device`` (:func:`dense_topk_mesh`, ``tfidf_csr_topk`` with the
    query's CSR row), called by every rank with the same query."""
    if k <= 0:
        return []
    if mesh is not None and isinstance(index, TfidfItemIndex):
        from matrix_factorization_tpu_torch.retrieval.sparse_scoring import (
            tfidf_csr_topk,
        )

        vals, top = tfidf_csr_topk(index, query_vec, k, mesh, device=device)
        vals, top = vals[0], top[0]
    elif isinstance(index, TfidfItemIndex):
        s = index.matrix @ query_vec.T
        if hasattr(s, "toarray"):
            s = s.toarray()
        vals, top = stable_topk(
            torch.from_numpy(np.asarray(s, np.float32).ravel()), k)
        vals, top = vals.numpy(), top.numpy()
    else:
        vals, top = search_topk_batch(
            index, np.asarray(query_vec, np.float32).reshape(1, -1), k,
            mesh=mesh, device=device)
        vals, top = vals[0], top[0]
    with span("search.answer"):
        return [(int(i), index.item_ids[int(i)], float(v))
                for i, v in zip(top, vals)]


def search_topk_batch(
    index: DenseItemIndex, query_vecs: np.ndarray, k: int, mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched device top-k for serving: (scores, positions), (B, k) host
    arrays, under the module's tie rule; with ``mesh``, row-sharded over
    its ranks (:func:`dense_topk_mesh`)."""
    if mesh is not None:
        return dense_topk_mesh(index, query_vecs, k, mesh, device=device)
    with span("search.query"):
        emb = device_embeddings(index, device)
        q = torch.from_numpy(np.ascontiguousarray(query_vecs, np.float32))
        q = q.to(emb.device)
    vals, idx = dense_topk(emb, q, min(k, emb.shape[0]))
    with span("search.fetch"):
        return _host_arrays(vals, idx)


def _host_arrays(*tensors) -> Tuple[np.ndarray, ...]:
    """Host arrays of the tensors. From a CUDA device: each copied into
    pinned host memory without blocking, then one wait for the stream, so
    that the host waits once for the call's work and its copies."""
    if tensors[0].device.type != "cuda":
        return tuple(t.cpu().numpy() for t in tensors)
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for o, t in zip(out, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(o.numpy() for o in out)


# -- the row-sharded dense search ---------------------------------------------

# weak-keyed by index, as ``_device_cache``: a rank's rows per (mesh, device)
_mesh_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _mesh_rows(index: DenseItemIndex, mesh, dev: torch.device, start: int,
               stop: int) -> torch.Tensor:
    """This rank's rows ``[start, stop)`` of the embeddings on ``dev``,
    copied once per index, mesh and device (only those rows are read, so an
    index whose embeddings are a memory map is read in part); the whole
    catalog is ``device_embeddings``' copy."""
    if start == 0 and stop == index.embeddings.shape[0]:
        return device_embeddings(index, dev)
    per_mesh = _mesh_cache.setdefault(index, {})
    arr = per_mesh.get((mesh, dev))
    if arr is None:
        arr = torch.from_numpy(np.array(index.embeddings[start:stop],
                                        np.float32)).to(dev)
        per_mesh[(mesh, dev)] = arr
    return arr


def dense_topk_mesh(index: DenseItemIndex, query_vecs: np.ndarray, k: int,
                    mesh, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Row-sharded dense top-k (JAX ``retrieval/search.py:166-221``):
    (scores, global positions), (B, k) host arrays, the same on every rank.
    A collective: every rank of ``mesh`` calls it with the same
    ``query_vecs``.

    The embeddings split by rows over every axis of the mesh
    (``catalog_shard``: ``round_up(n, 8N) / N`` rows a rank, the padding
    rows scoring ``-inf``). Each rank scores its real rows on ``device``
    (``None`` = CUDA) with :func:`dense_topk` (f32 row blocks, TF32 off,
    ``stable_topk``), offsets the positions by its first row, and the
    candidates merge in ``parallel/topk.py::merge_candidates``: score
    descending, then global position ascending. ``k`` is cut to the
    catalog's size. On a mesh of one rank this is :func:`dense_topk` on
    the whole catalog, bit for bit."""
    from matrix_factorization_tpu_torch.parallel.topk import (
        catalog_shard,
        merge_candidates,
        pad_candidates,
    )

    dev = resolve_device(device)
    n = index.embeddings.shape[0]
    k = min(k, n)
    start, stop, per = catalog_shard(n, mesh)
    kk = min(k, per)
    q = torch.from_numpy(np.ascontiguousarray(
        np.asarray(query_vecs, np.float32).reshape(-1, index.embeddings.shape[1])
    )).to(dev)
    # a rank past the catalog's last row holds no row: no candidate of its own
    vals, idx = dense_topk(_mesh_rows(index, mesh, dev, start, stop), q, kk)
    vals, gpos = pad_candidates(vals, idx + start, kk, stop)
    mvals, mpos = merge_candidates(vals, gpos, k)
    return mvals.cpu().numpy(), mpos.cpu().numpy()
