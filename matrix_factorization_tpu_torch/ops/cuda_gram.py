"""EASE's item gram on the int8 tensor cores: the hand-written kernels of
``csrc/ease_gram.cu`` and their plain PyTorch versions.

The gram ``G = X^T X`` of an interaction matrix whose entries are small
integers is exact in int8 products with int32 sums, and equals the
exact-f32 gram of ``ops/ease.py`` bit for bit when every count converts to
f32 exactly (``ops/ease.py::int8_exact`` decides). It replaces no TPU
kernel (the JAX package leaves the gram to XLA's f32 product); its source
says why it was added, what bounds it and how it is laid out.

A user chunk at a time, three steps: the chunk's (user, item, weight)
triples (a run of the pairs sorted by user) are written into a zeroed
item-major int8 slab ``Dt`` of :func:`slab_rows` rows (items, padded to a multiple of ``TILE``) and
``cu`` columns (the chunk's users, a multiple of ``K_TILE``); the
upper-triangle ``TILE x TILE`` tiles of ``Dt Dt^T`` (:func:`tile_order`)
are added to an int32 gram; after the last chunk the gram is converted to
f32 in place and its upper tiles mirrored into the lower ones.

``int8_gram`` takes CUDA tensors to the kernels and CPU tensors to the
plain versions (the same steps in PyTorch, for the tests).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from matrix_factorization_tpu_torch.ops import _build

TILE = 128  # kTile of csrc/ease_gram.cu: output tile rows and columns
K_TILE = 128  # kBK: users a stage; a chunk's users are a multiple of it
GROUP = 8  # tile rows whose tiles the order keeps together

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = _build.Library("ease_gram", {
    "mf_ease_gram_slab": ([_vp, _vp, _vp, _cll, _vp, _cll, _ci, _vp], _ci),
    "mf_ease_gram_tiles": ([_vp, _ci, _ci, _vp, _ci, _vp, _ci, _vp], _ci),
    "mf_ease_gram_finish": ([_vp, _ci, _vp], _ci),
}, error="mf_ease_gram_error_string")


def slab_rows(n: int) -> int:
    """Rows of the slab for an (n, n) gram: n padded to a multiple of
    ``TILE`` (the pad rows stay zero)."""
    return -(-n // TILE) * TILE


def tile_order(n: int, group: int = GROUP) -> np.ndarray:
    """(tiles, 2) int32 (tile row, tile column) of every upper-triangle
    tile of an (n, n) gram, each once: for each group of ``group`` tile
    rows, the columns left to right and in each column the group's rows
    (those on or above the diagonal), so that the blocks resident at once
    read a few row panels and a run of column panels."""
    t = -(-n // TILE)
    out = []
    for g0 in range(0, t, group):
        cols = np.arange(g0, t)
        rows = np.arange(g0, min(g0 + group, t))
        bi, bj = np.meshgrid(rows, cols)  # (columns, rows): column-major walk
        keep = bi <= bj
        out.append(np.stack([bi[keep], bj[keep]], axis=1))
    return np.concatenate(out).astype(np.int32)


def plain_slab(lu: torch.Tensor, ii: torch.Tensor, w: torch.Tensor, rows: int,
               cu: int) -> torch.Tensor:
    """The slab kernel's result: a zeroed (rows, cu) int8 slab with
    ``Dt[ii, lu] = w`` for every nonzero weight (rounded to the nearest
    integer, as ``__float2int_rn``)."""
    Dt = torch.zeros((rows, cu), dtype=torch.int8, device=lu.device)
    keep = w != 0
    Dt[ii[keep].long(), lu[keep].long()] = torch.round(w[keep]).to(torch.int8)
    return Dt


def plain_tiles(Dt: torch.Tensor, tiles: torch.Tensor, G: torch.Tensor) -> None:
    """The tile kernel's sums: ``G[tile] += Dt[rows] Dt[cols]^T`` in int32
    for every listed tile, cut at G's edge."""
    n = G.shape[0]
    for bi, bj in tiles.tolist():
        r0, c0 = bi * TILE, bj * TILE
        a = Dt[r0:r0 + TILE].to(torch.int32)
        b = Dt[c0:c0 + TILE].to(torch.int32)
        prod = a @ b.T
        G[r0:min(r0 + TILE, n), c0:min(c0 + TILE, n)] += prod[:n - r0, :n - c0]


def plain_finish(G: torch.Tensor) -> torch.Tensor:
    """The finish kernel's result: the f32 gram whose entry (i, j) is the
    int32 sum at (i, j) where i's tile row is at most j's tile column (a
    computed tile), else at (j, i)."""
    t = torch.arange(G.shape[0], device=G.device) // TILE
    upper = t[:, None] <= t[None, :]
    return torch.where(upper, G, G.T).to(torch.float32)


def int8_gram(lu: torch.Tensor, ii: torch.Tensor, w: torch.Tensor, bounds,
              n: int, cu: int, tiles: torch.Tensor) -> torch.Tensor:
    """The (n, n) f32 gram ``X^T X`` of the packed pairs ``lu``, ``ii``,
    ``w`` (chunk-local user ids below ``cu``, item ids below ``n``, integer
    weights; chunk c at ``[bounds[c], bounds[c + 1])``), through the int32
    sums of the upper tiles ``tiles`` (:func:`tile_order` of ``n``, int32,
    on the pairs' device). On a CUDA device the kernels, which return the
    int32 buffer itself as f32; on the CPU the plain versions."""
    if n % 8 or cu % K_TILE:
        raise ValueError(f"int8_gram takes n % 8 == 0 and cu % {K_TILE} == 0, "
                         f"got n={n}, cu={cu}")
    dev = lu.device
    rows = slab_rows(n)
    G = torch.zeros((n, n), dtype=torch.int32, device=dev)
    chunks = list(zip(bounds[:-1], bounds[1:]))
    if dev.type != "cuda":
        for s, e in chunks:
            plain_tiles(plain_slab(lu[s:e], ii[s:e], w[s:e], rows, cu), tiles, G)
        return plain_finish(G)
    for t in (lu, ii, w, tiles):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("int8_gram takes contiguous tensors on one device")
    if (lu.dtype, ii.dtype, w.dtype, tiles.dtype) != (torch.int32, torch.int32,
                                                      torch.float32, torch.int32):
        raise ValueError("int8_gram takes int32 ids and tiles and f32 weights")
    stream = torch.cuda.current_stream(dev).cuda_stream
    Dt = torch.empty((rows, cu), dtype=torch.int8, device=dev)
    for s, e in chunks:
        LIB("mf_ease_gram_slab", lu[s:e].data_ptr(), ii[s:e].data_ptr(),
            w[s:e].data_ptr(), e - s, Dt.data_ptr(), Dt.numel(), cu, stream)
        LIB("mf_ease_gram_tiles", Dt.data_ptr(), cu, cu // K_TILE,
            tiles.data_ptr(), tiles.shape[0], G.data_ptr(), n, stream)
    del Dt
    LIB("mf_ease_gram_finish", G.data_ptr(), n, stream)
    return G.view(torch.float32)
