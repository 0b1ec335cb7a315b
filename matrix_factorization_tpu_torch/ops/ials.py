"""Alternating least squares for the full factor model, and implicit-
feedback ALS (PyTorch port).

Counterpart of ``matrix_factorization_tpu/ops/ials.py``. Each half-sweep
is a batch of exact normal-equation solves, one per entity. Bias folding
(``ops/segment_sgd.py``) makes the bias a free extra column: in the user
sweep each rating's design row is ``x = [q_{:k}, 1]`` (the item row's
factors and its constant column, d = k + 1) with target
``r - mu - b_i``, and the solution's k + 1 values go to the user's factor
columns and bias column. The item sweep is symmetric.

Ratings are grouped per entity on the host and padded: to one length
over all entities (``group_by_entity``, for ``ials_train``), or into count
buckets of power-of-two length, each chunked to a row budget
(``group_by_entity_bucketed``, for ``ials_train_bucketed``). One native
pass of ``csrc/host_loader.cpp`` places every entry (numpy's argsorts
with ``native=False``). The packs are the JAX package's, byte for byte;
their tensors go to the tables' device
as int32 ids, f32 ratings and f32 masks (the JAX package's wire encoders
existed for the TPU image's remote link). A sweep forms each entity's
ridged gram and right-hand side (``normal_equations``: on the GPU the
hand-written kernel of ``ops/cuda_normal_eq.py``, which gathers the rows
straight from the table; elsewhere the (E, L, d) design rows and one
batched product), and solves with ``ops.spd.solve_spd``, whose
Gauss-Jordan leaf is the hand-written kernel of ``ops/cuda_spd.py`` on
the GPU. The sweeps are plain functions that
update the tables in place (the JAX package's jit caches have no
counterpart). Every product is exact f32 unless ``gram_dtype='bf16'``.

``dp_ials_train_bucketed`` is the data-parallel form, run by every rank of
a mesh (``parallel/mesh.py``): both tables whole on every rank, each
bucket's solves split over the data ranks, one ``all_gather_into_tensor``
of the solutions a bucket, and every rank writes the same rows, so the
tables stay replicated.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.data.loader import host_lib
from matrix_factorization_tpu_torch.ops import cuda_normal_eq
from matrix_factorization_tpu_torch.ops.segment_sgd import (
    MFParams,
    RatingBatches,
    bias_col,
    const_col,
    masked_sse,
    round_up,
)
from matrix_factorization_tpu_torch.ops.spd import _mm, solve_spd
from matrix_factorization_tpu_torch.utils.profiling import span

_GRAM_DTYPES = ("f32", "bf16", "highest")
_REG_SCALES = ("absolute", "per_obs")


class GroupedRatings(NamedTuple):
    """Per-entity padded rating lists: all tensors (n_entities, L)."""

    other_ids: torch.Tensor  # int32: the counterpart entity per rating
    ratings: torch.Tensor  # f32
    mask: torch.Tensor  # f32 1/0


class Bucket(NamedTuple):
    entity_ids: torch.Tensor  # (E_b,) int32: which rows this bucket solves
    other_ids: torch.Tensor  # (E_b, L_b)
    ratings: torch.Tensor
    mask: torch.Tensor


# ---------------------------------------------------------------------------
# The host packs
# ---------------------------------------------------------------------------


def _sorted_by_entity(ids, other_ids, ratings, n_entities: int):
    """The entries stably sorted by entity, the per-entity counts and each
    entry's position within its entity (the numpy packs)."""
    ids = np.asarray(ids, np.int32)
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    other_s = np.asarray(other_ids, np.int32)[order]
    r_s = np.asarray(ratings, np.float32)[order]
    counts = np.bincount(ids_s, minlength=n_entities)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(ids_s), dtype=np.int64) - starts[ids_s]
    return ids_s, other_s, r_s, counts, pos


def _entity_counts(ids: np.ndarray, n_entities: int) -> np.ndarray:
    """Per-entity counts by the native O(n) pass; ids outside
    [0, n_entities) raise (the native passes index by them)."""
    counts = np.zeros(n_entities, np.int32)
    ids = np.ascontiguousarray(ids, np.int32)
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= n_entities):
        raise ValueError(f"entity ids must lie in [0, {n_entities})")
    host_lib().mf_entity_counts(ids, len(ids), n_entities, counts)
    return counts


def _native_pools(ids, other_ids, ratings, n_entities: int, chunk_of,
                  row_of, L_of_chunk, chunk_base, pool_size: int):
    """One native pass (``mf_pack_grouped``) writing every entry into its
    (chunk, row, slot) cell of the flat pools, input order kept within an
    entity: the other-ids, ratings and mask pools."""
    oi = np.zeros(pool_size, np.int32)
    rr = np.zeros(pool_size, np.float32)
    mm = np.zeros(pool_size, np.float32)
    ids = np.ascontiguousarray(ids, np.int32)
    host_lib().mf_pack_grouped(
        ids, np.ascontiguousarray(other_ids, np.int32),
        np.ascontiguousarray(ratings, np.float32), len(ids),
        np.ascontiguousarray(chunk_of, np.int32),
        np.ascontiguousarray(row_of, np.int32),
        np.ascontiguousarray(L_of_chunk, np.int32),
        np.ascontiguousarray(chunk_base, np.int64),
        oi, rr, mm, np.zeros(n_entities, np.int32))
    return oi, rr, mm


def _count_mask(counts: np.ndarray, L: int) -> np.ndarray:
    """The (E, L) mask of rows filled from the left: ``arange(L) < count``."""
    return (np.arange(L)[None, :] < np.asarray(counts)[:, None]).astype(np.float32)


def _grouped_tensors(oi: np.ndarray, rr: np.ndarray, mm: np.ndarray,
                     E: int, L: int, device: torch.device):
    """(E, L) other-ids, ratings and mask on ``device``."""

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype).reshape(E, L)).to(device)

    return put(oi, np.int32), put(rr, np.float32), put(mm, np.float32)


def group_by_entity(ids: np.ndarray, other_ids: np.ndarray, ratings: np.ndarray,
                    n_entities: int, device=None, native: bool = True
                    ) -> GroupedRatings:
    """(n_entities, L) padded per-entity rating lists, input order kept
    within each entity, L the largest count rounded up to 8, on ``device``
    (``None`` = CUDA). One native pass (``mf_pack_grouped``), or with
    ``native=False`` one flat numpy scatter of the stably sorted entries;
    the bytes are equal."""
    dev = resolve_device(device)
    if native:
        counts = _entity_counts(ids, n_entities)
        L = round_up(max(1, int(counts.max(initial=0))), 8)
        pools = _native_pools(
            ids, other_ids, ratings, n_entities,
            chunk_of=np.zeros(n_entities, np.int32),
            row_of=np.arange(n_entities, dtype=np.int32),
            L_of_chunk=np.asarray([L], np.int32),
            chunk_base=np.asarray([0], np.int64), pool_size=n_entities * L)
        return GroupedRatings(*_grouped_tensors(*pools, n_entities, L, dev))
    ids_s, other_s, r_s, counts, pos = _sorted_by_entity(
        ids, other_ids, ratings, n_entities)
    L = round_up(max(1, int(counts.max(initial=0))), 8)
    flat = ids_s.astype(np.int64) * L + pos
    oi = np.zeros(n_entities * L, np.int32)
    rr = np.zeros(n_entities * L, np.float32)
    oi[flat] = other_s
    rr[flat] = r_s
    return GroupedRatings(*_grouped_tensors(
        oi, rr, _count_mask(counts, L), n_entities, L, dev))


def group_by_entity_bucketed(
    ids: np.ndarray,
    other_ids: np.ndarray,
    ratings: np.ndarray,
    n_entities: int,
    max_block_rows: int = 4_000_000,
    device=None,
    native: bool = True,
) -> List[Bucket]:
    """Entities with data bucketed by rating count (power-of-two L, at
    least 8), each bucket chunked so that E_b * L_b stays under
    ``max_block_rows``: a sweep's (E, L, d) gather stays bounded whatever
    the heaviest entity. Input order is kept within each entity; on
    ``device`` (``None`` = CUDA). The entries are placed by one native
    pass over the raw stream (``mf_pack_grouped``, no sort), or with
    ``native=False`` by numpy's stable argsorts and scatters; the bytes
    are equal."""
    dev = resolve_device(device)
    if native:
        counts = _entity_counts(ids, n_entities)
    else:
        ids_s, other_s, r_s, counts, pos_in_entity = _sorted_by_entity(
            ids, other_ids, ratings, n_entities)

    active = np.nonzero(counts)[0]
    # bucket label = next power of two >= count (min 8)
    L_of = np.maximum(8, 1 << np.ceil(np.log2(np.maximum(counts[active], 1))
                                      ).astype(int))
    chunk_of = np.full(n_entities, -1, np.int64)
    row_of = np.full(n_entities, -1, np.int64)
    chunk_meta = []  # (L, entity_ids)
    for L in np.unique(L_of):
        members = active[L_of == L]
        max_e = max(1, int(max_block_rows // L))
        for lo in range(0, len(members), max_e):
            chunk = members[lo:lo + max_e]
            chunk_of[chunk] = len(chunk_meta)
            row_of[chunk] = np.arange(len(chunk))
            chunk_meta.append((int(L), chunk))

    def bucket(chunk, L, oi, rr, mm):
        return Bucket(torch.from_numpy(chunk.astype(np.int32)).to(dev),
                      *_grouped_tensors(oi, rr, mm, len(chunk), L, dev))

    if native:
        sizes = np.asarray([L * len(chunk) for L, chunk in chunk_meta], np.int64)
        base = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        oi, rr, mm = _native_pools(
            ids, other_ids, ratings, n_entities, chunk_of, row_of,
            np.asarray([L for L, _ in chunk_meta], np.int32), base[:-1],
            int(sizes.sum()))
        return [bucket(chunk, L, *(a[base[c]:base[c + 1]] for a in (oi, rr, mm)))
                for c, (L, chunk) in enumerate(chunk_meta)]

    # three O(nnz) passes + a flat scatter per chunk
    entry_chunk = chunk_of[ids_s]
    entry_row = row_of[ids_s]
    order2 = np.argsort(entry_chunk, kind="stable")
    bounds = np.searchsorted(entry_chunk[order2], np.arange(len(chunk_meta) + 1))

    buckets = []
    for c, (L, chunk) in enumerate(chunk_meta):
        sl = order2[bounds[c]:bounds[c + 1]]
        E = len(chunk)
        flat = entry_row[sl] * L + pos_in_entity[sl]
        oi = np.zeros(E * L, np.int32)
        rr = np.zeros(E * L, np.float32)
        oi[flat] = other_s[sl]
        rr[flat] = r_s[sl]
        buckets.append(bucket(chunk, L, oi, rr, _count_mask(counts[chunk], L)))
    return buckets


def group_both_sides_bucketed(
    u: np.ndarray,
    i: np.ndarray,
    r: np.ndarray,
    n_users: int,
    n_items: int,
    max_block_rows: int = 4_000_000,
    device=None,
    native: bool = True,
) -> Tuple[List[Bucket], List[Bucket]]:
    """Both bucketed views (by user, by item): two
    ``group_by_entity_bucketed`` calls in two threads (the native passes
    release the interpreter lock, so the two packs overlap)."""
    with ThreadPoolExecutor(2) as ex:
        fu = ex.submit(group_by_entity_bucketed, u, i, r, n_users,
                       max_block_rows, device, native)
        fi = ex.submit(group_by_entity_bucketed, i, u, r, n_items,
                       max_block_rows, device, native)
        return fu.result(), fi.result()


# ---------------------------------------------------------------------------
# The sweeps
# ---------------------------------------------------------------------------


def _gram(Xg: torch.Tensor, gram_dtype: str) -> torch.Tensor:
    """(E, d, d) design grams ``X^T X`` of (E, L, d) design rows.

    ``'f32'`` and ``'highest'`` are both exact f32 here (TF32 off; on the
    TPU the two differed because XLA's default fed the MXU bf16 operands).
    ``'bf16'`` rounds the operands to bf16 and accumulates in f32: the
    rounded values are multiplied in f32, where the product of two bf16
    values is exact, so it is the semantics of a bf16 product with an f32
    accumulator, at the f32 product's speed."""
    if gram_dtype == "bf16":
        Xg = Xg.to(torch.bfloat16).to(torch.float32)
    return _mm(Xg.transpose(1, 2), Xg)


def _reg_diag(reg: float, mask: torch.Tensor, reg_scale: str):
    """The ridge on the diagonal of each entity's normal equations:
    ``reg`` (``'absolute'``, ``reg*I``: the reference bias-ALS convention)
    or ``reg * n_obs`` as an (E, 1) tensor (``'per_obs'``, ``reg*n_obs*I``:
    the exact ALS counterpart of SGD's per-rating L2, so a solve minimises
    the objective the SGD trainer descends). ``n_obs`` is at least 1."""
    if reg_scale == "per_obs":
        return reg * mask.sum(dim=1).clamp_min(1.0)[:, None]
    return reg


def normal_equations(other: torch.Tensor, other_ids: torch.Tensor,
                     ratings: torch.Tensor, mask: torch.Tensor,
                     mu: torch.Tensor, cfg: SGDConfig, own_side: str,
                     gram_dtype: str = "f32", reg_scale: str = "absolute"):
    """(A, b): the (E, d, d) ridged grams and (E, d) right-hand sides of E
    entities' padded rating lists against the other side's table
    ``other``, d = k + 1 (bias folding, see the module docstring). A CUDA
    table always takes the kernel of ``ops/cuda_normal_eq.py`` (span
    ``als.gram_kernel``), any other :func:`plain_normal_equations`."""
    k = cfg.n_factors
    o_side = "item" if own_side == "user" else "user"
    o_bias, o_const = bias_col(cfg, o_side), const_col(cfg, o_side)
    with span("als.normal_eq"):
        if other.device.type == "cuda":
            with span("als.gram_kernel"):
                return cuda_normal_eq.cuda_normal_equations(
                    other, other_ids, ratings, mask, mu, k, o_bias, o_const,
                    _reg_diag(cfg.reg, mask, reg_scale), gram_dtype == "bf16")
        return plain_normal_equations(other, other_ids, ratings, mask, mu, k,
                                      o_bias, o_const, cfg.reg, gram_dtype,
                                      reg_scale)


def plain_normal_equations(other: torch.Tensor, other_ids: torch.Tensor,
                           ratings: torch.Tensor, mask: torch.Tensor,
                           mu: torch.Tensor, k: int, o_bias: int, o_const: int,
                           reg: float, gram_dtype: str = "f32",
                           reg_scale: str = "absolute"):
    """:func:`normal_equations` in plain PyTorch: the d = k + 1 design
    columns of every other-side row gathered into an (E, L, d) block, the
    mask multiplied in, the grams by one batched product (:func:`_gram`),
    the ridge, and the right-hand sides by a second product."""
    design = torch.cat([other[:, :k], other[:, o_const:o_const + 1]], dim=1)
    ids = other_ids.long()
    Xm = design[ids].mul_(mask[..., None])
    y = (ratings - mu - other[:, o_bias][ids]) * mask
    A = _gram(Xm, gram_dtype)
    A.diagonal(dim1=-2, dim2=-1).add_(_reg_diag(reg, mask, reg_scale))
    b = _mm(Xm.transpose(1, 2), y[..., None])[..., 0]
    return A, b


# f32 elements of one solve's design block or grams: larger blocks are
# solved in pieces of whole entities (each entity's solve is its own, so
# the result is the same). Config 3's bucket chunks (15,625 x 256 and
# 7,812 x 512 at d = 201) fit in one piece.
_SOLVE_ELEMS = 1 << 30


def _solve_entities(other: torch.Tensor, other_ids: torch.Tensor,
                    ratings: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor,
                    cfg: SGDConfig, own_side: str, gram_dtype: str,
                    reg_scale: str) -> torch.Tensor:
    """The (E, k + 1) ridge solutions ``[p, b]`` of E entities' padded
    rating lists against ``other``, in pieces of at most ``_SOLVE_ELEMS``
    design or gram elements (one padded block over 162,000 users at
    d = 201 would take 26 GB of grams alone)."""
    E, L = other_ids.shape
    d = cfg.n_factors + 1
    step = max(1, _SOLVE_ELEMS // (d * max(L, d)))
    if E > step:
        return torch.cat([
            _solve_entities(other, other_ids[s:s + step], ratings[s:s + step],
                            mask[s:s + step], mu, cfg, own_side, gram_dtype,
                            reg_scale)
            for s in range(0, E, step)])
    return solve_spd(*normal_equations(other, other_ids, ratings, mask, mu, cfg,
                                       own_side, gram_dtype, reg_scale))


def _check_args(cfg: SGDConfig, reg_scale: str, gram_dtype: str = "f32") -> None:
    if cfg.kernel != "linear":
        raise ValueError("factor ALS requires the linear kernel")
    if gram_dtype not in _GRAM_DTYPES:
        raise ValueError(f"gram_dtype must be one of {_GRAM_DTYPES}")
    if reg_scale not in _REG_SCALES:
        raise ValueError(f"reg_scale must be one of {_REG_SCALES}")


def _epoch_rmse(params: MFParams, data: RatingBatches, cfg: SGDConfig):
    if cfg.compute_epoch_rmse:
        return torch.sqrt(masked_sse(params, data, cfg) / max(data.n_real, 1))
    return torch.zeros((), device=params.user_features.device)


def _copy_tables(params: MFParams) -> MFParams:
    return params._replace(user_features=params.user_features.clone(),
                           item_features=params.item_features.clone())


def grouped_sweep(own: torch.Tensor, other: torch.Tensor,
                  grouped: GroupedRatings, mu: torch.Tensor, cfg: SGDConfig,
                  own_side: str, reg_scale: str = "absolute") -> torch.Tensor:
    """One half-sweep over the first E rows of ``own`` (E = the grouped
    entities), in place: entities with data get their solved factor and
    bias columns, entities without keep their rows. Returns ``own``."""
    k = cfg.n_factors
    with span("als.bucket"):
        sol = _solve_entities(other, grouped.other_ids, grouped.ratings,
                              grouped.mask, mu, cfg, own_side, "f32", reg_scale)
        with span("als.write"):
            has_data = grouped.mask.sum(dim=1) > 0
            own_b = bias_col(cfg, own_side)
            live = own[:grouped.other_ids.shape[0]]
            live[:, :k] = torch.where(has_data[:, None], sol[:, :k], live[:, :k])
            live[:, own_b] = torch.where(has_data, sol[:, k], live[:, own_b])
    return own


def bucket_sweep(own: torch.Tensor, other: torch.Tensor, bucket: Bucket,
                 mu: torch.Tensor, cfg: SGDConfig, own_side: str,
                 gram_dtype: str = "f32",
                 reg_scale: str = "absolute") -> torch.Tensor:
    """One bucket's solves written into ``own`` at its entity ids (each
    has data), in place. Returns ``own``."""
    k = cfg.n_factors
    with span("als.bucket"):
        sol = _solve_entities(other, bucket.other_ids, bucket.ratings,
                              bucket.mask, mu, cfg, own_side, gram_dtype,
                              reg_scale)
        with span("als.write"):
            rows = bucket.entity_ids.long()
            own[rows, :k] = sol[:, :k]
            own[rows, bias_col(cfg, own_side)] = sol[:, k]
    return own


def ials_train(
    params: MFParams,
    by_user: Optional[GroupedRatings],
    by_item: Optional[GroupedRatings],
    data: Optional[RatingBatches],
    cfg: SGDConfig,
    n_epochs: int,
    update_user_params: bool = True,
    update_item_params: bool = True,
    reg_scale: str = "absolute",
) -> Tuple[MFParams, torch.Tensor]:
    """Alternate exact user and item sweeps on copies of ``params``'
    tables; returns (params, per-epoch train RMSE over ``data`` as one
    (n_epochs,) device tensor, zeros when ``cfg.compute_epoch_rmse`` is
    false, and then ``data`` may be ``None``). A frozen side's grouping
    may be ``None``."""
    _check_args(cfg, reg_scale)
    p = _copy_tables(params)
    hist = []
    for _ in range(n_epochs):
        with span("als.epoch"):
            if update_user_params:
                grouped_sweep(p.user_features, p.item_features, by_user,
                              p.global_mean, cfg, "user", reg_scale)
            if update_item_params:
                grouped_sweep(p.item_features, p.user_features, by_item,
                              p.global_mean, cfg, "item", reg_scale)
            hist.append(_epoch_rmse(p, data, cfg))
    return p, _stack(hist, p)


def _stack(hist: list, p: MFParams) -> torch.Tensor:
    if not hist:
        return torch.zeros(0, device=p.user_features.device)
    return torch.stack(hist)


def ials_train_bucketed(
    params: MFParams,
    buckets_user: list,
    buckets_item: list,
    data: Optional[RatingBatches],
    cfg: SGDConfig,
    n_epochs: int,
    update_user_params: bool = True,
    update_item_params: bool = True,
    gram_dtype: str = "f32",
    reg_scale: str = "absolute",
) -> Tuple[MFParams, torch.Tensor]:
    """``ials_train`` over count buckets (``group_by_entity_bucketed``):
    one solve per bucket chunk, so the gathers stay bounded at any scale.
    ``gram_dtype``: see :func:`_gram`; ``reg_scale``: :func:`_reg_diag`."""
    _check_args(cfg, reg_scale, gram_dtype)
    p = _copy_tables(params)
    hist = []
    for _ in range(n_epochs):
        with span("als.epoch"):
            if update_user_params:
                for b in buckets_user:
                    bucket_sweep(p.user_features, p.item_features, b,
                                 p.global_mean, cfg, "user", gram_dtype,
                                 reg_scale)
            if update_item_params:
                for b in buckets_item:
                    bucket_sweep(p.item_features, p.user_features, b,
                                 p.global_mean, cfg, "item", gram_dtype,
                                 reg_scale)
            hist.append(_epoch_rmse(p, data, cfg))
    return p, _stack(hist, p)


# ---------------------------------------------------------------------------
# Data-parallel ALS: each bucket's solves split over the data ranks
# ---------------------------------------------------------------------------


def _pad_bucket_for_mesh(b: Bucket, n_dev: int) -> Tuple[Bucket, np.ndarray]:
    """A bucket's entity rows padded to a multiple of ``n_dev`` (JAX
    ``_pad_bucket_for_mesh``): pads repeat ``entity_ids[0]`` with empty
    rating lists, and the (E_p,) f32 keep flags are 1 for the real
    entities, 0 for the pads at the tail. A bucket that divides is
    returned as it is."""
    E = b.entity_ids.shape[0]
    Ep = round_up(E, n_dev)
    keep = np.zeros(Ep, np.float32)
    keep[:E] = 1.0
    if Ep == E:
        return b, keep

    def pad(x, fill):
        out = torch.full((Ep,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        out[:E] = x
        return out

    return Bucket(pad(b.entity_ids, int(b.entity_ids[0])),
                  pad(b.other_ids, 0), pad(b.ratings, 0.0),
                  pad(b.mask, 0.0)), keep


def dp_bucket_sweep(own: torch.Tensor, other: torch.Tensor, bucket: Bucket,
                    keep: np.ndarray, mu: torch.Tensor, cfg: SGDConfig,
                    own_side: str, mesh,
                    reg_scale: str = "absolute") -> torch.Tensor:
    """One padded bucket's solves over the mesh's data ranks, in place: rank
    d solves the contiguous ``E_p / N`` entities ``[d * E_p / N, (d + 1) *
    E_p / N)`` with ``_solve_entities`` (Schur, the GJ leaf, refinement),
    one ``all_gather_into_tensor`` over the data group brings every rank's
    (E_p / N, k + 1) solutions in rank order, and every rank writes the
    kept rows, the same on each, so ``own`` stays replicated. The pads
    (keep 0, at the tail) are never written: an ``index_put_`` of a pad's
    row could overwrite the real entity that shares its id. Returns
    ``own``. At one rank this is ``bucket_sweep`` bit for bit (f32 grams)."""
    from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows
    from matrix_factorization_tpu_torch.parallel.mesh import (
        data_group,
        data_size_of,
        device_index,
    )

    n, d = data_size_of(mesh), device_index(mesh)
    per = bucket.entity_ids.shape[0] // n
    sl = slice(d * per, (d + 1) * per)
    sol = _solve_entities(other, bucket.other_ids[sl], bucket.ratings[sl],
                          bucket.mask[sl], mu, cfg, own_side, "f32",
                          reg_scale)
    sol = all_gather_rows(sol, data_group(mesh))
    E = int(keep.sum())
    k = cfg.n_factors
    rows = bucket.entity_ids[:E].long()
    own[rows, :k] = sol[:E, :k]
    own[rows, bias_col(cfg, own_side)] = sol[:E, k]
    return own


def dp_ials_train_bucketed(
    params: MFParams,
    buckets_user: list,
    buckets_item: list,
    data: Optional[RatingBatches],
    cfg: SGDConfig,
    n_epochs: int,
    mesh,
    reg_scale: str = "absolute",
) -> Tuple[MFParams, torch.Tensor]:
    """Data-parallel bucketed ALS (JAX ``dp_ials_train_bucketed``), run by
    every rank with the same whole tables, buckets and ``data``: both
    tables replicated, each bucket padded once to a multiple of the data
    ranks and swept by ``dp_bucket_sweep`` (the per-entity solves, the
    sweep's gram work, split; one all-gather of the solutions a bucket).
    The per-epoch train RMSE is each rank's own pass over the replicated
    ``data``. At one rank the same chunks are solved in the same order as
    ``ials_train_bucketed``, so the result is its bits. Both sides are
    updated, with f32 grams."""
    from matrix_factorization_tpu_torch.parallel.mesh import data_size_of

    _check_args(cfg, reg_scale)
    n = data_size_of(mesh)
    pu = [_pad_bucket_for_mesh(b, n) for b in buckets_user]
    pi = [_pad_bucket_for_mesh(b, n) for b in buckets_item]
    p = _copy_tables(params)
    hist = []
    for _ in range(n_epochs):
        for b, keep in pu:
            dp_bucket_sweep(p.user_features, p.item_features, b, keep,
                            p.global_mean, cfg, "user", mesh, reg_scale)
        for b, keep in pi:
            dp_bucket_sweep(p.item_features, p.user_features, b, keep,
                            p.global_mean, cfg, "item", mesh, reg_scale)
        hist.append(_epoch_rmse(p, data, cfg))
    return p, _stack(hist, p)


# ---------------------------------------------------------------------------
# Implicit feedback (confidence-weighted) ALS
# ---------------------------------------------------------------------------


def implicit_sweep(
    own: torch.Tensor,
    other: torch.Tensor,
    grouped: GroupedRatings,
    n_other_live: int,
    cfg: SGDConfig,
    alpha: float,
) -> torch.Tensor:
    """One implicit-ALS half-sweep (Hu, Koren and Volinsky 2008), in place
    on ``own``'s first E rows and k columns; returns ``own``.

    Preferences are 1 for observed pairs and 0 elsewhere, confidences
    ``c = 1 + alpha * strength``. The normal equations over all items are
    ``A_u = Y^T Y + sum_obs (c - 1) y y^T + reg I`` and
    ``b_u = sum_obs c y``: one shared k x k gram, and per-entity work only
    for observed pairs. Entities with no observations solve to zero."""
    k = cfg.n_factors
    Y = other[:n_other_live, :k]
    G = _mm(Y.T, Y)
    rows = other[:, :k][grouped.other_ids.long()]  # (E, L, k)
    cm1 = (alpha * grouped.ratings) * grouped.mask  # c - 1, masked
    A = _mm((rows * cm1[..., None]).transpose(1, 2), rows).add_(G)
    A.diagonal(dim1=-2, dim2=-1).add_(cfg.reg)
    b = _mm(rows.transpose(1, 2), ((1.0 + cm1) * grouped.mask)[..., None])[..., 0]
    own[:grouped.other_ids.shape[0], :k] = solve_spd(A, b)
    return own


def implicit_loss(P: torch.Tensor, Q: torch.Tensor, by_user: GroupedRatings,
                  n_users: int, n_items: int, cfg: SGDConfig,
                  alpha: float) -> torch.Tensor:
    """Exact confidence-weighted loss over all (user, item) pairs, a device
    scalar: ``sum_all (x.y)^2 = sum_u x_u^T (Y^T Y) x_u``, observed pairs
    add ``c (1 - x.y)^2 - (x.y)^2``, plus L2 on both tables."""
    k = cfg.n_factors
    X, Y = P[:n_users, :k], Q[:n_items, :k]
    base = (_mm(X, _mm(Y.T, Y)) * X).sum()
    rows = Q[:, :k][by_user.other_ids.long()]
    xy = _mm(rows, X[:, :, None])[..., 0]
    c = 1.0 + alpha * by_user.ratings
    obs = by_user.mask * (c * (1.0 - xy) ** 2 - xy ** 2)
    l2 = cfg.reg * ((X * X).sum() + (Y * Y).sum())
    return base + obs.sum() + l2


def implicit_als_train(
    params: MFParams,
    by_user: GroupedRatings,
    by_item: GroupedRatings,
    cfg: SGDConfig,
    n_epochs: int,
    alpha: float = 40.0,
    update_user_params: bool = True,
    update_item_params: bool = True,
) -> Tuple[MFParams, torch.Tensor]:
    """Alternating implicit sweeps on copies of ``params``' tables; returns
    (params, per-epoch loss as one (n_epochs,) device tensor, zeros when
    ``cfg.compute_epoch_rmse`` is false). The rating values in ``by_*``
    are interaction strengths; predictions are preference scores in
    ~[0, 1]."""
    if cfg.kernel != "linear":
        raise ValueError("implicit ALS requires the linear kernel")
    n_users = by_user.other_ids.shape[0]
    n_items = by_item.other_ids.shape[0]
    p = _copy_tables(params)
    P, Q = p.user_features, p.item_features
    hist = []
    for _ in range(n_epochs):
        if update_user_params:
            implicit_sweep(P, Q, by_user, n_items, cfg, alpha)
        if update_item_params:
            implicit_sweep(Q, P, by_item, n_users, cfg, alpha)
        hist.append(implicit_loss(P, Q, by_user, n_users, n_items, cfg, alpha)
                    if cfg.compute_epoch_rmse
                    else torch.zeros((), device=P.device))
    return p, _stack(hist, p)
