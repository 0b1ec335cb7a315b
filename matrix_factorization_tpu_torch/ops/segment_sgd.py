"""Bias-folded factor tables, the rating pack, mini-batch SGD and pair
prediction (PyTorch port).

Counterpart of ``matrix_factorization_tpu/ops/segment_sgd.py``. The
tables keep the JAX package's layout, so that checkpoints carry across:
the user/item biases live in two of the padding columns,
``user_ext = [p_0..p_K, b_u, 1]`` and ``item_ext = [q_0..q_K, 1, b_i]``,
rows are padded to ``SGDConfig.padded_factors`` columns, and the kernel's
linear sum ``mu + b_u + b_i + <p, q>`` is one row dot. For the rbf kernel
(no bias or mean terms) the extension columns stay zero.

Training keeps the JAX package's semantics and leaves its TPU design
behind (the one-hot MXU tiles, the stash lanes, the tile cost model and
the wire encoders):

* ``pack_ratings`` is the same numpy pack, byte for byte: one host
  shuffle from ``default_rng(shuffle_seed)``, the chunk sorts of the
  ``item``/``user``/``block`` orders, weight-0 pads, every batch sorted
  by its primary side, and the secondary side's stable per-batch argsort
  (``sec_perm``, ``sec_ids_sorted``). The tensors go to the device.
* A step (``minibatch_update``) reads the pre-step tables for every row
  and sums the deltas of one row, exactly as the JAX step does; only the
  float summation order differs. On the card it is two hand-written
  kernels: the fused primary step (``ops/cuda_sgd.py``), which updates
  the primary table in place, then the deterministic apply of the
  secondary deltas (``ops/segment_sum.py::segment_apply``). On the CPU,
  their plain versions.
* An epoch visits the batches in a per-epoch random order
  (``shuffle='batch'``), the pack order (``'none'``) or re-permutes every
  element (``'full'``, the reference's per-epoch shuffle); randomness
  comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.config import LANE, SUBLANE, SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.data.loader import host_lib, native_threads
from matrix_factorization_tpu_torch.ops import cuda_sgd, segment_sum
from matrix_factorization_tpu_torch.utils.profiling import span

class MFParams(NamedTuple):
    """Model state (capacity-padded, bias-folded tables).

    ``user_features (U, Kp)`` / ``item_features (I, Kp)``: columns
    ``[0, n_factors)`` are the latent factors, column ``n_factors`` holds
    the user bias / the constant 1, column ``n_factors+1`` holds the
    constant 1 / the item bias (zero for rbf). The remaining padding
    columns are zero.
    """

    user_features: torch.Tensor
    item_features: torch.Tensor
    global_mean: torch.Tensor  # f32 scalar


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bias_col(cfg: SGDConfig, side: str) -> int:
    """Column index of the bias in the extended factor row."""
    return cfg.n_factors if side == "user" else cfg.n_factors + 1


def const_col(cfg: SGDConfig, side: str) -> int:
    return cfg.n_factors + 1 if side == "user" else cfg.n_factors


def padded_width(cfg: SGDConfig) -> int:
    """Lane-padded row width with room for the two extension columns."""
    return cfg.padded_factors


def update_mask(cfg: SGDConfig, side: str) -> np.ndarray:
    """1.0 on columns this side may update (factors + own bias), 0 on the
    constant column and padding."""
    m = np.zeros(padded_width(cfg), np.float32)
    m[: cfg.n_factors] = 1.0
    if cfg.kernel != "rbf":
        m[bias_col(cfg, side)] = 1.0
    return m


def init_params(
    generator: torch.Generator,
    n_users: int,
    n_items: int,
    cfg: SGDConfig,
    global_mean: float,
    init_mean: float = 0.0,
    init_sd: float = 0.1,
    user_capacity: Optional[int] = None,
    item_capacity: Optional[int] = None,
) -> MFParams:
    """Zero biases + N(init_mean, init_sd) factors
    (reference kernel_matrix_factorization.py:93-102), bias-folded, on the
    generator's device. The layout and distribution are the JAX
    package's; the random bits are not."""
    ucap = round_up(user_capacity or n_users, SUBLANE)
    icap = round_up(item_capacity or n_items, SUBLANE)
    kp = padded_width(cfg)
    device = generator.device

    def table(cap, side):
        f = torch.zeros((cap, kp), dtype=torch.float32, device=device)
        f[:, : cfg.n_factors] = init_mean + init_sd * torch.randn(
            (cap, cfg.n_factors), generator=generator, device=device)
        if cfg.kernel != "rbf":
            f[:, const_col(cfg, side)] = 1.0
        return f

    return MFParams(
        user_features=table(ucap, "user"),
        item_features=table(icap, "item"),
        global_mean=torch.tensor(global_mean, dtype=torch.float32, device=device),
    )


def fresh_user_rows(generator: torch.Generator, n: int, cfg: SGDConfig,
                    init_mean: float, init_sd: float) -> torch.Tensor:
    """Rows for new or re-initialised users, on the generator's device:
    zero bias, fresh N(init_mean, init_sd) factors, const 1
    (reference ``kernel_matrix_factorization.py:189-210``)."""
    device = generator.device
    f = torch.zeros((n, padded_width(cfg)), dtype=torch.float32, device=device)
    f[:, : cfg.n_factors] = init_mean + init_sd * torch.randn(
        (n, cfg.n_factors), generator=generator, device=device)
    if cfg.kernel != "rbf":
        f[:, const_col(cfg, "user")] = 1.0
    return f


def params_from_numpy(
    user_features: np.ndarray,
    item_features: np.ndarray,
    global_mean,
    device=None,
    cfg: Optional[SGDConfig] = None,
) -> MFParams:
    """The port's ``MFParams`` from the JAX package's tables as numpy
    arrays (e.g. a checkpoint's ``arrays.npz``), on ``device``.

    Both tables must be 2-D with one width, a positive multiple of
    ``LANE``; with ``cfg`` the width must be ``cfg.padded_factors``."""
    dev = resolve_device(device)
    # copies: training updates the tables in place, and must not write
    # through to the caller's arrays
    P = np.array(user_features, dtype=np.float32, order="C")
    Q = np.array(item_features, dtype=np.float32, order="C")
    if P.ndim != 2 or Q.ndim != 2 or P.shape[1] != Q.shape[1]:
        raise ValueError(
            f"tables must be 2-D with one width, got {P.shape} and {Q.shape}")
    kp = P.shape[1]
    want = cfg.padded_factors if cfg is not None else None
    if kp % LANE or kp == 0 or (want is not None and kp != want):
        raise ValueError(
            f"table width {kp} is not the padded width "
            f"{want if want is not None else f'(a multiple of {LANE})'}")
    return MFParams(
        user_features=torch.from_numpy(P).to(dev),
        item_features=torch.from_numpy(Q).to(dev),
        global_mean=torch.tensor(float(np.asarray(global_mean)),
                                 dtype=torch.float32, device=dev),
    )


# ---------------------------------------------------------------------------
# The rating pack (host, numpy)
# ---------------------------------------------------------------------------


@dataclass
class RatingBatches:
    """Rating stream packed as (n_batches, batch_size) blocks on a device.

    When ``sec_perm`` is set (``pack_ratings(aggregate=True)``, the
    default), every batch is stored sorted by the ``primary`` side's id,
    stably, and ``sec_perm`` / ``sec_ids_sorted`` are each batch's stable
    argsort of the secondary ids and those ids in sorted order: the runs
    the two step kernels walk. Without them the step sorts the batch on
    the device first."""

    user_ids: torch.Tensor  # (nb, bs) int32
    item_ids: torch.Tensor  # (nb, bs) int32
    ratings: torch.Tensor  # (nb, bs) f32
    weights: torch.Tensor  # (nb, bs) f32, 1.0 real / 0.0 pad
    n_real: int
    # which side the batches are stored sorted by: 'item' | 'user'
    primary: str = "item"
    sec_ids_sorted: Optional[torch.Tensor] = None  # (nb, bs) int32
    sec_perm: Optional[torch.Tensor] = None  # (nb, bs) int32

    @property
    def n_batches(self) -> int:
        return self.user_ids.shape[0]

    @property
    def batch_size(self) -> int:
        return self.user_ids.shape[1]


def block_geometry(n_users: int, n_items: int, n_ratings: int,
                   batch_size: int) -> Tuple[int, int]:
    """Cell sizes (W_u, W_i) for ``pack_ratings(order='block')``: a cell
    holds about ``batch_size`` expected ratings, W_u about W_i / 2,
    power-of-two rounded and clamped to the table sizes (the JAX
    package's geometry, kept so that the packs agree)."""
    density = max(n_ratings, 1) / (max(n_users, 1) * max(n_items, 1))
    wi = (2.0 * batch_size / density) ** 0.5
    wi = 1 << max(5, int(round(np.log2(max(wi, 32)))))
    wu = max(32, wi // 2)
    return min(wu, round_up(n_users, 32)), min(wi, round_up(n_items, 32))


def _key_count(key: np.ndarray, n_keys: Optional[int] = None) -> int:
    """The native counting sorts index a count array by the key, so every
    key must lie in ``[0, n_keys)`` (``n_keys`` = the largest key + 1 when
    not given): the number of keys, or ``ValueError``. The count arrays
    take O(n_keys) memory a thread, so the ids are meant to be dense."""
    if not len(key):
        return int(n_keys or 0)
    lo, hi = int(key.min()), int(key.max())
    n_keys = hi + 1 if n_keys is None else int(n_keys)
    if lo < 0 or hi >= n_keys:
        raise ValueError(f"sort keys must lie in [0, {n_keys}); got [{lo}, {hi}]")
    return n_keys


def sort_stream_by_key(key: np.ndarray, u: np.ndarray, i: np.ndarray,
                       r: np.ndarray, n_keys: int, native: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(u, i, r) stably sorted by the dense ``key`` in [0, n_keys): the
    native counting sort (``mf_sort_triple_by_key``), or numpy's stable
    argsort with ``native=False``; the bytes are equal."""
    n = len(key)
    if native and n:
        u_s = np.empty(n, np.int32)
        i_s = np.empty(n, np.int32)
        r_s = np.empty(n, np.float32)
        host_lib().mf_sort_triple_by_key(
            np.ascontiguousarray(key, np.int32), np.ascontiguousarray(u, np.int32),
            np.ascontiguousarray(i, np.int32), np.ascontiguousarray(r, np.float32),
            n, _key_count(key, n_keys), u_s, i_s, r_s)
        return u_s, i_s, r_s
    order = np.argsort(key, kind="stable")
    return u[order], i[order], r[order]


def _sort_ranges(u, i, r, w, starts, ends, key_is_item: bool,
                 native: bool) -> None:
    """Stable in-place sort of every ``[start, end)`` range of the four
    flat columns by the user or item id: the threaded native counting
    sort (``mf_sort_ranges``), or numpy's stable argsort per range."""
    key = i if key_is_item else u
    if native:
        host_lib().mf_sort_ranges(u, i, r, w, starts, ends, len(starts),
                                  int(key_is_item), _key_count(key),
                                  native_threads())
        return
    for lo, hi in zip(starts, ends):
        srt = np.argsort(key[lo:hi], kind="stable")
        u[lo:hi] = u[lo:hi][srt]
        i[lo:hi] = i[lo:hi][srt]
        r[lo:hi] = r[lo:hi][srt]
        w[lo:hi] = w[lo:hi][srt]


def _argsort_batches(sec: np.ndarray, native: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-batch stable (argsort perm, sorted keys) of (nb, bs) ids: the
    threaded native counting argsort (``mf_argsort_ranges``) or numpy's."""
    if not native:
        ssort = np.argsort(sec, axis=1, kind="stable").astype(np.int32)
        return ssort, np.take_along_axis(sec, ssort, axis=1)
    nb, bs = sec.shape
    starts = np.arange(nb, dtype=np.int64) * bs
    perm = np.empty(nb * bs, np.int32)
    srt = np.empty(nb * bs, np.int32)
    host_lib().mf_argsort_ranges(
        np.ascontiguousarray(sec.reshape(-1), np.int32), starts, starts + bs,
        nb, _key_count(sec), perm, srt, native_threads())
    return perm.reshape(nb, bs), srt.reshape(nb, bs)


def pack_ratings(
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    ratings: np.ndarray,
    batch_size: int,
    shuffle_seed: Optional[int] = 0,
    order: str = "shuffle",
    aggregate: bool = True,
    item_sort_chunks: int = 8,
    n_dev: int = 1,
    users_per_dev: Optional[int] = None,
    segment: Optional[int] = None,
    user_block: Optional[int] = None,
    item_block: Optional[int] = None,
    device=None,
    native: bool = True,
) -> RatingBatches:
    """Host-side packing into (nb, bs) blocks, shuffled once, on
    ``device`` (``None`` = CUDA).

    The JAX package's ``pack_ratings`` without its TPU tile metadata; the
    ids, ratings, weights and ``primary`` come out equal to its leaves.
    ``order='shuffle'`` keeps the shuffled stream; ``'item'`` / ``'user'``
    split it into ``item_sort_chunks`` chunks of whole batches and sort
    each by that id, so batches cover narrow id windows while every id
    still gets several spread-out updates an epoch; ``'auto'`` picks the
    side with more ids; ``'block'`` sorts by (user block, item block)
    cell (``block_geometry``) and pads each user block to whole batches.
    ``aggregate`` stores every batch sorted by the primary side (the
    chunk-sort side, ``item`` for ``shuffle``) with the secondary side's
    stable argsort. Pads have weight 0 and repeat the tail of the real
    stream, so they keep its local id distribution.

    ``n_dev > 1`` packs device-major for the data-parallel trainers
    (``parallel/distributed.py``): device d owns users ``[d *
    users_per_dev, (d + 1) * users_per_dev)``, its user ids are local to
    it, each device's ratings are shuffled apart (``default_rng((
    shuffle_seed, d))``) and padded to one whole number of batches common
    to all (batches ``[d * nb_local, (d + 1) * nb_local)`` are device d's),
    and the chunk sorts stay inside a device's segment; ``'auto'`` then
    compares ``users_per_dev`` with the item ids, and ``'block'`` raises.
    ``segment=d`` packs device d's segment alone: its batches of the
    whole pack byte for byte (``n_real`` stays the whole stream's), at
    1 / n_dev of the host work, so each rank packs only its own.
    The shuffle's gather and every sort run in the native host library
    (``csrc/host_loader.cpp``: threaded counting sorts); ``native=False``
    runs numpy's instead, with equal bytes. The counting sorts take dense
    ids: a negative id raises ``ValueError`` before it reaches them.
    """
    dev = resolve_device(device)
    n = int(len(ratings))
    if order == "auto" and n > 0:
        max_u = (users_per_dev - 1 if n_dev > 1 and users_per_dev
                 else int(user_ids.max()))
        order = "user" if max_u > int(item_ids.max()) else "item"
    elif order == "auto":
        order = "item"
    if order not in ("shuffle", "item", "user", "block"):
        raise ValueError(f"unknown pack order {order!r}")
    if order == "block" and n > 1:
        if n_dev > 1:
            raise ValueError("order='block' is a single-device layout; "
                             "the dp trainers use device-major packs")
        nu_est = int(user_ids.max()) + 1
        ni_est = int(item_ids.max()) + 1
        if user_block is None or item_block is None:
            wu, wi = block_geometry(nu_est, ni_est, n, batch_size)
            user_block = user_block or wu
            item_block = item_block or wi
        if shuffle_seed is not None:
            perm = np.random.default_rng(shuffle_seed).permutation(n)
            user_ids = user_ids[perm]
            item_ids = item_ids[perm]
            ratings = ratings[perm]
        nib = -(-ni_est // item_block)
        # item order first, then a stable sort by cell: within a cell the
        # rows are item-sorted, so a batch that cuts a cell sees a compact
        # item range on each side of the cut
        user_ids, item_ids, ratings = sort_stream_by_key(
            item_ids.astype(np.int32), user_ids.astype(np.int32),
            item_ids.astype(np.int32), ratings.astype(np.float32), ni_est,
            native)
        cell = ((user_ids.astype(np.int64) // user_block) * nib
                + item_ids // item_block).astype(np.int32)
        user_ids, item_ids, ratings = sort_stream_by_key(
            cell, user_ids, item_ids, ratings, int(cell.max()) + 1, native)
        # each user-block row padded to whole batches (weight-0 tail
        # resamples), so no batch crosses a user block
        ub = user_ids // user_block
        ub_counts = np.bincount(ub, minlength=int(ub.max()) + 1)
        padded = np.where(
            ub_counts > 0,
            (ub_counts + batch_size - 1) // batch_size * batch_size, 0)
        n_pad_total = int(padded.sum())
        u2 = np.zeros(n_pad_total, np.int32)
        i2 = np.zeros(n_pad_total, np.int32)
        r2 = np.zeros(n_pad_total, np.float32)
        w2 = np.zeros(n_pad_total, np.float32)
        src = dst = 0
        for b, c in enumerate(ub_counts):
            c = int(c)
            if c == 0:
                continue
            p = int(padded[b])
            u2[dst:dst + c] = user_ids[src:src + c]
            i2[dst:dst + c] = item_ids[src:src + c]
            r2[dst:dst + c] = ratings[src:src + c]
            w2[dst:dst + c] = 1.0
            if p > c:
                tail = min(c, p - c)
                u2[dst + c:dst + p] = np.resize(
                    user_ids[src + c - tail:src + c], p - c)
                i2[dst + c:dst + p] = np.resize(
                    item_ids[src + c - tail:src + c], p - c)
            src += c
            dst += p
        return _pack_preformed(u2, i2, r2, w2, n, batch_size, "user",
                               aggregate, dev, native)
    if segment is not None and not 0 <= segment < n_dev:
        raise ValueError(f"segment {segment} is not a device of {n_dev}")
    n_segs = n_dev if segment is None else 1
    if n_dev > 1:
        if not users_per_dev:
            raise ValueError("n_dev > 1 needs users_per_dev")
        u, i, r, w = _device_major(user_ids, item_ids, ratings, batch_size,
                                   shuffle_seed, n_dev, users_per_dev, native,
                                   segment)
    else:
        u, i, r, w = _shuffled_padded(user_ids, item_ids, ratings, batch_size,
                                      shuffle_seed, native)
    n_pad = len(u)
    nb = n_pad // batch_size
    if order in ("item", "user") and n > 1:
        # chunk bounds are batch bounds and never cross a device segment;
        # pads carry weight 0
        nb_local = nb // n_segs
        chunks = max(1, min(item_sort_chunks, nb_local))
        step = -(-nb_local // chunks) * batch_size
        seg = nb_local * batch_size
        rel = np.arange(0, seg, step, dtype=np.int64)
        offs = np.arange(n_segs, dtype=np.int64)[:, None] * seg
        starts = (offs + rel[None, :]).reshape(-1)
        ends = (offs + np.minimum(rel + step, seg)[None, :]).reshape(-1)
        _sort_ranges(u, i, r, w, starts, ends, order == "item", native)
    primary = order if order in ("item", "user") else "item"
    return _pack_preformed(u, i, r, w, n, batch_size, primary, aggregate, dev,
                           native)


def _gather_into(user_ids, item_ids, ratings, perm, u, i, r,
                 native: bool) -> None:
    """``(u, i, r)[:] = (user_ids, item_ids, ratings)[perm]``: one
    threaded native gather, or numpy's."""
    if native:
        host_lib().mf_gather_rows(
            np.ascontiguousarray(user_ids, np.int32),
            np.ascontiguousarray(item_ids, np.int32),
            np.ascontiguousarray(ratings, np.float32),
            perm, len(perm), u, i, r, native_threads())
    else:
        u[:] = user_ids[perm]
        i[:] = item_ids[perm]
        r[:] = ratings[perm]


def _shuffled_padded(user_ids, item_ids, ratings, batch_size: int,
                     shuffle_seed, native: bool):
    """The single-device stream: shuffled once, padded to whole batches
    with weight-0 repeats of its tail."""
    n = int(len(ratings))
    n_pad = max(batch_size, round_up(n, batch_size))
    pad = n_pad - n
    u = np.empty(n_pad, np.int32)
    i = np.empty(n_pad, np.int32)
    r = np.empty(n_pad, np.float32)
    if shuffle_seed is not None and n > 1:
        perm = np.random.default_rng(shuffle_seed).permutation(n)
        _gather_into(user_ids, item_ids, ratings, perm, u[:n], i[:n], r[:n],
                     native)
    else:
        u[:n] = user_ids
        i[:n] = item_ids
        r[:n] = ratings
    if pad:
        tail = min(n, max(pad, 1))
        u[n:] = np.resize(u[n - tail:n], pad) if n else 0
        i[n:] = np.resize(i[n - tail:n], pad) if n else 0
        r[n:] = 0.0
    w = np.empty(n_pad, np.float32)
    w[:n] = 1.0
    w[n:] = 0.0
    return u, i, r, w


def _device_major(user_ids, item_ids, ratings, batch_size: int, shuffle_seed,
                  n_dev: int, users_per_dev: int, native: bool,
                  segment: Optional[int] = None):
    """The device-major stream of ``pack_ratings(n_dev > 1)``: device d's
    segment holds its users' ratings (local user ids), shuffled apart and
    padded with weight-0 repeats of its own tail to the common length.
    With ``segment``, that device's segment alone (its ratings picked out
    in stream order, which is what the stable sort by device gives it)."""
    dev = (np.asarray(user_ids).astype(np.int64) // users_per_dev).astype(np.int32)
    cols = (np.asarray(user_ids, np.int32), np.asarray(item_ids, np.int32),
            np.asarray(ratings, np.float32))
    counts = np.bincount(dev, minlength=n_dev)
    if segment is None:
        us, is_, rs = sort_stream_by_key(dev, *cols, n_dev, native)
        devs = range(n_dev)
    else:
        sel = np.flatnonzero(dev == segment)
        us, is_, rs = (a[sel] for a in cols)
        devs = [segment]
    n_pad_local = max(batch_size, round_up(max(int(counts.max()), 1), batch_size))
    n_pad = len(devs) * n_pad_local
    u = np.zeros(n_pad, np.int32)
    i = np.zeros(n_pad, np.int32)
    r = np.zeros(n_pad, np.float32)
    w = np.zeros(n_pad, np.float32)
    start = 0
    for s, d in enumerate(devs):
        c = int(counts[d])
        sl, off = slice(start, start + c), s * n_pad_local
        out = slice(off, off + c)
        if shuffle_seed is not None and c > 1:
            perm = np.random.default_rng((shuffle_seed, d)).permutation(c)
            _gather_into(us[sl], is_[sl], rs[sl], perm, u[out], i[out], r[out],
                         native)
        else:
            u[out], i[out], r[out] = us[sl], is_[sl], rs[sl]
        u[out] -= d * users_per_dev
        w[out] = 1.0
        padl = n_pad_local - c
        if padl and c:  # weight-0 repeats of the device's own tail
            tail = min(c, padl)
            u[off + c:off + n_pad_local] = np.resize(u[off + c - tail:off + c], padl)
            i[off + c:off + n_pad_local] = np.resize(i[off + c - tail:off + c], padl)
        start += c
    return u, i, r, w


def _pack_preformed(u, i, r, w, n_real: int, batch_size: int, primary: str,
                    aggregate: bool, device: torch.device,
                    native: bool) -> RatingBatches:
    """Flat padded (u, i, r, w) in final stream order -> batches, sorted
    by the primary side with the secondary argsort when ``aggregate``,
    as int32 / f32 tensors on ``device``."""
    nb = u.shape[0] // batch_size
    extra = {}
    if aggregate and n_real > 0:
        starts = np.arange(nb, dtype=np.int64) * batch_size
        _sort_ranges(u, i, r, w, starts, starts + batch_size,
                     primary == "item", native)
        sec = (u if primary == "item" else i).reshape(nb, batch_size)
        ssort, ss = _argsort_batches(sec, native)
        extra = {"sec_ids_sorted": ss, "sec_perm": ssort}
    u = u.reshape(nb, batch_size)
    i = i.reshape(nb, batch_size)
    r = r.reshape(nb, batch_size)
    w = w.reshape(nb, batch_size)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return RatingBatches(
        put(u, np.int32), put(i, np.int32), put(r, np.float32),
        put(w, np.float32), n_real, primary=primary,
        **{k: put(v, np.int32) for k, v in extra.items()})


# ---------------------------------------------------------------------------
# Forward and gradients on extended rows
# ---------------------------------------------------------------------------


def ext_forward(cfg: SGDConfig, mu, pu, qi) -> torch.Tensor:
    """Kernel forward on bias-folded rows (biases ride inside the dot)."""
    if cfg.kernel == "rbf":
        d = pu - qi
        power = -cfg.gamma * torch.sum(d * d, dim=-1)
        return cfg.a + cfg.c * torch.exp(power)
    x = mu + torch.sum(pu * qi, dim=-1)
    if cfg.kernel == "linear":
        return x
    if cfg.kernel == "sigmoid":
        return cfg.a + cfg.c * torch.sigmoid(x)
    raise ValueError(f"unknown kernel {cfg.kernel!r}")


def ext_forward_and_rowgrads(cfg: SGDConfig, mu, pu, qi):
    """(pred, d_pu, d_qi) with the reference's gradient convention
    (``c`` left out of the sigmoid and rbf gradients, PARITY.md #4)."""
    if cfg.kernel == "rbf":
        d = pu - qi
        power = -cfg.gamma * torch.sum(d * d, dim=-1)
        e = torch.exp(power)
        pred = cfg.a + cfg.c * e
        base = (2.0 * cfg.gamma) * e
        d_pu = -d * base[:, None]
        return pred, d_pu, -d_pu
    x = mu + torch.sum(pu * qi, dim=-1)
    if cfg.kernel == "linear":
        return x, qi, pu
    if cfg.kernel == "sigmoid":
        sig = torch.sigmoid(x)
        pred = cfg.a + cfg.c * sig
        base = sig * (1.0 - sig)
        return pred, qi * base[:, None], pu * base[:, None]
    raise ValueError(f"unknown kernel {cfg.kernel!r}")


# ---------------------------------------------------------------------------
# One mini-batch step
# ---------------------------------------------------------------------------


def mask_tensor(cfg: SGDConfig, side: str, device) -> torch.Tensor:
    """``update_mask`` built on ``device`` from comparisons, so that a
    CUDA caller makes no host-to-device copy (which waits)."""
    cols = torch.arange(padded_width(cfg), device=device)
    m = cols < cfg.n_factors
    if cfg.kernel != "rbf":
        m |= cols == bias_col(cfg, side)
    return m.float()


def sgd_minibatch_step(params: MFParams, u: torch.Tensor, i: torch.Tensor,
                       r: torch.Tensor, w: torch.Tensor, cfg: SGDConfig,
                       lr: float) -> MFParams:
    """One synchronous mini-batch update with summed per-example deltas,
    as gathers and ``index_add`` (out of place; the inputs stay as they
    are): per rating ``delta_p = -lr * (err * dpred/dp + reg * w * p)``
    under the column masks, as the reference's single-step updates
    (``kernels.py:156-178`` et al.); colliding rows sum."""
    pu = params.user_features[u.long()]
    qi = params.item_features[i.long()]
    pred, d_pu, d_qi = ext_forward_and_rowgrads(cfg, params.global_mean, pu, qi)
    err = (pred - r) * w
    new = params
    if cfg.update_user_params:
        m = mask_tensor(cfg, "user", pu.device)
        g = (err[:, None] * d_pu + (cfg.reg * w)[:, None] * pu) * m[None, :]
        new = new._replace(user_features=new.user_features.index_add(
            0, u.long(), -lr * g))
    if cfg.update_item_params:
        m = mask_tensor(cfg, "item", qi.device)
        g = (err[:, None] * d_qi + (cfg.reg * w)[:, None] * qi) * m[None, :]
        new = new._replace(item_features=new.item_features.index_add(
            0, i.long(), -lr * g))
    return new


def minibatch_update(params: MFParams, b: dict, cfg: SGDConfig, lr: float,
                     primary: str, masks: Optional[dict] = None,
                     reg: Optional[float] = None,
                     write: Optional[dict] = None) -> MFParams:
    """One synchronous mini-batch update, IN PLACE on ``params``' tables
    (which it returns): the counterpart of the JAX ``_minibatch_update``.

    ``b`` holds the batch's ``u``, ``i``, ``r``, ``w`` (bs,) and, when the
    batch is stored sorted by the ``primary`` side, the secondary argsort
    ``sp`` and sorted ids ``ss``; without them the batch is sorted here
    first (stable ``torch.sort`` by the primary id, then the secondary's
    stable argsort). The step kernel updates the primary table from the
    pre-step rows and emits the secondary deltas, which the apply kernel
    then adds; on CPU tensors their plain versions do the same. A frozen
    side (``cfg.update_item_params`` / ``update_user_params`` false) is
    neither written nor, for the secondary side, given deltas. ``masks``
    may carry the ``user`` and ``item`` update masks on the tables'
    device; ``reg``, when given, replaces ``cfg.reg``.

    ``write`` (the data-parallel trainers, ``parallel/distributed.py``)
    maps each side to the table its deltas are added to, in place of the
    side's own table: the step reads ``params``' tables as they stand
    before it, and a side whose ``write`` is another table (a window's
    delta table) is only read (the step kernel's accumulator mode on the
    primary side, the apply into that table on the secondary side). A
    side whose ``write`` is None is frozen."""
    prim_is_user = primary == "user"
    prim_side, sec_side = ("user", "item") if prim_is_user else ("item", "user")
    tables = {"user": params.user_features, "item": params.item_features}
    out = tables if write is None else write
    upd = {"user": cfg.update_user_params and out["user"] is not None,
           "item": cfg.update_item_params and out["item"] is not None}
    if not (upd["user"] or upd["item"]):
        return params
    u, i, r, w = b["u"], b["i"], b["r"], b["w"]
    prim_ids, sec_ids = (u, i) if prim_is_user else (i, u)
    if "sp" in b:
        sp, ss = b["sp"], b["ss"]
    else:
        prim_ids, order = torch.sort(prim_ids, stable=True)
        sec_ids, r, w = sec_ids[order], r[order], w[order]
        ss, sp = torch.sort(sec_ids, stable=True)
        sp = sp.to(torch.int32)
    dev = tables["user"].device
    if masks is None:
        masks = {s: mask_tensor(cfg, s, dev) for s in ("user", "item")}
    prim_out = out[prim_side]
    with span("sgd.step"):
        dq = cuda_sgd.sgd_step(
            cfg, params.global_mean, tables[prim_side], tables[sec_side],
            prim_ids, sec_ids, r, w, masks[prim_side], masks[sec_side], lr,
            cfg.reg if reg is None else reg,
            update_prim=upd[prim_side], write_dq=upd[sec_side],
            prim_out=None if prim_out is tables[prim_side] else prim_out)
    if upd[sec_side]:
        with span("sgd.apply"):
            segment_sum.segment_apply(out[sec_side], dq, sp, ss)
    return params


# ---------------------------------------------------------------------------
# Epoch and multi-epoch drivers
# ---------------------------------------------------------------------------


def batch_at(data: RatingBatches, k: int) -> dict:
    """Batch ``k`` of ``data`` as the dict ``minibatch_update`` takes
    (views, no copies)."""
    b = {"u": data.user_ids[k], "i": data.item_ids[k],
         "r": data.ratings[k], "w": data.weights[k]}
    if data.sec_perm is not None:
        b["sp"], b["ss"] = data.sec_perm[k], data.sec_ids_sorted[k]
    return b


def seeded_generator(device, *entropy) -> torch.Generator:
    """A generator on ``device`` seeded from integers, as ``fold_in`` keys
    the JAX package's streams (numpy's ``SeedSequence`` mixes them)."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0] & (2**63 - 1))
    return torch.Generator(device=device).manual_seed(seed)


def _perm(n: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randperm(n, generator=generator, device=generator.device)


def _as_index(order, device) -> torch.Tensor:
    """A permutation given as a tensor, array or list, as int64 on
    ``device``."""
    if torch.is_tensor(order):
        return order.to(device=device, dtype=torch.long)
    return torch.from_numpy(np.array(order, dtype=np.int64)).to(device)


def draw_order(given, e: int, n: int, generator, device) -> torch.Tensor:
    """Epoch ``e``'s permutation of ``n`` as int64 on ``device``:
    ``given[e]`` when ``given`` (one permutation an epoch) is not None,
    else ``torch.randperm`` from ``generator``."""
    return _as_index(given[e] if given is not None else _perm(n, generator),
                     device)


def epoch(params: MFParams, data: RatingBatches, cfg: SGDConfig, lr: float,
          generator: Optional[torch.Generator] = None,
          order=None, reg: Optional[float] = None) -> MFParams:
    """One epoch of ``minibatch_update`` over ``data``, in place.

    ``cfg.shuffle``: ``'batch'`` visits the batches in a random order,
    ``'none'`` in pack order, ``'full'`` re-permutes every element of the
    padded stream (the reference's per-epoch shuffle; the batches are
    then sorted on the device). ``order``, when given, is that
    permutation (of the batches for ``'batch'``, of the nb * bs elements
    for ``'full'``); otherwise it is drawn from ``generator`` with
    ``torch.randperm``. Under ``'batch'`` a CPU generator keeps the
    order on the host, so the epoch never waits for the device. ``reg``,
    when given, replaces ``cfg.reg``."""
    nb, bs = data.n_batches, data.batch_size
    dev = data.user_ids.device
    masks = {s: mask_tensor(cfg, s, dev) for s in ("user", "item")}

    def step(b):
        minibatch_update(params, b, cfg, lr, data.primary, masks, reg)

    if cfg.shuffle == "full":
        perm = _as_index(order if order is not None
                         else _perm(nb * bs, generator), dev)
        flat = {k: t.reshape(-1)[perm].reshape(nb, bs) for k, t in (
            ("u", data.user_ids), ("i", data.item_ids), ("r", data.ratings),
            ("w", data.weights))}
        for k in range(nb):
            step({name: t[k] for name, t in flat.items()})
        return params
    if cfg.shuffle == "batch":
        visit = _as_index(order if order is not None
                          else _perm(nb, generator), "cpu").tolist()
    elif cfg.shuffle == "none":
        visit = range(nb)
    else:
        raise ValueError(f"unknown shuffle {cfg.shuffle!r}")
    for k in visit:
        step(batch_at(data, k))
    return params


def masked_sse(params: MFParams, data: RatingBatches, cfg: SGDConfig,
               chunk: int = 1 << 18) -> torch.Tensor:
    """Sum of squared errors over the (padded) rating stream, a device
    scalar, in chunks of ``chunk`` ratings so that the row gathers stay
    bounded. The reference's per-epoch full train pass
    (``kernel_matrix_factorization.py:428-440``)."""
    with span("sgd.rmse"):
        u, i = data.user_ids.reshape(-1), data.item_ids.reshape(-1)
        r, w = data.ratings.reshape(-1), data.weights.reshape(-1)
        acc = torch.zeros((), dtype=torch.float32, device=u.device)
        for lo in range(0, u.numel(), chunk):
            sl = slice(lo, lo + chunk)
            pred = ext_forward(cfg, params.global_mean,
                               params.user_features[u[sl].long()],
                               params.item_features[i[sl].long()])
            e = (pred - r[sl]) * w[sl]
            acc = acc + torch.sum(e * e)
    return acc


def sgd_train(
    params: MFParams,
    data: RatingBatches,
    generator: Optional[torch.Generator],
    cfg: SGDConfig,
    n_epochs: int,
    lr: float,
    batch_orders: Optional[Sequence] = None,
    reg: Optional[float] = None,
) -> Tuple[MFParams, torch.Tensor]:
    """Run ``n_epochs`` epochs on copies of ``params``' tables; returns
    (params, per-epoch train RMSE as one (n_epochs,) device tensor, zeros
    when ``cfg.compute_epoch_rmse`` is false). Nothing waits for the
    device between epochs. ``batch_orders``, one permutation per epoch,
    replaces the orders drawn from ``generator`` (see ``epoch``).
    ``reg``, when given, replaces ``cfg.reg`` (a sweep's candidates share
    one config; the JAX ``sgd_train(reg=...)``)."""
    if batch_orders is not None and len(batch_orders) != n_epochs:
        raise ValueError(f"batch_orders has {len(batch_orders)} orders for "
                         f"{n_epochs} epochs")
    params = params._replace(user_features=params.user_features.clone(),
                             item_features=params.item_features.clone())
    hist: List[torch.Tensor] = []
    for e in range(n_epochs):
        order = batch_orders[e] if batch_orders is not None else None
        with span("sgd.epoch"):
            epoch(params, data, cfg, lr, generator, order, reg)
            if cfg.compute_epoch_rmse:
                hist.append(torch.sqrt(masked_sse(params, data, cfg)
                                       / max(data.n_real, 1)))
            else:
                hist.append(torch.zeros((), device=data.user_ids.device))
    if not hist:
        return params, torch.zeros(0, device=data.user_ids.device)
    return params, torch.stack(hist)


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------


def _cold_row(cfg: SGDConfig, side: str, kp: int, device) -> torch.Tensor:
    """The row of an unknown id: factors 0, bias 0, const 1 (all zeros for
    rbf, which has no extension columns)."""
    row = torch.zeros(kp, dtype=torch.float32, device=device)
    if cfg.kernel != "rbf":
        row[const_col(cfg, side)] = 1.0
    return row


def predict_pairs(
    params: MFParams,
    u: torch.Tensor,
    i: torch.Tensor,
    cfg: SGDConfig,
    bound_ratings: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cold-start-safe batched prediction.

    Unknown ids arrive as ``-1`` (reference ``recommender_base.py:166-168``)
    and take the cold row of their side (``_cold_row``), the reference's
    bias 0 + zero factor vector (``kernel_matrix_factorization.py:486-499``).
    Returns (predictions, predictions_possible)."""
    P, Q = params.user_features, params.item_features
    kp = P.shape[1]
    uv, iv = u >= 0, i >= 0
    pu = torch.where(uv[:, None], P[u.clamp(min=0)],
                     _cold_row(cfg, "user", kp, P.device))
    qi = torch.where(iv[:, None], Q[i.clamp(min=0)],
                     _cold_row(cfg, "item", kp, Q.device))
    pred = ext_forward(cfg, params.global_mean, pu, qi)
    if bound_ratings:
        pred = pred.clamp(cfg.min_rating, cfg.max_rating)
    return pred, uv & iv
