"""Data- and model-parallel SGD for KernelMF on ``torch.distributed``.

Counterpart of ``matrix_factorization_tpu/parallel/distributed.py``. Two
trainers, each run by every rank of a mesh (``parallel/mesh.py``) on its
own device:

* ``dp_fit``: P (the bias-folded user rows) row-sharded over the data
  axes, Q (the item rows) replicated. The ratings are split by user range,
  so a rank's user updates are local; its item deltas go into a window's
  delta table ``dQ``, which is all-reduced over the data group once every
  ``psum_every`` steps and added to every replica (synchronous mini-batch
  SGD with a global batch of n_data local batches at ``psum_every=1``).
  ``layout='flat'`` steps over a rank's ratings as they come (each batch
  sorted on the device); ``'tiled'`` over the device-major pack
  (``ops/segment_sgd.py::pack_ratings(n_dev > 1)``), whose batches come
  sorted with their secondary argsort.
* ``dp_tp_fit``: P sharded over the data axes and Q over the model axis,
  the ratings cut into (user range x item range) cells, one a rank. Both
  tables are read as they stood at the window's start; a window's user
  deltas are all-reduced over the model group, its item deltas over the
  data group.

Every step is the hand-written step of ``ops/cuda_sgd.py`` and apply of
``ops/segment_sum.py`` on CUDA (their plain versions on the CPU): a side
written in place (the local P of ``dp_fit``) is the step's in-place
primary update or the apply into that table; a side whose deltas go into
a window's table is the step's accumulator mode (``prim_out``) or the
apply into the delta table.
So a rank's step is the single-device step, and ``psum_every=1`` with one
rank is ``sgd_train`` up to where a delta is added.

``overlap_psum`` issues each window's all-reduce with ``async_op=True``
and waits for it after the next window's steps are queued, so that the
collective runs under them (a stream-side wait before them would queue
the steps behind it): the next window still reads the table without the
last window's deltas, the schedule of JAX's deferred ``psum``. Two sets of
delta tables alternate, and pending deltas are added before the epoch's
RMSE, so one-window epochs are the synchronous schedule bit for bit.

Epoch orders are per rank: ``orders[e][d]`` is the permutation of rank
d's batches (``cfg.shuffle='batch'``) or of its padded ratings
(``'full'``) in epoch e, d being the rank's index over the data axes
(``dp_fit``) or its cell ``d * n_model + m`` (``dp_tp_fit``); ``None``
draws them from ``seeded_generator('cpu', seed, e, d)``. The tests hand
in the JAX package's (``fold_in(split(key, n_epochs)[e], d)``).
Per-epoch train RMSE is the all-reduced local SSE.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops.segment_sgd import MFParams, RatingBatches, round_up
from matrix_factorization_tpu_torch.parallel.mesh import (
    data_group,
    data_size_of,
    device_index,
    model_group,
    model_index,
    model_size_of,
)


class ShardedRatings(NamedTuple):
    """A rank's part of the device-major rating stream (flat, padded to a
    whole number of batches; pads have weight 0)."""

    user_ids: torch.Tensor  # int32, user ids local to the rank's P shard
    item_ids: torch.Tensor  # int32, item ids (local to the Q shard in 2D)
    ratings: torch.Tensor
    weights: torch.Tensor

    @property
    def total_len(self) -> int:
        return self.user_ids.shape[0]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``x`` stacked along the rows, in group-rank order (one
    ``all_gather_into_tensor``; every rank's ``x`` has one shape)."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# Host plumbing: the device-major streams
# ---------------------------------------------------------------------------


def shard_ratings_by_user(u: np.ndarray, i: np.ndarray, r: np.ndarray,
                          user_capacity: int, n_dev: int, batch_size: int,
                          native: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, int]:
    """Device d owns users ``[d * U / D, (d + 1) * U / D)``: returns the
    device-major (u_local, i, r, w) and the per-device padded length, the
    largest shard rounded up to whole batches (pads zero, weight 0)."""
    if user_capacity % n_dev:
        raise ValueError(f"user capacity {user_capacity} is not a multiple "
                         f"of {n_dev} devices")
    users_per_dev = user_capacity // n_dev
    dev = (np.asarray(u).astype(np.int64) // users_per_dev).astype(np.int32)
    counts = np.bincount(dev, minlength=n_dev)
    u, i, r = sgd.sort_stream_by_key(dev, u, i, r, n_dev, native)
    n_pad = max(batch_size, round_up(int(counts.max()), batch_size))
    return _device_major_rows(u, i, r, counts, n_pad, n_dev, 1,
                              users_per_dev, 0)


def shard_ratings_2d(u: np.ndarray, i: np.ndarray, r: np.ndarray,
                     user_capacity: int, item_capacity: int, n_data: int,
                     n_model: int, batch_size: int, native: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, int]:
    """The ratings cut into (n_data x n_model) cells, cell ``d * n_model +
    m`` holding the users of P shard d and the items of Q shard m with
    ids local to both: device-major (u_local, i_local, r, w) in cell order
    and the per-cell padded length."""
    if user_capacity % n_data or item_capacity % n_model:
        raise ValueError("capacities must be multiples of the mesh axes")
    users_per = user_capacity // n_data
    items_per = item_capacity // n_model
    cell = ((np.asarray(u).astype(np.int64) // users_per) * n_model
            + np.asarray(i).astype(np.int64) // items_per).astype(np.int32)
    counts = np.bincount(cell, minlength=n_data * n_model)
    u, i, r = sgd.sort_stream_by_key(cell, u, i, r, n_data * n_model, native)
    n_pad = max(batch_size, round_up(int(counts.max()), batch_size))
    return _device_major_rows(u, i, r, counts, n_pad, n_data, n_model,
                              users_per, items_per)


def _device_major_rows(u, i, r, counts, n_pad, n_data, n_model, users_per,
                       items_per):
    n_dev = n_data * n_model
    uu = np.zeros((n_dev, n_pad), np.int32)
    ii = np.zeros((n_dev, n_pad), np.int32)
    rr = np.zeros((n_dev, n_pad), np.float32)
    ww = np.zeros((n_dev, n_pad), np.float32)
    start = 0
    for c in range(n_dev):
        cnt = int(counts[c])
        sl = slice(start, start + cnt)
        d, m = divmod(c, n_model)
        uu[c, :cnt] = u[sl] - d * users_per
        ii[c, :cnt] = i[sl] - m * items_per
        rr[c, :cnt] = r[sl]
        ww[c, :cnt] = 1.0
        start += cnt
    return uu.reshape(-1), ii.reshape(-1), rr.reshape(-1), ww.reshape(-1), n_pad


def dp_fit_plumbing(u: np.ndarray, i: np.ndarray, r: np.ndarray,
                    n_users: int, mesh, batch_size: int):
    """The host plumbing of every data-parallel fit: the user capacity (a
    multiple of 8 a data rank), the batch size and the device-major
    user-range split. Returns ``(ucap, bs, (su, si, sr, sw))``, the same
    on every rank; a rank takes its part with ``local_ratings``."""
    n_dev = data_size_of(mesh)
    ucap = round_up(n_users, 8 * n_dev)
    bs = min(batch_size, max(1, len(u)))
    su, si, sr, sw, _ = shard_ratings_by_user(
        np.asarray(u, np.int32), np.asarray(i, np.int32),
        np.asarray(r, np.float32), ucap, n_dev, bs)
    return ucap, bs, (su, si, sr, sw)


def local_ratings(arrays: Sequence[np.ndarray], index: int, n_shards: int,
                  device) -> ShardedRatings:
    """Shard ``index`` of ``n_shards`` of device-major (u, i, r, w) arrays
    as tensors on ``device``."""
    def part(a):
        a = np.asarray(a).reshape(n_shards, -1)[index]
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ShardedRatings(*(part(a) for a in arrays))


def place_params(params: MFParams, mesh, device=None) -> MFParams:
    """This rank's part of whole tables for ``dp_fit``: its P shard over
    the data axes, a copy of Q and ``mu``, on ``device``."""
    dev = resolve_device(device) if device is not None else params.user_features.device
    n, d = data_size_of(mesh), device_index(mesh)
    rows = params.user_features.shape[0] // n
    return MFParams(
        user_features=params.user_features[d * rows:(d + 1) * rows].to(dev, copy=True),
        item_features=params.item_features.to(dev, copy=True),
        global_mean=params.global_mean.to(dev, copy=True))


def place_params_2d(params: MFParams, mesh, device=None) -> MFParams:
    """This rank's part of whole tables for ``dp_tp_fit``: its P shard
    over the data axes and its Q shard over the model axis."""
    dev = resolve_device(device) if device is not None else params.user_features.device
    nd, d = data_size_of(mesh), device_index(mesh)
    nm, m = model_size_of(mesh), model_index(mesh)
    pr = params.user_features.shape[0] // nd
    qr = params.item_features.shape[0] // nm
    return MFParams(
        user_features=params.user_features[d * pr:(d + 1) * pr].to(dev, copy=True),
        item_features=params.item_features[m * qr:(m + 1) * qr].to(dev, copy=True),
        global_mean=params.global_mean.to(dev, copy=True))


def gather_params(params: MFParams, mesh, q_sharded: bool) -> MFParams:
    """Whole tables on every rank from the trainers' shards: P all-gathered
    over the data group, Q over the model group when ``q_sharded``
    (``dp_tp_fit``), else already whole."""
    P = all_gather_rows(params.user_features, data_group(mesh))
    Q = (all_gather_rows(params.item_features, model_group(mesh))
         if q_sharded else params.item_features)
    return MFParams(P, Q, params.global_mean)


def gather_table_rows(table_l: torch.Tensor, rows, mesh) -> torch.Tensor:
    """Rows ``rows`` (global ids, the same on every rank) of a table whose
    row shards the data ranks hold, ``table_l`` being this rank's, on
    every rank: each rank writes the rows its shard holds into a zeroed
    (len(rows), width) buffer, and one ``all_reduce`` (sum) over the data
    group assembles them. Each row has one writer, so the sum is exact."""
    n = table_l.shape[0]
    ids = torch.as_tensor(np.asarray(rows, np.int64)).to(table_l.device)
    local = ids - device_index(mesh) * n
    mine = (local >= 0) & (local < n)
    out = torch.zeros((ids.shape[0], table_l.shape[1]), dtype=table_l.dtype,
                      device=table_l.device)
    out[mine] = table_l[local[mine]]
    dist.all_reduce(out, group=data_group(mesh))
    return out


# ---------------------------------------------------------------------------
# The windowed epoch
# ---------------------------------------------------------------------------


def _check_psum_every(psum_every, nb: int) -> int:
    """The window length for ``nb`` local batches an epoch: ``'auto'`` the
    largest divisor of ``nb`` up to 16, ``'epoch'`` one window an epoch,
    else a positive int that divides ``nb`` (JAX's rule and messages)."""
    if psum_every == "epoch":
        return nb
    if psum_every == "auto":
        t = min(nb, 16)
        while nb % t:
            t -= 1
        return t
    if not isinstance(psum_every, int) or psum_every < 1:
        raise ValueError(
            "psum_every must be a positive int, 'auto' or 'epoch', "
            f"got {psum_every!r}")
    if nb % psum_every:
        raise ValueError(
            f"psum_every={psum_every} must divide the {nb} local batches "
            f"per epoch (pad the stream or pick a divisor — e.g. "
            f"{max(d for d in range(1, psum_every + 1) if nb % d == 0)})")
    return psum_every


def _windowed_epoch(sides: List[Tuple[torch.Tensor, object]], batches: list,
                    T: int, step, overlap: bool) -> None:
    """One epoch as windows of ``T`` batches. ``sides`` are the (table,
    group) pairs whose deltas a window collects: per window, each gets a
    zeroed delta table, ``step(b, deltas)`` runs the window's batches, and
    the deltas are all-reduced over the side's group and added to the
    table (in place). With ``overlap`` the all-reduce is asynchronous and
    its add waits until the next window's steps are queued; the last is
    added before this returns."""
    if not sides:
        for b in batches:
            step(b, [])
        return
    sets = [[torch.empty_like(t) for t, _ in sides]
            for _ in range(2 if overlap else 1)]
    pending: list = []
    for w in range(len(batches) // T):
        deltas = sets[w % len(sets)]
        for d in deltas:
            d.zero_()
        for b in batches[w * T:(w + 1) * T]:
            step(b, deltas)
        for work, table, d in pending:
            work.wait()
            table.add_(d)
        pending = []
        for d, (table, group) in zip(deltas, sides):
            work = dist.all_reduce(d, group=group, async_op=overlap)
            if overlap:
                pending.append((work, table, d))
            else:
                table.add_(d)
    for work, table, d in pending:
        work.wait()
        table.add_(d)


def _visit(n: int, order, e: int, d: int, seed: int) -> torch.Tensor:
    """Epoch ``e``'s permutation of ``n`` for shard ``d``: ``order[e][d]``
    when given, else drawn on the host from (seed, e, d)."""
    if order is not None:
        return sgd._as_index(order[e][d], "cpu")
    return torch.randperm(n, generator=sgd.seeded_generator("cpu", seed, e, d))


def _flat_batches(data: ShardedRatings, cfg: SGDConfig, orders, e: int,
                  d: int, seed: int) -> list:
    """A flat stream's batches in epoch ``e``'s visit order (views, or one
    gather for ``shuffle='full'``)."""
    bs = cfg.batch_size
    nb = data.total_len // bs
    cols = {"u": data.user_ids, "i": data.item_ids, "r": data.ratings,
            "w": data.weights}
    if cfg.shuffle == "full":
        perm = _visit(nb * bs, orders, e, d, seed).to(data.user_ids.device)
        cols = {k: v[perm] for k, v in cols.items()}
        visit = range(nb)
    elif cfg.shuffle == "batch":
        visit = _visit(nb, orders, e, d, seed).tolist()
    elif cfg.shuffle == "none":
        visit = range(nb)
    else:
        raise ValueError(f"unknown shuffle {cfg.shuffle!r}")
    rows = {k: v.reshape(nb, bs) for k, v in cols.items()}
    return [{k: v[b] for k, v in rows.items()} for b in visit]


def _packed_batches(data: RatingBatches, cfg: SGDConfig, orders, e: int,
                    d: int, seed: int) -> list:
    """A rank's packed batches in epoch ``e``'s visit order; under
    ``shuffle='full'`` the elements are permuted and every batch is sorted
    on the device (the single-device epoch's rule)."""
    nb, bs = data.n_batches, data.batch_size
    if cfg.shuffle == "full":
        perm = _visit(nb * bs, orders, e, d, seed).to(data.user_ids.device)
        cols = {k: t.reshape(-1)[perm].reshape(nb, bs) for k, t in (
            ("u", data.user_ids), ("i", data.item_ids), ("r", data.ratings),
            ("w", data.weights))}
        return [{k: v[b] for k, v in cols.items()} for b in range(nb)]
    if cfg.shuffle == "batch":
        visit = _visit(nb, orders, e, d, seed).tolist()
    elif cfg.shuffle == "none":
        visit = range(nb)
    else:
        raise ValueError(f"unknown shuffle {cfg.shuffle!r}")
    return [sgd.batch_at(data, b) for b in visit]


def _epoch_rmse(params: MFParams, data, cfg: SGDConfig, n_real: int,
                group) -> torch.Tensor:
    if not cfg.compute_epoch_rmse:
        return torch.zeros((), device=params.user_features.device)
    sse = sgd.masked_sse(params, data, cfg).reshape(1)
    dist.all_reduce(sse, group=group)
    return torch.sqrt(sse[0] / max(n_real, 1))


def _copy(params: MFParams) -> MFParams:
    return params._replace(user_features=params.user_features.clone(),
                           item_features=params.item_features.clone())


def _train_1d(params: MFParams, data, batches_of, cfg: SGDConfig,
              n_epochs: int, lr: float, mesh, n_real: int, primary: str,
              overlap_psum: bool, psum_every, orders, seed: int
              ) -> Tuple[MFParams, torch.Tensor]:
    """The 1D trainers' loop: P_l updated in place, Q through the window's
    delta table."""
    group = data_group(mesh)
    d = device_index(mesh)
    params = _copy(params)
    P_l, Q = params.user_features, params.item_features
    dev = P_l.device
    masks = {s: sgd.mask_tensor(cfg, s, dev) for s in ("user", "item")}
    hist = []
    for e in range(n_epochs):
        batches = batches_of(e, d)
        T = _check_psum_every(psum_every, len(batches))

        def step(b, deltas):
            write = {"user": P_l, "item": deltas[0] if deltas else None}
            sgd.minibatch_update(params, b, cfg, lr, primary, masks,
                                 write=write)

        sides = [(Q, group)] if cfg.update_item_params else []
        _windowed_epoch(sides, batches, T, step, overlap_psum)
        hist.append(_epoch_rmse(params, data, cfg, n_real, group))
    return params, (torch.stack(hist) if hist else torch.zeros(0, device=dev))


def _check_orders(orders, n_epochs: int, name: str = "orders") -> None:
    if orders is not None and len(orders) != n_epochs:
        raise ValueError(f"{name} has {len(orders)} epochs for {n_epochs}")


def dp_sgd_train(params: MFParams, data: ShardedRatings, cfg: SGDConfig,
                 n_epochs: int, lr: float, mesh, n_real: int,
                 overlap_psum: bool = False, psum_every=1, orders=None,
                 seed: int = 0) -> Tuple[MFParams, torch.Tensor]:
    """The flat data-parallel trainer (JAX ``dp_sgd_train``), run by every
    rank on its part: ``params`` from ``place_params``, ``data`` from
    ``local_ratings``. A batch is sorted by user on the device, so the
    step updates P_l in place and its item deltas go to the window's
    ``dQ``. Returns this rank's (P_l, Q, mu) copies and the per-epoch
    train RMSE (a device tensor, the same on every rank)."""
    _check_orders(orders, n_epochs)
    return _train_1d(
        params, data,
        lambda e, d: _flat_batches(data, cfg, orders, e, d, seed),
        cfg, n_epochs, lr, mesh, n_real, "user", overlap_psum, psum_every,
        orders, seed)


def dp_sgd_train_tiled(params: MFParams, data: RatingBatches,
                       cfg: SGDConfig, n_epochs: int, lr: float, mesh,
                       overlap_psum: bool = False, psum_every=1,
                       orders=None, seed: int = 0
                       ) -> Tuple[MFParams, torch.Tensor]:
    """The data-parallel trainer over this rank's batches of the
    device-major pack (``pack_ratings(n_dev > 1, segment=d)``, d the
    rank's ``device_index``): batches come sorted by the
    pack's primary side with the secondary argsort. Item-primary (pack
    orders ``'shuffle'`` and ``'item'``): the step reads Q and adds its
    deltas to ``dQ`` (the accumulator mode), and the apply adds the user
    deltas to P_l; user-primary: the step updates P_l in place and the
    apply adds the item deltas to ``dQ``."""
    _check_orders(orders, n_epochs)
    return _train_1d(
        params, data,
        lambda e, d: _packed_batches(data, cfg, orders, e, d, seed),
        cfg, n_epochs, lr, mesh, data.n_real, data.primary, overlap_psum,
        psum_every, orders, seed)


def dp_tp_sgd_train(params: MFParams, data: ShardedRatings, cfg: SGDConfig,
                    n_epochs: int, lr: float, mesh, n_real: int,
                    overlap_psum: bool = False, psum_every=1, orders=None,
                    seed: int = 0) -> Tuple[MFParams, torch.Tensor]:
    """The 2D trainer (JAX ``dp_tp_sgd_train``) on this rank's cell:
    ``params`` from ``place_params_2d``, ``data`` from ``local_ratings``
    over the cells. Both tables are read as they stood at the window's
    start: a batch sorted by user runs the step's accumulator mode into
    ``dP`` and the apply into ``dQ``; ``dP`` is all-reduced over the
    model group, ``dQ`` over the data group."""
    _check_orders(orders, n_epochs)
    cell = device_index(mesh) * model_size_of(mesh) + model_index(mesh)
    params = _copy(params)
    P_l, Q_l = params.user_features, params.item_features
    dev = P_l.device
    masks = {s: sgd.mask_tensor(cfg, s, dev) for s in ("user", "item")}
    sides, names = [], []
    if cfg.update_user_params:
        sides.append((P_l, model_group(mesh)))
        names.append("user")
    if cfg.update_item_params:
        sides.append((Q_l, data_group(mesh)))
        names.append("item")
    hist = []
    for e in range(n_epochs):
        batches = _flat_batches(data, cfg, orders, e, cell, seed)
        T = _check_psum_every(psum_every, len(batches))

        def step(b, deltas):
            write = {"user": None, "item": None}
            write.update(zip(names, deltas))
            sgd.minibatch_update(params, b, cfg, lr, "user", masks,
                                 write=write)

        _windowed_epoch(sides, batches, T, step, overlap_psum)
        hist.append(_epoch_rmse(params, data, cfg, n_real, None))
    return params, (torch.stack(hist) if hist else torch.zeros(0, device=dev))


# ---------------------------------------------------------------------------
# End-to-end fits
# ---------------------------------------------------------------------------


def _whole_init(n_users: int, n_items: int, cfg: SGDConfig, r: np.ndarray,
                seed: int, init_mean: float, init_sd: float, ucap: int,
                icap: Optional[int], device) -> MFParams:
    """The whole initial tables, the same on every rank (one generator
    seeded with ``seed`` on the rank's device type)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return sgd.init_params(gen, n_users, n_items, cfg,
                           float(np.mean(r)) if len(r) else 0.0, init_mean,
                           init_sd, user_capacity=ucap, item_capacity=icap)


def _check_whole(params: MFParams, ucap: int, icap: Optional[int]) -> None:
    if params.user_features.shape[0] != ucap or (
            icap is not None and params.item_features.shape[0] != icap):
        raise ValueError(
            f"the initial tables must have {ucap} user rows"
            + (f" and {icap} item rows" if icap is not None else "")
            + f", got {tuple(params.user_features.shape)} and "
            f"{tuple(params.item_features.shape)}")


def dp_fit(u: np.ndarray, i: np.ndarray, r: np.ndarray, n_users: int,
           n_items: int, cfg: SGDConfig, n_epochs: int, lr: float, mesh,
           seed: int = 0, init_mean: float = 0.0, init_sd: float = 0.1,
           overlap_psum: bool = False, layout: str = "flat",
           pack_order: str = "shuffle", psum_every=1, *,
           params: Optional[MFParams] = None, orders=None, device=None
           ) -> Tuple[MFParams, np.ndarray]:
    """End-to-end data-parallel fit, called by every rank with the same
    ratings: initial tables (or ``params``, whole tables with the user
    capacity ``round_up(n_users, 8 * n_data)``), this rank's shard of the
    stream, the trainer. ``layout='tiled'`` (``'auto'``: tiled unless
    ``cfg.shuffle`` is ``'full'``) packs device-major with ``pack_order``
    and trains with ``dp_sgd_train_tiled``, each rank packing only its own
    segment; ``'flat'`` splits by user range (``dp_fit_plumbing``; with
    fewer ratings than a batch, one batch of them all) and trains with
    ``dp_sgd_train``. Returns this rank's (P_l, Q, mu) and the train-RMSE
    history as a host array."""
    n_dev, d = data_size_of(mesh), device_index(mesh)
    dev = resolve_device(device)
    ucap = round_up(n_users, 8 * n_dev)
    if layout == "auto":
        layout = "flat" if cfg.shuffle == "full" else "tiled"
    if layout not in ("flat", "tiled"):
        raise ValueError(f"unknown dp layout {layout!r}")
    if params is None:
        params = _whole_init(n_users, n_items, cfg, r, seed, init_mean,
                             init_sd, ucap, None, dev)
    _check_whole(params, ucap, None)
    local = place_params(params, mesh, dev)
    u, i, r = (np.asarray(u, np.int32), np.asarray(i, np.int32),
               np.asarray(r, np.float32))
    if layout == "tiled":
        data = sgd.pack_ratings(
            u, i, r, cfg.batch_size, shuffle_seed=seed, order=pack_order,
            n_dev=n_dev, users_per_dev=ucap // n_dev, segment=d, device=dev)
        local, hist = dp_sgd_train_tiled(
            local, data, cfg, n_epochs, lr, mesh, overlap_psum=overlap_psum,
            psum_every=psum_every, orders=orders, seed=seed)
    else:
        _, bs, stream = dp_fit_plumbing(u, i, r, n_users, mesh, cfg.batch_size)
        cfg = dataclasses.replace(cfg, batch_size=bs)
        data = local_ratings(stream, d, n_dev, dev)
        local, hist = dp_sgd_train(
            local, data, cfg, n_epochs, lr, mesh, len(r),
            overlap_psum=overlap_psum, psum_every=psum_every, orders=orders,
            seed=seed)
    return local, hist.cpu().numpy()


def dp_tp_fit(u: np.ndarray, i: np.ndarray, r: np.ndarray, n_users: int,
              n_items: int, cfg: SGDConfig, n_epochs: int, lr: float, mesh,
              seed: int = 0, init_mean: float = 0.0, init_sd: float = 0.1,
              overlap_psum: bool = False, psum_every=1, *,
              params: Optional[MFParams] = None, orders=None, device=None
              ) -> Tuple[MFParams, np.ndarray]:
    """End-to-end 2D fit (P and Q sharded), called by every rank with the
    same ratings; ``params`` (whole tables) must have the capacities
    ``round_up(n_users, 8 * n_data)`` and ``round_up(n_items, 8 *
    n_model)``. Returns this rank's (P shard, Q shard, mu) and the
    train-RMSE history as a host array."""
    nd, nm = data_size_of(mesh), model_size_of(mesh)
    dev = resolve_device(device)
    ucap = round_up(n_users, 8 * nd)
    icap = round_up(n_items, 8 * nm)
    if params is None:
        params = _whole_init(n_users, n_items, cfg, r, seed, init_mean,
                             init_sd, ucap, icap, dev)
    _check_whole(params, ucap, icap)
    local = place_params_2d(params, mesh, dev)
    su, si, sr, sw, _ = shard_ratings_2d(
        np.asarray(u, np.int32), np.asarray(i, np.int32),
        np.asarray(r, np.float32), ucap, icap, nd, nm, cfg.batch_size)
    cell = device_index(mesh) * nm + model_index(mesh)
    data = local_ratings((su, si, sr, sw), cell, nd * nm, dev)
    local, hist = dp_tp_sgd_train(
        local, data, cfg, n_epochs, lr, mesh, len(r),
        overlap_psum=overlap_psum, psum_every=psum_every, orders=orders,
        seed=seed)
    return local, hist.cpu().numpy()
