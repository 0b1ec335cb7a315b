"""Bias-only model solvers: closed-form ALS and mini-batch SGD (PyTorch
port).

Counterpart of ``matrix_factorization_tpu/ops/als.py``. The model is
``r_ui ~= mu + b_u + b_i``:

* **ALS** is exact: a half-sweep is one segment sum and an elementwise
  divide, ``b_u = sum_{i in R_u} w (r - mu - b_i) / (reg + |R_u|)``, then
  the item half-sweep with the *fresh* ``b_u`` (the reference's in-epoch
  order, ``baseline_model.py:329-348``). The sorted orders by user and by
  item are made once per call.
* **SGD** is the synchronous mini-batch step of the JAX package: every
  entry reads the pre-step biases, the deltas
  ``lr * (err - reg * w * b)`` of one id sum, the user side then the item
  side (``baseline_model.py:259-266``). An epoch re-permutes every
  element of the padded stream; each batch is sorted by user and by item
  on the device for its two sums.

The data-parallel trainers (``dp_als_train``, ``dp_bias_sgd_train``) run
on every rank of a mesh (``parallel/mesh.py``) over its columns of every
(nb, bs) block (``shard_bias_data``), so that every rank works the same
global mini-batch; the bias vectors stay whole on every rank (KBs).
A rank sums its slice into full-length vectors and one ``all_reduce``
over the data group a half-sweep (ALS) or a step and side (SGD) merges
them, so they are the single-device updates up to where the sums regroup.

Every reduction by id is ``ops/segment_sum.py``'s deterministic segment
sum (a hand-written kernel on the card), and the all-reduces of a fixed
world sum in a fixed order: the same inputs give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import dataclasses

import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops.segment_sgd import RatingBatches, _as_index
from matrix_factorization_tpu_torch.ops.segment_sum import (
    segment_sum,
    segment_sums,
    sorted_order,
)


class BiasParams(NamedTuple):
    user_biases: torch.Tensor  # (U,)
    item_biases: torch.Tensor  # (I,)
    global_mean: torch.Tensor  # f32 scalar


def init_bias_params(n_users: int, n_items: int, global_mean: float,
                     device=None) -> BiasParams:
    """Zero biases on ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)
    return BiasParams(
        user_biases=torch.zeros(n_users, dtype=torch.float32, device=dev),
        item_biases=torch.zeros(n_items, dtype=torch.float32, device=dev),
        global_mean=torch.tensor(global_mean, dtype=torch.float32, device=dev),
    )


def _flat(data: RatingBatches):
    """The (nb, bs) blocks flattened, ids as int64 for indexing."""
    return (data.user_ids.reshape(-1).long(), data.item_ids.reshape(-1).long(),
            data.ratings.reshape(-1), data.weights.reshape(-1))


def bias_rmse(params: BiasParams, data: RatingBatches) -> torch.Tensor:
    """Train RMSE over the real ratings (pads have weight 0), a device
    scalar."""
    u, i, r, w = _flat(data)
    pred = params.global_mean + params.user_biases[u] + params.item_biases[i]
    e = (pred - r) * w
    return torch.sqrt(torch.sum(e * e) / max(data.n_real, 1))


def _history(hist, device) -> torch.Tensor:
    return torch.stack(hist) if hist else torch.zeros(0, device=device)


# ---------------------------------------------------------------------------
# ALS — exact closed form
# ---------------------------------------------------------------------------


def als_train(
    params: BiasParams,
    data: RatingBatches,
    reg: float,
    n_epochs: int,
    compute_epoch_rmse: bool = True,
) -> Tuple[BiasParams, torch.Tensor]:
    """``n_epochs`` exact sweeps; returns (params, per-epoch train RMSE,
    an (n_epochs,) device tensor, zeros when ``compute_epoch_rmse`` is
    false). An id without ratings keeps its bias."""
    u, i, r, w = _flat(data)
    nu = params.user_biases.shape[0]
    ni = params.item_biases.shape[0]
    by_user, by_item = sorted_order(u), sorted_order(i)
    # |R_u|, |R_i| once (reference baseline_model.py:317-323)
    user_counts = segment_sums(w, by_user, nu)
    item_counts = segment_sums(w, by_item, ni)
    mu = params.global_mean
    bu, bi = params.user_biases, params.item_biases
    hist = []
    for _ in range(n_epochs):
        resid_u = w * (r - mu - bi[i])
        bu = torch.where(user_counts > 0,
                         segment_sums(resid_u, by_user, nu) / (reg + user_counts),
                         bu)
        resid_i = w * (r - mu - bu[u])  # fresh b_u, as in the reference
        bi = torch.where(item_counts > 0,
                         segment_sums(resid_i, by_item, ni) / (reg + item_counts),
                         bi)
        p = BiasParams(bu, bi, mu)
        hist.append(bias_rmse(p, data) if compute_epoch_rmse
                    else torch.zeros((), device=mu.device))
    return BiasParams(bu, bi, mu), _history(hist, mu.device)


def als_update_users(
    params: BiasParams,
    data: RatingBatches,
    reg: float,
    n_epochs: int,
) -> BiasParams:
    """Closed-form user-side solve with the item biases frozen. One solve
    is exact, so ``n_epochs`` changes nothing (the JAX signature)."""
    u, i, r, w = _flat(data)
    nu = params.user_biases.shape[0]
    by_user = sorted_order(u)
    user_counts = segment_sums(w, by_user, nu)
    resid = w * (r - params.global_mean - params.item_biases[i])
    bu = torch.where(user_counts > 0,
                     segment_sums(resid, by_user, nu) / (reg + user_counts),
                     params.user_biases)
    return params._replace(user_biases=bu)


# ---------------------------------------------------------------------------
# SGD — synchronous mini-batches
# ---------------------------------------------------------------------------


def bias_sgd_train(
    params: BiasParams,
    data: RatingBatches,
    generator: Optional[torch.Generator],
    lr: float,
    reg: float,
    n_epochs: int,
    batch_size: int,
    update_user_params: bool = True,
    update_item_params: bool = True,
    compute_epoch_rmse: bool = True,
    orders: Optional[Sequence] = None,
) -> Tuple[BiasParams, torch.Tensor]:
    """``n_epochs`` epochs on copies of ``params``' biases; returns
    (params, per-epoch train RMSE as an (n_epochs,) device tensor).

    Every epoch visits one permutation of the padded stream's ``nb * bs``
    elements, cut into ``nb = n_pad // batch_size`` batches: ``orders[e]``
    when given (the JAX package's ``jax.random.permutation`` in the
    tests), else ``torch.randperm`` from ``generator`` on its device.
    Pads carry weight 0 and move nothing."""
    if orders is not None and len(orders) != n_epochs:
        raise ValueError(f"orders has {len(orders)} permutations for "
                         f"{n_epochs} epochs")
    uf, if_, rf, wf = _flat(data)
    n_pad = uf.numel()
    nb = max(1, n_pad // batch_size)
    dev = uf.device
    bu_t = params.user_biases.clone()
    bi_t = params.item_biases.clone()
    mu = params.global_mean
    p = BiasParams(bu_t, bi_t, mu)
    hist = []
    for e in range(n_epochs):
        perm = _as_index(orders[e] if orders is not None else torch.randperm(
            n_pad, generator=generator, device=generator.device), dev)
        us, is_, rs, ws = (t[perm].reshape(nb, -1) for t in (uf, if_, rf, wf))
        for k in range(nb):
            u, i, r, w = us[k], is_[k], rs[k], ws[k]
            bu = bu_t[u]
            bi = bi_t[i]
            err = (r - (mu + bu + bi)) * w
            if update_user_params:
                segment_sum(bu_t, lr * (err - reg * w * bu), *sorted_order(u))
            if update_item_params:
                segment_sum(bi_t, lr * (err - reg * w * bi), *sorted_order(i))
        hist.append(bias_rmse(p, data) if compute_epoch_rmse
                    else torch.zeros((), device=dev))
    return p, _history(hist, dev)


# ---------------------------------------------------------------------------
# Data-parallel trainers
# ---------------------------------------------------------------------------


def shard_bias_data(data: RatingBatches, mesh, device=None) -> RatingBatches:
    """This rank's columns of every (nb, bs) block: rank d (its index over
    the mesh's data axes, N of them) takes ``[d * bs / N, (d + 1) * bs / N)``,
    so each rank holds a contiguous slice of every mini-batch. ``bs`` must
    be a multiple of N (callers round the pack's batch size up). The
    columns are copied to ``device`` (``None``: the pack's); ``n_real``
    stays the whole stream's."""
    from matrix_factorization_tpu_torch.parallel.mesh import data_size_of, device_index

    n, d = data_size_of(mesh), device_index(mesh)
    bs = data.batch_size
    if bs % n:
        raise ValueError(f"batch size {bs} is not a multiple of the {n} "
                         f"data ranks")
    w = bs // n
    dev = data.user_ids.device if device is None else resolve_device(device)

    def cols(t):
        return t[:, d * w:(d + 1) * w].contiguous().to(dev)

    return dataclasses.replace(
        data, user_ids=cols(data.user_ids), item_ids=cols(data.item_ids),
        ratings=cols(data.ratings), weights=cols(data.weights),
        sec_ids_sorted=None, sec_perm=None)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


def _dp_rmse(sse: torch.Tensor, group, n_real: int) -> torch.Tensor:
    """The train RMSE from this rank's SSE: all-reduced, over ``n_real``."""
    return torch.sqrt(_all_reduce(sse.reshape(1), group)[0] / max(n_real, 1))


def dp_als_train(
    params: BiasParams,
    data: RatingBatches,
    reg: float,
    n_epochs: int,
    mesh,
) -> Tuple[BiasParams, torch.Tensor]:
    """Data-parallel exact ALS (JAX ``dp_als_train``), run by every rank on
    its columns (``shard_bias_data``): the rank segment-sums its slice into
    full-length (U,) and (I,) vectors and one ``all_reduce`` over the data
    group a half-sweep merges them; the counts are reduced once, and the
    fresh ``b_u`` feeds the item half. ``params``' biases are whole on
    every rank and stay so. Returns (params, per-epoch train RMSE: the
    all-reduced SSE over ``data.n_real``, an (n_epochs,) device tensor)."""
    from matrix_factorization_tpu_torch.parallel.mesh import data_group

    group = data_group(mesh)
    u, i, r, w = _flat(data)
    nu = params.user_biases.shape[0]
    ni = params.item_biases.shape[0]
    by_user, by_item = sorted_order(u), sorted_order(i)
    counts = _all_reduce(torch.cat([segment_sums(w, by_user, nu),
                                    segment_sums(w, by_item, ni)]), group)
    user_counts, item_counts = counts[:nu], counts[nu:]
    mu = params.global_mean
    bu, bi = params.user_biases, params.item_biases
    hist = []
    for _ in range(n_epochs):
        resid_u = w * (r - mu - bi[i])
        sums = _all_reduce(segment_sums(resid_u, by_user, nu), group)
        bu = torch.where(user_counts > 0, sums / (reg + user_counts), bu)
        resid_i = w * (r - mu - bu[u])  # fresh b_u, as in the reference
        sums = _all_reduce(segment_sums(resid_i, by_item, ni), group)
        bi = torch.where(item_counts > 0, sums / (reg + item_counts), bi)
        e = (mu + bu[u] + bi[i] - r) * w
        hist.append(_dp_rmse(torch.sum(e * e), group, data.n_real))
    return BiasParams(bu, bi, mu), _history(hist, mu.device)


def dp_bias_sgd_train(
    params: BiasParams,
    data: RatingBatches,
    orders: Sequence,
    lr: float,
    reg: float,
    mesh,
) -> Tuple[BiasParams, torch.Tensor]:
    """Data-parallel mini-batch bias SGD (JAX ``dp_bias_sgd_train``), run by
    every rank on its columns (``shard_bias_data``) of copies of the whole
    biases: per step every entry of the rank's slice reads the pre-step
    biases, the slice's deltas ``lr * (err - reg * w * b)`` are summed by id
    into zeroed full-length vectors, and one ``all_reduce`` over the data
    group a step and a side merges them before they are added: the
    summed-minibatch step of the global batch. Epoch ``e`` visits the
    batches in ``orders[e]`` (a permutation of ``nb``, the same on every
    rank; the tests hand in JAX's ``permutation(split(key, n_epochs)[e],
    nb)``), one epoch for each order. (The single-device trainer permutes
    every element, which would move entries across ranks.) Each batch's
    sorted orders by user and by item are made once per call. Returns
    (params, per-epoch train RMSE)."""
    from matrix_factorization_tpu_torch.parallel.mesh import data_group

    group = data_group(mesh)
    nb = data.n_batches
    us, is_ = data.user_ids.long(), data.item_ids.long()
    rs, ws = data.ratings, data.weights
    dev = us.device
    by_user = [sorted_order(us[k]) for k in range(nb)]
    by_item = [sorted_order(is_[k]) for k in range(nb)]
    bu_t = params.user_biases.clone()
    bi_t = params.item_biases.clone()
    mu = params.global_mean
    hist = []
    for order in orders:
        for k in _as_index(order, "cpu").tolist():
            u, i, r, w = us[k], is_[k], rs[k], ws[k]
            bu = bu_t[u]
            bi = bi_t[i]
            err = (r - (mu + bu + bi)) * w
            du = segment_sums(lr * (err - reg * w * bu), by_user[k],
                              bu_t.shape[0])
            bu_t.add_(_all_reduce(du, group))
            di = segment_sums(lr * (err - reg * w * bi), by_item[k],
                              bi_t.shape[0])
            bi_t.add_(_all_reduce(di, group))
        e_ = (mu + bu_t[us] + bi_t[is_] - rs) * ws
        hist.append(_dp_rmse(torch.sum(e_ * e_), group, data.n_real))
    return BiasParams(bu_t, bi_t, mu), _history(hist, dev)


def bias_predict(
    params: BiasParams, u: torch.Tensor, i: torch.Tensor, min_rating: float,
    max_rating: float, bound_ratings: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mu + the known sides' biases; an unknown id (-1) contributes 0
    (reference ``baseline_model.py:400-405``). Returns (predictions,
    predictions_possible)."""
    uv, iv = u >= 0, i >= 0
    bu = torch.where(uv, params.user_biases[u.clamp(min=0)], 0.0)
    bi = torch.where(iv, params.item_biases[i.clamp(min=0)], 0.0)
    pred = params.global_mean + bu + bi
    if bound_ratings:
        pred = pred.clamp(min_rating, max_rating)
    return pred, uv & iv
