"""SVD++ (Koren, KDD 2008): matrix factorization with implicit-feedback
factor terms, PyTorch port.

Counterpart of ``matrix_factorization_tpu/ops/svdpp.py``, single device.
Model: ``r_hat(u,i) = mu + b_u + b_i + q_i . (p_u + |N(u)|^-1/2 sum_{j in
N(u)} y_j)``, trained under the JAX package's epoch-cached schedule:

* the implicit sums ``S`` are built once an epoch from the rating stream
  and held fixed for its forward passes;
* ``p_u``, ``q_i`` and both biases update per mini-batch (summed
  deltas); ``A`` accumulates ``e_ui q_i`` per user with the PRE-update
  ``q_i``;
* at epoch end ``Y`` takes the regrouped gradient ``gY[j] = sum over
  observed pairs (u, j) of |N(u)|^-1/2 A_u`` with the ``item_deg`` ridge,
  and after the last epoch ``S`` is refreshed against the final ``Y``.

Bias folding is ``segment_sgd``'s; ``Y`` is nonzero only in the factor
columns, so the serving view ``P + S`` (``SVDppParams.as_mf``) prices the
biases once under the linear catalog scorer.

Every ``.at[].add`` of the JAX module is ``segment_sum.segment_apply`` here,
which on the card is the hand-written ``mf_segment_apply`` (one writer a
row, a fixed order, no float atomics): the S build, ``A`` and ``P`` over
a pack batch's user order (the identity: batches are stored sorted by
user), ``Q`` and ``gY`` over the pack's ``sec_perm`` / ``sec_ids_sorted``;
the flat trainers and ``user_refit`` sort each batch or chunk on the
device (``segment_sum.sorted_order``). ``user_refit``'s touched mask is an
``index_fill_`` of ones, which every writer sets alike. The random streams
are ``torch.Generator``s; the trainers also take their permutations given.

The data-parallel trainers ``dp_svdpp_train`` (a flat stream) and
``dp_svdpp_train_batched`` (a device-major pack) run on every rank of a
mesh (``parallel/mesh.py``), one process a device. Layout: P, S and the
``A`` accumulator row-sharded over the data axes with user ids local to
the rank's rows (``wvec`` sharded the same way), Q and Y replicated,
``item_deg`` whole on every rank. An epoch builds the rank's S from its
own pairs, then runs the steps with P and A updated in place and the Q
deltas into a window's zeroed ``dQ``, all-reduced over the data group and
added to every replica (``parallel/distributed.py::_windowed_epoch``):
once a step in the flat trainer, once every ``psum_every`` steps in the
batched one (Q read as it stood at the window's start; ``overlap_psum``
runs each all-reduce under the next window's steps). Then each rank
scatters its pairs' share of the Y gradient, ONE all-reduce of that
(Icap, Kp) table, and every rank applies the same Y update. Collectives an
epoch: one all-reduce of ``dQ`` a window, one of ``gY`` and one of the
squared error. S stays frozen for the epoch and is refreshed from the
final Y after the last. At one rank ``Q + dQ`` rounds otherwise than the
in-place apply, so the trainers match the single-device ones within float
rounding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import segment_sum
from matrix_factorization_tpu_torch.ops.segment_sum import identity_order, sorted_order


class SVDppParams(NamedTuple):
    """``MFParams`` plus the implicit item-factor table
    ``implicit_features`` ((Icap, Kp), factor columns only) and the
    materialized per-user implicit sums ``user_implicit_sums`` ((Ucap,
    Kp)), refreshed at fit end and per cohort in ``update_users``."""

    user_features: torch.Tensor
    item_features: torch.Tensor
    implicit_features: torch.Tensor
    user_implicit_sums: torch.Tensor
    global_mean: torch.Tensor

    @property
    def as_mf(self) -> sgd.MFParams:
        """Effective serving view ``P + S``."""
        return sgd.MFParams(self.user_features + self.user_implicit_sums,
                            self.item_features, self.global_mean)


def init_params(generator: torch.Generator, n_users: int, n_items: int,
                cfg: SGDConfig, global_mean: float, init_mean: float = 0.0,
                init_sd: float = 0.1,
                user_capacity: Optional[int] = None) -> SVDppParams:
    """``segment_sgd.init_params`` with ``Y`` and ``S`` at zero (Koren's
    initialization: epoch 1 is plain biased MF)."""
    base = sgd.init_params(generator, n_users, n_items, cfg, global_mean,
                           init_mean, init_sd, user_capacity=user_capacity)
    return SVDppParams(base.user_features, base.item_features,
                       torch.zeros_like(base.item_features),
                       torch.zeros_like(base.user_features), base.global_mean)


def svdpp_params_from_numpy(user_features, item_features, implicit_features,
                            user_implicit_sums, global_mean, device=None,
                            cfg: Optional[SGDConfig] = None) -> SVDppParams:
    """The port's ``SVDppParams`` from the JAX package's tables as numpy
    arrays (a checkpoint's ``arrays.npz``), on ``device``: P and Q checked
    as ``segment_sgd.params_from_numpy`` checks them, Y shaped as Q and S
    as P."""
    mf = sgd.params_from_numpy(user_features, item_features, global_mean,
                               device=device, cfg=cfg)
    Y = np.array(implicit_features, dtype=np.float32, order="C")
    S = np.array(user_implicit_sums, dtype=np.float32, order="C")
    if Y.shape != tuple(mf.item_features.shape) or \
            S.shape != tuple(mf.user_features.shape):
        raise ValueError(
            f"implicit table {Y.shape} and sums {S.shape} must be shaped as "
            f"the item {tuple(mf.item_features.shape)} and user "
            f"{tuple(mf.user_features.shape)} tables")
    dev = mf.user_features.device
    return SVDppParams(mf.user_features, mf.item_features,
                       torch.from_numpy(Y).to(dev), torch.from_numpy(S).to(dev),
                       mf.global_mean)


def pack_pairs(u: np.ndarray, i: np.ndarray, r: np.ndarray,
               batch_size: int) -> Tuple[np.ndarray, ...]:
    """Pad the rating stream to whole batches; returns (u, i, r, w) each
    (n_pad,) plus the clamped batch size ``min(batch_size, n)``."""
    n = len(u)
    bs = min(batch_size, max(1, n))
    n_pad = sgd.round_up(n, bs)
    up = np.zeros(n_pad, np.int32)
    ip = np.zeros(n_pad, np.int32)
    rp = np.zeros(n_pad, np.float32)
    wp = np.zeros(n_pad, np.float32)
    up[:n], ip[:n], rp[:n], wp[:n] = u, i, r, 1.0
    return up, ip, rp, wp, bs


def _neighbor_weights(u: np.ndarray, n_users: int, cap: int) -> np.ndarray:
    """|N(u)|^-1/2 per user row (0 for users with no interactions)."""
    counts = np.bincount(u, minlength=n_users).astype(np.float32)
    w = np.zeros(cap, np.float32)
    w[:n_users] = np.where(counts > 0, 1.0 / np.sqrt(np.maximum(counts, 1)),
                           0.0)
    return w


def factor_mask(cfg: SGDConfig, kp: int, device) -> torch.Tensor:
    """1.0 on the factor columns, 0 on the bias, constant and padding."""
    return (torch.arange(kp, device=device) < cfg.n_factors).float()


def _chunks(n: int, chunk: int):
    step = n if chunk <= 0 or chunk >= n else chunk
    return (slice(lo, lo + step) for lo in range(0, n, step))


def implicit_sum(Y: torch.Tensor, u: torch.Tensor, i: torch.Tensor,
                 w: torch.Tensor, wvec: torch.Tensor,
                 chunk: int = 0) -> torch.Tensor:
    """``S[u] = |N(u)|^-1/2 sum_{j in N(u)} y_j`` over the (padded) pair
    stream, in chunks of ``chunk`` pairs (0: one), each sorted by user on
    the device and applied."""
    S = torch.zeros((wvec.shape[0], Y.shape[1]), dtype=Y.dtype,
                    device=Y.device)
    for sl in _chunks(u.shape[0], chunk):
        segment_sum.segment_apply(S, Y[i[sl].long()] * w[sl, None],
                                  *sorted_order(u[sl]))
    return S * wvec[:, None]


def _scatter_pair_grads(A: torch.Tensor, Y_like: torch.Tensor,
                        u: torch.Tensor, i: torch.Tensor, w: torch.Tensor,
                        wvec: torch.Tensor, chunk: int) -> torch.Tensor:
    """``gY[j] = sum over observed pairs (u, j) of |N(u)|^-1/2 A_u``, the
    transposed twin of ``implicit_sum``, chunked the same way."""
    gY = torch.zeros_like(Y_like)
    for sl in _chunks(u.shape[0], chunk):
        uu = u[sl].long()
        rows = A[uu] * wvec[uu][:, None] * w[sl, None]
        segment_sum.segment_apply(gY, rows, *sorted_order(i[sl]))
    return gY


def _batch_step(P, Q, S, A, mu, u, i, r, w, orders, cfg: SGDConfig, masks,
                dq=None):
    """One mini-batch of the epoch-cached schedule, in place on ``P``,
    ``Q`` and ``A``; returns the batch's squared error. Every delta is
    formed from the rows read before any write; ``orders`` holds the
    ``(perm, ids_sorted)`` of ``u`` and of ``i``. ``dq`` (the
    data-parallel trainers: a window's delta table) takes the Q deltas in
    place of ``Q``, which is then only read."""
    umask, imask, fmask = masks
    pu = P[u.long()]
    qi = Q[i.long()]
    eff = pu + S[u.long()]
    e = (r - (mu + torch.sum(eff * qi, dim=1))) * w
    reg_w = (cfg.reg * w)[:, None]
    gp = (e[:, None] * qi - reg_w * pu) * umask[None, :]
    gq = (e[:, None] * eff - reg_w * qi) * imask[None, :]
    segment_sum.segment_apply(A, e[:, None] * qi * fmask[None, :], *orders[0])
    segment_sum.segment_apply(P, cfg.lr * gp, *orders[0])
    segment_sum.segment_apply(Q if dq is None else dq, cfg.lr * gq, *orders[1])
    return torch.sum(e * e)


def _masks(cfg: SGDConfig, device):
    return (sgd.mask_tensor(cfg, "user", device),
            sgd.mask_tensor(cfg, "item", device),
            factor_mask(cfg, sgd.padded_width(cfg), device))


def _y_update(Y, gY, item_deg, lr_y: float, reg_y: float, fmask):
    return Y + lr_y * (gY - reg_y * item_deg[:, None] * Y) * fmask[None, :]


def svdpp_train(
    params: SVDppParams,
    u_all: torch.Tensor,  # (n_pad,) padded pair stream (also the y index)
    i_all: torch.Tensor,
    r_all: torch.Tensor,
    w_all: torch.Tensor,
    wvec: torch.Tensor,  # (Ucap,) |N(u)|^-1/2
    item_deg: torch.Tensor,  # (Icap,) pair count per item (the y ridge)
    generator: Optional[torch.Generator],
    cfg: SGDConfig,
    n_epochs: int,
    lr_y: float,
    reg_y: float,
    batch_size: int,
    n_real: int,
    perms: Optional[Sequence] = None,
) -> Tuple[SVDppParams, torch.Tensor]:
    """The flat trainer: each epoch permutes the whole padded stream
    (``perms``, one permutation of ``n_pad`` an epoch, replaces the draws
    from ``generator``) and sorts each batch on the device. Returns
    (params, per-epoch train RMSE as one device tensor)."""
    n_pad = u_all.shape[0]
    P = params.user_features.clone()
    Q = params.item_features.clone()
    Y = params.implicit_features
    dev = P.device
    masks = _masks(cfg, dev)
    hist = []
    for e in range(n_epochs):
        S = implicit_sum(Y, u_all, i_all, w_all, wvec, chunk=batch_size)
        perm = sgd.draw_order(perms, e, n_pad, generator, dev)
        us, is_, rs, ws = (t[perm] for t in (u_all, i_all, r_all, w_all))
        A = torch.zeros_like(P)
        sse = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(n_pad // batch_size):
            sl = slice(k * batch_size, (k + 1) * batch_size)
            sse = sse + _batch_step(
                P, Q, S, A, params.global_mean, us[sl], is_[sl], rs[sl],
                ws[sl], (sorted_order(us[sl]), sorted_order(is_[sl])), cfg,
                masks)
        gY = _scatter_pair_grads(A, Y, u_all, i_all, w_all, wvec,
                                 chunk=batch_size)
        Y = _y_update(Y, gY, item_deg, lr_y, reg_y, masks[2])
        hist.append(torch.sqrt(sse / max(n_real, 1)))
    S = implicit_sum(Y, u_all, i_all, w_all, wvec, chunk=batch_size)
    return params._replace(user_features=P, item_features=Q,
                           implicit_features=Y,
                           user_implicit_sums=S), _stack(hist, dev)


def implicit_sum_batched(Y: torch.Tensor, data: sgd.RatingBatches,
                         wvec: torch.Tensor) -> torch.Tensor:
    """``S = wvec * sum_u Y[i]`` over a user-primary pack, one apply a
    batch over the batch's own user order."""
    S = torch.zeros((wvec.shape[0], Y.shape[1]), dtype=Y.dtype,
                    device=Y.device)
    for k in range(data.n_batches):
        b = sgd.batch_at(data, k)
        segment_sum.segment_apply(S, Y[b["i"].long()] * b["w"][:, None],
                                  *identity_order(b["u"]))
    return S * wvec[:, None]


def _pair_grads_batched(A: torch.Tensor, Y_like: torch.Tensor,
                        data: sgd.RatingBatches,
                        wvec: torch.Tensor) -> torch.Tensor:
    """``gY[j] = sum over observed pairs (u, j) of wvec_u A_u`` over a
    user-primary pack: A scaled by wvec once, each batch's rows applied
    over the pack's secondary (item) order."""
    Aw = A * wvec[:, None]
    gY = torch.zeros_like(Y_like)
    for k in range(data.n_batches):
        b = sgd.batch_at(data, k)
        segment_sum.segment_apply(gY, Aw[b["u"].long()] * b["w"][:, None],
                                  b["sp"], b["ss"])
    return gY


def _check_user_pack(data: sgd.RatingBatches) -> None:
    if data.primary != "user" or data.sec_perm is None:
        raise ValueError("the batched SVD++ trainer needs an aggregated "
                         "pack_ratings(order='user') pack")


def svdpp_train_batched(
    params: SVDppParams,
    data: sgd.RatingBatches,
    wvec: torch.Tensor,  # (Ucap,) |N(u)|^-1/2
    item_deg: torch.Tensor,  # (Icap,) pair count per item (the y ridge)
    generator: Optional[torch.Generator],
    cfg: SGDConfig,
    n_epochs: int,
    lr_y: float,
    reg_y: float,
    batch_orders: Optional[Sequence] = None,
) -> Tuple[SVDppParams, torch.Tensor]:
    """SVD++ on a user-primary pack (``pack_ratings(order='user')``), what
    ``SVDpp.fit`` runs: the batches visited in a random order each epoch
    (``batch_orders``, one permutation of the batches an epoch, replaces
    the draws from ``generator``: the JAX trainer's ``permutation(k,
    nb)``). Returns (params, per-epoch train RMSE as one device tensor)."""
    _check_user_pack(data)
    P = params.user_features.clone()
    Q = params.item_features.clone()
    Y = params.implicit_features
    dev = P.device
    masks = _masks(cfg, dev)
    hist = []
    for e in range(n_epochs):
        S = implicit_sum_batched(Y, data, wvec)
        A = torch.zeros_like(P)
        sse = torch.zeros((), dtype=torch.float32, device=dev)
        for k in sgd.draw_order(batch_orders, e, data.n_batches, generator,
                                "cpu").tolist():
            b = sgd.batch_at(data, k)
            sse = sse + _batch_step(
                P, Q, S, A, params.global_mean, b["u"], b["i"], b["r"],
                b["w"], (identity_order(b["u"]), (b["sp"], b["ss"])), cfg,
                masks)
        Y = _y_update(Y, _pair_grads_batched(A, Y, data, wvec), item_deg,
                      lr_y, reg_y, masks[2])
        hist.append(torch.sqrt(sse / max(data.n_real, 1)))
    S = implicit_sum_batched(Y, data, wvec)
    return params._replace(user_features=P, item_features=Q,
                           implicit_features=Y,
                           user_implicit_sums=S), _stack(hist, dev)


def _stack(hist, device) -> torch.Tensor:
    return torch.stack(hist) if hist else torch.zeros(0, device=device)


def _dp_epochs(params: SVDppParams, wvec, item_deg, cfg: SGDConfig,
               n_epochs: int, lr_y: float, reg_y: float, n_real: int, mesh,
               overlap_psum: bool, psum_every, implicit, pair_grads,
               epoch_of, orders_of) -> Tuple[SVDppParams, torch.Tensor]:
    """The loop both data-parallel trainers share. ``implicit(Y)`` is the
    rank's S from its pairs, ``pair_grads(A)`` its share of the Y gradient,
    ``epoch_of(e, d)`` rank d's batches of epoch e in visit order (dicts
    with ``u``, ``i``, ``r``, ``w``) and ``orders_of(b)`` a batch's
    ``(perm, ids_sorted)`` of ``u`` and ``i``."""
    import torch.distributed as dist

    from matrix_factorization_tpu_torch.parallel.distributed import (
        _check_psum_every, _windowed_epoch)
    from matrix_factorization_tpu_torch.parallel.mesh import data_group, device_index

    group, d = data_group(mesh), device_index(mesh)
    P = params.user_features.clone()
    Q = params.item_features.clone()
    Y = params.implicit_features
    mu = params.global_mean
    dev = P.device
    masks = _masks(cfg, dev)
    hist = []
    for e in range(n_epochs):
        S = implicit(Y)
        A = torch.zeros_like(P)
        batches = epoch_of(e, d)
        T = _check_psum_every(psum_every, len(batches))
        sse = [torch.zeros((), dtype=torch.float32, device=dev)]

        def step(b, deltas):
            sse[0] = sse[0] + _batch_step(
                P, Q, S, A, mu, b["u"], b["i"], b["r"], b["w"], orders_of(b),
                cfg, masks, dq=deltas[0])

        _windowed_epoch([(Q, group)], batches, T, step, overlap_psum)
        gY = pair_grads(A)
        dist.all_reduce(gY, group=group)
        Y = _y_update(Y, gY, item_deg, lr_y, reg_y, masks[2])
        total = sse[0].reshape(1)
        dist.all_reduce(total, group=group)
        hist.append(torch.sqrt(total[0] / max(n_real, 1)))
    return params._replace(user_features=P, item_features=Q,
                           implicit_features=Y,
                           user_implicit_sums=implicit(Y)), _stack(hist, dev)


def _rank_order(perms, e: int, d: int, n: int, key, device) -> torch.Tensor:
    """``perms[e][d]`` when given, else a permutation of ``n`` drawn on
    ``device`` from ``seeded_generator(device, *key, e, d)``."""
    if perms is not None:
        return sgd._as_index(perms[e][d], device)
    return sgd._perm(n, sgd.seeded_generator(device, *key, e, d)).to(device)


def dp_svdpp_train(
    params: SVDppParams,
    data,  # parallel.distributed.ShardedRatings: LOCAL user ids, padded
    wvec: torch.Tensor,  # the rank's rows of |N(u)|^-1/2
    item_deg: torch.Tensor,  # (Icap,) pair count per item, whole
    cfg: SGDConfig,
    n_epochs: int,
    lr_y: float,
    reg_y: float,
    batch_size: int,
    n_real: int,
    mesh,
    overlap_psum: bool = False,
    perms: Optional[Sequence] = None,
    key: Tuple[int, ...] = (0,),
) -> Tuple[SVDppParams, torch.Tensor]:
    """Flat data-parallel SVD++ (JAX ``dp_svdpp_train``), run by every
    rank: ``params`` its rows of P and S with a whole Q and Y, ``data`` its
    user range of the padded stream (``local_ratings`` of
    ``dp_fit_plumbing``'s split). S and the Y gradient are built in chunks
    of ``batch_size`` pairs; each epoch the rank permutes its stream
    (``perms[e][d]``, else drawn from ``seeded_generator(device, *key, e,
    d)``) and every step's Q deltas are all-reduced (deferred one step
    under ``overlap_psum``). Returns this rank's (P_l, Q, Y, S_l, mu) and
    the per-epoch train RMSE (a device tensor, the same on every rank)."""
    from matrix_factorization_tpu_torch.parallel.distributed import _check_orders

    _check_orders(perms, n_epochs, "perms")
    u, i, r, w = data.user_ids, data.item_ids, data.ratings, data.weights
    n = u.shape[0]
    if n % batch_size:
        raise ValueError(f"the rank's stream of {n} is not a whole number of "
                         f"batches of {batch_size}")
    dev = params.user_features.device

    def epoch_of(e, d):
        perm = _rank_order(perms, e, d, n, key, dev)
        cols = {"u": u[perm], "i": i[perm], "r": r[perm], "w": w[perm]}
        return [{k: v[lo:lo + batch_size] for k, v in cols.items()}
                for lo in range(0, n, batch_size)]

    return _dp_epochs(
        params, wvec, item_deg, cfg, n_epochs, lr_y, reg_y, n_real, mesh,
        overlap_psum, 1,
        lambda Y: implicit_sum(Y, u, i, w, wvec, chunk=batch_size),
        lambda A: _scatter_pair_grads(A, params.implicit_features, u, i, w,
                                      wvec, chunk=batch_size),
        epoch_of, lambda b: (sorted_order(b["u"]), sorted_order(b["i"])))


def dp_svdpp_train_batched(
    params: SVDppParams,
    data: sgd.RatingBatches,
    wvec: torch.Tensor,  # the rank's rows of |N(u)|^-1/2
    item_deg: torch.Tensor,  # (Icap,) pair count per item, whole
    cfg: SGDConfig,
    n_epochs: int,
    lr_y: float,
    reg_y: float,
    mesh,
    overlap_psum: bool = False,
    psum_every=1,
    batch_orders: Optional[Sequence] = None,
    key: Tuple[int, ...] = (0,),
) -> Tuple[SVDppParams, torch.Tensor]:
    """Data-parallel SVD++ on this rank's segment of the user-primary
    device-major pack (JAX ``dp_svdpp_train_batched``): ``data`` is
    ``pack_ratings(order='user', n_dev=N, users_per_dev=Ucap / N,
    segment=d)``. A step is ``svdpp_train_batched``'s (P and A over the
    batch's own user order, Q over the pack's secondary order), its Q
    deltas into the window's ``dQ``: ``psum_every`` steps a window
    (``_check_psum_every``), all reading Q as it stood at the window's
    start. S and the rank's Y gradient come from its own batches.
    ``batch_orders[e][d]`` (a permutation of the rank's batches) replaces
    the draws. Returns this rank's (P_l, Q, Y, S_l, mu) and the per-epoch
    train RMSE over the pack's ``n_real``."""
    from matrix_factorization_tpu_torch.parallel.distributed import _check_orders

    _check_user_pack(data)
    _check_orders(batch_orders, n_epochs, "batch_orders")
    dev = params.user_features.device

    def epoch_of(e, d):
        visit = _rank_order(batch_orders, e, d, data.n_batches, key, dev)
        return [sgd.batch_at(data, k) for k in visit.tolist()]

    return _dp_epochs(
        params, wvec, item_deg, cfg, n_epochs, lr_y, reg_y, data.n_real, mesh,
        overlap_psum, psum_every,
        lambda Y: implicit_sum_batched(Y, data, wvec),
        lambda A: _pair_grads_batched(A, params.implicit_features, data, wvec),
        epoch_of, lambda b: (identity_order(b["u"]), (b["sp"], b["ss"])))


def user_refit(
    params: SVDppParams,
    u_all: torch.Tensor,
    i_all: torch.Tensor,
    r_all: torch.Tensor,
    w_all: torch.Tensor,
    wvec: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: SGDConfig,
    n_epochs: int,
    batch_size: int,
    perms: Optional[Sequence] = None,
) -> SVDppParams:
    """``update_users``: the P rows retrain against FROZEN Q and Y. The
    cohort's implicit sums come from its own (padded) pairs, once, and
    replace the stored sums of the touched users (those with a pair of
    weight > 0). Each epoch permutes the pairs (``perms`` replaces the
    draws from ``generator``) and sorts each batch by user."""
    n_pad = u_all.shape[0]
    P = params.user_features.clone()
    Q = params.item_features
    mu = params.global_mean
    umask = sgd.mask_tensor(cfg, "user", P.device)
    S = implicit_sum(params.implicit_features, u_all, i_all, w_all, wvec,
                     chunk=batch_size)
    for e in range(n_epochs):
        perm = sgd.draw_order(perms, e, n_pad, generator, P.device)
        us, is_, rs, ws = (t[perm] for t in (u_all, i_all, r_all, w_all))
        for k in range(n_pad // batch_size):
            sl = slice(k * batch_size, (k + 1) * batch_size)
            u, w = us[sl], ws[sl]
            pu = P[u.long()]
            qi = Q[is_[sl].long()]
            e_ = (rs[sl] - (mu + torch.sum((pu + S[u.long()]) * qi, dim=1))) * w
            gp = (e_[:, None] * qi - (cfg.reg * w)[:, None] * pu) * umask[None, :]
            segment_sum.segment_apply(P, cfg.lr * gp, *sorted_order(u))
    # pads (weight 0) go to a spare row past the table, so only real pairs
    # mark their user; every write sets 1.0, so the fill is deterministic
    cap = P.shape[0]
    rows = torch.where(w_all > 0, u_all.long(), cap)
    touched = torch.zeros(cap + 1, dtype=torch.bool, device=P.device)
    touched.index_fill_(0, rows, True)
    S_new = torch.where(touched[:cap, None], S, params.user_implicit_sums)
    return params._replace(user_features=P, user_implicit_sums=S_new)
