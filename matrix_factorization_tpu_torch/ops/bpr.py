"""BPR-Opt: Bayesian Personalized Ranking triplet SGD (Rendle et al.,
UAI 2009), PyTorch port.

Counterpart of ``matrix_factorization_tpu/ops/bpr.py``, single device:
the flat trainer ``bpr_train``, the pack trainer ``bpr_train_tiled`` that
``BPR.fit`` runs, and ``auc_sampled``. Per triplet (u, i, j), user,
observed positive item and sampled negative item, ascend
``log sigmoid(x_ui - x_uj)`` with L2 regularization, on the bias-folded
tables of ``ops/segment_sgd.py`` (so BPR serves through the catalog
scorer like every other model).

A step reads every row it needs (``P[u]``, ``Q[i]``, ``Q[j]``) before any
table is written, forms the three deltas from those pre-step rows, as the
JAX step does, and adds them with ``segment_sum.segment_apply``: over the
batch's own user order for P (the pack stores every batch sorted by user,
so the identity permutation), over the pack's ``sec_perm`` /
``sec_ids_sorted`` for ``Q[i]``, and over a per-batch stable sort of the
negatives for ``Q[j]``, applied after the ``Q[i]`` apply. On the card the
apply is the hand-written ``mf_segment_apply``: one writer a row, a fixed
summation order, no float atomics, so a seeded fit repeats bit for bit. A
``j == i`` collision lands on one row from both applies, and its ``+s``
and ``-s`` terms cancel as in JAX's summed scatter.

Negatives are uniform over the catalog and drawn per epoch, never checked
against the user's positives (LearnBPR's shortcut, see the JAX module).
The random streams are ``torch.Generator``s, not ``jax.random``; every
trainer also takes its draws given (the batch orders and the negatives),
which the tests use to replay the JAX package's draws.

The data-parallel trainers ``dp_bpr_train`` (a flat stream) and
``dp_bpr_train_tiled`` (a device-major pack) run on every rank of a mesh
(``parallel/mesh.py``), one process a device. Layout: P row-sharded over
the data axes with user ids local to the rank's rows (every P update is
local, in place), Q replicated. A rank's ``Q[i]`` and ``Q[j]`` deltas go,
in that order, into a window's zeroed delta table ``dQ``, which is
all-reduced over the data group and added to every replica
(``parallel/distributed.py::_windowed_epoch``): once a step in the flat
trainer, once every ``psum_every`` steps in the tiled one, where Q is read
as it stood at the window's start. ``overlap_psum`` runs each window's
all-reduce under the next window's steps, which still read Q without it;
the last is added at the epoch's end. Collectives an epoch: one
``all_reduce`` of ``dQ`` a window and one of the loss. The replicas stay
bit-equal. ``Q + dQ`` rounds otherwise than two in-place applies, so a
world of one rank is the single-device trainer within float rounding, not
bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import segment_sum
from matrix_factorization_tpu_torch.ops.segment_sum import identity_order, sorted_order


def _as_ids(a, device) -> torch.Tensor:
    """Ids given as a tensor or an array, as int32 on ``device``."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a, dtype=np.int32))
    return a.to(device=device, dtype=torch.int32)


def _draw_ids(n: int, n_items: int, generator, device) -> torch.Tensor:
    """``n`` uniform item ids from ``generator``, int32 on ``device``."""
    return torch.randint(0, n_items, (n,), generator=generator,
                         device=generator.device,
                         dtype=torch.int32).to(device)


def bpr_step(P: torch.Tensor, Q: torch.Tensor, u: torch.Tensor,
             i: torch.Tensor, j: torch.Tensor, w: torch.Tensor, orders,
             cfg: SGDConfig, lr: float, umask: torch.Tensor,
             imask: torch.Tensor, update_item_params: bool = True,
             dq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One summed mini-batch BPR update, in place on ``P`` and ``Q``;
    returns the batch's visited loss (pre-update, weighted), a device
    scalar. ``orders`` holds the ``(perm, ids_sorted)`` of ``u``, ``i`` and
    ``j``. The gradient of ``-log sigmoid(x)`` at ``x = x_ui - x_uj`` is
    ``-sigmoid(-x)``; the masks keep each side's constant column fixed
    (and ``b_u`` never moves: its lane of ``qi - qj`` is ``1 - 1``).
    ``dq`` (the data-parallel trainers: a window's delta table) takes the
    Q deltas in place of ``Q``, which is then only read."""
    pu = P[u.long()]
    qi = Q[i.long()]
    qj = Q[j.long()]
    d = qi - qj
    x = torch.sum(pu * d, dim=1)
    s = torch.sigmoid(-x) * w
    loss = torch.sum(F.softplus(-x) * w)
    reg_w = (cfg.reg * w)[:, None]
    gP = (s[:, None] * d - reg_w * pu) * umask[None, :]
    segment_sum.segment_apply(P, lr * gP, *orders[0])
    if update_item_params:
        gQi = (s[:, None] * pu - reg_w * qi) * imask[None, :]
        gQj = (-s[:, None] * pu - reg_w * qj) * imask[None, :]
        out = Q if dq is None else dq
        segment_sum.segment_apply(out, lr * gQi, *orders[1])
        segment_sum.segment_apply(out, lr * gQj, *orders[2])
    return loss


def _start(params: sgd.MFParams, cfg: SGDConfig):
    """Copies of the tables (training writes in place) and both masks."""
    P = params.user_features.clone()
    Q = params.item_features.clone()
    masks = [sgd.mask_tensor(cfg, s, P.device) for s in ("user", "item")]
    return P, Q, masks


def bpr_train(
    params: sgd.MFParams,
    u_all: torch.Tensor,  # (n_pad,) int32 positives, zero-padded
    i_all: torch.Tensor,  # (n_pad,) int32
    w_all: torch.Tensor,  # (n_pad,) f32, 0.0 on padding
    generator: Optional[torch.Generator],
    cfg: SGDConfig,
    n_epochs: int,
    lr: float,
    n_items: int,
    batch_size: int,
    n_real: int,
    update_item_params: bool = True,
    perms: Optional[Sequence] = None,
    negatives: Optional[Sequence] = None,
) -> Tuple[sgd.MFParams, torch.Tensor]:
    """Multi-epoch flat BPR; returns (params, per-epoch mean visited
    loss as one (n_epochs,) device tensor). Each epoch permutes the padded
    stream and draws one negative a triplet, then walks it in batches of
    ``batch_size``; each batch is sorted by user, item and negative on
    the device for the applies. ``perms`` (one permutation of ``n_pad``
    an epoch) and ``negatives`` (one (n_pad,) array an epoch) replace the
    draws from ``generator``."""
    n_pad = u_all.shape[0]
    nb = n_pad // batch_size
    P, Q, (umask, imask) = _start(params, cfg)
    dev = P.device
    hist = []
    for e in range(n_epochs):
        perm = sgd.draw_order(perms, e, n_pad, generator, dev)
        j_all = (_as_ids(negatives[e], dev) if negatives is not None
                 else _draw_ids(n_pad, n_items, generator, dev))
        us, is_, ws = u_all[perm], i_all[perm], w_all[perm]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(nb):
            sl = slice(k * batch_size, (k + 1) * batch_size)
            u, i, j = us[sl], is_[sl], j_all[sl]
            loss = loss + bpr_step(
                P, Q, u, i, j, ws[sl],
                (sorted_order(u), sorted_order(i), sorted_order(j)), cfg, lr,
                umask, imask, update_item_params)
        hist.append(loss / max(n_real, 1))
    return (params._replace(user_features=P, item_features=Q),
            _stack(hist, dev))


def bpr_train_tiled(
    params: sgd.MFParams,
    data: sgd.RatingBatches,
    generator: Optional[torch.Generator],
    cfg: SGDConfig,
    n_epochs: int,
    lr: float,
    n_items: int,
    update_item_params: bool = True,
    batch_orders: Optional[Sequence] = None,
    negatives: Optional[Sequence] = None,
) -> Tuple[sgd.MFParams, torch.Tensor]:
    """BPR on a user-primary pack (``pack_ratings(order='user')``), what
    ``BPR.fit`` runs; returns (params, per-epoch mean visited loss).

    Batch composition is fixed at pack time; each epoch visits the
    batches in a random order and draws fresh negatives for the batch at
    each visit (negatives cannot be batch-sorted: pairing them with
    user-sorted positives would bias the sample). ``batch_orders`` (one
    permutation of the batches an epoch) and ``negatives`` (one (nb, bs)
    array an epoch, row ``t`` for the ``t``-th batch visited) replace the
    draws from ``generator``: the JAX trainer's ``permutation(kp, nb)``
    and ``randint(kn, (nb, bs), 0, n_items)``."""
    if data.primary != "user" or data.sec_perm is None:
        raise ValueError("bpr_train_tiled needs an aggregated "
                         "pack_ratings(order='user') pack")
    P, Q, (umask, imask) = _start(params, cfg)
    dev = P.device
    hist = []
    for e in range(n_epochs):
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        visit = sgd.draw_order(batch_orders, e, data.n_batches, generator,
                             "cpu").tolist()
        for t, k in enumerate(visit):
            b = sgd.batch_at(data, k)
            j = (_as_ids(negatives[e][t], dev) if negatives is not None
                 else _draw_ids(data.batch_size, n_items, generator, dev))
            loss = loss + bpr_step(
                P, Q, b["u"], b["i"], j, b["w"],
                (identity_order(b["u"]), (b["sp"], b["ss"]), sorted_order(j)),
                cfg, lr, umask, imask, update_item_params)
        hist.append(loss / max(data.n_real, 1))
    return (params._replace(user_features=P, item_features=Q),
            _stack(hist, dev))


def _stack(hist, device) -> torch.Tensor:
    return torch.stack(hist) if hist else torch.zeros(0, device=device)


def rank_draws(perms, negatives, key: Tuple[int, ...], e: int, d: int,
               n: int, neg_shape: Tuple[int, ...], n_items: int, device):
    """Rank ``d``'s draws of epoch ``e`` for the data-parallel trainers: a
    permutation of ``n`` (int64) and the negatives, int32 of
    ``neg_shape``. ``perms[e][d]`` / ``negatives[e][d]`` when given, else
    drawn on ``device`` from ``seeded_generator(device, *key, e, d)``, the
    permutation first."""
    gen = (None if perms is not None and negatives is not None
           else sgd.seeded_generator(device, *key, e, d))
    order = (sgd._as_index(perms[e][d], device) if perms is not None
             else sgd._perm(n, gen).to(device))
    negs = (_as_ids(negatives[e][d], device) if negatives is not None
            else torch.randint(0, n_items, neg_shape, generator=gen,
                               device=gen.device, dtype=torch.int32).to(device))
    return order, negs


def _dp_epochs(params: sgd.MFParams, cfg: SGDConfig, n_epochs: int,
               lr: float, n_real: int, mesh, overlap_psum: bool, psum_every,
               epoch_of, orders_of) -> Tuple[sgd.MFParams, torch.Tensor]:
    """The loop both data-parallel trainers share: ``epoch_of(e, d)`` gives
    rank d's batches of epoch e in visit order (dicts with ``u``, ``i``,
    ``j``, ``w``), ``orders_of(b)`` a batch's ``(perm, ids_sorted)`` of
    ``u``, ``i`` and ``j``. Each epoch runs as windows of ``psum_every``
    steps (the Q deltas into ``dQ``, one all-reduce a window), then the
    summed loss is all-reduced and divided by ``n_real``."""
    import torch.distributed as dist

    from matrix_factorization_tpu_torch.parallel.distributed import (
        _check_psum_every, _windowed_epoch)
    from matrix_factorization_tpu_torch.parallel.mesh import data_group, device_index

    group, d = data_group(mesh), device_index(mesh)
    P, Q, (umask, imask) = _start(params, cfg)
    dev = P.device
    hist = []
    for e in range(n_epochs):
        batches = epoch_of(e, d)
        T = _check_psum_every(psum_every, len(batches))
        loss = [torch.zeros((), dtype=torch.float32, device=dev)]

        def step(b, deltas):
            loss[0] = loss[0] + bpr_step(
                P, Q, b["u"], b["i"], b["j"], b["w"], orders_of(b), cfg, lr,
                umask, imask, dq=deltas[0])

        _windowed_epoch([(Q, group)], batches, T, step, overlap_psum)
        total = loss[0].reshape(1)
        dist.all_reduce(total, group=group)
        hist.append(total[0] / max(n_real, 1))
    return params._replace(user_features=P, item_features=Q), _stack(hist, dev)


def dp_bpr_train(
    params: sgd.MFParams,
    data,  # parallel.distributed.ShardedRatings: LOCAL user ids, padded
    cfg: SGDConfig,
    n_epochs: int,
    lr: float,
    n_items: int,
    batch_size: int,
    n_real: int,
    mesh,
    overlap_psum: bool = False,
    perms: Optional[Sequence] = None,
    negatives: Optional[Sequence] = None,
    key: Tuple[int, ...] = (0,),
) -> Tuple[sgd.MFParams, torch.Tensor]:
    """Flat data-parallel BPR (JAX ``dp_bpr_train``), run by every rank:
    ``params`` its P rows and a whole Q (``parallel.distributed.
    place_params``), ``data`` its user range of the padded stream
    (``local_ratings`` of ``dp_fit_plumbing``'s split; the ratings column
    is not read). Each epoch the rank permutes its stream and draws one
    negative a triplet, then walks it in batches of ``batch_size``, each
    sorted on the device; every step's Q deltas are all-reduced (deferred
    one step under ``overlap_psum``). ``perms[e][d]`` (a permutation of the
    rank's stream) and ``negatives[e][d]`` (one id a triplet, in permuted
    order) replace the draws from ``seeded_generator(device, *key, e,
    d)``. Returns this rank's (P_l, Q, mu) and the per-epoch mean visited
    loss over ``n_real`` (a device tensor, the same on every rank)."""
    from matrix_factorization_tpu_torch.parallel.distributed import _check_orders

    _check_orders(perms, n_epochs, "perms")
    _check_orders(negatives, n_epochs, "negatives")
    n = data.user_ids.shape[0]
    if n % batch_size:
        raise ValueError(f"the rank's stream of {n} is not a whole number of "
                         f"batches of {batch_size}")
    dev = params.user_features.device

    def epoch_of(e, d):
        perm, j_all = rank_draws(perms, negatives, key, e, d, n, (n,),
                                 n_items, dev)
        cols = {"u": data.user_ids[perm], "i": data.item_ids[perm],
                "j": j_all, "w": data.weights[perm]}
        return [{k: v[lo:lo + batch_size] for k, v in cols.items()}
                for lo in range(0, n, batch_size)]

    return _dp_epochs(params, cfg, n_epochs, lr, n_real, mesh, overlap_psum,
                      1, epoch_of,
                      lambda b: (sorted_order(b["u"]), sorted_order(b["i"]),
                                 sorted_order(b["j"])))


def dp_bpr_train_tiled(
    params: sgd.MFParams,
    data: sgd.RatingBatches,
    cfg: SGDConfig,
    n_epochs: int,
    lr: float,
    n_items: int,
    mesh,
    overlap_psum: bool = False,
    psum_every=1,
    batch_orders: Optional[Sequence] = None,
    negatives: Optional[Sequence] = None,
    key: Tuple[int, ...] = (0,),
) -> Tuple[sgd.MFParams, torch.Tensor]:
    """Data-parallel BPR on this rank's segment of the user-primary
    device-major pack (JAX ``dp_bpr_train_tiled``): ``data`` is
    ``pack_ratings(order='user', n_dev=N, users_per_dev=Ucap / N,
    segment=d)``, ``params`` from ``place_params``. A step is
    ``bpr_train_tiled``'s (P over the batch's own user order, ``Q[i]`` over
    the pack's secondary order, ``Q[j]`` over a per-batch sort of the
    negatives), its Q deltas into the window's ``dQ``: ``psum_every``
    (``_check_psum_every``: a divisor of the rank's batches, ``'auto'`` or
    ``'epoch'``) steps a window, all reading Q as it stood at the window's
    start. ``batch_orders[e][d]`` (a permutation of the rank's batches) and
    ``negatives[e][d]`` (an (nb_local, bs) array, row ``t`` for the
    ``t``-th batch visited) replace the draws. Returns this rank's (P_l, Q,
    mu) and the per-epoch mean visited loss over the pack's ``n_real``."""
    if data.primary != "user" or data.sec_perm is None:
        raise ValueError("dp_bpr_train_tiled needs an aggregated "
                         "pack_ratings(order='user') pack")
    from matrix_factorization_tpu_torch.parallel.distributed import _check_orders

    _check_orders(batch_orders, n_epochs, "batch_orders")
    _check_orders(negatives, n_epochs, "negatives")
    nb, bs = data.n_batches, data.batch_size
    dev = params.user_features.device

    def epoch_of(e, d):
        visit, negs = rank_draws(batch_orders, negatives, key, e, d, nb,
                                 (nb, bs), n_items, dev)
        out = []
        for t, k in enumerate(visit.tolist()):
            b = sgd.batch_at(data, k)
            b["j"] = negs[t]
            out.append(b)
        return out

    return _dp_epochs(params, cfg, n_epochs, lr, data.n_real, mesh,
                      overlap_psum, psum_every, epoch_of,
                      lambda b: (identity_order(b["u"]), (b["sp"], b["ss"]),
                                 sorted_order(b["j"])))


def _members(keys: torch.Tensor, q: np.ndarray) -> np.ndarray:
    """Which of the int64 ``q`` are in the ascending ``keys`` (a tensor on
    the tables' device), by binary search: exact, as ``np.isin``."""
    qt = torch.from_numpy(np.ascontiguousarray(q, np.int64)).to(keys.device)
    idx = torch.searchsorted(keys, qt).clamp_(max=keys.numel() - 1)
    return (keys[idx] == qt).cpu().numpy()


def auc_sampled(params: sgd.MFParams, u: np.ndarray, i: np.ndarray,
                n_items: int, cfg: SGDConfig, seed: int = 0,
                n_neg: int = 20,
                observed: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                chunk: int = 16_384) -> float:
    """Sampled pairwise AUC on (u, i) positives: the fraction of
    (positive, negative) pairs the model ranks strictly correctly. The
    negatives are drawn on the host with numpy's ``default_rng(seed)``,
    exactly as the JAX package draws them (so the two agree on the same
    tables); ``observed`` (u_obs, i_obs) pairs are true positives and are
    rejected from the draws (up to 8 resample rounds). The membership test
    of the rejection sorts the observed pairs' keys once on the tables'
    device (millions of training pairs) and searches them; the scoring
    runs there too, ``chunk`` positives at a time."""
    P, Q = params.user_features, params.item_features
    dev = P.device
    rng = np.random.default_rng(seed)
    j = rng.integers(0, n_items, (len(u), n_neg)).astype(np.int32)
    if observed is not None and len(observed[0]):
        keys = torch.sort(
            torch.from_numpy(observed[0].astype(np.int64) * n_items
                             + observed[1].astype(np.int64)).to(dev)).values
        jf = j.reshape(-1)
        uf = np.repeat(u.astype(np.int64), n_neg)
        bad = np.flatnonzero(_members(keys, uf * n_items + jf))
        for _ in range(8):
            if bad.size == 0:
                break
            jf[bad] = rng.integers(0, n_items, bad.size, dtype=np.int32)
            bad = bad[_members(keys, uf[bad] * n_items + jf[bad])]
        del keys
    wins = 0
    for lo in range(0, len(u), chunk):
        uu = torch.from_numpy(np.asarray(u[lo:lo + chunk], np.int64)).to(dev)
        ii = torch.from_numpy(np.asarray(i[lo:lo + chunk], np.int64)).to(dev)
        jj = torch.from_numpy(j[lo:lo + chunk].astype(np.int64)).to(dev)
        # one product for the positive and the negatives, so that a
        # negative equal to the positive scores the same bits: a tie,
        # which counts as a miss
        x = torch.einsum("nk,nmk->nm", P[uu], Q[torch.cat([ii[:, None], jj], 1)])
        wins += int(torch.count_nonzero(x[:, :1] > x[:, 1:]))
    return wins / max(j.size, 1)
