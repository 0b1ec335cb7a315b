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
JAX step does, and adds them with ``cuda_sgd.segment_apply``: over the
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
which the tests use to replay the JAX package's draws. The data-parallel
``dp_*`` trainers come with slice 6.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import cuda_sgd
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
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
             imask: torch.Tensor, update_item_params: bool = True
             ) -> torch.Tensor:
    """One summed mini-batch BPR update, in place on ``P`` and ``Q``;
    returns the batch's visited loss (pre-update, weighted), a device
    scalar. ``orders`` holds the ``(perm, ids_sorted)`` of ``u``, ``i`` and
    ``j``. The gradient of ``-log sigmoid(x)`` at ``x = x_ui - x_uj`` is
    ``-sigmoid(-x)``; the masks keep each side's constant column fixed
    (and ``b_u`` never moves: its lane of ``qi - qj`` is ``1 - 1``)."""
    pu = P[u.long()]
    qi = Q[i.long()]
    qj = Q[j.long()]
    d = qi - qj
    x = torch.sum(pu * d, dim=1)
    s = torch.sigmoid(-x) * w
    loss = torch.sum(F.softplus(-x) * w)
    reg_w = (cfg.reg * w)[:, None]
    gP = (s[:, None] * d - reg_w * pu) * umask[None, :]
    cuda_sgd.segment_apply(P, lr * gP, *orders[0])
    if update_item_params:
        gQi = (s[:, None] * pu - reg_w * qi) * imask[None, :]
        gQj = (-s[:, None] * pu - reg_w * qj) * imask[None, :]
        cuda_sgd.segment_apply(Q, lr * gQi, *orders[1])
        cuda_sgd.segment_apply(Q, lr * gQj, *orders[2])
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
