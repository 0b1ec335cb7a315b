"""Non-negative matrix factorization on the observed-ratings mask,
PyTorch port.

Counterpart of ``matrix_factorization_tpu/ops/nmf.py``, single device: the
Lee-Seung multiplicative update restricted to observed entries, with
per-entity-count L2 (the `surprise` NMF), on an alternating schedule: the
user pass accumulates against the pre-epoch ``Q`` and updates ``P``, the
item pass then accumulates against the fresh ``P``::

    p_uf <- p_uf * (sum_{i in I_u} q_if r_ui)
                  / (sum_{i in I_u} q_if est_ui + reg |I_u| p_uf + eps)

Each pass reads the pack batch by batch and sums one side's
``[other * r || other * est]`` rows into a ``(cap, 2k)`` accumulator; the
update itself is one elementwise pass, and rows with no observations keep
their values. Training draws no randomness after the init.

The accumulator is ``segment_sum.segment_sum``, which on the card is the
hand-written ``mf_segment_sum`` (its "columns" layout takes the 2k-wide
rows as they are, 30 at the default k = 15; one writer a row, no float
atomics): over a batch's own order when the side is the pack's primary
(every batch is stored sorted by it), over the pack's ``sec_perm`` /
``sec_ids_sorted`` when it is the secondary. So a pack of either
orientation serves both passes.

Tables are ``segment_sgd``'s bias-folded rows with the biases and
``global_mean`` at 0, so the linear scorer's ``mu + b_u + b_i + p.q`` is
the NMF score ``p.q``.

``dp_nmf_train`` is the data-parallel form (JAX ``dp_nmf_train``), run by
every rank of a mesh (``parallel/mesh.py``) on its user rows of P and a
whole Q, over its segment of the device-major pack (local user ids). The
user pass needs no communication (a user's ratings all live on its
rank); the item pass all-reduces one (Icap, 2k) accumulator an epoch, and
the update then runs the same way on every rank, so the Q replicas stay
bit-equal. Each pass is a full-batch segment sum, so the schedule is the
single-device one up to where the sums regroup.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from matrix_factorization_tpu_torch.core.config import SUBLANE, SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import segment_sum as segsum


def _uniform_rows(generator: torch.Generator, n: int, cfg: SGDConfig,
                  side: str, init_low: float, init_high: float) -> torch.Tensor:
    """Rows of Uniform[init_low, init_high) factors, biases 0, constant 1."""
    device = generator.device
    f = torch.zeros((n, sgd.padded_width(cfg)), dtype=torch.float32,
                    device=device)
    f[:, : cfg.n_factors] = init_low + (init_high - init_low) * torch.rand(
        (n, cfg.n_factors), generator=generator, device=device)
    f[:, sgd.const_col(cfg, side)] = 1.0
    return f


def init_nmf_params(
    generator: torch.Generator,
    n_users: int,
    n_items: int,
    cfg: SGDConfig,
    init_low: float = 0.0,
    init_high: float = 1.0,
    user_capacity: Optional[int] = None,
    item_capacity: Optional[int] = None,
) -> sgd.MFParams:
    """Non-negative uniform factors in extended rows on the generator's
    device (the JAX layout; not its random bits)."""
    if init_low < 0 or init_high <= init_low:
        raise ValueError("need 0 <= init_low < init_high")
    ucap = sgd.round_up(user_capacity or n_users, SUBLANE)
    icap = sgd.round_up(item_capacity or n_items, SUBLANE)
    return sgd.MFParams(
        user_features=_uniform_rows(generator, ucap, cfg, "user", init_low,
                                    init_high),
        item_features=_uniform_rows(generator, icap, cfg, "item", init_low,
                                    init_high),
        global_mean=torch.tensor(0.0, dtype=torch.float32,
                                 device=generator.device),
    )


def fresh_nmf_user_rows(generator: torch.Generator, n: int, cfg: SGDConfig,
                        init_low: float, init_high: float) -> torch.Tensor:
    """Rows for new or re-initialised users."""
    return _uniform_rows(generator, n, cfg, "user", init_low, init_high)


def _accumulate_side(P: torch.Tensor, Q: torch.Tensor,
                     data: sgd.RatingBatches, k: int,
                     side: str) -> torch.Tensor:
    """One read-only pass over the pack: the (cap, 2k)
    ``[sum other*r || sum other*est]`` accumulator of ``side``, for a pack
    of either orientation."""
    cap = (P if side == "user" else Q).shape[0]
    side_is_prim = side == data.primary
    if not side_is_prim and data.sec_perm is None:
        raise ValueError("NMF's secondary side needs an aggregated pack "
                         "(pack_ratings(aggregate=True))")
    Pk, Qk = P[:, :k], Q[:, :k]
    acc = torch.zeros((cap, 2 * k), dtype=torch.float32, device=P.device)
    for b in range(data.n_batches):
        u, i = data.user_ids[b], data.item_ids[b]
        w = data.weights[b]
        pu, qi = Pk[u.long()], Qk[i.long()]
        est = torch.sum(pu * qi, dim=1)
        other = qi if side == "user" else pu
        rows = torch.cat([other * (data.ratings[b] * w)[:, None],
                          other * (est * w)[:, None]], dim=1)
        if side_is_prim:
            order = segsum.identity_order(u if side == "user" else i)
        else:
            order = (data.sec_perm[b], data.sec_ids_sorted[b])
        segsum.segment_sum(acc, rows, *order)
    return acc


def _apply_mult_update(table: torch.Tensor, acc: torch.Tensor,
                       cnt: torch.Tensor, k: int, reg: float,
                       eps: float) -> torch.Tensor:
    """Masked multiplicative update of the factor slice, out of place:
    rows with zero observations keep their values."""
    f = table[:, :k]
    new_f = f * acc[:, :k] / (acc[:, k:] + reg * cnt[:, None] * f + eps)
    out = table.clone()
    out[:, :k] = torch.where((cnt > 0)[:, None], new_f, f)
    return out


def nmf_train(
    params: sgd.MFParams,
    data: sgd.RatingBatches,
    cnt_u: torch.Tensor,  # (Ucap,) f32 observation counts
    cnt_i: torch.Tensor,  # (Icap,) f32
    cfg: SGDConfig,
    n_epochs: int,
    reg_pu: float,
    reg_qi: float,
    update_user_params: bool = True,
    update_item_params: bool = True,
    eps: float = 1e-8,
) -> Tuple[sgd.MFParams, torch.Tensor]:
    """Multi-epoch alternating NMF; returns (params, per-epoch train RMSE
    as one device tensor, zeros when ``cfg.compute_epoch_rmse`` is
    false). A frozen side's table is the caller's tensor, untouched."""
    k = cfg.n_factors
    p = params
    dev = params.user_features.device
    hist = []
    for _ in range(n_epochs):
        P, Q = p.user_features, p.item_features
        if update_user_params:
            P = _apply_mult_update(P, _accumulate_side(P, Q, data, k, "user"),
                                   cnt_u, k, reg_pu, eps)
        if update_item_params:
            Q = _apply_mult_update(Q, _accumulate_side(P, Q, data, k, "item"),
                                   cnt_i, k, reg_qi, eps)
        p = p._replace(user_features=P, item_features=Q)
        if cfg.compute_epoch_rmse:
            hist.append(torch.sqrt(sgd.masked_sse(p, data, cfg)
                                   / max(data.n_real, 1)))
        else:
            hist.append(torch.zeros((), device=dev))
    return p, (torch.stack(hist) if hist else torch.zeros(0, device=dev))


def dp_nmf_train(
    params: sgd.MFParams,
    data: sgd.RatingBatches,
    cnt_u: torch.Tensor,  # (rows of P_l,) f32: the rank's users' counts
    cnt_i: torch.Tensor,  # (Icap,) f32: the global item counts
    cfg: SGDConfig,
    n_epochs: int,
    reg_pu: float,
    reg_qi: float,
    mesh,
) -> Tuple[sgd.MFParams, torch.Tensor]:
    """Data-parallel alternating NMF, run by every rank: ``params`` its P
    rows and a whole Q (``parallel.distributed.place_params``), ``data``
    its segment of the device-major pack (``pack_ratings(n_dev=N,
    users_per_dev=Ucap / N, segment=d)``, user ids local to the rank's
    rows). The user pass is local; the item accumulator is all-reduced
    over the data group once an epoch. Returns this rank's (P_l, Q, mu)
    and the per-epoch train RMSE (the all-reduced SSE over ``n_real``, a
    device tensor, the same on every rank)."""
    import torch.distributed as dist

    from matrix_factorization_tpu_torch.parallel.mesh import data_group

    eps = 1e-8
    k = cfg.n_factors
    group = data_group(mesh)
    p = params
    dev = params.user_features.device
    hist = []
    for _ in range(n_epochs):
        P, Q = p.user_features, p.item_features
        P = _apply_mult_update(P, _accumulate_side(P, Q, data, k, "user"),
                               cnt_u, k, reg_pu, eps)
        acc_i = _accumulate_side(P, Q, data, k, "item")
        dist.all_reduce(acc_i, group=group)
        Q = _apply_mult_update(Q, acc_i, cnt_i, k, reg_qi, eps)
        p = p._replace(user_features=P, item_features=Q)
        if cfg.compute_epoch_rmse:
            sse = sgd.masked_sse(p, data, cfg).reshape(1)
            dist.all_reduce(sse, group=group)
            hist.append(torch.sqrt(sse[0] / max(data.n_real, 1)))
        else:
            hist.append(torch.zeros((), device=dev))
    return p, (torch.stack(hist) if hist else torch.zeros(0, device=dev))
