"""Hyper-parameter sweeps of KernelMF SGD (PyTorch port).

Counterpart of ``matrix_factorization_tpu/ops/sweep.py``. The JAX
package vmaps the whole multi-epoch trainer over the (lr, reg) grid, one
compiled program for K models. Here the K candidates train one after
another over the same packed stream and the same per-epoch batch orders,
each through ``segment_sgd.sgd_train`` and so, on the card, through the
hand-written step and apply kernels (``ops/cuda_sgd.py``): ``vmap``
cannot see through a ``ctypes`` launch, and a kernel that trains K
stacked tables at once would be a new design. ``jit_grid_train`` has no
counterpart (PyTorch runs eagerly).

The candidates' random streams are the ones ``KernelMF.fit`` draws: the
initial tables from a generator seeded with ``seed`` on the data's
device, the batch orders from ``seeded_generator('cpu', seed, 1)``. So a
candidate equals ``KernelMF(lr=lr_k, reg=reg_k, seed=seed).fit`` on the
same pack, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd


def _as_floats(v) -> list:
    return [float(x) for x in np.asarray(v, np.float64).reshape(-1)]


def grid_train(
    data: sgd.RatingBatches,
    n_users: int,
    n_items: int,
    cfg: SGDConfig,
    n_epochs: int,
    lrs: Sequence[float],
    regs: Sequence[float],
    global_mean: float,
    seed: int = 0,
    per_candidate_init: bool = False,
    init_mean: float = 0.0,
    init_sd: float = 0.1,
    init: Optional[Sequence[sgd.MFParams]] = None,
    batch_orders: Optional[Sequence] = None,
) -> Tuple[sgd.MFParams, torch.Tensor]:
    """Train ``K = len(lrs)`` models over shared ``data``.

    Returns (MFParams with a leading K axis on every field, (K, n_epochs)
    train RMSE history). ``per_candidate_init=True`` gives each candidate
    its own initial tables (drawn one after another from the seeded
    generator); the default shares one, so that candidates differ only in
    (lr, reg). ``init`` (one MFParams, or K of them) and ``batch_orders``
    (one permutation an epoch, shared by every candidate) replace the
    seeded streams; the tests hand the JAX package's streams in this
    way."""
    if np.ndim(lrs) != 1 or np.shape(lrs) != np.shape(regs):
        raise ValueError("lrs and regs must be 1-D of equal length")
    lrs, regs = _as_floats(lrs), _as_floats(regs)
    K = len(lrs)
    dev = data.user_ids.device
    if init is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def draw():
            return sgd.init_params(gen, n_users, n_items, cfg, global_mean,
                                   init_mean, init_sd)

        init = [draw() for _ in range(K)] if per_candidate_init else draw()
    starts = [init] * K if isinstance(init, sgd.MFParams) else list(init)
    if len(starts) != K:
        raise ValueError(f"init has {len(starts)} tables for {K} candidates")
    if batch_orders is None and cfg.shuffle != "none":
        shuffle = sgd.seeded_generator("cpu", seed, 1)
        n = data.n_batches * (data.batch_size if cfg.shuffle == "full" else 1)
        batch_orders = [sgd._perm(n, shuffle) for _ in range(n_epochs)]
    trained, hists = [], []
    for p0, lr, reg in zip(starts, lrs, regs):
        p, hist = sgd.sgd_train(p0, data, None, cfg, n_epochs, lr,
                                batch_orders=batch_orders, reg=reg)
        trained.append(p)
        hists.append(hist)
    stacked = sgd.MFParams(*(torch.stack([getattr(p, f) for p in trained])
                             for f in sgd.MFParams._fields))
    return stacked, torch.stack(hists)


def candidate(params_k: sgd.MFParams, k: int) -> sgd.MFParams:
    """Candidate ``k``'s tables out of the stack."""
    return sgd.MFParams(*(t[k] for t in params_k))


def grid_eval_rmse(
    params_k: sgd.MFParams,
    u_val: torch.Tensor,
    i_val: torch.Tensor,
    r_val: torch.Tensor,
    cfg: SGDConfig,
) -> torch.Tensor:
    """(K,) held-out RMSE of stacked sweep params (bounded predictions;
    an unknown id arrives as -1 and takes the cold row,
    ``segment_sgd.predict_pairs``)."""
    out = []
    for k in range(params_k.user_features.shape[0]):
        pred, _ = sgd.predict_pairs(candidate(params_k, k), u_val, i_val, cfg,
                                    bound_ratings=True)
        e = pred - r_val
        out.append(torch.sqrt(torch.mean(e * e)))
    return torch.stack(out)


def best_index(scores) -> int:
    """The argmin with NaN (a diverged candidate; large lr grids have
    some) treated as +inf, so it is never picked; the first of equal
    scores wins."""
    s = np.asarray(torch.as_tensor(scores).cpu(), np.float64)
    return int(np.argmin(np.where(np.isnan(s), np.inf, s)))


def select_best(params_k: sgd.MFParams,
                scores) -> Tuple[int, sgd.MFParams]:
    """The best candidate (``best_index``) and a copy of its tables (the
    stack is freed with the sweep, and the kernels want aligned tensors
    of their own)."""
    best = best_index(scores)
    return best, sgd.MFParams(*(t.clone()
                                for t in candidate(params_k, best)))
