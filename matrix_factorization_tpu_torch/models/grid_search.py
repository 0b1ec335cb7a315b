"""Model-level hyper-parameter grid search of KernelMF (PyTorch port).

Counterpart of ``grid_search_kernel_mf`` in
``matrix_factorization_tpu/models/grid_search.py`` (single device). The
reference tunes with sklearn ``GridSearchCV`` over the estimator API (81
candidates x 5 folds, ``examples/recommender-system.ipynb`` cells 29-30);
here every (lr, reg) candidate trains over one preprocessing pass and one
packed rating stream (``ops/sweep.py``), on the card through the SGD step
and apply kernels, and the winner serves through the catalog scorer.
``grid_search_ease`` sweeps EASE's ridge with one gram and one batched
inverse.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from matrix_factorization_tpu_torch.models.kernel_mf import KernelMF
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import sweep


def _ids(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def grid_search_kernel_mf(
    X: pd.DataFrame,
    y: pd.Series,
    X_val: pd.DataFrame = None,
    y_val: pd.Series = None,
    lrs: Sequence[float] = (0.002, 0.01, 0.05),
    regs: Sequence[float] = (0.005, 0.05, 0.5),
    n_epochs: int = 20,
    seed: int = 0,
    cv: int = 0,
    **model_kwargs,
) -> Tuple[KernelMF, list]:
    """Train the full (lr x reg) grid and pick the best by validation
    RMSE.

    ``lrs``/``regs`` are the grid's axes (every pair trains). Two
    protocols:

    * holdout: pass ``X_val``/``y_val``; the winner's trained tables are
      returned on the model;
    * ``cv=F`` folds (the reference's ``GridSearchCV(cv=5)``): fold of a
      rating from ``numpy.random.default_rng(seed)``, one sweep a fold
      (seeded ``seed + f``), scores averaged over the folds, then the
      best (lr, reg) refit on ALL of ``X``.

    ``model_kwargs`` go to ``KernelMF`` (``device`` among them). Returns
    ``(best_model, results)``: a fitted :class:`KernelMF` and a list of
    dicts (lr, reg, val_rmse, train_rmse) sorted by validation RMSE, a
    diverged (NaN) candidate last; NaN never wins.
    """
    if (X_val is None) == (not cv):
        raise ValueError("pass either X_val/y_val or cv=<folds>")
    if X_val is not None and y_val is None:
        raise ValueError("X_val requires y_val")
    if cv and cv < 2:
        raise ValueError(
            f"cv must be >= 2 folds (got cv={cv}: every fold's training "
            "split would be empty)"
        )
    grid = [(float(lr), float(rg)) for lr in lrs for rg in regs]
    lr_v = [g[0] for g in grid]
    rg_v = [g[1] for g in grid]

    model = KernelMF(n_epochs=n_epochs, seed=seed, **model_kwargs)
    u, i, r = model._preprocess_fit(X, y)
    model.global_mean = float(np.mean(r))
    cfg = model._cfg()
    dev = model._device

    def train(uu, ii, rr, fold_seed):
        data = sgd.pack_ratings(uu, ii, rr, cfg.batch_size,
                                order=model.epoch_order, device=dev)
        return sweep.grid_train(data, model.n_users, model.n_items, cfg,
                                n_epochs, lr_v, rg_v, float(rr.mean()),
                                seed=fold_seed, init_mean=model.init_mean,
                                init_sd=model.init_sd)

    if cv:
        rng = np.random.default_rng(seed)
        fold_of = rng.integers(0, cv, len(r))
        score_sum = np.zeros(len(grid), np.float32)
        hist_np = None
        for f in range(cv):
            tr = fold_of != f
            params_k, hist_k = train(u[tr], i[tr], r[tr], seed + f)
            scores = sweep.grid_eval_rmse(
                params_k, _ids(u[~tr], dev), _ids(i[~tr], dev),
                torch.from_numpy(r[~tr]).to(dev), cfg)
            score_sum += scores.cpu().numpy()
            hist_np = hist_k.cpu().numpy()  # the last fold's, as the JAX one
            del params_k
        scores_np = score_sum / cv
        best = sweep.best_index(scores_np)
        model.lr, model.reg = grid[best]
        # refit the winner on ALL the training data (sklearn refit=True)
        model.fit(X, y)
    else:
        params_k, hist_k = train(u, i, r, seed)
        uv = model.user_vocab.encode(X_val["user_id"].to_numpy())
        iv = model.item_vocab.encode(X_val["item_id"].to_numpy())
        rv = np.array(y_val, np.float32)
        scores = sweep.grid_eval_rmse(params_k, _ids(uv, dev), _ids(iv, dev),
                                      torch.from_numpy(rv).to(dev), cfg)
        scores_np = scores.cpu().numpy()
        hist_np = hist_k.cpu().numpy()
        best, best_params = sweep.select_best(params_k, scores_np)
        model.lr, model.reg = grid[best]
        model._params = best_params
        model.train_rmse = hist_np[best].tolist()

    results = sorted(
        (
            {
                "lr": grid[k][0],
                "reg": grid[k][1],
                "val_rmse": float(scores_np[k]),
                "train_rmse": float(hist_np[k][-1]),
            }
            for k in range(len(grid))
        ),
        # diverged candidates (NaN) sort last, as best_index never picks them
        key=lambda d: (np.isnan(d["val_rmse"]), d["val_rmse"]),
    )
    return model, results


def grid_search_ease(
    X: pd.DataFrame,
    y: pd.Series,
    regs: Sequence[float] = (50.0, 250.0, 1000.0),
    holdout_per_user: int = 1,
    k: int = 10,
    max_eval_users: int = 2048,
    seed: int = 0,
    **model_kwargs,
):
    """Ridge sweep of :class:`~matrix_factorization_tpu_torch.models.ease.EASE`.

    The item gram does not depend on lam, so the sweep is one gram and one
    batched Schur-recursion inverse of the stacked ``G + lam I``
    (``ops/ease.py::ease_weights_multi``). Selection is leave-``n``-out:
    ``holdout_per_user`` interactions of every user with more than that
    many are held out, candidates are scored by hit@``k`` on them (the
    users' training items masked), and the winner is refit on all
    interactions. ``model_kwargs`` go to ``EASE`` (``device`` among them).

    Returns ``(best_model, results)``: the fitted EASE and dicts
    (reg, hit_at_k) sorted best first.
    """
    from matrix_factorization_tpu_torch.models.ease import EASE
    from matrix_factorization_tpu_torch.ops import ease as ease_ops

    if not regs:
        raise ValueError("regs must be non-empty")
    if holdout_per_user < 1:
        raise ValueError("holdout_per_user must be >= 1")
    model = EASE(reg=float(regs[0]), **model_kwargs)
    u, i, r = model._preprocess_fit(X, y)
    w = model._weights(r)
    ease_ops.check_item_budget(model.n_items)

    # per-user holdout: shuffle the pairs, rank them within each user, hold
    # the first `holdout_per_user` of each user that keeps a training item
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(u))
    order = perm[np.argsort(u[perm], kind="stable")]
    us = u[order]
    starts = np.searchsorted(us, np.arange(model.n_users))
    rank = np.arange(len(us)) - starts[us]
    counts = np.bincount(u, minlength=model.n_users)
    held = np.zeros(len(u), bool)
    held[order] = (rank < holdout_per_user) & (counts[us] > holdout_per_user)
    tr = ~held

    G = ease_ops.item_gram(u[tr], i[tr], w[tr], model.n_users, model.n_items,
                           model.gram_chunk_users, device=model._device)
    B_stack = ease_ops.ease_weights_multi(G, list(regs))
    del G

    # the evaluation cohort: users with held-out items, capped
    eval_users = np.unique(u[held])
    if len(eval_users) > max_eval_users:
        eval_users = rng.choice(eval_users, max_eval_users, replace=False)
    held_items = {int(uu): set() for uu in eval_users}
    for uu, ii in zip(u[held], i[held]):
        if int(uu) in held_items:
            held_items[int(uu)].add(int(ii))

    # the cohort's training histories (the serving-side state)
    model._set_histories(u[tr], i[tr], w[tr])
    hits = np.zeros(len(regs), np.float64)
    for lo in range(0, len(eval_users), 256):
        cohort = eval_users[lo:lo + 256]
        ids, ww = model._history_block(cohort)
        for c in range(len(regs)):
            _, idx = ease_ops.history_topk_unseen(
                B_stack[c], ids, ww, min(k, model.n_items), model.n_items)
            for row, uu in enumerate(cohort):
                if held_items[int(uu)] & set(idx[row].tolist()):
                    hits[c] += 1
    hit_rate = hits / max(1, len(eval_users))
    del B_stack

    best = int(np.argmax(hit_rate))
    model.reg = float(regs[best])
    # refit the winner on all interactions
    G_full = ease_ops.item_gram(u, i, w, model.n_users, model.n_items,
                                model.gram_chunk_users, device=model._device)
    model._params = ease_ops.EASEParams(ease_ops.ease_weights(G_full, model.reg))
    model._serving_cache = None
    model._set_histories(u, i, w)

    results = sorted(
        ({"reg": float(regs[c]), "hit_at_k": float(hit_rate[c])}
         for c in range(len(regs))),
        key=lambda d: -d["hit_at_k"])
    return model, results
