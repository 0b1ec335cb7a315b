"""Model-level hyper-parameter grid search of KernelMF (PyTorch port).

Counterpart of ``grid_search_kernel_mf`` in
``matrix_factorization_tpu/models/grid_search.py`` (single device). The
reference tunes with sklearn ``GridSearchCV`` over the estimator API (81
candidates x 5 folds, ``examples/recommender-system.ipynb`` cells 29-30);
here every (lr, reg) candidate trains over one preprocessing pass and one
packed rating stream (``ops/sweep.py``), on the card through the SGD step
and apply kernels, and the winner serves through the catalog scorer.
``grid_search_ease`` comes with EASE.
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
