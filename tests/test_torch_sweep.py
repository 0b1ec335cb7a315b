"""The port's (lr, reg) sweep (``ops/sweep.py``) and grid search
(``models/grid_search.py``) against the JAX package, on the CPU.

Every candidate of ``grid_train`` equals the port's ``sgd_train`` run
alone from the same tables and batch orders (bitwise: the same steps in
the same order), equals ``KernelMF.fit`` with that (lr, reg) and seed
(the same seeded streams), and equals the JAX ``grid_train`` from the
JAX init and the JAX batch orders at atol 1e-5, the bar of
``tests/test_sweep.py:46``. ``grid_search_kernel_mf`` picks the JAX
function's (lr, reg) on a seeded set with a clear winner.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.models.grid_search import (
    grid_search_kernel_mf as jax_grid_search,
)
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu.ops import sweep as jsweep
from matrix_factorization_tpu_torch import KernelMF, grid_search_kernel_mf
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import sweep

LRS = [0.01, 0.05, 0.02]
REGS = [0.1, 0.01, 0.5]


def _ratings(n_users=40, n_items=30, n=600, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = rng.integers(0, n_items, n).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


@pytest.mark.parametrize("kernel,shuffle", [
    ("linear", "batch"), ("sigmoid", "batch"), ("linear", "full")])
def test_grid_train_matches_jax_and_sgd_train_alone(kernel, shuffle):
    u, i, r = _ratings()
    mu = float(r.mean())
    kw = dict(kernel=kernel, n_factors=8, batch_size=128, min_rating=1.0,
              max_rating=5.0, shuffle=shuffle)
    cfg, jcfg = SGDConfig(**kw), JaxConfig(**kw)
    jdata = jsgd.pack_ratings(u, i, r, 128)
    data = sgd.pack_ratings(u, i, r, 128, device="cpu")
    want_k, whist_k = jsweep.grid_train(jdata, 40, 30, jcfg, 3,
                                        np.float32(LRS), np.float32(REGS), mu,
                                        seed=7)
    # the JAX streams: one init from k_init, the orders from k_train
    k_init, k_train = jax.random.split(jax.random.PRNGKey(7))
    p0 = jsgd.init_params(k_init, 40, 30, jcfg, mu)
    init = sgd.params_from_numpy(np.asarray(p0.user_features),
                                 np.asarray(p0.item_features), mu,
                                 device="cpu")
    n = data.n_batches * (128 if shuffle == "full" else 1)
    orders = [np.asarray(jax.random.permutation(k, n))
              for k in jax.random.split(k_train, 3)]
    got_k, hist_k = sweep.grid_train(data, 40, 30, cfg, 3, LRS, REGS, mu,
                                     init=init, batch_orders=orders)
    assert got_k.user_features.shape == (3, 40, cfg.padded_factors)
    assert hist_k.shape == (3, 3)
    for c in range(3):
        np.testing.assert_allclose(got_k.user_features[c].numpy(),
                                   np.asarray(want_k.user_features[c]),
                                   atol=1e-5)
        np.testing.assert_allclose(got_k.item_features[c].numpy(),
                                   np.asarray(want_k.item_features[c]),
                                   atol=1e-5)
        np.testing.assert_allclose(hist_k[c].numpy(), np.asarray(whist_k[c]),
                                   atol=1e-5)
        alone, hist = sgd.sgd_train(init, data, None, cfg, 3, LRS[c],
                                    batch_orders=orders, reg=REGS[c])
        assert torch.equal(got_k.user_features[c], alone.user_features)
        assert torch.equal(got_k.item_features[c], alone.item_features)
        assert torch.equal(hist_k[c], hist)


def test_candidates_equal_kernel_mf_fits_and_inits():
    """With the seeded streams a candidate is ``KernelMF.fit`` with its
    (lr, reg) and the same seed; per-candidate inits differ."""
    u, i, r = _ratings(seed=1)
    X = pd.DataFrame({"user_id": u, "item_id": i}).drop_duplicates()
    y = pd.Series(r[X.index.to_numpy()])
    model = KernelMF(n_factors=6, n_epochs=2, batch_size=64, seed=5,
                     device="cpu")
    uu, ii, rr = model._preprocess_fit(X, y)
    cfg = model._cfg()
    data = sgd.pack_ratings(uu, ii, rr, 64, device="cpu")
    got_k, hist_k = sweep.grid_train(data, model.n_users, model.n_items, cfg,
                                     2, LRS[:2], REGS[:2], float(rr.mean()),
                                     seed=5)
    for c in range(2):
        alone = KernelMF(n_factors=6, n_epochs=2, batch_size=64, seed=5,
                         lr=LRS[c], reg=REGS[c], device="cpu").fit(X, y)
        assert torch.equal(got_k.user_features[c],
                           alone._params.user_features)
        assert hist_k[c].tolist() == alone.train_rmse
    own, _ = sweep.grid_train(data, model.n_users, model.n_items, cfg, 0,
                              LRS[:2], REGS[:2], 3.0, seed=5,
                              per_candidate_init=True)
    assert not torch.equal(own.user_features[0], own.user_features[1])
    with pytest.raises(ValueError, match="1-D"):
        sweep.grid_train(data, model.n_users, model.n_items, cfg, 1,
                         [0.1, 0.2], [0.1], 3.0)


def test_reg_override_defaults_to_cfg():
    """``sgd_train(reg=None)`` is the path without the override, bit for
    bit, and another ``reg`` moves the tables."""
    u, i, r = _ratings(n_users=20, n_items=15, n=200, seed=2)
    cfg = SGDConfig(kernel="sigmoid", n_factors=4, batch_size=64, reg=0.07,
                    min_rating=1, max_rating=5)
    data = sgd.pack_ratings(u, i, r, 64, device="cpu")
    p0 = sgd.init_params(torch.Generator().manual_seed(0), 20, 15, cfg, 3.0)
    runs = [sgd.sgd_train(p0, data, torch.Generator().manual_seed(1), cfg, 2,
                          0.05, reg=reg) for reg in (None, 0.07, 0.3)]
    (a, ha), (b, hb), (c, _) = runs
    assert torch.equal(a.user_features, b.user_features)
    assert torch.equal(a.item_features, b.item_features) and torch.equal(ha, hb)
    assert not torch.equal(a.user_features, c.user_features)


def test_grid_eval_and_select_best():
    cfg = SGDConfig(kernel="linear", n_factors=2, min_rating=0, max_rating=10)
    kp = cfg.padded_factors
    P = torch.zeros(3, 2, kp)
    Q = torch.zeros(3, 2, kp)
    P[..., sgd.const_col(cfg, "user")] = 1.0
    Q[..., sgd.const_col(cfg, "item")] = 1.0
    Q[:, 0, sgd.bias_col(cfg, "item")] = torch.tensor([1.0, 0.0, 3.0])
    params_k = sgd.MFParams(P, Q, torch.full((3,), 2.0))
    u = torch.tensor([0, 1, -1])
    i = torch.tensor([0, 1, 0])
    r = torch.tensor([3.0, 2.0, 2.0])
    scores = sweep.grid_eval_rmse(params_k, u, i, r, cfg)
    # mu 2 + b_i: candidate 0 predicts 3, 2 and (a cold user) 3; candidate
    # 1 2, 2, 2; candidate 2 5, 2, 5
    np.testing.assert_allclose(scores.numpy(), [np.sqrt(1 / 3), np.sqrt(1 / 3),
                                                np.sqrt(13 / 3)], rtol=1e-6)
    best, p = sweep.select_best(params_k, torch.tensor([np.nan, 0.5, 0.5]))
    assert best == 1  # NaN never wins; the first of equal scores does
    assert torch.equal(p.item_features, Q[1])
    assert p.item_features.data_ptr() != Q[1].data_ptr()  # a copy


@pytest.fixture(scope="module")
def clear_winner():
    X, y = lowrank_ratings(n_users=60, n_items=45, n_factors=3, density=0.4,
                           noise_sd=0.1, seed=5)
    return X, y, dict(lrs=[0.0005, 0.03], regs=[0.01, 1.0], n_epochs=6,
                      n_factors=8, batch_size=128)


def test_grid_search_holdout_picks_the_jax_winner(clear_winner):
    X, y, kw = clear_winner
    cut = int(len(y) * 0.8)
    args = (X.iloc[:cut], y.iloc[:cut], X.iloc[cut:], y.iloc[cut:])
    model, results = grid_search_kernel_mf(*args, device="cpu", **kw)
    jmodel, jresults = jax_grid_search(*args, **kw)
    assert (model.lr, model.reg) == (jmodel.lr, jmodel.reg)
    assert [(d["lr"], d["reg"]) for d in results][:1] == [
        (d["lr"], d["reg"]) for d in jresults][:1]
    assert results == sorted(results, key=lambda d: d["val_rmse"])
    np.testing.assert_allclose([d["val_rmse"] for d in results],
                               [d["val_rmse"] for d in jresults], atol=0.05)
    preds = model.predict(X.iloc[cut:])
    got = float(np.sqrt(np.mean((preds - y.iloc[cut:].to_numpy()) ** 2)))
    assert abs(got - results[0]["val_rmse"]) < 1e-5
    assert len(model.train_rmse) == kw["n_epochs"]
    assert len(model.recommend(X["user_id"].iloc[0], amount=3)) == 3


def test_grid_search_cv_picks_the_jax_winner(clear_winner):
    X, y, kw = clear_winner
    model, results = grid_search_kernel_mf(X, y, cv=3, device="cpu", **kw)
    jmodel, _ = jax_grid_search(X, y, cv=3, **kw)
    assert (model.lr, model.reg) == (jmodel.lr, jmodel.reg)
    assert len(results) == 4 and np.isfinite(results[0]["val_rmse"])
    # the winner is refit on all of X
    refit = KernelMF(n_epochs=kw["n_epochs"], n_factors=8, batch_size=128,
                     lr=model.lr, reg=model.reg, device="cpu").fit(X, y)
    assert torch.equal(model._params.user_features,
                       refit._params.user_features)


def test_grid_search_never_picks_a_diverged_candidate():
    X, y = lowrank_ratings(n_users=60, n_items=40, n_factors=3, density=0.4,
                           noise_sd=0.1, seed=3)
    cut = int(len(y) * 0.8)
    model, results = grid_search_kernel_mf(
        X.iloc[:cut], y.iloc[:cut], X.iloc[cut:], y.iloc[cut:],
        lrs=[0.01, 50.0], regs=[0.01], n_epochs=8, n_factors=8,
        batch_size=128, device="cpu")
    assert model.lr == 0.01
    assert torch.isfinite(model._params.user_features).all()
    assert np.isnan(results[-1]["val_rmse"])  # the diverged one, last
    assert np.isfinite(model.predict(X.iloc[cut:])).all()


def test_grid_search_validation_errors():
    X, y = lowrank_ratings(n_users=30, n_items=20, density=0.4, seed=5)
    kw = dict(lrs=[0.01], regs=[0.01], n_epochs=2, n_factors=4, batch_size=64,
              device="cpu")
    with pytest.raises(ValueError, match="X_val"):
        grid_search_kernel_mf(X, y, **kw)
    with pytest.raises(ValueError, match="X_val"):
        grid_search_kernel_mf(X, y, X, y, cv=2, **kw)
    with pytest.raises(ValueError, match="cv must be >= 2"):
        grid_search_kernel_mf(X, y, cv=1, **kw)
    with pytest.raises(ValueError, match="y_val"):
        grid_search_kernel_mf(X, y, X_val=X, **kw)
