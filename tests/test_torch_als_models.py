"""The port's ALS models against the JAX package's, on the CPU.

* A JAX-fitted ``KernelMF(method='als')`` saved with the JAX
  ``save_model`` loads into the port; then ``fit(warm_start=True,
  n_epochs=2)`` and ``update_users`` match the JAX model doing the same,
  on the grouped path and, with ``_als_needs_buckets`` patched true in
  both packages, on the bucketed one: tables at atol 2e-4 (the JAX
  package's bar between two ALS paths, ``tests/test_ials.py:111``), RMSE
  histories at atol 1e-4. The port's ``update_users`` solves only the
  named users as a compact block where the JAX package groups every user;
  the results agree because a user without data keeps their row in both.
* The ALS warm start's sweeps from the same initial tables match.
* A JAX-fitted ``ImplicitALS`` loads, serves and updates users as the JAX
  model does; port checkpoints of both classes load into the JAX package.
* The lifecycle tests of ``tests/test_ials.py:48-83, :310-370`` and
  ``tests/test_implicit.py``, on the port with ``device="cpu"``.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import matrix_factorization_tpu.models.kernel_mf as jax_kmf
from matrix_factorization_tpu import ImplicitALS as JaxImplicitALS
from matrix_factorization_tpu import KernelMF as JaxKernelMF
from matrix_factorization_tpu.core import checkpoint as jax_ckpt
from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu.utils.metrics import rmse
from matrix_factorization_tpu_torch import (ImplicitALS, KernelMF, fit_resumable,
                                            load_model, save_model)
from matrix_factorization_tpu_torch.models import kernel_mf as port_kmf
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd


def _views_close(got, want, names, atol=2e-4):
    for view in names:
        np.testing.assert_allclose(getattr(got, view), getattr(want, view),
                                   atol=atol, err_msg=view)


MF_VIEWS = ("user_features", "item_features", "user_biases", "item_biases")


@pytest.mark.parametrize("bucketed,reg_scale", [(False, "absolute"),
                                                (True, "per_obs")])
def test_jax_als_checkpoint_continues_like_jax(bucketed, reg_scale, tmp_path,
                                               monkeypatch):
    if bucketed:
        for mod in (jax_kmf, port_kmf):
            monkeypatch.setattr(mod, "_als_needs_buckets", lambda *a, **k: True)
    X, y = lowrank_ratings(n_users=60, n_items=40, density=0.5, seed=19)
    X = X.assign(user_id="u" + X["user_id"].astype(str))
    jm = JaxKernelMF(n_factors=6, n_epochs=3, method="als", reg=0.1,
                     reg_scale=reg_scale, batch_size=128).fit(X, y)
    jax_ckpt.save_model(jm, tmp_path / "als")
    m = load_model(tmp_path / "als", device="cpu")
    assert m.method == "als" and m.reg_scale == reg_scale
    _views_close(m, jm, MF_VIEWS, atol=0)
    np.testing.assert_allclose(m.predict(X), jm.predict(X), atol=1e-5)

    for model in (m, jm):
        model.fit(X, y, n_epochs=2, warm_start=True)
    _views_close(m, jm, MF_VIEWS)
    assert len(m.train_rmse) == 5
    np.testing.assert_allclose(m.train_rmse, jm.train_rmse, atol=1e-4)

    # a known user with fewer ratings, and two new users
    Xu = pd.concat([X[X.user_id == "u3"].iloc[:4],
                    X[X.user_id == "u5"].iloc[:7].assign(user_id="new1"),
                    X[X.user_id == "u6"].iloc[:5].assign(user_id="new2")],
                   ignore_index=True)
    yu = pd.Series(np.linspace(1.0, 5.0, len(Xu)))
    items = m.item_features.copy()
    for model in (m, jm):
        model.update_users(Xu, yu, n_epochs=5)
    np.testing.assert_array_equal(m.item_features, items)
    assert m.user_vocab.raw_ids == jm.user_vocab.raw_ids
    _views_close(m, jm, MF_VIEWS)
    np.testing.assert_allclose(m.train_rmse, jm.train_rmse, atol=1e-4)
    assert len(m.train_rmse) == 2
    np.testing.assert_allclose(m.predict(Xu), jm.predict(Xu), atol=1e-3)


@pytest.mark.parametrize("kernel,bucketed", [("sigmoid", False),
                                             ("linear", True)])
def test_warm_start_sweeps_match_jax(kernel, bucketed, monkeypatch):
    """The ALS warm start of a fresh fit, from the same initial tables:
    logit targets for sigmoid, the ratings for linear, a per-observation
    ridge of ``als_warm_reg``."""
    if bucketed:
        for mod in (jax_kmf, port_kmf):
            monkeypatch.setattr(mod, "_als_needs_buckets", lambda *a, **k: True)
    X, y = lowrank_ratings(n_users=50, n_items=40, density=0.4, noise_sd=0.1,
                           min_rating=0.5, max_rating=5.0, seed=5)
    kw = dict(n_factors=6, kernel=kernel, lr=0.01, reg=0.02, min_rating=0.5,
              max_rating=5.0, batch_size=256, als_warm_start=2,
              als_warm_reg=0.1)
    jm, m = JaxKernelMF(**kw), KernelMF(device="cpu", **kw)
    u, i, r = jm._preprocess_fit(X, y)
    m._preprocess_fit(X, y)
    cfg, jcfg = m._cfg(), jm._cfg()
    jp = jsgd.init_params(jax.random.PRNGKey(2), 50, 40, jcfg, float(r.mean()))
    start = sgd.params_from_numpy(np.asarray(jp.user_features),
                                  np.asarray(jp.item_features), float(r.mean()),
                                  device="cpu")
    want = jm._run_als_warm_start(jp, u, i, r, jcfg,
                                  jsgd.pack_ratings(u, i, r, 256))
    got = m._run_als_warm_start(start, u, i, r, cfg,
                                sgd.pack_ratings(u, i, r, 256, device="cpu"))
    np.testing.assert_allclose(got.user_features.numpy(),
                               np.asarray(want.user_features), atol=2e-4)
    np.testing.assert_allclose(got.item_features.numpy(),
                               np.asarray(want.item_features), atol=2e-4)


@pytest.fixture(scope="module")
def interactions():
    rng = np.random.default_rng(0)
    n_u, n_i, n = 60, 40, 600
    flat = rng.choice(n_u * n_i, size=n, replace=False)
    X = pd.DataFrame({"user_id": (flat // n_i).astype(np.int32),
                      "item_id": (flat % n_i).astype(np.int32)})
    return X, pd.Series(rng.exponential(2.0, n).astype(np.float32))


def test_jax_implicit_checkpoint_serves_and_updates_like_jax(interactions,
                                                             tmp_path):
    X, s = interactions
    jm = JaxImplicitALS(n_factors=8, n_epochs=4, reg=0.2, alpha=5.0).fit(X, s)
    jax_ckpt.save_model(jm, tmp_path / "implicit")
    m = load_model(tmp_path / "implicit", device="cpu")
    assert isinstance(m, ImplicitALS) and m.train_loss == jm.train_loss
    _views_close(m, jm, ("user_features", "item_features"), atol=0)
    Xq = pd.concat([X.iloc[:50], pd.DataFrame({"user_id": [-1],
                                               "item_id": [3]})])
    np.testing.assert_allclose(m.predict(Xq), jm.predict(Xq), atol=1e-6)
    assert m.predictions_possible == jm.predictions_possible
    for a, b in ((m.recommend(5, amount=6, items_known=[0, 1]),
                  jm.recommend(5, amount=6, items_known=[0, 1])),
                 (m.recommend_batch([1, 2, 3], amount=4),
                  jm.recommend_batch([1, 2, 3], amount=4))):
        assert list(a.item_id) == list(b.item_id)
        np.testing.assert_allclose(a.rating_pred, b.rating_pred, atol=1e-6)
    Xn = pd.DataFrame({"user_id": ["fresh"] * 3 + [7, 7],
                       "item_id": [0, 5, 9, 2, 11]})
    sn = pd.Series([3.0, 1.0, 2.0, 0.5, 4.0])
    for model in (m, jm):
        model.update_users(Xn, sn)
    assert m.user_vocab.raw_ids == jm.user_vocab.raw_ids
    _views_close(m, jm, ("user_features", "item_features"), atol=2e-5)


def test_port_als_checkpoints_load_into_jax(interactions, tmp_path):
    X, y = lowrank_ratings(n_users=40, n_items=30, density=0.5, seed=3)
    m = KernelMF(n_factors=5, n_epochs=2, method="als", reg=0.1,
                 device="cpu").fit(X, y)
    Xi, s = interactions
    mi = ImplicitALS(n_factors=6, n_epochs=2, device="cpu").fit(Xi, s)
    for model, Xp in ((m, X), (mi, Xi)):
        path = tmp_path / type(model).__name__
        save_model(model, path)
        back = jax_ckpt.load_model(path)
        assert type(back).__name__ == type(model).__name__
        np.testing.assert_allclose(back.predict(Xp.iloc[:40]),
                                   model.predict(Xp.iloc[:40]), atol=1e-6)
        again = load_model(path, device="cpu")
        np.testing.assert_array_equal(again.user_features, model.user_features)


# -- lifecycle (tests/test_ials.py:48-83, :310-370) ---------------------------


def test_kernelmf_als_converges_fast():
    X, y = lowrank_ratings(n_users=100, n_items=80, n_factors=4,
                           density=0.4, noise_sd=0.05, seed=2)
    als = KernelMF(n_factors=8, n_epochs=5, method="als", reg=0.1,
                   batch_size=256, device="cpu").fit(X, y)
    sgd_m = KernelMF(n_factors=8, n_epochs=5, method="sgd", lr=0.02,
                     reg=0.02, batch_size=256, device="cpu").fit(X, y)
    # exact alternation dominates 5 epochs of SGD
    assert rmse(y, als.predict(X)) < rmse(y, sgd_m.predict(X))
    assert als.train_rmse[-1] <= als.train_rmse[0]
    assert len(als.recommend(user=X["user_id"].iloc[0], amount=5)) == 5


def test_als_fit_resumable_equals_one_fit(tmp_path):
    """ALS draws no random numbers after the initial tables, so two
    checkpointed segments of 2 sweeps give the bits of one 4-sweep fit."""
    X, y = lowrank_ratings(n_users=50, n_items=30, density=0.5, seed=4)
    kw = dict(n_factors=5, n_epochs=4, method="als", reg=0.1,
              reg_scale="per_obs", device="cpu")
    one = KernelMF(**kw).fit(X, y)
    seg = fit_resumable(KernelMF(**kw), X, y, tmp_path / "ckpt",
                        segment_epochs=2)
    assert seg._epochs_done == 4 and seg.train_rmse == one.train_rmse
    np.testing.assert_array_equal(seg.user_features, one.user_features)
    np.testing.assert_array_equal(seg.item_biases, one.item_biases)


def test_als_rejects_nonlinear_kernels():
    with pytest.raises(ValueError, match="linear"):
        KernelMF(kernel="rbf", method="als", device="cpu")
    with pytest.raises(ValueError, match="Method"):
        KernelMF(method="newton", device="cpu")
    with pytest.raises(ValueError):
        KernelMF(method="als", reg_scale="bogus", device="cpu")


def test_als_update_users_cold_start():
    X, y = lowrank_ratings(n_users=60, n_items=40, density=0.5, seed=19)
    holdout = X["user_id"] == 0
    m = KernelMF(n_factors=6, method="als", reg=0.1, n_epochs=5,
                 batch_size=128, device="cpu").fit(X[~holdout], y[~holdout])
    items_before = m.item_features.copy()
    m.update_users(X[holdout], y[holdout], n_epochs=5)
    np.testing.assert_array_equal(m.item_features, items_before)
    err = rmse(y[holdout], m.predict(X[holdout]))
    base = rmse(y[holdout], np.full(int(holdout.sum()), float(y.mean())))
    assert err < base
    # every rating on an unknown item: nothing is solved, as in the JAX model
    users = m.user_features.copy()
    m.update_users(pd.DataFrame({"user_id": [3], "item_id": [999]}),
                   pd.Series([2.0]), n_epochs=5)
    np.testing.assert_array_equal(m.user_features, users)
    assert m.train_rmse == [0.0, 0.0]


def test_sigmoid_als_warm_start_beats_cold_sgd():
    X, y = lowrank_ratings(n_users=120, n_items=90, n_factors=4,
                           density=0.35, noise_sd=0.1, min_rating=0.5,
                           max_rating=5.0, seed=5)
    kw = dict(n_factors=8, n_epochs=3, kernel="sigmoid", lr=0.01,
              reg=0.02, min_rating=0.5, max_rating=5.0, batch_size=512,
              device="cpu")
    cold = KernelMF(**kw).fit(X, y)
    warm = KernelMF(als_warm_start=1, **kw).fit(X, y)
    assert warm.train_rmse[0] < cold.train_rmse[0] - 0.05, (
        warm.train_rmse, cold.train_rmse)
    assert warm.train_rmse[-1] < cold.train_rmse[-1]
    lin = KernelMF(als_warm_start=1, n_factors=8, n_epochs=2,
                   kernel="linear", lr=0.002, reg=0.02, min_rating=0.5,
                   max_rating=5.0, batch_size=512, device="cpu").fit(X, y)
    assert lin.train_rmse[-1] <= lin.train_rmse[0]
    # als_warm_reg is live: another ridge, another fit, still a good init
    strong = KernelMF(als_warm_start=1, als_warm_reg=0.5, **kw).fit(X, y)
    assert strong.train_rmse[0] != warm.train_rmse[0]
    assert strong.train_rmse[0] < cold.train_rmse[0] - 0.05
    for bad in ({"kernel": "rbf", "als_warm_start": 1},
                {"method": "als", "als_warm_start": 1},
                {"als_warm_start": -1}):
        with pytest.raises(ValueError):
            KernelMF(device="cpu", **bad)


def test_als_warm_start_skipped_on_warm_start_continuation():
    """``fit(warm_start=True)`` continues from the current tables: the
    warm sweeps initialise a fresh fit only."""
    X, y = lowrank_ratings(n_users=80, n_items=60, n_factors=4,
                           density=0.35, noise_sd=0.1, min_rating=0.5,
                           max_rating=5.0, seed=9)
    m = KernelMF(n_epochs=2, n_factors=8, kernel="sigmoid", lr=0.01,
                 reg=0.02, min_rating=0.5, max_rating=5.0, batch_size=512,
                 als_warm_start=1, device="cpu")
    m.fit(X, y)
    calls = []
    orig = m._run_als_warm_start
    m._run_als_warm_start = lambda *a, **k: calls.append(1) or orig(*a, **k)
    before = m._params.user_features.clone()
    rmse_before = m.train_rmse[-1]
    m.fit(X, y, n_epochs=2, warm_start=True)
    assert not calls, "warm sweeps must not re-run on a continuation fit"
    assert len(m.train_rmse) == 4
    assert m.train_rmse[-1] <= rmse_before + 0.02
    assert not torch.equal(before, m._params.user_features)


# -- ImplicitALS lifecycle (tests/test_implicit.py) ----------------------------


def test_implicit_fit_loss_decreases_and_scores_rank_observed_items(interactions):
    X, s = interactions
    m = ImplicitALS(n_factors=16, n_epochs=8, reg=0.05, alpha=5.0,
                    device="cpu").fit(X, s)
    assert len(m.train_loss) == 8 and m.train_loss[-1] < m.train_loss[0]
    obs = np.asarray(m.predict(X.iloc[:100], bound_ratings=False))
    rng = np.random.default_rng(0)
    seen = set(zip(X["user_id"], X["item_id"]))
    rows = [(u_, i_) for u_ in range(40) for i_ in rng.integers(0, 40, 3)
            if (u_, i_) not in seen][:100]
    unobs = np.asarray(m.predict(pd.DataFrame(rows, columns=["user_id", "item_id"]),
                                 bound_ratings=False))
    assert obs.mean() > unobs.mean() + 0.2


def test_implicit_recommend_excludes_known_and_orders(interactions):
    X, s = interactions
    m = ImplicitALS(n_factors=16, n_epochs=6, alpha=5.0, device="cpu").fit(X, s)
    user = int(X["user_id"].iloc[0])
    known = set(X.loc[X["user_id"] == user, "item_id"])
    recs = m.recommend(user=user, amount=5, items_known=known)
    assert len(recs) == 5 and not set(recs["item_id"]) & known
    assert recs["rating_pred"].is_monotonic_decreasing


def test_implicit_update_users_new_user_matches_exact_solve(interactions):
    X, s = interactions
    m = ImplicitALS(n_factors=16, n_epochs=6, reg=0.2, alpha=5.0,
                    device="cpu").fit(X, s)
    items = m.item_features.copy()
    Xn = pd.DataFrame({"user_id": ["brand_new"] * 3, "item_id": [0, 5, 9]})
    m.update_users(Xn, pd.Series([3.0, 1.0, 2.0]))
    assert m.contains_user("brand_new")
    Y = m.item_features.astype(np.float64)
    np.testing.assert_array_equal(m.item_features, items)
    A = Y.T @ Y + 0.2 * np.eye(16)
    b = np.zeros(16)
    for j, c in zip([m.item_id_map[j] for j in (0, 5, 9)], [3.0, 1.0, 2.0]):
        A += 5.0 * c * np.outer(Y[j], Y[j])
        b += (1.0 + 5.0 * c) * Y[j]
    np.testing.assert_allclose(m.user_features[m.user_id_map["brand_new"]],
                               np.linalg.solve(A, b), rtol=2e-3, atol=1e-4)
    preds = m.predict(Xn)
    assert all(0.0 <= p <= 1.0 for p in preds)
    assert m.predictions_possible == [True, True, True]
    # every interaction on an unknown item: nothing to solve
    before = m.user_features.copy()
    m.update_users(pd.DataFrame({"user_id": [1], "item_id": [999]}),
                   pd.Series([1.0]))
    np.testing.assert_array_equal(m.user_features[: len(before)], before)


def test_implicit_rejects_bad_input_and_needs_cuda(interactions, monkeypatch):
    X, s = interactions
    with pytest.raises(ValueError, match="non-negative"):
        ImplicitALS(n_factors=8, n_epochs=2, device="cpu").fit(X, s - 10.0)
    with pytest.raises(ValueError, match="serving_dtype"):
        ImplicitALS(serving_dtype="float16", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ImplicitALS()


def test_implicit_cold_start_predict(interactions):
    X, s = interactions
    m = ImplicitALS(n_factors=8, n_epochs=3, device="cpu").fit(X, s)
    Xq = pd.DataFrame({"user_id": ["ghost"], "item_id": [X["item_id"].iloc[0]]})
    assert m.predict(Xq) == [0.0]  # zero factors x anything, clipped to [0, 1]
    assert m.predictions_possible == [False]
