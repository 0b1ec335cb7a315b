"""The port's bias model (``ops/als.py``, ``models/baseline.py``) against
the JAX package, on the CPU.

The JAX random streams are handed to the port: ``bias_sgd_train``'s
per-epoch ``jax.random.permutation`` of the padded stream goes in as
``orders``, and the models' fits take them through a wrapper of
``als_ops.bias_sgd_train``. Tolerances: ALS atol 1e-5 after 20 sweeps
(f32 sums in the same order, then a divide), and 1e-4 against the
float64 oracle of ``tests/test_als_and_baseline.py`` (its bar); SGD atol
2e-5 after 20 epochs (the bar of ``tests/test_pallas_sgd.py:61``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu.core import checkpoint as jax_ckpt
from matrix_factorization_tpu.models.baseline import BaselineModel as JaxBaseline
from matrix_factorization_tpu.ops import als as jals
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch import BaselineModel, load_model, save_model
from matrix_factorization_tpu_torch.ops import als
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd


def _data(n=900, n_users=60, n_items=40, seed=0):
    """Unique pairs, ratings in [1, 5]; one user and one item left with no
    rating (their biases must stay as they were)."""
    rng = np.random.default_rng(seed)
    flat = rng.choice((n_users - 1) * (n_items - 1), n, replace=False)
    u = (flat // (n_items - 1)).astype(np.int32)
    i = (flat % (n_items - 1)).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


def _als_oracle(u, i, r, n_users, n_items, reg, n_epochs):
    """``tests/test_als_and_baseline.py::_als_oracle``: the sequential
    reference semantics in float64."""
    mu = r.mean()
    bu = np.zeros(n_users)
    bi = np.zeros(n_items)
    cu = np.bincount(u, minlength=n_users)
    ci = np.bincount(i, minlength=n_items)
    for _ in range(n_epochs):
        np.divide(np.bincount(u, weights=r - mu - bi[i], minlength=n_users),
                  reg + cu, out=bu, where=(cu + reg) > 0)
        np.divide(np.bincount(i, weights=r - mu - bu[u], minlength=n_items),
                  reg + ci, out=bi, where=(ci + reg) > 0)
    return mu, bu, bi


def _packs(u, i, r, bs):
    return (jsgd.pack_ratings(u, i, r, bs),
            sgd.pack_ratings(u, i, r, bs, device="cpu"))


def _start(n_users, n_items, mu, rng=None):
    """The same starting biases for both packages (random when ``rng``)."""
    bu = np.zeros(n_users, np.float32)
    bi = np.zeros(n_items, np.float32)
    if rng is not None:
        bu[:] = rng.normal(0, 0.3, n_users)
        bi[:] = rng.normal(0, 0.3, n_items)
    return (jals.BiasParams(jnp.asarray(bu), jnp.asarray(bi), jnp.float32(mu)),
            als.BiasParams(torch.from_numpy(bu.copy()),
                           torch.from_numpy(bi.copy()),
                           torch.tensor(mu, dtype=torch.float32)))


@pytest.mark.parametrize("reg", [0.5, 3.0])
@pytest.mark.parametrize("bs", [128, 1024])
def test_als_train_matches_jax_and_oracle(reg, bs):
    u, i, r = _data()
    jdata, data = _packs(u, i, r, bs)
    j0, p0 = _start(64, 40, float(r.mean()), np.random.default_rng(1))
    want, whist = jals.als_train(j0, jdata, reg, 20)
    got, hist = als.als_train(p0, data, reg, 20)
    np.testing.assert_allclose(got.user_biases.numpy(),
                               np.asarray(want.user_biases), atol=1e-5)
    np.testing.assert_allclose(got.item_biases.numpy(),
                               np.asarray(want.item_biases), atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), np.asarray(whist), rtol=1e-5)
    assert hist.shape == (20,) and hist[-1] <= hist[0]
    # ids without ratings keep their starting bias
    assert got.user_biases[59] == p0.user_biases[59]
    assert got.item_biases[39] == p0.item_biases[39]
    # the float64 oracle starts from zero biases
    _, z = _start(64, 40, float(r.mean()))
    got0, _ = als.als_train(z, data, reg, 20)
    mu, bu, bi = _als_oracle(u, i, r.astype(np.float64), 64, 40, reg, 20)
    np.testing.assert_allclose(got0.user_biases.numpy(), bu, atol=1e-4)
    np.testing.assert_allclose(got0.item_biases.numpy(), bi, atol=1e-4)


def test_als_update_users_and_rmse_off():
    u, i, r = _data(seed=2)
    jdata, data = _packs(u, i, r, 256)
    j0, p0 = _start(64, 40, float(r.mean()), np.random.default_rng(3))
    want = jals.als_update_users(j0, jdata, 0.7, 5)
    got = als.als_update_users(p0, data, 0.7, 5)
    np.testing.assert_allclose(got.user_biases.numpy(),
                               np.asarray(want.user_biases), atol=1e-5)
    assert torch.equal(got.item_biases, p0.item_biases)
    _, hist = als.als_train(p0, data, 0.7, 3, compute_epoch_rmse=False)
    assert torch.equal(hist, torch.zeros(3))
    _, hist = als.als_train(p0, data, 0.7, 0)
    assert hist.shape == (0,)


def _jax_orders(key, n_epochs, n_pad):
    """The permutations ``jals.bias_sgd_train`` draws from ``key``."""
    return [np.asarray(jax.random.permutation(k, n_pad))
            for k in jax.random.split(key, n_epochs)]


@pytest.mark.parametrize("update_users,update_items", [
    (True, True), (True, False), (False, True)])
def test_bias_sgd_train_matches_jax(update_users, update_items):
    u, i, r = _data(seed=4)
    bs = 128
    jdata, data = _packs(u, i, r, bs)
    j0, p0 = _start(64, 40, float(r.mean()), np.random.default_rng(5))
    key = jax.random.PRNGKey(7)
    want, whist = jax.jit(lambda p, d: jals.bias_sgd_train(
        p, d, key, 0.05, 0.1, 20, bs, update_user_params=update_users,
        update_item_params=update_items))(j0, jdata)
    orders = _jax_orders(key, 20, data.n_batches * bs)
    got, hist = als.bias_sgd_train(p0, data, None, 0.05, 0.1, 20, bs,
                                   update_user_params=update_users,
                                   update_item_params=update_items,
                                   orders=orders)
    np.testing.assert_allclose(got.user_biases.numpy(),
                               np.asarray(want.user_biases), atol=2e-5)
    np.testing.assert_allclose(got.item_biases.numpy(),
                               np.asarray(want.item_biases), atol=2e-5)
    np.testing.assert_allclose(hist.numpy(), np.asarray(whist), rtol=1e-5)
    frozen = [] if update_users else ["user_biases"]
    frozen += [] if update_items else ["item_biases"]
    for name in frozen:
        assert torch.equal(getattr(got, name), getattr(p0, name))
    # the starting biases are untouched (the trainer works on copies)
    assert torch.equal(p0.user_biases, torch.from_numpy(
        np.array(j0.user_biases)))


def test_bias_sgd_same_seed_same_bits():
    u, i, r = _data(seed=6)
    _, data = _packs(u, i, r, 64)
    runs = []
    for seed in (3, 3, 4):
        _, p0 = _start(64, 40, float(r.mean()))
        runs.append(als.bias_sgd_train(
            p0, data, torch.Generator().manual_seed(seed), 0.05, 0.1, 3, 64))
    (a, ha), (b, hb), (c, _) = runs
    assert torch.equal(a.user_biases, b.user_biases)
    assert torch.equal(a.item_biases, b.item_biases) and torch.equal(ha, hb)
    assert not torch.equal(a.user_biases, c.user_biases)
    with pytest.raises(ValueError, match="permutations"):
        als.bias_sgd_train(a, data, None, 0.05, 0.1, 2, 64, orders=[[0]])


def test_bias_predict_cold_start_and_bounds():
    p = als.BiasParams(torch.tensor([1.0, -2.0]), torch.tensor([0.5, 3.0]),
                       torch.tensor(3.0))
    u = torch.tensor([0, 1, -1, 0, -1])
    i = torch.tensor([0, 1, 0, -1, -1])
    pred, ok = als.bias_predict(p, u, i, 1.0, 5.0, bound_ratings=False)
    assert pred.tolist() == [4.5, 4.0, 3.5, 4.0, 3.0]
    assert ok.tolist() == [True, True, False, False, False]
    pred, _ = als.bias_predict(p, torch.tensor([0]), torch.tensor([1]), 1.0,
                               5.0)
    assert pred.tolist() == [5.0]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _frame(seed=8, n=1200, n_users=70, n_items=50):
    u, i, r = _data(n=n, n_users=n_users, n_items=n_items, seed=seed)
    X = pd.DataFrame({"user_id": u.astype(np.int64) + 1000,
                      "item_id": np.array([f"m{x}" for x in i])})
    return X, pd.Series(r)


@pytest.fixture
def jax_streams(monkeypatch):
    """Route the port's ``bias_sgd_train`` through the JAX model's
    permutations: ``fold_in(PRNGKey(seed), epochs done)`` for ``fit``,
    ``PRNGKey(seed + 1)`` for ``update_users``."""
    keys = []
    real = als.bias_sgd_train

    def with_jax_orders(params, data, generator, lr, reg, n_epochs,
                        batch_size, **kw):
        orders = _jax_orders(keys.pop(0), n_epochs, data.user_ids.numel())
        return real(params, data, None, lr, reg, n_epochs, batch_size,
                    orders=orders, **kw)

    monkeypatch.setattr(als, "bias_sgd_train", with_jax_orders)
    return keys


def _assert_models_close(got, want, atol):
    np.testing.assert_allclose(got.user_biases, want.user_biases, atol=atol)
    np.testing.assert_allclose(got.item_biases, want.item_biases, atol=atol)
    np.testing.assert_allclose(got.train_rmse, want.train_rmse, rtol=1e-5)


@pytest.mark.parametrize("method", ["als", "sgd"])
def test_model_matches_jax(method, jax_streams):
    X, y = _frame()
    kw = dict(method=method, n_epochs=20, reg=0.5 if method == "als" else 0.05,
              lr=0.05, min_rating=1, max_rating=5, batch_size=256, seed=3)
    want = JaxBaseline(**kw).fit(X, y)
    jax_streams.append(jax.random.fold_in(jax.random.PRNGKey(3), 0))
    got = BaselineModel(device="cpu", **kw).fit(X, y)
    atol = 1e-5 if method == "als" else 2e-5
    _assert_models_close(got, want, atol)
    assert got.global_mean == pytest.approx(want.global_mean, abs=1e-6)
    assert got._params.user_biases.shape == (1024,)

    # predict: known, unknown user, unknown item; bounds
    Xp = pd.concat([X.iloc[:30], pd.DataFrame(
        {"user_id": [5, 1001], "item_id": ["m1", "nope"]})], ignore_index=True)
    for bound in (True, False):
        np.testing.assert_allclose(got.predict(Xp, bound_ratings=bound),
                                   want.predict(Xp, bound_ratings=bound),
                                   atol=2e-5)
    assert got.predictions_possible == want.predictions_possible
    assert got.predictions_possible[-2:] == [False, False]
    assert min(got.predict(Xp)) >= 1 and max(got.predict(Xp)) <= 5
    assert got.predict(X.iloc[:0]) == []

    # recommend: the device top-k, ties to the lower index, known excluded
    for user in (1000, 1005):
        a = got.recommend(user, amount=7, items_known=["m3", "m4"])
        b = want.recommend(user, amount=7, items_known=["m3", "m4"])
        assert a["item_id"].tolist() == b["item_id"].tolist()
        np.testing.assert_allclose(a["rating_pred"], b["rating_pred"],
                                   atol=2e-5)
    cold = got.recommend("nobody", amount=3)
    assert cold["item_id"].tolist() == want.recommend(
        "nobody", amount=3)["item_id"].tolist()
    batch = got.recommend_batch([1000, 1001, 1002], amount=4)
    assert len(batch) == 12
    assert batch["item_id"].tolist()[:4] == got.recommend(
        1000, amount=4)["item_id"].tolist()
    np.testing.assert_allclose(got._catalog_scores(0), want._catalog_scores(0),
                               atol=2e-5)

    # update_users: known users restart from 0, new users appended, the
    # item side frozen
    upd = pd.DataFrame({"user_id": [1000, 1000, 7777, 7777, 7778],
                        "item_id": ["m1", "m2", "m1", "m5", "zzz"]})
    yu = pd.Series([5.0, 4.0, 1.0, 2.0, 3.0])
    items_before = got.item_biases.copy()
    want.update_users(upd, yu, lr=0.1, n_epochs=5)
    jax_streams.append(jax.random.PRNGKey(4))
    got.update_users(upd, yu, lr=0.1, n_epochs=5)
    np.testing.assert_array_equal(got.item_biases, items_before)
    _assert_models_close(got, want, 2e-5)
    assert got.n_users == want.n_users and 7777 in got.known_users
    assert 7778 not in got.known_users  # all its items were unknown


def test_warm_start_and_capacity_growth():
    X, y = _frame(seed=9, n_users=1300, n=5000)
    m = BaselineModel(method="sgd", n_epochs=2, lr=0.05, reg=0.1,
                      batch_size=512, device="cpu").fit(X, y)
    assert m.n_users > 1024 and m._params.user_biases.shape == (2048,)
    m.fit(X, y, n_epochs=3, warm_start=True)
    assert len(m.train_rmse) == 5
    again = BaselineModel(method="sgd", n_epochs=2, lr=0.05, reg=0.1,
                          batch_size=512, device="cpu").fit(X, y)
    again.fit(X, y, n_epochs=3, warm_start=True)
    np.testing.assert_array_equal(m.user_biases, again.user_biases)
    n_before = m.n_users
    new = pd.DataFrame({"user_id": np.arange(2100) + 10**6,
                        "item_id": X["item_id"].iloc[:2100].to_numpy()})
    m.update_users(new, pd.Series(np.full(2100, 4.0)), n_epochs=1)
    assert m.n_users == n_before + 2100
    # by half again (2048 * 1.5 + 1 = 3073), rounded up to 1024
    assert m._params.user_biases.shape == (4096,)
    np.testing.assert_array_equal(m.user_biases[:n_before],
                                  again.user_biases)  # known users untouched
    with pytest.raises(ValueError):
        m.fit(X.assign(user_id=-5), y, warm_start=True)


def test_checkpoints_cross_both_ways(tmp_path):
    X, y = _frame(seed=10)
    kw = dict(method="als", n_epochs=5, reg=0.5, min_rating=1, max_rating=5,
              batch_size=256)
    want = JaxBaseline(**kw).fit(X, y)
    jax_ckpt.save_model(want, tmp_path / "jax")
    got = load_model(tmp_path / "jax", device="cpu")
    assert isinstance(got, BaselineModel) and got.method == "als"
    _assert_models_close(got, want, 0)
    assert got.predict(X.iloc[:20]) == pytest.approx(want.predict(X.iloc[:20]))
    save_model(got, tmp_path / "port")
    back = jax_ckpt.load_model(tmp_path / "port")
    assert isinstance(back, JaxBaseline) and back.mesh is None
    for name in ("user_biases", "item_biases", "global_mean"):
        np.testing.assert_array_equal(np.asarray(getattr(back._params, name)),
                                      np.asarray(getattr(want._params, name)))
    assert back.user_vocab.raw_ids == want.user_vocab.raw_ids


def test_bad_arguments():
    with pytest.raises(ValueError, match="'sgd' or 'als'"):
        BaselineModel(method="newton", device="cpu")
    mesh = object()  # a mesh is accepted (slice 6b); fit reads it
    assert BaselineModel(mesh=mesh, device="cpu").mesh is mesh
    with pytest.raises(RuntimeError, match="not fitted"):
        BaselineModel(device="cpu").update_users(*_frame())
