"""Multi-epoch SGD training of the PyTorch port against the JAX package.

* Two epochs from the same tables (the JAX ``init_params`` carried over
  with ``params_from_numpy``) and the same batch order (the JAX order is
  computed here from ``jax.random`` and handed to the port as
  ``batch_orders``): tables at atol 2e-5 and the train-RMSE history at
  rtol 1e-5, the bar of ``tests/test_pallas_sgd.py:61-65``.
* The same generator seed gives bitwise-equal tables.
* The golden mini fixture: the port's ``sgd_train`` lands within 1e-3 of
  the pinned sequential-oracle held-out RMSE, as the JAX engine does in
  ``tests/test_golden_mini.py:86``: same data, same initial tables from
  numpy, and the engine's batch orders (drawn there from ``PRNGKey(3)``,
  recorded in ``data/golden_mini_batch_orders.json`` and checked here).
  With five batches an epoch the order moves the held-out RMSE by a few
  1e-4 either way, so the port replays the engine's order rather than
  drawing its own.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

DATA = Path(__file__).resolve().parent / "data"
EXP = json.loads((DATA / "golden_mini_expected.json").read_text())
ORDERS = json.loads((DATA / "golden_mini_batch_orders.json").read_text())


def _data(n=1777, n_users=200, n_items=120, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = rng.integers(0, n_items, n).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


def _jax_orders(cfg, nb, n_epochs):
    """The per-epoch permutations ``jsgd.shuffle_xs`` draws from
    ``sgd_train``'s key ``PRNGKey(1)``."""
    keys = jax.random.split(jax.random.PRNGKey(1), n_epochs)
    n = nb * cfg.batch_size if cfg.shuffle == "full" else nb
    return [np.asarray(jax.random.permutation(k, n)) for k in keys]


@pytest.mark.parametrize("kernel,order,shuffle", [
    ("linear", "user", "batch"), ("sigmoid", "user", "batch"),
    ("rbf", "user", "batch"), ("sigmoid", "item", "batch"),
    ("linear", "item", "none"), ("rbf", "user", "none"),
    ("sigmoid", "shuffle", "full"),
])
def test_two_epochs_match_jax(kernel, order, shuffle):
    kw = dict(kernel=kernel, n_factors=12, reg=0.02, gamma=0.05,
              min_rating=1.0, max_rating=5.0, batch_size=256,
              shuffle=shuffle)
    cfg, jcfg = SGDConfig(**kw), JaxConfig(**kw)
    u, i, r = _data()
    jdata = jsgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order=order)
    data = sgd.pack_ratings(u, i, r, 256, shuffle_seed=3, order=order,
                            device="cpu")
    p0 = jsgd.init_params(jax.random.PRNGKey(0), 200, 120, jcfg, 3.0)
    want, whist = jax.jit(lambda p, d: jsgd.sgd_train(
        p, d, jax.random.PRNGKey(1), jcfg, 2, 0.05))(p0, jdata)
    start = sgd.params_from_numpy(np.asarray(p0.user_features),
                                  np.asarray(p0.item_features), 3.0,
                                  device="cpu")
    orders = (None if shuffle == "none"
              else _jax_orders(jcfg, data.n_batches, 2))
    got, hist = sgd.sgd_train(start, data, None, cfg, 2, 0.05,
                              batch_orders=orders)
    np.testing.assert_allclose(got.user_features.numpy(),
                               np.asarray(want.user_features), atol=2e-5)
    np.testing.assert_allclose(got.item_features.numpy(),
                               np.asarray(want.item_features), atol=2e-5)
    assert hist.shape == (2,) and hist.device.type == "cpu"
    np.testing.assert_allclose(hist.numpy(), np.asarray(whist), rtol=1e-5)
    assert hist[1] < hist[0]
    # sgd_train trains copies: the starting tables are untouched
    np.testing.assert_array_equal(start.user_features.numpy(),
                                  np.asarray(p0.user_features))


@pytest.mark.parametrize("shuffle", ["batch", "full"])
def test_same_seed_same_bits(shuffle):
    cfg = SGDConfig(kernel="sigmoid", n_factors=12, reg=0.02, lr=0.05,
                    min_rating=1.0, max_rating=5.0, batch_size=128,
                    shuffle=shuffle)
    u, i, r = _data(n=1500)
    data = sgd.pack_ratings(u, i, r, 128, device="cpu")
    runs = []
    for seed in (5, 5, 6):
        p0 = sgd.init_params(torch.Generator().manual_seed(0), 200, 120, cfg,
                             3.0)
        runs.append(sgd.sgd_train(p0, data, torch.Generator().manual_seed(seed),
                                  cfg, 3, 0.05))
    (a, ha), (b, hb), (c, _) = runs
    assert torch.equal(a.user_features, b.user_features)
    assert torch.equal(a.item_features, b.item_features)
    assert torch.equal(ha, hb)
    assert not torch.equal(a.user_features, c.user_features)  # another order


def test_rmse_off_and_zero_epochs():
    cfg = SGDConfig(n_factors=12, batch_size=64, compute_epoch_rmse=False)
    u, i, r = _data(n=300)
    data = sgd.pack_ratings(u, i, r, 64, device="cpu")
    p0 = sgd.init_params(torch.Generator().manual_seed(0), 200, 120, cfg, 3.0)
    p, hist = sgd.sgd_train(p0, data, torch.Generator(), cfg, 2, 0.01)
    assert torch.equal(hist, torch.zeros(2))
    assert not torch.equal(p.user_features, p0.user_features)
    _, hist = sgd.sgd_train(p0, data, torch.Generator(), cfg, 0, 0.01)
    assert hist.shape == (0,)
    with pytest.raises(ValueError, match="orders"):
        sgd.sgd_train(p0, data, None, cfg, 2, 0.01, batch_orders=[[0]])
    # the chunked squared-error pass equals one unchunked pass
    whole = sgd.masked_sse(p, data, cfg, chunk=1 << 20)
    torch.testing.assert_close(sgd.masked_sse(p, data, cfg, chunk=37), whole)


@pytest.fixture(scope="module")
def golden():
    raw = np.genfromtxt(DATA / "golden_mini.csv", delimiter=",",
                        skip_header=1)
    u = raw[:, 0].astype(np.int32)
    i = raw[:, 1].astype(np.int32)
    r = raw[:, 2].astype(np.float64)
    tr = raw[:, 3].astype(bool)
    rng = np.random.default_rng(EXP["init_seed"])
    P0 = rng.normal(0, 0.1, (EXP["n_users"], EXP["n_factors"]))
    Q0 = rng.normal(0, 0.1, (EXP["n_items"], EXP["n_factors"]))
    return u, i, r, tr, P0, Q0


def golden_test_rmse(kernel, mu, P, Q, bu, bi, u, i, r):
    """Held-out RMSE in float64 (``tests/test_golden_mini.py::_test_rmse``)."""
    lo, hi = EXP["min_rating"], EXP["max_rating"]
    d = np.einsum("nk,nk->n", P[u], Q[i])
    if kernel == "linear":
        pred = mu + bu[u] + bi[i] + d
    elif kernel == "sigmoid":
        pred = lo + (hi - lo) / (1 + np.exp(-(mu + bu[u] + bi[i] + d)))
    else:
        sq = np.sum((P[u] - Q[i]) ** 2, axis=1)
        pred = lo + (hi - lo) * np.exp(-EXP["gamma"] * sq)
    return float(np.sqrt(np.mean((np.clip(pred, lo, hi) - r) ** 2)))


@pytest.mark.parametrize("kernel", ["linear", "sigmoid", "rbf"])
@pytest.mark.parametrize("order", ["shuffle", "item"])
def test_golden_mini_parity_vs_pinned_oracle(golden, kernel, order):
    u, i, r, tr, P0, Q0 = golden
    nu, ni, K = EXP["n_users"], EXP["n_items"], EXP["n_factors"]
    mu = float(r[tr].mean())
    cfg = SGDConfig(kernel=kernel, n_factors=K, lr=EXP["lrs"][kernel],
                    reg=EXP["reg"], gamma=EXP["gamma"],
                    min_rating=EXP["min_rating"],
                    max_rating=EXP["max_rating"], batch_size=1024)
    kp = cfg.padded_factors
    uf = np.zeros((sgd.round_up(nu, 8), kp), np.float32)
    uf[:nu, :K] = P0
    itf = np.zeros((sgd.round_up(ni, 8), kp), np.float32)
    itf[:ni, :K] = Q0
    if kernel != "rbf":
        uf[:, sgd.const_col(cfg, "user")] = 1.0
        itf[:, sgd.const_col(cfg, "item")] = 1.0
    params = sgd.params_from_numpy(uf, itf, mu, device="cpu")
    data = sgd.pack_ratings(u[tr], i[tr], r[tr].astype(np.float32), 1024,
                            order=order, device="cpu")
    assert data.n_batches == ORDERS["n_batches"]
    params, _ = sgd.sgd_train(params, data, None, cfg, EXP["n_epochs"],
                              cfg.lr, batch_orders=ORDERS["orders"])
    P = params.user_features.numpy().astype(np.float64)
    Q = params.item_features.numpy().astype(np.float64)
    e = golden_test_rmse(kernel, mu, P[:nu, :K], Q[:ni, :K],
                         P[:nu, sgd.bias_col(cfg, "user")],
                         Q[:ni, sgd.bias_col(cfg, "item")],
                         u[~tr], i[~tr], r[~tr])
    pinned = EXP["oracle_test_rmse"][kernel]
    assert abs(e - pinned) <= 1e-3, f"{kernel}/{order}: {pinned} vs {e}"


def test_golden_batch_orders_are_the_jax_engines():
    keys = jax.random.split(jax.random.PRNGKey(ORDERS["prng_key"]),
                            ORDERS["n_epochs"])
    want = [np.asarray(jax.random.permutation(k, ORDERS["n_batches"])).tolist()
            for k in keys]
    assert ORDERS["n_epochs"] == EXP["n_epochs"]
    assert ORDERS["orders"] == want
