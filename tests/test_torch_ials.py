"""The port's ALS sweeps and packs (``ops/ials.py``) against the JAX
package on the CPU.

* The grouped and bucketed packs are byte-equal to the JAX package's, ids
  beyond 65,535 (the JAX wire encoder's 16-bit plane) and float and
  half-step ratings included.
* From the same tables (the JAX ``init_params`` through
  ``params_from_numpy``), ``ials_train`` and ``ials_train_bucketed`` match
  the JAX functions after 1 and 3 epochs, with both ridge scales: tables
  at atol 2e-4, the JAX package's own bar between two ALS paths
  (``tests/test_ials.py:111``), and the RMSE history at atol 1e-4. The
  JAX package's CPU solves take a Cholesky leaf, the port the Gauss-Jordan
  leaf, so the two agree to rounding.
* ``implicit_sweep``, ``implicit_loss`` and ``implicit_als_train`` match
  the JAX functions, and single sweeps match numpy ridge solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.ops import ials as jials
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import ials
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd


def _pairs(rng, n, n_users, n_items):
    flat = rng.choice(n_users * n_items, size=n, replace=False)
    u = (flat // n_items).astype(np.int32)
    i = (flat % n_items).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


def _port_params(jp):
    return sgd.params_from_numpy(np.asarray(jp.user_features),
                                 np.asarray(jp.item_features),
                                 np.asarray(jp.global_mean), device="cpu")


def _assert_params(got, want, atol=2e-4):
    np.testing.assert_allclose(got.user_features.numpy(),
                               np.asarray(want.user_features), atol=atol)
    np.testing.assert_allclose(got.item_features.numpy(),
                               np.asarray(want.item_features), atol=atol)


def _assert_same_grouped(got, want):
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("max_other,half", [(300, False), (300, True),
                                            (9_000_000, False),
                                            (9_000_000, True)])
def test_packs_equal_jax_packs(max_other, half):
    rng = np.random.default_rng(max_other % 97 + half)
    n, U = 30_000, 700
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, max_other, n).astype(np.int32)
    r = ((rng.integers(1, 11, n) * 0.5) if half
         else rng.uniform(0.5, 5, n)).astype(np.float32)
    _assert_same_grouped(ials.group_by_entity(u, i, r, U, device="cpu"),
                         jials.group_by_entity(u, i, r, U))
    got = ials.group_by_entity_bucketed(u, i, r, U, max_block_rows=5_000,
                                        device="cpu")
    want = jials.group_by_entity_bucketed(u, i, r, U, max_block_rows=5_000)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _assert_same_grouped(g, w)


def test_pack_edges_and_both_sides():
    """An entity without data (a zero row), one entity, and the two-sided
    pack equal to two one-sided packs."""
    u = np.array([3, 3, 0, 3], np.int32)
    i = np.array([1, 0, 2, 70_000], np.int32)
    r = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    _assert_same_grouped(ials.group_by_entity(u, i, r, 5, device="cpu"),
                         jials.group_by_entity(u, i, r, 5))
    rng = np.random.default_rng(4)
    u, i, r = _pairs(rng, 4000, 300, 200)
    bu, bi = ials.group_both_sides_bucketed(u, i, r, 300, 200,
                                            max_block_rows=800, device="cpu")
    ju, ji = jials.group_both_sides_bucketed(u, i, r, 300, 200,
                                             max_block_rows=800)
    for got, want in ((bu, ju), (bi, ji)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_grouped(g, w)


def _setup(reg, n=500, n_users=37, n_items=23, seed=3, bs=64):
    rng = np.random.default_rng(seed)
    u, i, r = _pairs(rng, n, n_users, n_items)
    kw = dict(kernel="linear", n_factors=5, reg=reg, batch_size=bs,
              compute_epoch_rmse=True)
    cfg, jcfg = SGDConfig(**kw), JaxConfig(**kw)
    jp = jsgd.init_params(jax.random.PRNGKey(seed), n_users, n_items, jcfg,
                          float(r.mean()))
    return (u, i, r), cfg, jcfg, jp


@pytest.mark.parametrize("n_epochs", [1, 3])
@pytest.mark.parametrize("reg_scale", ["absolute", "per_obs"])
def test_ials_train_matches_jax(n_epochs, reg_scale):
    (u, i, r), cfg, jcfg, jp = _setup(0.2)
    jdata = jsgd.pack_ratings(u, i, r, 64)
    want, whist = jials.jit_ials_train(jcfg, n_epochs, reg_scale=reg_scale)(
        jp, jials.group_by_entity(u, i, r, 37), jials.group_by_entity(i, u, r, 23),
        jdata)
    data = sgd.pack_ratings(u, i, r, 64, device="cpu")
    got, hist = ials.ials_train(
        _port_params(jp), ials.group_by_entity(u, i, r, 37, device="cpu"),
        ials.group_by_entity(i, u, r, 23, device="cpu"), data, cfg, n_epochs,
        reg_scale=reg_scale)
    _assert_params(got, want)
    np.testing.assert_allclose(hist.numpy(), np.asarray(whist), atol=1e-4)
    assert hist.shape == (n_epochs,) and bool((hist[1:] <= hist[:-1] + 1e-6).all())


@pytest.mark.parametrize("n_epochs", [1, 3])
@pytest.mark.parametrize("reg_scale", ["absolute", "per_obs"])
def test_ials_train_bucketed_matches_jax(n_epochs, reg_scale):
    (u, i, r), cfg, jcfg, jp = _setup(0.2)
    start = _port_params(jp)  # the JAX sweeps donate (delete) jp's tables
    P0 = start.user_features.numpy().copy()
    want, whist = jials.ials_train_bucketed(
        jp, jials.group_by_entity_bucketed(u, i, r, 37, max_block_rows=64),
        jials.group_by_entity_bucketed(i, u, r, 23, max_block_rows=64),
        jsgd.pack_ratings(u, i, r, 64), jcfg, n_epochs, reg_scale=reg_scale)
    bu, bi = ials.group_both_sides_bucketed(u, i, r, 37, 23, max_block_rows=64,
                                            device="cpu")
    assert len(bu) > 1 and len(bi) > 1  # the tiny cap forces several chunks
    got, hist = ials.ials_train_bucketed(
        start, bu, bi, sgd.pack_ratings(u, i, r, 64, device="cpu"), cfg,
        n_epochs, reg_scale=reg_scale)
    _assert_params(got, want)
    np.testing.assert_allclose(hist.numpy(), whist, atol=1e-4)
    # the caller's tables are not written
    np.testing.assert_array_equal(start.user_features.numpy(), P0)


def test_bucketed_matches_grouped_and_gram_dtypes():
    """Both are exact solves (``tests/test_ials.py:85``); 'highest' is the
    f32 path, 'bf16' stays close; bad arguments raise."""
    (u, i, r), cfg, _, jp = _setup(0.2, seed=5)
    data = sgd.pack_ratings(u, i, r, 64, device="cpu")
    simple, h1 = ials.ials_train(
        _port_params(jp), ials.group_by_entity(u, i, r, 37, device="cpu"),
        ials.group_by_entity(i, u, r, 23, device="cpu"), data, cfg, 3)
    bu, bi = ials.group_both_sides_bucketed(u, i, r, 37, 23, max_block_rows=64,
                                            device="cpu")
    out = {}
    for g in ("f32", "highest", "bf16"):
        out[g] = ials.ials_train_bucketed(_port_params(jp), bu, bi, data, cfg,
                                          3, gram_dtype=g)
    _assert_params(out["f32"][0], simple)
    np.testing.assert_allclose(out["f32"][1].numpy(), h1.numpy(), atol=1e-4)
    np.testing.assert_array_equal(out["highest"][0].user_features.numpy(),
                                  out["f32"][0].user_features.numpy())
    np.testing.assert_allclose(out["bf16"][1].numpy(), h1.numpy(), atol=2e-2)
    for kw in ({"gram_dtype": "fp8"}, {"reg_scale": "bogus"}):
        with pytest.raises(ValueError):
            ials.ials_train_bucketed(_port_params(jp), bu, bi, data, cfg, 1, **kw)
    with pytest.raises(ValueError, match="linear"):
        ials.ials_train(_port_params(jp), None, None, data,
                        SGDConfig(kernel="sigmoid", n_factors=5), 1)


@pytest.mark.parametrize("reg_scale", ["absolute", "per_obs"])
def test_user_sweep_matches_numpy_ridge(reg_scale):
    """One user sweep is a per-user ridge regression on [q_i, 1] ->
    [p_u, b_u], ridge reg (or reg * n_obs); a user without data keeps
    their row."""
    rng = np.random.default_rng(0)
    n_users, n_items, k, n = 7, 15, 4, 60
    u = rng.integers(0, n_users - 1, n).astype(np.int32)  # the last: no data
    i = rng.integers(0, n_items, n).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    mu, reg = float(r.mean()), 0.3
    cfg = SGDConfig(kernel="linear", n_factors=k, reg=reg, batch_size=32,
                    compute_epoch_rmse=False)
    p0 = sgd.init_params(torch.Generator().manual_seed(0), n_users, n_items,
                         cfg, mu)
    out, hist = ials.ials_train(
        p0, ials.group_by_entity(u, i, r, n_users, device="cpu"), None,
        sgd.pack_ratings(u, i, r, 32, device="cpu"), cfg, 1,
        update_item_params=False, reg_scale=reg_scale)
    assert hist.tolist() == [0.0]
    Q = p0.item_features.numpy().astype(np.float64)
    for user in range(n_users - 1):
        rows = np.where(u == user)[0]
        X = np.column_stack([Q[i[rows], :k], np.ones(len(rows))])
        y = r[rows] - mu - Q[i[rows], sgd.bias_col(cfg, "item")]
        ridge = reg * (len(rows) if reg_scale == "per_obs" else 1.0)
        sol = np.linalg.solve(X.T @ X + ridge * np.eye(k + 1), X.T @ y)
        np.testing.assert_allclose(out.user_features[user, :k].numpy(),
                                   sol[:k], atol=2e-3)
        np.testing.assert_allclose(
            float(out.user_features[user, sgd.bias_col(cfg, "user")]), sol[k],
            atol=2e-3)
    np.testing.assert_array_equal(out.user_features[n_users - 1].numpy(),
                                  p0.user_features[n_users - 1].numpy())
    np.testing.assert_array_equal(out.item_features.numpy(),
                                  p0.item_features.numpy())


def _implicit_setup(seed=0, n_users=30, n_items=20, n=200, k=6):
    rng = np.random.default_rng(seed)
    u, i, _ = _pairs(rng, n, n_users, n_items)
    s = rng.exponential(2.0, n).astype(np.float32)
    kw = dict(kernel="linear", n_factors=k, reg=0.1)
    cfg, jcfg = SGDConfig(**kw), JaxConfig(**kw)
    jp = jsgd.init_params(jax.random.PRNGKey(seed), n_users, n_items, jcfg,
                          0.0, init_sd=0.1)
    return (u, i, s), cfg, jcfg, jp


def test_implicit_sweep_and_loss_match_jax():
    (u, i, s), cfg, jcfg, jp = _implicit_setup()
    jbu, jbi = jials.group_by_entity(u, i, s, 30), jials.group_by_entity(i, u, s, 20)
    bu = ials.group_by_entity(u, i, s, 30, device="cpu")
    p = _port_params(jp)
    want = jials.implicit_sweep(jp.user_features, jp.item_features, jbu, 20,
                                jcfg, 5.0)
    got = ials.implicit_sweep(p.user_features.clone(), p.item_features, bu, 20,
                              cfg, 5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    wl = jials.implicit_loss(want, jp.item_features, jbu, 30, 20, jcfg, 5.0)
    gl = ials.implicit_loss(got, p.item_features, bu, 30, 20, cfg, 5.0)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    # three alternating epochs
    jt, jloss = jials.jit_implicit_als_train(jcfg, 3, 5.0)(jp, jbu, jbi)
    gt, gloss = ials.implicit_als_train(
        p, bu, ials.group_by_entity(i, u, s, 20, device="cpu"), cfg, 3, 5.0)
    _assert_params(gt, jt)
    np.testing.assert_allclose(gloss.numpy(), np.asarray(jloss), rtol=1e-4)
    assert gloss[-1] < gloss[0]


def test_implicit_sweep_matches_numpy_normal_equations():
    """``tests/test_implicit.py:42``: user 1 has no data and solves to 0."""
    rng = np.random.default_rng(0)
    k, n_items, n_users = 8, 12, 5
    cfg = SGDConfig(kernel="linear", n_factors=k, reg=0.3)
    Q = np.zeros((16, cfg.padded_factors), np.float32)
    Q[:n_items, :k] = rng.normal(size=(n_items, k))
    u = np.array([0, 0, 0, 2], np.int32)
    i = np.array([1, 4, 7, 3], np.int32)
    s = np.array([2.0, 0.5, 1.0, 4.0], np.float32)
    own = ials.implicit_sweep(
        torch.zeros(n_users, cfg.padded_factors), torch.from_numpy(Q),
        ials.group_by_entity(u, i, s, n_users, device="cpu"), n_items, cfg,
        alpha=10.0).numpy()
    Y = Q[:n_items, :k].astype(np.float64)

    def solve(items, strengths):
        A = Y.T @ Y + 0.3 * np.eye(k)
        b = np.zeros(k)
        for j, c in zip(items, strengths):
            A += 10.0 * c * np.outer(Y[j], Y[j])
            b += (1.0 + 10.0 * c) * Y[j]
        return np.linalg.solve(A, b)

    np.testing.assert_allclose(own[0, :k], solve([1, 4, 7], [2.0, 0.5, 1.0]),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(own[2, :k], solve([3], [4.0]), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(own[1, :k], 0.0, atol=1e-7)


def test_solves_in_pieces_match_one_piece(monkeypatch):
    """A block above ``_SOLVE_ELEMS`` is solved in pieces of whole
    entities; each entity's solve is its own, so the tables agree."""
    (u, i, r), cfg, _, jp = _setup(0.2, seed=7)
    by_user = ials.group_by_entity(u, i, r, 37, device="cpu")
    by_item = ials.group_by_entity(i, u, r, 23, device="cpu")
    data = sgd.pack_ratings(u, i, r, 64, device="cpu")
    whole, h1 = ials.ials_train(_port_params(jp), by_user, by_item, data, cfg, 2)
    d = cfg.n_factors + 1
    widest = max(by_user.other_ids.shape[1], by_item.other_ids.shape[1], d)
    monkeypatch.setattr(ials, "_SOLVE_ELEMS", 4 * d * widest)  # 4 entities a piece
    pieces, h2 = ials.ials_train(_port_params(jp), by_user, by_item, data, cfg, 2)
    np.testing.assert_allclose(pieces.user_features.numpy(),
                               whole.user_features.numpy(), atol=1e-6)
    np.testing.assert_allclose(pieces.item_features.numpy(),
                               whole.item_features.numpy(), atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=1e-6)
