"""The port's SVD++ (``ops/svdpp.py``, ``models/svdpp.py``) against the
JAX package, on the CPU.

JAX's initial tables and permutations are handed to the port: the batched
trainer's ``permutation(k, nb)``, the flat trainer's and ``user_refit``'s
``permutation(k, n_pad)``, with ``k = jax.random.split(key, n_epochs)[e]``.
Tolerances are JAX's own (``tests/test_svdpp.py``): the single passes
(implicit sums, pair gradients) and the refreshed sums 1e-6; the trainers'
tables 2e-4 and train RMSE 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu import SVDpp as JaxSVDpp
from matrix_factorization_tpu.core import checkpoint as jax_ckpt
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu.ops import svdpp as jsvd
from matrix_factorization_tpu_torch import SVDpp, load_model, save_model, svdpp_params_from_numpy
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops import svdpp

N_USERS, N_ITEMS = 40, 30


def _ratings(n=500, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(N_USERS * N_ITEMS, n, replace=False)
    u = (flat // N_ITEMS).astype(np.int32)
    i = (flat % N_ITEMS).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


def _cfg(bs=128):
    kw = dict(kernel="linear", n_factors=6, lr=0.05, reg=0.02,
              min_rating=1.0, max_rating=5.0, batch_size=bs)
    return SGDConfig(**kw), jsgd.SGDConfig(**kw)


def _params(jcfg, mu, y_sd=0.0):
    """JAX's initial tables, with a random Y when ``y_sd`` (so that the
    first epoch already reads it), for both packages."""
    p = jsvd.init_params(jax.random.PRNGKey(0), N_USERS, N_ITEMS, jcfg, mu,
                         init_sd=0.1)
    if y_sd:
        Y = np.zeros(p.implicit_features.shape, np.float32)
        Y[:, :jcfg.n_factors] = np.random.default_rng(1).normal(
            0, y_sd, (Y.shape[0], jcfg.n_factors))
        p = p._replace(implicit_features=jnp.asarray(Y))
    return p, svdpp_params_from_numpy(*(np.asarray(x) for x in p),
                                      device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def _side(u, i, cap):
    wvec = jsvd._neighbor_weights(u, N_USERS, cap)
    np.testing.assert_array_equal(svdpp._neighbor_weights(u, N_USERS, cap),
                                  wvec)
    return wvec


@pytest.mark.parametrize("chunk", [0, 96])
def test_flat_passes_match_jax(chunk):
    u, i, r = _ratings()
    cfg, jcfg = _cfg()
    jp, p = _params(jcfg, 3.0, y_sd=0.2)
    up, ip, rp, wp, bs = jsvd.pack_pairs(u, i, r, 128)
    got = svdpp.pack_pairs(u, i, r, 128)
    for a, b in zip(got, (up, ip, rp, wp, bs)):
        np.testing.assert_array_equal(a, b)
    wvec = _side(u, i, p.user_features.shape[0])
    up_, ip_, wp_, wvec_ = (jnp.asarray(a) for a in (up, ip, wp, wvec))
    S = jsvd.implicit_sum(jp.implicit_features, up_, ip_, wp_, wvec_,
                          chunk=chunk)
    _close(svdpp.implicit_sum(p.implicit_features, _t(up), _t(ip), _t(wp),
                              _t(wvec), chunk=chunk), S, 1e-6)
    A = np.random.default_rng(3).normal(size=p.user_features.shape)
    A = A.astype(np.float32)
    gY = jsvd._scatter_pair_grads(jnp.asarray(A), jp.implicit_features, up_,
                                  ip_, wp_, wvec_, chunk=chunk)
    _close(svdpp._scatter_pair_grads(_t(A), p.implicit_features, _t(up),
                                     _t(ip), _t(wp), _t(wvec), chunk), gY, 1e-6)


def _packs(u, i, r, bs):
    jdata = jsgd.pack_ratings(u, i, r, bs, shuffle_seed=0, order="user")
    data = sgd.pack_ratings(u, i, r, bs, shuffle_seed=0, order="user",
                            device="cpu")
    for name in ("user_ids", "item_ids", "ratings", "weights"):
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      np.asarray(getattr(jdata, name)), name)
    return jdata, data


def test_batched_passes_match_jax():
    u, i, r = _ratings()
    cfg, jcfg = _cfg()
    jdata, data = _packs(u, i, r, 128)
    jp, p = _params(jcfg, 3.0, y_sd=0.2)
    wvec = _side(u, i, p.user_features.shape[0])
    S = jsvd.implicit_sum_batched(jp.implicit_features, jdata,
                                  jnp.asarray(wvec))
    _close(svdpp.implicit_sum_batched(p.implicit_features, data, _t(wvec)), S,
           1e-6)
    A = np.random.default_rng(3).normal(size=p.user_features.shape)
    A = A.astype(np.float32)
    gY = jsvd._pair_grads_batched(jnp.asarray(A), jp.implicit_features, jdata,
                                  jnp.asarray(wvec), jdata.expand_prim)
    _close(svdpp._pair_grads_batched(_t(A), p.implicit_features, data,
                                     _t(wvec)), gY, 1e-6)


def _deg(i, cap):
    deg = np.zeros(cap, np.float32)
    deg[:N_ITEMS] = np.bincount(i, minlength=N_ITEMS)
    return deg


def _assert_trained(got, want, ghist, whist):
    for name in ("user_features", "item_features", "implicit_features"):
        _close(getattr(got, name), getattr(want, name), 2e-4)
    np.testing.assert_allclose(ghist.numpy(), np.asarray(whist), atol=1e-4)


def test_batched_trainer_matches_jax_and_refreshes_sums():
    u, i, r = _ratings()
    cfg, jcfg = _cfg()
    jdata, data = _packs(u, i, r, 128)
    mu = float(r.mean())
    jp, p = _params(jcfg, mu)
    wvec = _side(u, i, p.user_features.shape[0])
    deg = _deg(i, p.item_features.shape[0])
    key = jax.random.PRNGKey(7)
    want, whist = jsvd.jit_svdpp_train_batched(jcfg, 2, 0.05, 0.02)(
        jp, jdata, jnp.asarray(wvec), jnp.asarray(deg), key)
    orders = [np.asarray(jax.random.permutation(k, data.n_batches))
              for k in jax.random.split(key, 2)]
    got, hist = svdpp.svdpp_train_batched(p, data, _t(wvec), _t(deg), None,
                                          cfg, 2, 0.05, 0.02,
                                          batch_orders=orders)
    _assert_trained(got, want, hist, whist)
    assert float(got.implicit_features.abs().max()) > 1e-6
    # the stored sums are the final Y's, as JAX's pass computes them
    S = jsvd.implicit_sum_batched(jnp.asarray(got.implicit_features.numpy()),
                                  jdata, jnp.asarray(wvec))
    _close(got.user_implicit_sums, S, 1e-6)


def test_flat_trainer_matches_jax():
    u, i, r = _ratings(300)
    cfg, jcfg = _cfg()
    mu = float(r.mean())
    jp, p = _params(jcfg, mu)
    up, ip, rp, wp, bs = jsvd.pack_pairs(u, i, r, 64)
    wvec = _side(u, i, p.user_features.shape[0])
    deg = _deg(i, p.item_features.shape[0])
    key = jax.random.PRNGKey(7)
    want, whist = jsvd.jit_svdpp_train(jcfg, 2, 0.05, 0.02, bs, len(u),
                                       len(up))(jp, up, ip, rp, wp, wvec, deg,
                                                key)
    perms = [np.asarray(jax.random.permutation(k, len(up)))
             for k in jax.random.split(key, 2)]
    got, hist = svdpp.svdpp_train(p, _t(up), _t(ip), _t(rp), _t(wp), _t(wvec),
                                  _t(deg), None, cfg, 2, 0.05, 0.02, bs,
                                  len(u), perms=perms)
    _assert_trained(got, want, hist, whist)
    _close(got.user_implicit_sums, jsvd.implicit_sum(
        jnp.asarray(got.implicit_features.numpy()),
        *(jnp.asarray(a) for a in (up, ip, wp, wvec))), 1e-6)


def test_user_refit_matches_jax_with_the_permutation_given():
    u, i, r = _ratings(300)
    cfg, jcfg = _cfg()
    jp, p = _params(jcfg, 3.0, y_sd=0.2)
    cohort = u < 12  # a cohort of users, with user 0 among them
    cu, ci, cr = u[cohort], i[cohort], r[cohort]
    up, ip, rp, wp, bs = jsvd.pack_pairs(cu, ci, cr, 16)
    wvec = _side(cu, ci, p.user_features.shape[0])
    key = jax.random.PRNGKey(2)
    want = jsvd.jit_user_refit(jcfg, 3, bs, len(up))(
        jp, up, ip, rp, wp, wvec, key)
    perms = [np.asarray(jax.random.permutation(k, len(up)))
             for k in jax.random.split(key, 3)]
    got = svdpp.user_refit(p, _t(up), _t(ip), _t(rp), _t(wp), _t(wvec), None,
                           cfg, 3, bs, perms=perms)
    _close(got.user_features, want.user_features, 2e-4)
    _close(got.user_implicit_sums, want.user_implicit_sums, 1e-6)
    assert torch.equal(got.item_features, p.item_features)
    assert torch.equal(got.implicit_features, p.implicit_features)


def _frame(u, i, r):
    return pd.DataFrame({"user_id": u, "item_id": i}), pd.Series(r)


def _fitted(**kw):
    X, y = _frame(*_ratings())
    args = dict(n_factors=6, n_epochs=5, lr=0.05, batch_size=128, seed=0)
    args.update(kw)
    return X, y, SVDpp(device="cpu", **args).fit(X, y)


def test_fit_learns_repeats_and_serves_on_p_plus_s():
    X, y, m = _fitted()
    assert m.train_rmse[-1] < m.train_rmse[0]
    _, _, again = _fitted()
    for a, b in zip(m._params, again._params):
        assert torch.equal(a, b)
    preds = np.asarray(m.predict(X.iloc[:50]))
    assert preds.min() >= 0 and preds.max() <= 5
    P = (m._params.user_features + m._params.user_implicit_sums).numpy()
    Q = m._params.item_features.numpy()[:m.n_items]
    users = [0, 3, 17]
    batch = m.recommend_batch(users, amount=5)
    for row, user in enumerate(users):
        d = m.user_vocab.encode(np.asarray([user], dtype=object))[0]
        s = float(m.global_mean) + P[d] @ Q.T
        want = np.argsort(-s, kind="stable")[:5]
        got = m.item_vocab.encode(np.asarray(
            batch.item_id[5 * row:5 * row + 5], dtype=object))
        np.testing.assert_array_equal(got, want)


def test_update_users_grows_and_freezes_items():
    X, y, m = _fitted()
    Q0 = m._params.item_features.clone()
    Y0 = m._params.implicit_features.clone()
    cap = m._params.user_features.shape[0]
    n_new = cap - m.n_users + 5
    new = pd.DataFrame({"user_id": [9000 + k for k in range(n_new)] + [0],
                        "item_id": [int(k % N_ITEMS) for k in range(n_new)] + [3]})
    m.update_users(new, pd.Series(np.full(len(new), 4.0)), n_epochs=2)
    grown = m._params.user_features.shape[0]
    assert grown >= m.n_users and grown % 1024 == 0
    assert m._params.user_implicit_sums.shape == m._params.user_features.shape
    assert torch.equal(m._params.item_features, Q0)
    assert torch.equal(m._params.implicit_features, Y0)
    # the cohort's sums come from its update pairs: y_3 / sqrt(1) for user 0
    d = m.user_vocab.encode(np.asarray([0], dtype=object))[0]
    j = m.item_vocab.encode(np.asarray([3], dtype=object))[0]
    assert torch.equal(m._params.user_implicit_sums[d], Y0[j])
    assert len(m.recommend(9001, amount=3)) == 3


def test_checkpoints_cross_both_ways(tmp_path):
    X, y = _frame(*_ratings())
    jm = JaxSVDpp(n_factors=6, n_epochs=3, lr=0.05, batch_size=128).fit(X, y)
    jax_ckpt.save_model(jm, tmp_path / "jax")
    got = load_model(tmp_path / "jax", device="cpu")
    assert isinstance(got, SVDpp)
    users = [0, 5, 21]
    want = jm.recommend_batch(users, amount=5)
    have = got.recommend_batch(users, amount=5)
    assert list(have.item_id) == list(want.item_id)
    np.testing.assert_allclose(got.predict(X.iloc[:20]), jm.predict(X.iloc[:20]),
                               atol=1e-5)
    save_model(got, tmp_path / "port")
    back = jax_ckpt.load_model(tmp_path / "port")
    for name in jsvd.SVDppParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back._params, name)),
                                      np.asarray(getattr(jm._params, name)))
    assert back.train_rmse == jm.train_rmse


def test_params_from_numpy_checks_the_implicit_shapes():
    _, jcfg = _cfg()
    jp, _ = _params(jcfg, 3.0)
    arrays = [np.asarray(x) for x in jp]
    with pytest.raises(ValueError, match="implicit"):
        svdpp_params_from_numpy(arrays[0], arrays[1], arrays[1][:-8],
                                arrays[3], arrays[4], device="cpu")
    with pytest.raises(ValueError, match="overlap_psum"):
        SVDpp(overlap_psum=True, device="cpu")
