"""The port's BPR (``ops/bpr.py``, ``models/bpr.py``) against the JAX
package, on the CPU.

The JAX random streams are handed to the port: each epoch's key is split
as ``jax.random.split(key, n_epochs)[e]`` then ``kp, kn = split(k)``, and
the batch order ``permutation(kp, nb)`` and negatives ``randint(kn, (nb,
bs), 0, n_items)`` (the flat trainer: ``permutation(kp, n_pad)`` and
``randint(kn, (n_pad,), ...)``) go in with JAX's initial tables. Tolerances
are JAX's own (``tests/test_bpr.py``): tables atol 2e-5, loss rtol 1e-5;
one step atol 1e-6; the sampled AUC within 1e-6 where the negatives are
drawn from outside the observed pairs (as ``BPR.auc`` draws them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu import BPR as JaxBPR
from matrix_factorization_tpu.core import checkpoint as jax_ckpt
from matrix_factorization_tpu.ops import bpr as jbpr
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch import BPR, load_model, params_from_numpy, save_model
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import bpr
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.ops.segment_sum import sorted_order


def _interactions(n_users=60, n_items=40, per_user=8, seed=0):
    """Two user groups, each preferring one half of the catalog."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        own = np.arange(0, n_items // 2) if u < n_users // 2 else \
            np.arange(n_items // 2, n_items)
        pos = list(rng.choice(own, size=per_user, replace=False))
        if rng.random() < 0.3:
            pos.append(int(rng.integers(n_items)))
        rows += [(u, it) for it in dict.fromkeys(pos)]
    return pd.DataFrame(rows, columns=["user_id", "item_id"])


def _cfg(n_factors=6, reg=0.01):
    kw = dict(kernel="linear", n_factors=n_factors, reg=reg, min_rating=0.0,
              max_rating=1.0)
    return SGDConfig(**kw), jsgd.SGDConfig(**kw)


def _jax_params(n_users, n_items, jcfg, sd=0.1):
    p = jsgd.init_params(jax.random.PRNGKey(0), n_users, n_items, jcfg,
                         global_mean=0.0, init_sd=sd)
    return p, params_from_numpy(np.asarray(p.user_features),
                                np.asarray(p.item_features), 0.0, device="cpu")


def _tiled_draws(key, n_epochs, nb, bs, n_items):
    orders, negs = [], []
    for k in jax.random.split(key, n_epochs):
        kp, kn = jax.random.split(k)
        orders.append(np.asarray(jax.random.permutation(kp, nb)))
        negs.append(np.asarray(jax.random.randint(kn, (nb, bs), 0, n_items,
                                                  jnp.int32)))
    return orders, negs


def _assert_tables(got, want, atol=2e-5):
    np.testing.assert_allclose(got.user_features.numpy(),
                               np.asarray(want.user_features), atol=atol)
    np.testing.assert_allclose(got.item_features.numpy(),
                               np.asarray(want.item_features), atol=atol)


@pytest.mark.parametrize("n_epochs,update_items", [(1, True), (2, True),
                                                   (2, False)])
def test_tiled_trainer_matches_jax(n_epochs, update_items):
    X = _interactions(n_users=90, n_items=50)
    u = X.user_id.to_numpy(np.int32)
    i = X.item_id.to_numpy(np.int32)
    w = np.ones(len(u), np.float32)
    cfg, jcfg = _cfg()
    jdata = jsgd.pack_ratings(u, i, w, 128, shuffle_seed=3, order="user",
                               agg_min_gain=-1.0)
    data = sgd.pack_ratings(u, i, w, 128, shuffle_seed=3, order="user",
                            device="cpu")
    # (the JAX pack keeps its secondary argsort only where its tile cost
    # model wants it; tests/test_torch_pack.py holds those leaves equal)
    for name in ("user_ids", "item_ids", "weights"):
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      np.asarray(getattr(jdata, name)), name)
    jp, p = _jax_params(90, 50, jcfg)
    key = jax.random.PRNGKey(5)
    want, whist = jbpr.bpr_train_tiled(jp, jdata, key, jcfg, n_epochs, 0.05,
                                       50, update_items)
    orders, negs = _tiled_draws(key, n_epochs, data.n_batches,
                                data.batch_size, 50)
    got, hist = bpr.bpr_train_tiled(p, data, None, cfg, n_epochs, 0.05, 50,
                                    update_items, batch_orders=orders,
                                    negatives=negs)
    _assert_tables(got, want)
    np.testing.assert_allclose(hist.numpy(), np.asarray(whist), rtol=1e-5)
    if not update_items:
        assert torch.equal(got.item_features, p.item_features)


def test_flat_trainer_matches_jax():
    X = _interactions(n_users=50, n_items=30)
    u = X.user_id.to_numpy(np.int32)
    i = X.item_id.to_numpy(np.int32)
    bs = 64
    n = len(u)
    n_pad = -(-n // bs) * bs
    up, ip, wp = (np.zeros(n_pad, np.int32), np.zeros(n_pad, np.int32),
                  np.zeros(n_pad, np.float32))
    up[:n], ip[:n], wp[:n] = u, i, 1.0
    cfg, jcfg = _cfg(n_factors=5)
    jp, p = _jax_params(50, 30, jcfg)
    key = jax.random.PRNGKey(9)
    want, whist = jbpr.bpr_train(jp, jnp.asarray(up), jnp.asarray(ip),
                                 jnp.asarray(wp), key, jcfg, 2, 0.05, 30, bs,
                                 n)
    perms, negs = [], []
    for k in jax.random.split(key, 2):
        kp, kn = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(kp, n_pad)))
        negs.append(np.asarray(jax.random.randint(kn, (n_pad,), 0, 30,
                                                  jnp.int32)))
    got, hist = bpr.bpr_train(p, torch.from_numpy(up), torch.from_numpy(ip),
                              torch.from_numpy(wp), None, cfg, 2, 0.05, 30,
                              bs, n, perms=perms, negatives=negs)
    _assert_tables(got, want)
    np.testing.assert_allclose(hist.numpy(), np.asarray(whist), rtol=1e-5)


def test_step_with_collisions_and_j_equal_i_matches_jax():
    """Duplicate users and items, ``j == i`` triplets and a pad: the
    port's three applies against JAX's summed scatters."""
    cfg, jcfg = _cfg(n_factors=4, reg=0.05)
    jp, p = _jax_params(6, 5, jcfg, sd=0.3)
    u = np.array([0, 0, 2, 3, 3, 5, 5], np.int32)
    i = np.array([1, 2, 2, 0, 4, 3, 1], np.int32)
    j = np.array([3, 2, 1, 4, 4, 3, 1], np.int32)  # j == i in three slots
    w = np.array([1, 1, 1, 1, 1, 0, 1], np.float32)
    (P1, Q1, loss), _ = jbpr._bpr_step(
        (jp.user_features, jp.item_features, jnp.float32(0.0)),
        tuple(jnp.asarray(a) for a in (u, i, j, w)), jcfg, 0.1, True)
    P, Q = p.user_features.clone(), p.item_features.clone()
    t = {k: torch.from_numpy(a) for k, a in zip("uijw", (u, i, j, w))}
    got_loss = bpr.bpr_step(
        P, Q, t["u"], t["i"], t["j"], t["w"],
        tuple(sorted_order(t[k]) for k in "uij"), cfg, 0.1,
        sgd.mask_tensor(cfg, "user", "cpu"), sgd.mask_tensor(cfg, "item", "cpu"))
    np.testing.assert_allclose(P.numpy(), np.asarray(P1), atol=1e-6)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Q1), atol=1e-6)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)


@pytest.mark.parametrize("observed", [False, True])
def test_auc_sampled_matches_jax(observed):
    cfg, jcfg = _cfg(n_factors=8)
    jp, p = _jax_params(40, 30, jcfg, sd=0.5)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 40, 300).astype(np.int32)
    i = rng.integers(0, 30, 300).astype(np.int32)
    obs = (u, i) if observed else None
    want = jbpr.auc_sampled(jp, u, i, 30, jcfg, seed=4, n_neg=7, observed=obs)
    got = bpr.auc_sampled(p, u, i, 30, cfg, seed=4, n_neg=7, observed=obs,
                          chunk=128)
    if observed:
        assert abs(got - want) <= 1e-6
    else:
        # a negative drawn equal to its positive is a tie, which the port
        # counts as a miss and JAX as float noise decides
        j = np.random.default_rng(4).integers(0, 30, (300, 7))
        ties = int((j == i[:, None]).sum())
        assert ties > 0 and abs(got - want) <= ties / j.size + 1e-6


def _fitted(**kw):
    X = _interactions()
    args = dict(n_factors=8, n_epochs=6, lr=0.1, batch_size=128, seed=0)
    args.update(kw)
    return X, BPR(device="cpu", **args).fit(X)


def test_fit_learns_repeats_and_serves():
    X, m = _fitted()
    assert m.train_loss[-1] < m.train_loss[0]
    assert m.auc(X, n_neg=10) > 0.5
    _, again = _fitted()
    assert torch.equal(m._params.user_features, again._params.user_features)
    assert torch.equal(m._params.item_features, again._params.item_features)
    # a cold user takes the cold row (its score is the item's bias) and is
    # flagged; scores are not clamped
    preds = m.predict(pd.DataFrame({"user_id": [0, 999], "item_id": [1, 1]}))
    bias = m.item_biases[m.item_vocab.encode(np.asarray([1], dtype=object))[0]]
    assert preds[1] == pytest.approx(float(bias), abs=1e-7)
    assert m.predictions_possible == [True, False]
    rec = m.recommend(0, amount=5, items_known=[1, 2])
    assert len(rec) == 5 and not set(rec.item_id) & {1, 2}
    batch = m.recommend_batch([0, 1, 2], amount=4)
    assert len(batch) == 12
    single = m.recommend(1, amount=4)
    assert list(batch.item_id[4:8]) == list(single.item_id)


def test_update_users_freezes_items_and_grows():
    X, m = _fitted()
    Q0 = m._params.item_features.clone()
    cap = m._params.user_features.shape[0]
    new = pd.DataFrame({"user_id": [5000 + k for k in range(cap - m.n_users + 3)],
                        "item_id": [int(X.item_id.iloc[0])] * (cap - m.n_users + 3)})
    # every row non-positive: no training, but the table must still grow
    m.update_users(new, y=pd.Series(np.zeros(len(new), np.float32)))
    assert m._params.user_features.shape[0] >= m.n_users
    assert m._params.user_features.shape[0] % 1024 == 0
    upd = pd.DataFrame({"user_id": [0, 0, 7000, 7000],
                        "item_id": [3, 4, 5, 6]})
    m.update_users(upd, n_epochs=3)
    assert torch.equal(m._params.item_features, Q0)
    assert len(m.recommend(7000, amount=3)) == 3


def test_update_users_keeps_known_user_without_positives():
    X, m = _fitted()
    known, other = X.user_id.iloc[0], X.user_id.iloc[-1]
    row = m.user_vocab.encode(np.asarray([known], dtype=object))[0]
    before = m._params.user_features[row].clone()
    upd = pd.DataFrame({"user_id": [known, other, other],
                        "item_id": [int(X.item_id.iloc[k]) for k in range(3)]})
    m.update_users(upd, y=pd.Series(np.array([0.0, 1.0, 1.0], np.float32)))
    assert torch.equal(m._params.user_features[row], before)


def test_warm_start_keeps_earlier_positives_for_auc():
    X, m = _fitted(n_epochs=2)
    first = m._train_pairs
    m.fit(X.iloc[:40], n_epochs=1, warm_start=True)
    assert len(m._train_pairs[0]) == len(first[0]) + 40
    assert len(m.train_loss) == 3


def test_checkpoints_cross_both_ways(tmp_path):
    X = _interactions()
    jm = JaxBPR(n_factors=8, n_epochs=3, lr=0.1, batch_size=128).fit(X)
    jax_ckpt.save_model(jm, tmp_path / "jax")
    got = load_model(tmp_path / "jax", device="cpu")
    assert isinstance(got, BPR)
    np.testing.assert_array_equal(got._train_pairs[0], jm._train_pairs[0])
    users = [0, 5, 40]
    want = jm.recommend_batch(users, amount=5)
    have = got.recommend_batch(users, amount=5)
    assert list(have.item_id) == list(want.item_id)
    np.testing.assert_allclose(have.rating_pred, want.rating_pred, atol=1e-5)
    save_model(got, tmp_path / "port")
    back = jax_ckpt.load_model(tmp_path / "port")
    np.testing.assert_array_equal(np.asarray(back._params.user_features),
                                  np.asarray(jm._params.user_features))
    np.testing.assert_array_equal(back._train_pairs[1], jm._train_pairs[1])
    assert back.train_loss == jm.train_loss
    again = load_model(tmp_path / "port", device="cpu")
    assert torch.equal(again._params.item_features, got._params.item_features)


@pytest.mark.parametrize("kw,err", [
    ({"psum_every": "auto"}, ValueError),
    ({"overlap_psum": True}, ValueError),
    ({"serving_dtype": "float16"}, ValueError),
    ({"dp_layout": "ring"}, ValueError),
    ({"psum_every": 2}, ValueError),
])
def test_constructor_checks(kw, err):
    with pytest.raises(err):
        BPR(device="cpu", **kw)
