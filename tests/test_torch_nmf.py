"""The port's NMF (``ops/nmf.py``, ``models/nmf.py``) against the JAX
package, on the CPU.

NMF training draws nothing after its init, so the JAX package's initial
tables go in and the tables must agree to rtol 1e-5 (both sum the
accumulators in f32, in different orders). The packs are byte-equal
first; ``order='auto'`` packs by users on one shape and by items on the
other, so each side's accumulator runs both as the pack's primary and as
its secondary; the default k = 15 gives the 30-wide accumulator.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu import NMF as JaxNMF
from matrix_factorization_tpu.core import checkpoint as jax_ckpt
from matrix_factorization_tpu.ops import nmf as jnmf
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch import NMF, load_model, params_from_numpy, save_model
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import nmf
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd


def _ratings(n_users, n_items, n=700, seed=0):
    """Unique pairs over all but the last user and item (rows that must
    stay as they were), ratings in [1, 5]."""
    rng = np.random.default_rng(seed)
    flat = rng.choice((n_users - 1) * (n_items - 1), n, replace=False)
    u = (flat // (n_items - 1)).astype(np.int32)
    i = (flat % (n_items - 1)).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


@pytest.mark.parametrize("shape", [(80, 30), (30, 80)],
                         ids=["user-primary", "item-primary"])
@pytest.mark.parametrize("n_factors", [4, 15])
@pytest.mark.parametrize("update_items", [True, False])
def test_nmf_train_matches_jax(shape, n_factors, update_items):
    n_users, n_items = shape
    u, i, r = _ratings(n_users, n_items)
    kw = dict(kernel="linear", n_factors=n_factors, min_rating=0.0,
              max_rating=5.0, batch_size=128)
    cfg, jcfg = SGDConfig(**kw), jsgd.SGDConfig(**kw)
    jdata = jsgd.pack_ratings(u, i, r, 128, order="auto",
                              row_width=2 * n_factors)
    data = sgd.pack_ratings(u, i, r, 128, order="auto", device="cpu")
    assert data.primary == ("user" if n_users > n_items else "item")
    for name in ("user_ids", "item_ids", "ratings", "weights"):
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      np.asarray(getattr(jdata, name)), name)
    assert data.primary == jdata.primary
    jp = jnmf.init_nmf_params(jax.random.PRNGKey(0), n_users, n_items, jcfg)
    P0 = np.array(jp.user_features)
    Q0 = np.array(jp.item_features)
    p = params_from_numpy(P0, Q0, 0.0, device="cpu")
    cnt_u = np.bincount(u, minlength=P0.shape[0]).astype(np.float32)
    cnt_i = np.bincount(i, minlength=Q0.shape[0]).astype(np.float32)
    want, whist = jnmf.jit_nmf_train(jcfg, 5, 0.06, 0.03,
                                     update_item_params=update_items)(
        jp, jdata, cnt_u, cnt_i)
    got, hist = nmf.nmf_train(p, data, torch.from_numpy(cnt_u),
                              torch.from_numpy(cnt_i), cfg, 5, 0.06, 0.03,
                              update_item_params=update_items)
    np.testing.assert_allclose(got.user_features.numpy(),
                               np.asarray(want.user_features), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.item_features.numpy(),
                               np.asarray(want.item_features), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(hist.numpy(), np.asarray(whist), rtol=1e-5)
    assert float(got.user_features.min()) >= 0
    assert float(got.item_features.min()) >= 0
    # rows with no observations keep their values
    assert torch.equal(got.user_features[n_users - 1:], p.user_features[n_users - 1:])
    assert torch.equal(got.item_features[n_items - 1:], p.item_features[n_items - 1:])
    if not update_items:
        assert torch.equal(got.item_features, p.item_features)


def _frame(u, i, r):
    return pd.DataFrame({"user_id": u, "item_id": i}), pd.Series(r)


def test_fit_descends_repeats_and_serves():
    X, y = _frame(*_ratings(60, 40))
    m = NMF(n_epochs=8, batch_size=128, device="cpu").fit(X, y)
    assert np.all(np.diff(m.train_rmse) <= 1e-6)
    again = NMF(n_epochs=8, batch_size=128, device="cpu").fit(X, y)
    assert torch.equal(m._params.user_features, again._params.user_features)
    assert m.user_features.min() >= 0 and m.item_features.min() >= 0
    preds = m.predict(pd.DataFrame({"user_id": [0, 999], "item_id": [1, 1]}))
    assert preds[1] == pytest.approx(min(m.global_mean, 5.0))
    assert m.predictions_possible == [True, False]
    P = m._params.user_features.numpy()
    Q = m._params.item_features.numpy()[:m.n_items]
    batch = m.recommend_batch([0, 7], amount=6)
    for row, user in enumerate([0, 7]):
        d = m.user_vocab.encode(np.asarray([user], dtype=object))[0]
        want = np.argsort(-(P[d] @ Q.T), kind="stable")[:6]
        got = m.item_vocab.encode(np.asarray(batch.item_id[6 * row:6 * row + 6],
                                             dtype=object))
        np.testing.assert_array_equal(got, want)


def test_update_users_freezes_items_and_grows():
    X, y = _frame(*_ratings(60, 40))
    m = NMF(n_epochs=4, batch_size=128, device="cpu").fit(X, y)
    Q0 = m._params.item_features.clone()
    cap = m._params.user_features.shape[0]
    n_new = cap - m.n_users + 2  # past the capacity: the table grows
    new = pd.DataFrame({"user_id": [0, 0] + [500 + k for k in range(n_new)],
                        "item_id": [1, 2] + [k % 30 for k in range(n_new)]})
    ratings = pd.Series(np.linspace(1, 5, len(new)))
    m.update_users(new, ratings, n_epochs=5)
    assert torch.equal(m._params.item_features, Q0)
    assert m._params.user_features.shape[0] == 1024
    assert m.user_features.min() >= 0
    assert len(m.train_rmse) == 5
    assert len(m.recommend(500, amount=3)) == 3
    with pytest.raises(ValueError, match="non-negative"):
        m.update_users(new, -ratings)
    # every rating names an unknown item: an empty pack, nothing moves
    P0 = m._params.user_features.clone()
    m.update_users(pd.DataFrame({"user_id": [0], "item_id": [10_000]}),
                   pd.Series([3.0]), n_epochs=2)
    assert torch.equal(m._params.user_features, P0)
    assert m.train_rmse == [0.0, 0.0]


def test_checkpoints_cross_both_ways(tmp_path):
    X, y = _frame(*_ratings(60, 40))
    jm = JaxNMF(n_epochs=5, batch_size=128).fit(X, y)
    jax_ckpt.save_model(jm, tmp_path / "jax")
    got = load_model(tmp_path / "jax", device="cpu")
    assert isinstance(got, NMF)
    users = [0, 5, 21]
    want = jm.recommend_batch(users, amount=5)
    have = got.recommend_batch(users, amount=5)
    assert list(have.item_id) == list(want.item_id)
    cold = pd.DataFrame({"user_id": [0, 999], "item_id": [1, 1]})
    np.testing.assert_allclose(got.predict(cold), jm.predict(cold), atol=1e-5)
    save_model(got, tmp_path / "port")
    back = jax_ckpt.load_model(tmp_path / "port")
    np.testing.assert_array_equal(np.asarray(back._params.item_features),
                                  np.asarray(jm._params.item_features))
    assert back.get_params() == jm.get_params()
