"""The PyTorch port's KernelMF against the JAX package's.

Serving: a small JAX ``KernelMF`` is fitted per kernel and checkpointed
with the JAX ``save_model``; the port loads it (``device="cpu"``) and
must give the same predictions, views, recommendations and batch
recommendations (same items in the same order, scores at atol 1e-5: both
score in f32, summed in different orders). The reverse trip, a port
checkpoint into the JAX package, must work too.

Training: the port's ``fit`` / ``update_users`` on the reference's
cold-start split (the ported ``train_update_test_split``, equal to the
JAX split) reach the JAX model's held-out RMSE within 0.02 (the initial
tables and batch orders come from different generators, so the two
trajectories differ), and ``warm_start``, ``update_users``,
``fit_resumable`` and checkpoints keep their contracts."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu import KernelMF as JaxKernelMF
from matrix_factorization_tpu.core import checkpoint as jax_ckpt
from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.utils.splits import (
    train_update_test_split as jax_split)
from matrix_factorization_tpu_torch import (
    KernelMF,
    fit_resumable,
    load_model,
    params_from_numpy,
    save_model,
    train_update_test_split,
)
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.parallel import launch

KERNELS = ["linear", "sigmoid", "rbf"]


@pytest.fixture(scope="module")
def data():
    X, y = lowrank_ratings(n_users=120, n_items=90, density=0.3, seed=5,
                           min_rating=1.0, max_rating=5.0)
    # string item ids: the vocabularies must carry arbitrary hashables
    X = X.assign(item_id="m" + X["item_id"].astype(str))
    return X, y


@pytest.fixture(scope="module")
def fitted(data, tmp_path_factory):
    """kernel -> (JAX model, its checkpoint directory)."""
    X, y = data
    out = {}
    for kernel in KERNELS:
        m = JaxKernelMF(n_factors=14, n_epochs=3, kernel=kernel, lr=0.05,
                        reg=0.02, batch_size=256, min_rating=1.0,
                        max_rating=5.0, seed=1).fit(X, y)
        path = tmp_path_factory.mktemp("ckpt") / kernel
        jax_ckpt.save_model(m, path)
        out[kernel] = (m, path)
    return out


def _eval_frame(X):
    """Known pairs plus unknown users and items (-1 rows)."""
    extra = pd.DataFrame({"user_id": [-5, X.user_id.iloc[0], -6],
                          "item_id": [X.item_id.iloc[0], "m-nope", "m-x"]})
    return pd.concat([X.iloc[:300], extra], ignore_index=True)


def _assert_same_frame(got, want):
    assert list(got.columns) == list(want.columns)
    for col in got.columns:
        if col == "rating_pred":
            np.testing.assert_allclose(got[col].to_numpy(),
                                       want[col].to_numpy(), atol=1e-5)
        else:
            assert list(got[col]) == list(want[col])


@pytest.mark.parametrize("kernel", KERNELS)
def test_load_jax_checkpoint_views_and_predict(fitted, data, kernel):
    jm, path = fitted[kernel]
    m = load_model(path, device="cpu")
    assert isinstance(m, KernelMF)
    assert m._params.user_features.device.type == "cpu"
    cfg = {k: v for k, v in m.get_params().items() if k != "device"}
    assert cfg == jm.get_params()
    assert m.user_vocab.raw_ids == jm.user_vocab.raw_ids
    assert m.item_vocab.raw_ids == jm.item_vocab.raw_ids
    assert m.global_mean == jm.global_mean
    assert m.train_rmse == jm.train_rmse
    for view in ("user_features", "item_features", "user_biases",
                 "item_biases"):
        np.testing.assert_allclose(getattr(m, view), getattr(jm, view),
                                   atol=1e-5)
    Xe = _eval_frame(data[0])
    for bound in (True, False):
        got = m.predict(Xe, bound_ratings=bound)
        want = jm.predict(Xe, bound_ratings=bound)
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert m.predictions_possible == jm.predictions_possible
    assert not any(m.predictions_possible[-3:])
    assert min(m.predict(Xe)) >= 1.0 and max(m.predict(Xe)) <= 5.0
    assert m.predict(Xe.iloc[:0]) == []


@pytest.mark.parametrize("kernel", KERNELS)
def test_recommend_matches_jax(fitted, data, kernel):
    jm, path = fitted[kernel]
    m = load_model(path, device="cpu")
    X = data[0]
    user = X.user_id.iloc[3]
    known = list(X.loc[X.user_id == user, "item_id"])
    for kw in ({}, {"items_known": known}, {"items_known": known[:2] + ["m-x"]},
               {"include_user": False, "amount": 4},
               {"bound_ratings": False, "amount": 90}):
        _assert_same_frame(m.recommend(user, **kw), jm.recommend(user, **kw))
        assert m.predictions_possible == jm.predictions_possible
    rec = m.recommend(user, amount=8, items_known=known)
    assert not set(rec.item_id) & set(known)
    assert (np.diff(rec.rating_pred.to_numpy()) <= 0).all()
    # an unknown user is scored from the cold row
    for kw in ({}, {"items_known": known[:3]}):
        _assert_same_frame(m.recommend("stranger", **kw),
                           jm.recommend("stranger", **kw))
        assert m.predictions_possible == jm.predictions_possible


@pytest.mark.parametrize("kernel", KERNELS)
def test_recommend_batch_matches_jax(fitted, data, kernel):
    jm, path = fitted[kernel]
    m = load_model(path, device="cpu")
    X = data[0]
    users = list(pd.unique(X.user_id))[:9]
    known = {u: list(X.loc[X.user_id == u, "item_id"])[:n]
             for n, u in enumerate(users[:5])}
    _assert_same_frame(m.recommend_batch(users, amount=6),
                       jm.recommend_batch(users, amount=6))
    _assert_same_frame(m.recommend_batch(users, amount=6, items_known_map=known),
                       jm.recommend_batch(users, amount=6, items_known_map=known))
    # a cohort with an unknown user goes user by user
    mixed = users[:3] + ["stranger"]
    _assert_same_frame(m.recommend_batch(mixed, amount=5),
                       jm.recommend_batch(mixed, amount=5))
    for u in users:
        np.testing.assert_allclose(
            m._catalog_scores(int(m.user_vocab.encode(np.array([u]))[0])),
            m._catalog_scores_batch(m.user_vocab.encode(np.array(users)))[
                users.index(u)], atol=1e-6)


@pytest.mark.parametrize("kernel", ["sigmoid", "rbf"])
def test_bf16_serving(fitted, data, kernel):
    """bf16 serving tables: the same items and scores as the JAX
    package's bf16 serving (atol 1e-3, both upcast the same bf16 values),
    close to f32 serving, and ``predict`` stays f32."""
    jm, path = fitted[kernel]
    f32 = load_model(path, device="cpu")
    m = load_model(path, device="cpu")
    m.serving_dtype = "bfloat16"
    jb = jax_ckpt.load_model(path)
    jb.serving_dtype = "bfloat16"
    X = data[0]
    users = list(pd.unique(X.user_id))[:6]
    got, want = m.recommend_batch(users, amount=6), jb.recommend_batch(users, amount=6)
    np.testing.assert_allclose(got.rating_pred, want.rating_pred, atol=1e-3)
    for u in users:
        a = set(got.loc[got.user_id == u, "item_id"])
        assert len(a & set(want.loc[want.user_id == u, "item_id"])) >= 5
        b = f32.recommend(u, amount=6)
        assert len(a & set(b.item_id)) >= 4
    sp = m._cached_serving_params()
    assert sp.item_features.dtype == torch.bfloat16
    assert sp.user_features.dtype == torch.bfloat16
    assert m._params.item_features.dtype == torch.float32
    assert m._cached_serving_params() is sp  # cached while _params is unchanged
    m._params = m._params._replace()
    assert m._cached_serving_params() is not sp  # a new _params rebuilds the copy
    assert m.predict(X) == f32.predict(X)


@pytest.mark.parametrize("kernel", KERNELS)
def test_port_checkpoint_loads_into_jax(fitted, data, kernel, tmp_path):
    jm, path = fitted[kernel]
    m = load_model(path, device="cpu")
    save_model(m, tmp_path / "port")
    back = jax_ckpt.load_model(tmp_path / "port")
    assert type(back) is JaxKernelMF
    assert back.get_params() == jm.get_params()
    for name in ("user_features", "item_features", "global_mean"):
        np.testing.assert_array_equal(np.asarray(getattr(back._params, name)),
                                      np.asarray(getattr(jm._params, name)))
    assert back._params.user_features.dtype == jnp.float32
    X = data[0]
    np.testing.assert_allclose(back.predict(X), m.predict(X), atol=1e-5)
    user = X.user_id.iloc[0]
    _assert_same_frame(m.recommend(user), back.recommend(user))
    # and back again: the port reads its own checkpoint
    again = load_model(tmp_path / "port", device="cpu")
    np.testing.assert_array_equal(again.user_features, m.user_features)


def test_training_and_later_slices_raise(fitted, data):
    """Training is ported (slice 2), ALS and its warm start too (slice 3),
    SGD on a mesh too (slice 6a), and ALS on a data mesh of more than one
    rank (slice 6b)."""
    m = load_model(fitted["linear"][1], device="cpu")
    X, y = data
    m.fit(X, y, n_epochs=1)
    assert len(m.train_rmse) == 1 and np.isfinite(m.train_rmse[0])
    m.update_users(X.iloc[:50], y.iloc[:50], n_epochs=1)
    assert len(m.train_rmse) == 1
    assert KernelMF(device="cpu", method="als").method == "als"
    assert KernelMF(device="cpu", als_warm_start=2).als_warm_start == 2
    data2 = _mesh_stub(2, 1)
    assert KernelMF(device="cpu", method="als", mesh=data2).mesh is data2
    assert KernelMF(device="cpu", method="als", mesh=_mesh_stub(1, 2)).mesh
    for kw in ({"mesh": data2}, {"mesh": data2, "keep_sharded": True}):
        assert KernelMF(device="cpu", **kw).mesh is data2
    for kw in ({"kernel": "cubic"}, {"serving_dtype": "float16"},
               {"keep_sharded": True}, {"method": "als", "kernel": "rbf"},
               {"psum_every": 4}):
        with pytest.raises(ValueError):
            KernelMF(device="cpu", **kw)
    with pytest.raises(RuntimeError, match="not fitted"):
        KernelMF(device="cpu").recommend(1)
    with pytest.raises(RuntimeError, match="not fitted"):
        KernelMF(device="cpu").update_users(X, y)


def _mesh_stub(n_data, n_model):
    """What the argument checks read of a mesh: its axis names and sizes
    (a ``DeviceMesh`` needs a world of that many ranks)."""
    from types import SimpleNamespace

    return SimpleNamespace(mesh_dim_names=("data", "model"),
                           shape=(n_data, n_model))


def test_mesh_argument_checks_match_jax():
    """JAX's checks of the mesh flags (``kernel_mf.py:186-218``): the same
    arguments are refused by both packages, with the same message."""
    stub = _mesh_stub(2, 1)
    cases = [{"overlap_psum": True}, {"psum_every": 4},
             {"psum_every": "auto"}, {"keep_sharded": True},
             {"dp_layout": "diagonal"},
             {"als_warm_start": 1, "mesh": stub},
             {"overlap_psum": True, "method": "als", "mesh": stub},
             {"psum_every": "auto", "method": "als", "mesh": stub}]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            JaxKernelMF(**kw)
        with pytest.raises(ValueError) as got:
            KernelMF(device="cpu", **kw)
        assert str(got.value) == str(want.value), kw
    m = KernelMF(device="cpu", mesh=stub, overlap_psum=True,
                 psum_every="epoch", keep_sharded=True, dp_layout="flat")
    assert (m.overlap_psum, m.psum_every, m.keep_sharded) == (True, "epoch",
                                                              True)


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, at one intra-op thread."""
    with launch.world_of_one():
        yield


def test_mesh_checkpoint_and_resume_on_one_rank(split, tmp_path, world_of_one):
    """A model with a mesh checkpoints without it (the mesh and the flags
    that need one are stripped, as JAX's ``_strip_runtime_config`` does,
    and the pickle holds no ``DeviceMesh``); ``fit_resumable`` gives the
    restored model the caller's mesh. On one rank the fit itself is the
    single-device fit (a data mesh of 1), as in the JAX package."""
    import pickle

    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    train = split[:2]
    mesh = make_mesh()
    kw = dict(n_factors=6, n_epochs=2, lr=0.05, reg=0.02, batch_size=128,
              min_rating=1.0, max_rating=5.0, device="cpu", mesh=mesh)
    m = KernelMF(keep_sharded=True, psum_every="auto", **kw)
    m.fit(*train)
    assert m._topk_catalog is not None
    plain = KernelMF(**{**kw, "mesh": None}).fit(*train)
    np.testing.assert_array_equal(m.user_features, plain.user_features)
    u0 = train[0]["user_id"].iloc[0]
    _assert_same_frame(m.recommend(u0, amount=6), plain.recommend(u0, amount=6))
    save_model(m, tmp_path / "ckpt")
    back = load_model(tmp_path / "ckpt", device="cpu")
    assert back.mesh is None and not back.keep_sharded
    assert back.psum_every == 1 and not back.overlap_psum
    np.testing.assert_array_equal(back.predict(train[0]), m.predict(train[0]))
    restored = pickle.loads(pickle.dumps(m))
    assert restored.mesh is None and restored._topk_catalog is None
    resumed = fit_resumable(KernelMF(**kw), *train, tmp_path / "resume",
                            total_epochs=2, segment_epochs=1)
    assert resumed.mesh is mesh and resumed._epochs_done == 2
    again = fit_resumable(KernelMF(**{**kw, "n_epochs": 3}), *train,
                          tmp_path / "resume", segment_epochs=1)
    assert again.mesh is mesh and again._epochs_done == 3
    assert len(again.train_rmse) == 3


def test_default_device_needs_cuda(fitted, monkeypatch):
    """``device=None`` means CUDA: without a GPU it raises, never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KernelMF()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(fitted["linear"][1])
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(np.zeros((8, 128)), np.zeros((8, 128)), 0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        KernelMF(device="cuda")
    assert KernelMF(device="cpu")._device == torch.device("cpu")


# ---------------------------------------------------------------------------
# Training (slice 2)
# ---------------------------------------------------------------------------

TRAIN_KW = dict(n_factors=14, n_epochs=6, lr=0.05, reg=0.02, batch_size=256,
                min_rating=1.0, max_rating=5.0, seed=1)


@pytest.fixture(scope="module")
def split(data):
    X, y = data
    return train_update_test_split(X.assign(rating=y), 0.2, seed=4)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def test_split_matches_jax_split(data, split):
    X, y = data
    want = jax_split(X.assign(rating=y), 0.2, seed=4)
    for got, exp in zip(split, want):
        pd.testing.assert_frame_equal(pd.DataFrame(got), pd.DataFrame(exp))


@pytest.mark.parametrize("kernel", KERNELS)
def test_fit_and_update_users_match_jax_heldout(split, kernel):
    X_tr, y_tr, X_up, y_up, X_te, y_te = split
    out = {}
    for name, cls, kw in (("port", KernelMF, {"device": "cpu"}),
                          ("jax", JaxKernelMF, {})):
        m = cls(kernel=kernel, **TRAIN_KW, **kw).fit(X_tr, y_tr)
        hist = np.asarray(m.train_rmse)
        assert len(hist) == 6 and np.isfinite(hist).all()
        assert (np.diff(hist) < 0).all(), (name, hist)
        m.update_users(X_up, y_up, lr=0.05, n_epochs=5)
        out[name] = _rmse(m.predict(X_te), y_te)
    assert abs(out["port"] - out["jax"]) <= 0.02, out


def test_warm_start_continues_without_reinit(split):
    X_tr, y_tr = split[0], split[1]
    m = KernelMF(kernel="sigmoid", **TRAIN_KW, device="cpu")
    m.fit(X_tr, y_tr, n_epochs=2)
    before = m._params
    m.fit(X_tr, y_tr, n_epochs=1, warm_start=True)
    assert len(m.train_rmse) == 3
    # the continued fit is one more epoch from the current tables, with
    # the batch order of the fit's own generator (seed, epochs done + 1)
    cfg = m._cfg()
    data = sgd.pack_ratings(m.user_vocab.encode(X_tr.user_id.to_numpy()),
                            m.item_vocab.encode(X_tr.item_id.to_numpy()),
                            np.asarray(y_tr, np.float32), cfg.batch_size,
                            device="cpu")
    want, hist = sgd.sgd_train(before, data, sgd.seeded_generator("cpu", 1, 3),
                               cfg, 1, m.lr)
    assert torch.equal(m._params.user_features, want.user_features)
    assert torch.equal(m._params.item_features, want.item_features)
    assert m.train_rmse[2] == hist[0].item()
    with pytest.raises(KeyError):  # a warm start keeps the id space
        m.fit(X_tr.iloc[:2].assign(user_id=[-7, -8]), y_tr.iloc[:2],
              n_epochs=1, warm_start=True)


def test_update_users_freezes_items_and_grows_users(split):
    X_tr, y_tr, X_up, y_up, _, _ = split
    m = KernelMF(kernel="linear", **TRAIN_KW, device="cpu").fit(X_tr, y_tr)
    items = m._params.item_features.clone()
    users = m._params.user_features.clone()
    n0, cap0 = m.n_users, users.shape[0]
    known = X_tr.user_id.iloc[:3].tolist()
    Xk = pd.DataFrame({"user_id": known, "item_id": X_tr.item_id.iloc[:3]})
    X = pd.concat([X_up, Xk], ignore_index=True)
    y = pd.concat([y_up, y_tr.iloc[:3]], ignore_index=True)
    # no epochs: what is left is the re-initialisation and the new rows
    m.update_users(X, y, n_epochs=0)
    new_users = pd.unique(X_up.user_id)
    assert m.n_users == n0 + len(new_users)
    assert m._params.user_features.shape[0] == max(
        cap0, sgd.round_up(max(m.n_users, int(cap0 * 1.5) + 1), 1024))
    assert m._params.user_features.shape[0] >= m.n_users
    assert torch.equal(m._params.item_features, items)
    kd = m.user_vocab.encode(np.asarray(known, dtype=object))
    cfg = m._cfg()
    rows = m._params.user_features[torch.from_numpy(kd.astype(np.int64))]
    assert not torch.equal(rows, users[kd])  # re-initialised
    assert torch.all(rows[:, sgd.bias_col(cfg, "user")] == 0)
    assert torch.all(rows[:, sgd.const_col(cfg, "user")] == 1)
    others = np.setdiff1d(np.arange(n0), kd)
    assert torch.equal(m._params.user_features[others], users[others])
    # with epochs: only user rows move, and the frozen item table is
    # bitwise unchanged
    m.update_users(X, y, n_epochs=3)
    assert torch.equal(m._params.item_features, items)
    assert len(m.train_rmse) == 3 and m.train_rmse[-1] < m.train_rmse[0]
    assert m.predict(X_up.iloc[:5]) and all(m.predictions_possible)


def test_fit_resumable_segments(split, tmp_path):
    """Two checkpointed segments are the same two fits run by hand (each
    segment draws its batch orders from its own generator, as in the JAX
    package), and a run resumed from the first segment's checkpoint ends
    bitwise where the uninterrupted run ends."""
    X_tr, y_tr = split[0], split[1]
    kw = dict(kernel="rbf", **{**TRAIN_KW, "n_epochs": 4})
    m = fit_resumable(KernelMF(**kw, device="cpu"), X_tr, y_tr,
                      tmp_path / "a", segment_epochs=2)
    assert m._epochs_done == 4 and len(m.train_rmse) == 4
    ref = KernelMF(**kw, device="cpu").fit(X_tr, y_tr, n_epochs=2)
    ref.fit(X_tr, y_tr, n_epochs=2, warm_start=True)
    assert torch.equal(m._params.user_features, ref._params.user_features)
    assert m.train_rmse == ref.train_rmse
    half = fit_resumable(KernelMF(**kw, device="cpu"), X_tr, y_tr,
                         tmp_path / "b", total_epochs=2, segment_epochs=2)
    assert half._epochs_done == 2
    resumed = fit_resumable(KernelMF(**kw, device="cpu"), X_tr, y_tr,
                            tmp_path / "b", segment_epochs=2)
    assert resumed._epochs_done == 4
    assert torch.equal(resumed._params.item_features, m._params.item_features)
    assert resumed.train_rmse == m.train_rmse


def test_port_trained_checkpoint_predicts_the_same_in_jax(split, tmp_path):
    X_tr, y_tr, X_up, y_up, X_te, _ = split
    m = KernelMF(kernel="sigmoid", **TRAIN_KW, device="cpu").fit(X_tr, y_tr)
    m.update_users(X_up, y_up, n_epochs=2)
    save_model(m, tmp_path / "ckpt")
    back = jax_ckpt.load_model(tmp_path / "ckpt")
    assert back.train_rmse == m.train_rmse
    np.testing.assert_allclose(back.predict(X_te), m.predict(X_te), atol=1e-5)
    user = X_te.user_id.iloc[0]
    _assert_same_frame(m.recommend(user), back.recommend(user))
