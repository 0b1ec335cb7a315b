"""The port's EASE (gram, closed form, model, ridge sweep, checkpoints)
against the JAX package's on the same seeded data, and against the
float64 dense formula, at the tolerances of ``tests/test_ease.py``."""

import numpy as np
import pandas as pd
import pytest
import torch

from matrix_factorization_tpu.core import checkpoint as jckpt
from matrix_factorization_tpu.data.synthetic import clustered_interactions
from matrix_factorization_tpu.models import grid_search as jgrid
from matrix_factorization_tpu.models.ease import EASE as JEASE
from matrix_factorization_tpu.ops import ease as jops
from matrix_factorization_tpu_torch.core import checkpoint as ckpt
from matrix_factorization_tpu_torch.models import grid_search
from matrix_factorization_tpu_torch.models.ease import EASE
from matrix_factorization_tpu_torch.ops import cuda_spd
from matrix_factorization_tpu_torch.ops import ease as ops
from matrix_factorization_tpu_torch.parallel import launch


def _toy(n_users=40, n_items=50, n=600, seed=0):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < n:
        pairs.add((int(rng.integers(n_users)), int(rng.integers(n_items))))
    u, i = np.array(sorted(pairs)).T
    X = pd.DataFrame({"user_id": [f"u{x}" for x in u],
                      "item_id": [f"i{x}" for x in i]})
    y = pd.Series(rng.uniform(0.5, 5.0, len(u)).astype(np.float32))
    return X, y


def _dense_oracle(u, i, w, n_users, n_items, lam):
    X = np.zeros((n_users, n_items), np.float64)
    X[u, i] = w
    P = np.linalg.inv(X.T @ X + lam * np.eye(n_items))
    B = -P / np.diag(P)[None, :]
    np.fill_diagonal(B, 0.0)
    return X, B


def _dense_ids(m, X):
    return (m.user_vocab.encode(X["user_id"].to_numpy()),
            m.item_vocab.encode(X["item_id"].to_numpy()))


@pytest.mark.parametrize("n_items,chunk", [(50, 2048), (37, 8)],
                         ids=["one-chunk", "chunks-of-8"])
def test_item_gram_equals_jax(n_items, chunk):
    """Binary co-occurrence counts are exact: the grams are equal."""
    rng = np.random.default_rng(n_items)
    u = rng.integers(0, 40, 500).astype(np.int32)
    i = rng.integers(0, n_items, 500).astype(np.int32)
    w = np.ones(500, np.float32)
    got = ops.item_gram(u, i, w, 40, n_items, chunk, device="cpu")
    want = np.asarray(jops.item_gram(u, i, w, 40, n_items, chunk))
    assert got.shape == (ops.round8(n_items),) * 2
    np.testing.assert_array_equal(got.numpy(), want)


def test_ease_weights_match_jax_and_oracle():
    X, y = _toy()
    m = EASE(reg=10.0, device="cpu").fit(X, y)
    u, i = _dense_ids(m, X)
    Xd, B_ref = _dense_oracle(u, i, np.ones(len(u)), m.n_users, m.n_items, 10.0)
    B = m._params.item_weights.numpy()
    assert B.shape == (56, 56) and np.abs(np.diag(B)).max() == 0.0
    assert not B[50:].any() and not B[:, 50:].any()  # pad items inert
    np.testing.assert_allclose(B[:50, :50], B_ref, atol=5e-4)
    want = JEASE(reg=10.0).fit(X, y)
    np.testing.assert_allclose(B, np.asarray(want._params.item_weights), atol=5e-4)
    S = m._catalog_scores_batch(np.arange(m.n_users))
    np.testing.assert_allclose(S, Xd @ B_ref, atol=5e-4)


def test_weighted_histories_and_multi():
    X, y = _toy(seed=3)
    m = EASE(reg=25.0, binarize=False, device="cpu").fit(X, y)
    u, i = _dense_ids(m, X)
    Xd, B_ref = _dense_oracle(u, i, np.asarray(y, np.float64), m.n_users,
                              m.n_items, 25.0)
    np.testing.assert_allclose(m._catalog_scores_batch(np.arange(m.n_users)),
                               Xd @ B_ref, atol=3e-3)
    G = ops.item_gram(u, i, np.ones(len(u), np.float32), m.n_users, m.n_items,
                      device="cpu")
    regs = [2.0, 10.0, 80.0]
    stack = ops.ease_weights_multi(G, regs)
    want = np.asarray(jops.ease_weights_multi(jops.item_gram(
        u, i, np.ones(len(u), np.float32), m.n_users, m.n_items), regs))
    for c, lam in enumerate(regs):
        np.testing.assert_allclose(stack[c].numpy(),
                                   ops.ease_weights(G, lam).numpy(), atol=2e-5)
        np.testing.assert_allclose(stack[c].numpy(), want[c], atol=5e-4)


def test_ease_runs_the_gauss_jordan_leaf(monkeypatch):
    """The inverse goes through the leaf: at 300 items the Schur recursion
    splits to leaves of 80 and 72 (within the 128 the leaf takes)."""
    calls = []
    plain = cuda_spd.gj_inverse

    def counting(A):
        calls.append(tuple(A.shape))
        return plain(A)

    monkeypatch.setattr(cuda_spd, "gj_inverse", counting)
    G = ops.item_gram(np.arange(300) % 7, np.arange(300), np.ones(300, np.float32),
                      7, 300, device="cpu")
    B = ops.ease_weights(G, 5.0)
    assert calls and all(d <= cuda_spd.MAX_D for _, d, _ in calls)
    assert torch.isfinite(B).all()


def test_recommend_predict_and_update_users_match_jax():
    X, y = _toy(seed=1)
    m = EASE(reg=5.0, device="cpu").fit(X, y)
    j = JEASE(reg=5.0).fit(X, y)
    uid = X["user_id"].iloc[0]
    known = list(X[X["user_id"] == uid]["item_id"])
    for kw in ({}, {"items_known": known}):
        got = m.recommend(user=uid, amount=8, **kw)
        want = j.recommend(user=uid, amount=8, **kw)
        assert got["item_id"].tolist() == want["item_id"].tolist()
        np.testing.assert_allclose(got["rating_pred"], want["rating_pred"], atol=5e-4)
    users = X["user_id"].unique()[:5].tolist()
    rb = m.recommend_batch(users, amount=5)
    assert rb["item_id"].tolist() == j.recommend_batch(users, amount=5)["item_id"].tolist()
    q = pd.DataFrame({"user_id": [uid, "GHOST", X["user_id"].iloc[1]] + users,
                      "item_id": [X["item_id"].iloc[0], X["item_id"].iloc[0],
                                  "GHOST"] + X["item_id"].iloc[:5].tolist()})
    np.testing.assert_allclose(m.predict(q), j.predict(q), atol=5e-4)
    assert m.predictions_possible == j.predictions_possible
    assert m.predict(pd.DataFrame({"user_id": [], "item_id": []})) == []
    ghost = m.recommend(user="GHOST", amount=3)
    assert len(ghost) == 3 and m.predictions_possible == [False] * 50
    # new users recorded, known users' histories replaced
    items = X["item_id"].drop_duplicates().to_numpy()[:6]
    upd = pd.DataFrame({"user_id": ["newbie"] * 6 + [uid], "item_id": list(items) + [items[0]]})
    for model in (m, j):
        model.update_users(upd, pd.Series(np.ones(7, np.float32)))
    np.testing.assert_array_equal(m._indptr, j._indptr)
    np.testing.assert_array_equal(m._hist_i, j._hist_i)
    got = m.recommend(user="newbie", amount=5, items_known=list(items))
    want = j.recommend(user="newbie", amount=5, items_known=list(items))
    assert got["item_id"].tolist() == want["item_id"].tolist()


def test_unknown_user_rating_pred_dtype_matches_jax():
    """A user outside the vocabulary scores every item 0.0; JAX's generic
    path gives those as float64, and so does the port, in ``recommend``
    and in ``recommend_batch`` with a known user beside it."""
    X, y = _toy(seed=4)
    m = EASE(reg=5.0, device="cpu").fit(X, y)
    j = JEASE(reg=5.0).fit(X, y)
    uid = X["user_id"].iloc[0]
    for got, want in (
            (m.recommend(user="GHOST", amount=4), j.recommend(user="GHOST", amount=4)),
            (m.recommend_batch(["GHOST", uid], amount=4),
             j.recommend_batch(["GHOST", uid], amount=4))):
        ghost_got = got[got["user_id"] == "GHOST"]["rating_pred"]
        ghost_want = want[want["user_id"] == "GHOST"]["rating_pred"]
        assert ghost_got.dtype == ghost_want.dtype == np.float64
        assert got["rating_pred"].dtype == want["rating_pred"].dtype
        assert got["item_id"].tolist() == want["item_id"].tolist()
        np.testing.assert_allclose(got["rating_pred"], want["rating_pred"], atol=5e-4)


def test_bf16_serving_and_guards():
    X, y = _toy(seed=6)
    m32 = EASE(reg=5.0, device="cpu").fit(X, y)
    mb = EASE(reg=5.0, serving_dtype="bfloat16", device="cpu").fit(X, y)
    np.testing.assert_allclose(mb._catalog_scores_batch(np.arange(4)),
                               m32._catalog_scores_batch(np.arange(4)),
                               rtol=2e-2, atol=2e-2)
    assert mb._params.item_weights.dtype == torch.float32
    assert mb._serving_B().dtype == torch.bfloat16
    with pytest.raises(ValueError):
        EASE(reg=0.0, device="cpu")
    with pytest.raises(ValueError):
        EASE(serving_dtype="fp8", device="cpu")
    stub = object()
    assert EASE(mesh=stub, device="cpu").mesh is stub  # fits on a mesh
    with pytest.raises(RuntimeError):
        EASE(device="cpu").recommend(user="u0")
    with pytest.raises(ValueError):
        EASE(device="cpu").fit(pd.concat([X.iloc[:1], X.iloc[:1]]), pd.Series([1.0, 2.0]))
    with pytest.raises(ValueError):
        EASE(binarize=False, device="cpu").fit(X.iloc[:2], pd.Series([-1.0, 2.0]))
    with pytest.raises(ValueError):
        ops.check_item_budget(16_385)
    ops.check_item_budget(16_384)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port", "port-to-port"])
def test_checkpoint_both_ways(tmp_path, direction):
    X, y = _toy(seed=5)
    src = (JEASE(reg=7.5) if direction == "jax-to-port"
           else EASE(reg=7.5, device="cpu")).fit(X, y)
    save = jckpt.save_model if direction == "jax-to-port" else ckpt.save_model
    load = (jckpt.load_model if direction == "port-to-jax"
            else lambda p: ckpt.load_model(p, device="cpu"))
    save(src, tmp_path / "ease")
    back = load(tmp_path / "ease")
    assert type(back).__name__ == "EASE" and back.reg == 7.5
    np.testing.assert_array_equal(np.asarray(back._params.item_weights),
                                  np.asarray(src._params.item_weights))
    for name in ("_indptr", "_hist_i", "_hist_w"):
        np.testing.assert_array_equal(getattr(back, name), getattr(src, name))
    users = X["user_id"].unique()[:4].tolist()
    got = back.recommend_batch(users, amount=5)
    want = src.recommend_batch(users, amount=5)
    assert got["item_id"].tolist() == want["item_id"].tolist()
    np.testing.assert_allclose(got["rating_pred"], want["rating_pred"], atol=1e-5)


def test_grid_search_ease_matches_jax():
    X, y = clustered_interactions(n_users=250, n_items=200, n_clusters=5,
                                  per_user=14, seed=11)
    regs = (0.5, 20.0, 50_000.0)
    model, results = grid_search.grid_search_ease(X, y, regs=regs, k=10, seed=3,
                                                  device="cpu")
    jmodel, jresults = jgrid.grid_search_ease(X, y, regs=regs, k=10, seed=3)
    assert [d["reg"] for d in results] == [d["reg"] for d in jresults]
    np.testing.assert_allclose([d["hit_at_k"] for d in results],
                               [d["hit_at_k"] for d in jresults], atol=1e-9)
    assert isinstance(model, EASE) and model.reg == jmodel.reg != 50_000.0
    assert int(model._indptr[-1]) == len(X)
    np.testing.assert_allclose(model._params.item_weights.numpy(),
                               np.asarray(jmodel._params.item_weights), atol=5e-4)
    assert len(model.recommend(user=X["user_id"].iloc[0], amount=5)) == 5
    with pytest.raises(ValueError):
        grid_search.grid_search_ease(X, y, regs=(), device="cpu")
    with pytest.raises(ValueError):
        grid_search.grid_search_ease(X, y, holdout_per_user=0, device="cpu")


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, at one intra-op thread."""
    with launch.world_of_one():
        yield


def test_mesh_of_one_rank_is_the_single_device_fit(world_of_one):
    """One data rank takes the single-device path, as JAX's model does:
    ``B`` whole and equal to the mesh-free fit's, the same scores; the
    sharded Newton-Schulz path on the one rank within 5e-4 of Schur."""
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    X, y = _toy(seed=8)
    mesh = make_mesh(1)
    got = EASE(reg=5.0, mesh=mesh, device="cpu").fit(X, y)
    want = EASE(reg=5.0, device="cpu").fit(X, y)
    assert got._sharding is None and got.mesh is mesh
    assert torch.equal(got._params.item_weights, want._params.item_weights)
    np.testing.assert_array_equal(got._catalog_scores_batch(np.arange(8)),
                                  want._catalog_scores_batch(np.arange(8)))
    u, i = _dense_ids(want, X)
    G = ops.item_gram(u, i, np.ones(len(u), np.float32), want.n_users,
                      want.n_items, device="cpu")
    B_ns = ops.ease_weights_sharded(G.clone(), 5.0, mesh, inverse="ns")
    np.testing.assert_allclose(B_ns.numpy(), want._params.item_weights.numpy(),
                               atol=5e-4)
    assert not B_ns.diagonal().any()
