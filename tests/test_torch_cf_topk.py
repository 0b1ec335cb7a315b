"""The port's top-k neighbourhood CF (``TopKItemItemCF`` /
``TopKUserUserCF``) against the JAX package's on the same seeded ratings,
and its device predictor against a float64 replay of the formula."""

import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.models import cf_topk as jcf
from matrix_factorization_tpu_torch.models import cf_topk as cf
from matrix_factorization_tpu_torch.parallel import launch

CLASSES = [("TopKItemItemCF", "item"), ("TopKUserUserCF", "user")]


def _pairs(rng, n_u, n_i, n):
    u = rng.integers(0, n_u, n).astype(np.int32)
    i = rng.integers(0, n_i, n).astype(np.int32)
    keep = ~pd.DataFrame({"u": u, "i": i}).duplicated().to_numpy()
    u, i = u[keep], i[keep]
    r = rng.uniform(0.5, 5, len(u)).astype(np.float32)
    return pd.DataFrame({"user_id": u, "item_id": i}), pd.Series(r)


@pytest.mark.parametrize("name,mode", CLASSES, ids=[c[0] for c in CLASSES])
def test_fit_and_predict_match_jax(name, mode):
    X, y = lowrank_ratings(n_users=80, n_items=60, density=0.4, seed=14)
    y = y.clip(lower=0.5)
    kw = dict(n_neighbors=10, user_block=32, item_tile=32, min_rating=0.5,
              max_rating=5.0)
    want = getattr(jcf, name)(**kw).fit(X, y)
    got = getattr(cf, name)(**kw, device="cpu").fit(X, y)
    assert got.global_mean == want.global_mean
    np.testing.assert_allclose(got._neighbor_sims.numpy(),
                               np.asarray(want._neighbor_sims), atol=1e-5)
    np.testing.assert_array_equal(got._means.numpy(), np.asarray(want._means))
    # the CSR: row-sorted candidate ids, their ratings, the row offsets
    np.testing.assert_array_equal(got._flat_q.numpy(), np.asarray(want._flat_q))
    np.testing.assert_array_equal(got._flat_r.numpy(), np.asarray(want._flat_r))
    np.testing.assert_array_equal(got._offsets.numpy(), np.asarray(want._offsets))
    assert got._iters == want._iters
    rng = np.random.default_rng(3)
    Q = pd.DataFrame({"user_id": rng.choice(X["user_id"].unique(), 300),
                      "item_id": rng.choice(X["item_id"].unique(), 300)})
    Q.loc[:4, "user_id"] = 10**9  # unknown users: the global mean
    for bound in (True, False):
        np.testing.assert_allclose(got.predict(Q, bound_ratings=bound),
                                   want.predict(Q, bound_ratings=bound),
                                   atol=1e-5)
    assert got.predictions_possible == want.predictions_possible
    assert got.predict(Q.iloc[:0]) == []
    recs = got.recommend(user=X["user_id"].iloc[0], amount=5)
    assert len(recs) == 5
    pd.testing.assert_frame_equal(
        recs, want.recommend(user=X["user_id"].iloc[0], amount=5),
        check_exact=False, atol=1e-5)


def test_device_predict_matches_reference_formula():
    """The CSR binary search reproduces pred = mean_e + sum(sim * (r -
    mean_n)) / sum(|sim|) over the (neighbour list, rated) intersection,
    replayed in float64 on the fitted lists."""
    rng = np.random.default_rng(0)
    X, y = _pairs(rng, 60, 45, 900)
    m = cf.TopKItemItemCF(n_neighbors=8, min_rating=0.5, max_rating=5.0,
                          device="cpu").fit(X, y)
    qu = rng.integers(-1, 60, 300).astype(np.int32)
    qi = rng.integers(-1, 45, 300).astype(np.int32)
    got, poss = m._predict_arrays(qu, qi, bound_ratings=True)
    du = m.user_vocab.encode(X["user_id"].to_numpy())
    di = m.item_vocab.encode(X["item_id"].to_numpy())
    sims = m._neighbor_sims.numpy().astype(np.float64)
    ids = m._neighbor_ids.numpy()
    means = m._means.numpy().astype(np.float64)
    rated = {(int(a), int(b)): float(c) for a, b, c in zip(du, di, y)}
    want = np.empty(300)
    for p, (a, b) in enumerate(zip(qu, qi)):
        if a < 0 or b < 0:
            want[p] = m.global_mean
            continue
        num = den = 0.0
        for j, s in zip(ids[b], sims[b]):
            if (int(a), int(j)) in rated:
                num += s * (rated[(int(a), int(j))] - means[j])
                den += abs(s)
        want[p] = means[b] + num / max(den, 1e-12) if den > 0 else means[b]
    np.testing.assert_allclose(got, np.clip(want, 0.5, 5.0), atol=1e-4)
    np.testing.assert_array_equal(poss, (qu >= 0) & (qi >= 0))


def test_chunked_predict_equals_one_chunk(monkeypatch):
    """Pairs past one chunk go through several chunks with equal results."""
    from matrix_factorization_tpu_torch.models import base

    rng = np.random.default_rng(4)
    X, y = _pairs(rng, 50, 40, 700)
    m = cf.TopKUserUserCF(n_neighbors=6, device="cpu").fit(X, y)
    qu = rng.integers(0, 50, 1000).astype(np.int32)
    qi = rng.integers(0, 40, 1000).astype(np.int32)
    whole = m._predict_arrays(qu, qi, True)
    monkeypatch.setattr(base, "_MAX_PREDICT_CHUNK", 96)
    parts = m._predict_arrays(qu, qi, True)
    np.testing.assert_array_equal(whole[0], parts[0])
    np.testing.assert_array_equal(whole[1], parts[1])


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, at one intra-op thread."""
    with launch.world_of_one():
        yield


@pytest.mark.parametrize("name,mode", CLASSES, ids=[c[0] for c in CLASSES])
def test_mesh_of_one_rank_fits_as_one_device(world_of_one, name, mode):
    """``mesh=`` is accepted and fits: on one rank the similarity fit is
    the mesh-free one, so the neighbour lists and the predictions are
    equal to the mesh-free model's."""
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    X, y = lowrank_ratings(n_users=50, n_items=40, density=0.4, seed=15)
    y = y.clip(lower=0.5)
    kw = dict(n_neighbors=8, user_block=16, item_tile=16, device="cpu")
    mesh = make_mesh(1)
    got = getattr(cf, name)(mesh=mesh, **kw).fit(X, y)
    want = getattr(cf, name)(**kw).fit(X, y)
    assert got.mesh is mesh
    np.testing.assert_array_equal(got._neighbor_sims.numpy(),
                                  want._neighbor_sims.numpy())
    np.testing.assert_array_equal(got._neighbor_ids.numpy(),
                                  want._neighbor_ids.numpy())
    np.testing.assert_array_equal(got.predict(X.iloc[:100]),
                                  want.predict(X.iloc[:100]))


def test_duplicates_raise():
    X = pd.DataFrame({"user_id": [1, 1], "item_id": [2, 2]})
    with pytest.raises(ValueError, match="Duplicate"):
        cf.TopKItemItemCF(device="cpu").fit(X, pd.Series([1.0, 2.0]))
