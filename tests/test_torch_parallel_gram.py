"""The gram models on a mesh: the PyTorch port's ``dp_item_gram``,
``ease_weights_sharded``, ``spd_inverse_ns_sharded``, ``EASE(mesh=)``,
``similarity_topk(mesh=)``, ``TopKItemItemCF`` / ``TopKUserUserCF(mesh=)``
and ``ItemItemCF`` / ``UserUserCF(mesh=)`` against the JAX package's.

One ``torch.distributed`` world of 4 gloo ranks on the CPU
(``parallel.launch.spawn_world``, once for the file) runs every case on a
4 x 1 and a 2 x 2 mesh; each rank returns numpy arrays. JAX runs the same
cases here on ``make_mesh`` of the same shapes over its 8 virtual CPU
devices, and the port's mesh-free calls run here too. The cases are JAX's
spec tests: ``tests/test_ease.py:262`` (the data-parallel gram), ``:278``
(the mesh fit), ``:298`` and ``:336`` (Newton-Schulz against Schur),
``:381`` (the item budget's tiers), ``tests/test_cf_topk.py:172, :198,
:217, :233`` (the sparse gram's top-k, the top-k models, the dense
models).

Bars: JAX's own. The gram equal (integer counts); EASE scores and ``B``
within 5e-4; similarities 1e-5, means 1e-6, neighbour ids equal wherever
the top two similarities are more than 1e-4 apart; CF predictions 1e-4.
Checkpoints cross between the packages both ways (``EASE``; the JAX
package's ``load_model`` knows no CF class, so the CF models have no
checkpoint in either package).
"""

import pickle
import tempfile

import numpy as np
import pandas as pd
import pytest

WORLD = 4
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
EASE_REG, NS_REG = 10.0, 25.0


def _toy(n_users, n_items, n, seed):
    """``tests/test_ease.py::_toy``: unique seeded pairs with string ids."""
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < n:
        pairs.add((int(rng.integers(n_users)), int(rng.integers(n_items))))
    u, i = np.array(sorted(pairs)).T
    X = pd.DataFrame({"user_id": [f"u{x}" for x in u],
                      "item_id": [f"i{x}" for x in i]})
    y = pd.Series(rng.uniform(0.5, 5.0, len(u)).astype(np.float32))
    return X, y


def _coo(rng, n_users, n_items, n):
    flat = rng.choice(n_users * n_items, size=n, replace=False)
    return ((flat // n_items).astype(np.int32), (flat % n_items).astype(np.int32),
            rng.uniform(1, 5, n).astype(np.float32))


def _frame(X, y):
    return {"X": {c: X[c].to_numpy() for c in X.columns}, "y": y.to_numpy()}


def _unframe(f):
    return pd.DataFrame(f["X"]), pd.Series(f["y"])


def _dense_ids(X):
    """Dense ids in first-seen order, as both packages' vocabularies give
    them."""
    return (pd.factorize(X["user_id"])[0].astype(np.int64),
            pd.factorize(X["item_id"])[0].astype(np.int64))


# ---------------------------------------------------------------------------
# What the ranks run (module level: the spawned ranks import this module)
# ---------------------------------------------------------------------------


def _rank_mesh(mesh, inp):
    """Every case on one mesh, on this rank."""
    import torch

    from matrix_factorization_tpu_torch import (
        EASE,
        ItemItemCF,
        TopKItemItemCF,
        TopKUserUserCF,
        UserUserCF,
    )
    from matrix_factorization_tpu_torch.ops import ease as ops
    from matrix_factorization_tpu_torch.ops import sparse_gram as sg
    from matrix_factorization_tpu_torch.ops import spd

    res = {}
    g = inp["gram"]
    res["gram"] = ops.dp_item_gram(g["u"], g["i"], g["w"], g["n_users"],
                                   g["n_items"], mesh, device="cpu").numpy()
    ns = inp["ns"]
    G = ops.dp_item_gram(ns["u"], ns["i"], ns["w"], ns["n_users"], ns["n_items"],
                         mesh, device="cpu")
    lay = spd.ns_layout(G.shape[0], mesh)
    res["rows"] = (lay.lo, lay.hi)
    res["B_schur"] = ops.ease_weights_sharded(G, NS_REG, mesh,
                                              inverse="schur").numpy()
    res["B_ns"] = ops.ease_weights_sharded(G.clone(), NS_REG, mesh,
                                           inverse="ns").numpy()
    try:
        ops.ease_weights_sharded(G, NS_REG, mesh, inverse="bogus")
    except ValueError as e:
        res["bogus"] = str(e)
    info = {}
    A = torch.from_numpy(inp["A_small"])
    res["ns_small"] = spd.spd_inverse_ns_sharded(A, mesh, col_block=64,
                                                 info=info).numpy()
    res["ns_small_info"] = info

    X, y = _unframe(inp["ease"])
    m = EASE(reg=EASE_REG, mesh=mesh, device="cpu").fit(X, y)
    res["ease"] = {
        "scores": m._catalog_scores_batch(np.arange(16)),
        "recs": m.recommend(user=X["user_id"].iloc[0], amount=5),
        "B_whole": m._whole_params().item_weights.numpy(),
        "B_rows": tuple(m._params.item_weights.shape),
        "sharding": m._sharding,
        "predict": np.asarray(m.predict(X.iloc[:60])),
    }
    back = pickle.loads(pickle.dumps(m))  # ranks return numpy, never tensors
    res["ease"]["pickled"] = (back.mesh, back._sharding,
                              back._params.item_weights.numpy())
    # one item past the data ranks' tier: the fit raises before any gram
    from matrix_factorization_tpu_torch.parallel.mesh import data_size_of

    limit = ops.item_limit(data_size_of(mesh))
    Xb = pd.DataFrame({"user_id": np.zeros(limit + 1, np.int64),
                       "item_id": np.arange(limit + 1)})
    try:
        EASE(mesh=mesh, device="cpu").fit(Xb, pd.Series(np.ones(limit + 1)))
        res["budget"] = (limit, "fitted")
    except ValueError as e:
        res["budget"] = (limit, str(e))

    c = inp["sim_item"]
    res["sim_item"] = sg.similarity_topk(c["u"], c["i"], c["r"], 130, 70, k=6,
                                         user_block=16, item_tile=16,
                                         mesh=mesh, device="cpu")
    c = inp["sim_user"]
    res["sim_user"] = sg.similarity_topk(c["i"], c["u"], c["r"], 50, 90, k=5,
                                         user_block=16, item_tile=16,
                                         mesh=mesh, device="cpu")
    X, y = _unframe(inp["topk"])
    for cls in (TopKItemItemCF, TopKUserUserCF):
        m = cls(n_neighbors=10, user_block=32, item_tile=32, mesh=mesh,
                device="cpu").fit(X, y)
        res[cls.__name__] = np.asarray(m.predict(X.iloc[:300]))
    X, y = _unframe(inp["dense"])
    for cls in (ItemItemCF, UserUserCF):
        m = cls(n_neighbors=10, mesh=mesh, device="cpu").fit(X, y)
        whole = (m.item_similarity_matrix if cls is ItemItemCF
                 else m.user_similarity_matrix)
        res[cls.__name__] = {"predict": np.asarray(m.predict(X.iloc[:200])),
                             "sim_rows": tuple(m._state.sim.shape),
                             "sim": whole,
                             "pickled_sim": pickle.loads(pickle.dumps(m))._state.sim.numpy()}
    return res


def _rank_cases(rank, world, inp):
    import torch

    from matrix_factorization_tpu_torch import EASE, save_model
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    out = {tag: _rank_mesh(make_mesh(*shape), inp)
           for tag, shape in MESHES.items()}
    # a mesh fit checkpoints its whole B: every rank calls save_model (the
    # gather is a collective), rank 0 writes
    X, y = _unframe(inp["ease"])
    m = EASE(reg=EASE_REG, mesh=make_mesh(4, 1), device="cpu").fit(X, y)
    save_model(m, f"{inp['ckpt']}/port_ease")
    torch.distributed.barrier()
    out["ckpt"] = {"predict": np.asarray(m.predict(X.iloc[:60])),
                   "recs": m.recommend(user=X["user_id"].iloc[3], amount=5)}
    return out


# ---------------------------------------------------------------------------
# The inputs, JAX's results and the port's mesh-free results
# ---------------------------------------------------------------------------


def _inputs(ckpt):
    inp = {"ckpt": ckpt}
    X, y = _toy(60, 40, 800, seed=12)  # tests/test_ease.py:262
    u, i = _dense_ids(X)
    inp["gram"] = {"u": u, "i": i, "w": np.ones(len(u), np.float32),
                   "n_users": int(u.max()) + 1, "n_items": int(i.max()) + 1}
    rng = np.random.default_rng(3)  # :298
    inp["ns"] = {"u": rng.integers(0, 200, 3000).astype(np.int64),
                 "i": rng.integers(0, 96, 3000).astype(np.int64),
                 "w": np.ones(3000, np.float32), "n_users": 200, "n_items": 96}
    M = np.random.default_rng(0).normal(0, 1, (64, 256)).astype(np.float32)
    inp["A_small"] = M.T @ M + 10.0 * np.eye(256, dtype=np.float32)  # :336
    inp["ease"] = _frame(*_toy(80, 96, 1200, seed=13))  # :278
    rng = np.random.default_rng(7)
    u, i, r = _coo(rng, 130, 70, 2000)  # tests/test_cf_topk.py:172
    inp["sim_item"] = {"u": u, "i": i, "r": r}
    u, i, r = _coo(rng, 90, 50, 1200)  # :198
    inp["sim_user"] = {"u": u, "i": i, "r": r}
    from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings

    X, y = lowrank_ratings(n_users=80, n_items=60, density=0.4, seed=14)  # :217
    inp["topk"] = _frame(X, y.clip(lower=0.5))
    X, y = lowrank_ratings(n_users=64, n_items=48, density=0.4, seed=3)  # :233
    inp["dense"] = _frame(X, y.clip(lower=0.5))
    return inp


def _jax_results(inp):
    """JAX's mesh results for every case, on ``make_mesh`` of each shape."""
    import jax.numpy as jnp

    from matrix_factorization_tpu.core import checkpoint as jckpt
    from matrix_factorization_tpu.models.cf_topk import (
        TopKItemItemCF as JTopKItem,
        TopKUserUserCF as JTopKUser,
    )
    from matrix_factorization_tpu.models.collaborative import (
        ItemItemCF as JItem,
        UserUserCF as JUser,
    )
    from matrix_factorization_tpu.models.ease import EASE as JEASE
    from matrix_factorization_tpu.ops import ease as jops
    from matrix_factorization_tpu.ops.sparse_gram import similarity_topk as jsim
    from matrix_factorization_tpu.ops.spd import spd_inverse_ns_sharded as jns
    from matrix_factorization_tpu.parallel.mesh import make_mesh as jmesh

    ref = {}
    for tag, shape in MESHES.items():
        mesh = jmesh(*shape)
        res = ref[tag] = {}
        g = inp["gram"]
        res["gram"] = np.asarray(jops.dp_item_gram(
            g["u"], g["i"], g["w"], g["n_users"], g["n_items"], mesh))
        ns = inp["ns"]
        G = jops.dp_item_gram(ns["u"], ns["i"], ns["w"], ns["n_users"],
                              ns["n_items"], mesh)
        for inv in ("schur", "ns"):
            res[f"B_{inv}"] = np.asarray(jops.ease_weights_sharded(
                G, NS_REG, mesh, inverse=inv))
        res["ns_small"] = np.asarray(jns(jnp.asarray(inp["A_small"]), mesh,
                                         col_block=64))
        X, y = _unframe(inp["ease"])
        m = JEASE(reg=EASE_REG, mesh=mesh).fit(X, y)
        res["ease"] = {"scores": m._catalog_scores_batch(np.arange(16)),
                       "predict": np.asarray(m.predict(X.iloc[:60]))}
        if tag == "4x1":
            jckpt.save_model(m, f"{inp['ckpt']}/jax_ease")
            res["ease"]["recs"] = m.recommend(user=X["user_id"].iloc[3], amount=5)
        c = inp["sim_item"]
        res["sim_item"] = jsim(c["u"], c["i"], c["r"], 130, 70, k=6,
                               user_block=16, item_tile=16, mesh=mesh)
        c = inp["sim_user"]
        res["sim_user"] = jsim(c["i"], c["u"], c["r"], 50, 90, k=5,
                               user_block=16, item_tile=16, mesh=mesh)
        X, y = _unframe(inp["topk"])
        for name, cls in (("TopKItemItemCF", JTopKItem), ("TopKUserUserCF", JTopKUser)):
            jm = cls(n_neighbors=10, user_block=32, item_tile=32, mesh=mesh)
            res[name] = np.asarray(jm.fit(X, y).predict(X.iloc[:300]))
        X, y = _unframe(inp["dense"])
        for name, cls in (("ItemItemCF", JItem), ("UserUserCF", JUser)):
            res[name] = np.asarray(cls(n_neighbors=10, mesh=mesh).fit(X, y)
                                   .predict(X.iloc[:200]))
    return ref


def _free_results(inp):
    """The port's mesh-free calls on the same inputs."""
    from matrix_factorization_tpu_torch import (
        EASE,
        ItemItemCF,
        TopKItemItemCF,
        TopKUserUserCF,
        UserUserCF,
    )
    from matrix_factorization_tpu_torch.ops import ease as ops
    from matrix_factorization_tpu_torch.ops import sparse_gram as sg

    free = {}
    g = inp["gram"]
    free["gram"] = ops.item_gram(g["u"], g["i"], g["w"], g["n_users"],
                                 g["n_items"], device="cpu").numpy()
    X, y = _unframe(inp["ease"])
    m = EASE(reg=EASE_REG, device="cpu").fit(X, y)
    free["ease"] = {"scores": m._catalog_scores_batch(np.arange(16)),
                    "predict": np.asarray(m.predict(X.iloc[:60])),
                    "B": m._params.item_weights.numpy()}
    c = inp["sim_item"]
    free["sim_item"] = sg.similarity_topk(c["u"], c["i"], c["r"], 130, 70, k=6,
                                          user_block=16, item_tile=16, device="cpu")
    c = inp["sim_user"]
    free["sim_user"] = sg.similarity_topk(c["i"], c["u"], c["r"], 50, 90, k=5,
                                          user_block=16, item_tile=16, device="cpu")
    X, y = _unframe(inp["topk"])
    for cls in (TopKItemItemCF, TopKUserUserCF):
        free[cls.__name__] = np.asarray(cls(
            n_neighbors=10, user_block=32, item_tile=32, device="cpu")
            .fit(X, y).predict(X.iloc[:300]))
    X, y = _unframe(inp["dense"])
    for cls in (ItemItemCF, UserUserCF):
        m = cls(n_neighbors=10, device="cpu").fit(X, y)
        free[cls.__name__] = {"predict": np.asarray(m.predict(X.iloc[:200])),
                              "sim": m._state.sim.numpy()}
    return free


@pytest.fixture(scope="module")
def cases():
    """The inputs, JAX's results, the ranks' results and the port's
    mesh-free results, and what crossed in the checkpoints. The world runs
    in a thread while JAX computes here."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from matrix_factorization_tpu.core import checkpoint as jckpt
    from matrix_factorization_tpu_torch import load_model
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            inp = _inputs(ckpt)
            with ThreadPoolExecutor(1) as pool:
                world = pool.submit(spawn_world, _rank_cases, WORLD,
                                    device="cpu", args=(inp,), timeout=600)
                ref = _jax_results(inp)
                free = _free_results(inp)
                ranks = world.result()
            X, _ = _unframe(inp["ease"])
            crossed = {
                "port_to_jax": jckpt.load_model(f"{ckpt}/port_ease"),
                "jax_to_port": load_model(f"{ckpt}/jax_ease", device="cpu")}
            crossed = {k: {"predict": np.asarray(m.predict(X.iloc[:60])),
                           "recs": m.recommend(user=X["user_id"].iloc[3], amount=5),
                           "mesh": m.mesh}
                       for k, m in crossed.items()}
    finally:
        torch.set_num_threads(n_threads)
    return inp, ref, ranks, free, crossed


def _whole_rows(ranks, tag, key):
    """The ranks' row shards stacked in rank order (on a 2 x 2 mesh the
    model-axis replicas hold the same rows: take model index 0)."""
    n_model = MESHES[tag][1]
    return np.concatenate([rk[tag][key] for rk in ranks[::n_model]], axis=0)


# ---------------------------------------------------------------------------
# EASE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(MESHES))
def test_dp_gram_equals_jax_and_the_single_device_gram(cases, tag):
    """``tests/test_ease.py:262``: co-occurrence counts are integers, so the
    all-reduced gram over the data group is equal to JAX's dp gram and to
    the mesh-free ``item_gram``, replicated on every rank (a world-wide
    reduce would count each user once per model rank on the 2 x 2 mesh)."""
    _, ref, ranks, free, _ = cases
    for rk in ranks:
        np.testing.assert_array_equal(rk[tag]["gram"], ref[tag]["gram"])
        np.testing.assert_array_equal(rk[tag]["gram"], free["gram"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_newton_schulz_matches_schur_and_jax(cases, tag):
    """``tests/test_ease.py:298``: the row-sharded Newton-Schulz ``B``
    within 5e-4 of the Schur ``B``, an exactly zero diagonal, both within
    5e-4 of JAX's; each rank holds its rows; an unknown ``inverse`` raises
    naming it."""
    _, ref, ranks, _, _ = cases
    B_ns = _whole_rows(ranks, tag, "B_ns")
    B_schur = _whole_rows(ranks, tag, "B_schur")
    assert B_ns.shape == B_schur.shape == (96, 96)
    np.testing.assert_allclose(B_ns, B_schur, atol=5e-4)
    assert np.abs(np.diagonal(B_ns)).max() == 0.0
    np.testing.assert_allclose(B_ns, ref[tag]["B_ns"], atol=5e-4)
    np.testing.assert_allclose(B_schur, ref[tag]["B_schur"], atol=5e-4)
    n_data = MESHES[tag][0]
    for r, rk in enumerate(ranks):
        lo = (r // MESHES[tag][1]) * 96 // n_data
        assert rk[tag]["rows"] == (lo, lo + 96 // n_data)
        assert "inverse" in rk[tag]["bogus"]


@pytest.mark.parametrize("tag", list(MESHES))
def test_sharded_newton_schulz_inverse(cases, tag):
    """``tests/test_ease.py:336-346``: the row-sharded inverse of a 256 x
    256 SPD system in 64-column slabs, ``|P A - I|`` below 1e-3, within
    1e-5 of JAX's; every rank stopped at the same step."""
    inp, ref, ranks, _, _ = cases
    P = _whole_rows(ranks, tag, "ns_small")
    A = inp["A_small"].astype(np.float64)
    assert np.abs(P @ A - np.eye(256)).max() < 1e-3
    np.testing.assert_allclose(P, ref[tag]["ns_small"], atol=1e-5)
    steps = {rk[tag]["ns_small_info"]["steps"] for rk in ranks}
    assert len(steps) == 1 and 1 < steps.pop() < 100


@pytest.mark.parametrize("tag", list(MESHES))
def test_mesh_fit_matches_single_device_and_jax(cases, tag):
    """``tests/test_ease.py:278``: ``EASE(mesh=)`` scores the catalog
    within 5e-4 of the single-device fit and of JAX's mesh fit, predicts
    and recommends on every rank alike; ``B`` stays row-sharded (a
    quarter or half of the rows a rank) and gathers whole and finite."""
    _, ref, ranks, free, _ = cases
    n_data = MESHES[tag][0]
    for rk in ranks:
        got = rk[tag]["ease"]
        np.testing.assert_allclose(got["scores"], free["ease"]["scores"], atol=5e-4)
        np.testing.assert_allclose(got["scores"], ref[tag]["ease"]["scores"],
                                   atol=5e-4)
        np.testing.assert_allclose(got["predict"], ref[tag]["ease"]["predict"],
                                   atol=5e-4)
        np.testing.assert_allclose(got["B_whole"], free["ease"]["B"], atol=5e-4)
        assert np.isfinite(got["B_whole"]).all()
        assert got["sharding"] == "rows" and got["B_rows"] == (96 // n_data, 96)
        assert len(got["recs"]) == 5
        assert got["recs"].equals(ranks[0][tag]["ease"]["recs"])
        # a pickle holds the whole B, on the host, without the mesh
        mesh, sharding, B = got["pickled"]
        assert mesh is None and sharding is None
        np.testing.assert_array_equal(B, got["B_whole"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_item_budget_tiers(cases, tag):
    """``tests/test_ease.py:381``: the budget takes the data ranks' tier:
    16,384 items on 1 or 2 data ranks, 32,768 on 4, 65,536 on 8; a fit
    above it raises before building a gram."""
    from matrix_factorization_tpu_torch.ops import ease as ops

    _, _, ranks, _, _ = cases
    for rk in ranks:
        limit, msg = rk[tag]["budget"]
        assert limit == {4: 32768, 2: 16384}[MESHES[tag][0]]
        assert f"budget here is {limit} items" in msg
    ops.check_item_budget(limit, item_limit=limit)
    assert [ops.item_limit(n) for n in (1, 2, 3, 4, 7, 8, 16)] == \
        [16384, 16384, 16384, 32768, 32768, 65536, 65536]
    with pytest.raises(ValueError, match="O\\(items"):
        ops.check_item_budget(65536, item_limit=ops.item_limit(4))
    ops.check_item_budget(65536, item_limit=ops.item_limit(8))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_mesh_checkpoints_cross_packages(cases, direction):
    """A mesh-fitted EASE checkpoints its whole ``B``: the port's
    ``save_model`` (the ranks gather, rank 0 writes) loads in the JAX
    package without a mesh, and JAX's mesh checkpoint in the port; the
    loaded model predicts and recommends within 1e-4 of the fit that
    wrote it."""
    _, ref, ranks, _, crossed = cases
    got = crossed[direction]
    want = (ranks[0]["ckpt"] if direction == "port_to_jax"
            else {**ref["4x1"]["ease"], "recs": ref["4x1"]["ease"]["recs"]})
    assert got["mesh"] is None
    np.testing.assert_allclose(got["predict"], want["predict"], atol=1e-4)
    assert got["recs"]["item_id"].tolist() == want["recs"]["item_id"].tolist()
    np.testing.assert_allclose(got["recs"]["rating_pred"].to_numpy(),
                               want["recs"]["rating_pred"].to_numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# The sparse gram's top-k and the CF models
# ---------------------------------------------------------------------------


def _hold_sims(got, want):
    """``tests/test_cf_topk.py:172-193``: sims 1e-5, means 1e-6, ids equal
    wherever the top two similarities are more than 1e-4 apart."""
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    top = np.sort(want[0], axis=1)
    gap = np.abs(top[:, -1] - top[:, -2])
    agree = (got[1] == want[1]).all(axis=1)
    assert agree[gap > 1e-4].all()


@pytest.mark.parametrize("case", ["sim_item", "sim_user"])
@pytest.mark.parametrize("tag", list(MESHES))
def test_similarity_topk_mesh_matches_jax_and_single_device(cases, tag, case):
    """``tests/test_cf_topk.py:172, :198``: the blocks split over every rank
    of the mesh (so the 2 x 2 mesh needs no case of its own), one
    all-reduce a strip; item-item and the swapped user-user call against
    the mesh-free call and JAX's mesh call; every rank holds the same
    lists."""
    _, ref, ranks, free, _ = cases
    got = ranks[0][tag][case]
    _hold_sims(got, free[case])
    _hold_sims(got, ref[tag][case])
    for rk in ranks:
        for a, b in zip(rk[tag][case], got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls", ["TopKItemItemCF", "TopKUserUserCF"])
@pytest.mark.parametrize("tag", list(MESHES))
def test_topk_cf_models_on_the_mesh(cases, tag, cls):
    """``tests/test_cf_topk.py:217``: the top-k models with a mesh predict
    within 1e-4 of the mesh-free model and of JAX's mesh model."""
    _, ref, ranks, free, _ = cases
    for rk in ranks:
        np.testing.assert_allclose(rk[tag][cls], free[cls], atol=1e-4)
        np.testing.assert_allclose(rk[tag][cls], ref[tag][cls], atol=1e-4)


@pytest.mark.parametrize("cls", ["ItemItemCF", "UserUserCF"])
@pytest.mark.parametrize("tag", list(MESHES))
def test_dense_cf_models_on_the_mesh(cases, tag, cls):
    """``tests/test_cf_topk.py:233``: the similarity matrix row-sharded over
    every rank (``ceil(E / 4)`` rows each, the last rank the rest), the
    predictions within 1e-4 of the mesh-free model and of JAX's mesh
    model on every rank; the gathered matrix equal to the mesh-free one
    (every product of ``cosine_rows`` has one shape, so a row's bits do
    not depend on the rank that computes it)."""
    _, ref, ranks, free, _ = cases
    E = free[cls]["sim"].shape[0]
    rows = [rk[tag][cls]["sim_rows"] for rk in ranks]
    per = -(-E // WORLD)
    assert [r[0] for r in rows] == [min(per, E - k * per) for k in range(WORLD)]
    assert all(r[1] == E for r in rows)
    for rk in ranks:
        got = rk[tag][cls]
        np.testing.assert_allclose(got["predict"], free[cls]["predict"], atol=1e-4)
        np.testing.assert_allclose(got["predict"], ref[tag][cls], atol=1e-4)
        np.testing.assert_array_equal(got["sim"], free[cls]["sim"])
        np.testing.assert_array_equal(got["pickled_sim"], got["sim"])
