"""Retrieval, the hybrid evaluation and sharded checkpoints on a mesh: the
PyTorch port's ``dense_topk_mesh``, ``search_topk_batch`` /
``search_topk_pos(mesh=)``, ``tfidf_csr_topk``, ``tfidf_batch_topk(mesh=)``,
``evaluate_hybrid(mesh=)`` and ``save_model_sharded`` /
``load_model_sharded`` against the JAX package's.

One ``torch.distributed`` world of 4 gloo ranks on the CPU
(``parallel.launch.spawn_world``, once for the file) runs every case on a
4 x 1 and a 2 x 2 mesh; each rank returns numpy arrays. JAX runs the same
cases here on ``make_mesh`` of the same shapes over its 8 virtual CPU
devices, and the port's mesh-free calls run here too. The cases are JAX's
spec tests: ``tests/test_retrieval_rank.py:253`` (TF-IDF, 5 items: ranks 1
to 3 hold none) and ``:281`` (dense, 37 items: 16 rows a rank, rank 3
holds none), ``tests/test_eval.py:110`` and ``:132`` (the hybrid
evaluation, 30 items: rank 3 holds 6), and ``tests/test_serve_checkpoint.py
:401`` and ``:440`` (JAX's orbax pair; the port writes a
``torch.distributed.checkpoint`` tree, which the JAX package cannot read,
so the trees do not cross: ``save_model`` of a sharded fit does).

Bars: JAX's own. Top-k values within 1e-5, positions equal wherever the
gap to the next value is at least 1e-6; hybrid metrics within 0.05 (the
TF-IDF profiles' host path orders zero ties by numpy's ``argsort``, the
mesh path by ``stable_topk``); restored shards equal, ``predict`` 1e-6. On
a world of one rank every mesh path is its mesh-free call, bit for bit.
"""

import tempfile

import numpy as np
import pandas as pd
import pytest

WORLD = 4
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
TEXTS = [  # tests/test_retrieval_rank.py:36
    "title: grilled chicken salad\ningredients: chicken breast; lettuce; olive oil\ndirections: grill chicken 10-15 minutes and toss",
    "title: peanut butter cookies\ningredients: peanut butter; sugar; flour; eggs\ndirections: bake 12 minutes",
    "title: creamy salmon pasta\ningredients: salmon; cream; pasta; cheese\ndirections: cook pasta 1 hour",
    "title: tofu stir fry\ningredients: tofu; soy sauce; broccoli\ndirections: fry tofu 5 minutes",
    "title: walnut brownies\ningredients: walnut; chocolate; butter; sugar\ndirections: bake 30 minutes",
]
IDS = ["a", "b", "c", "d", "e"]
QUERIES = ["grilled chicken salad", "peanut butter", "tofu broccoli"]
DENSE_Q = ("protein p3 veg v1", "method m2", "recipe 11")
HYBRID = dict(alpha=0.0, k=5, candidate_k=20, positive_threshold=3.0, n_test=2)
CKPT_KW = dict(n_factors=8, n_epochs=8, lr=0.05, reg=0.01, batch_size=64, seed=0)


def _dense_corpus():
    """``tests/test_retrieval_rank.py:281``: 37 recipes, ``hash_embed`` at
    dim 64, and three encoded queries."""
    from matrix_factorization_tpu_torch.retrieval.encode import hash_embed

    ids = [f"d{i}" for i in range(37)]
    texts = [f"recipe {i} protein p{i % 7} veg v{i % 5} method m{i % 3}"
             for i in range(37)]
    return ids, texts, hash_embed(texts, dim=64), hash_embed(list(DENSE_Q), dim=64)


def _hybrid_items(df):
    """``tests/test_eval.py:110``: the rated items' texts."""
    items = sorted(df["item_id"].unique())
    return [str(i) for i in items], [
        f"item text number {i} with words w{i} w{i % 5}" for i in items]


def _indexes(inp):
    """The port's indexes of the inputs (built in each process alike)."""
    from matrix_factorization_tpu_torch.retrieval import index as rindex

    ids, texts, emb, _ = inp["dense"]
    hids, htexts, hemb = inp["hybrid_items"]
    return {"dense": rindex.build_dense_index(ids, texts, emb),
            "tfidf": rindex.build_tfidf_index(IDS, TEXTS, min_df=1),
            "hybrid_dense": rindex.build_dense_index(hids, htexts, hemb),
            "hybrid_tfidf": rindex.build_tfidf_index(hids, htexts, min_df=1)}


def _paths(idx, mesh, inp, device="cpu"):
    """Every retrieval and evaluation path of the slice on ``idx`` (the
    port's indexes), with ``mesh`` or without."""
    from matrix_factorization_tpu_torch.eval.hybrid_eval import evaluate_hybrid
    from matrix_factorization_tpu_torch.retrieval import search, sparse_scoring

    q = inp["dense"][3]
    tix = idx["tfidf"]
    Qs = tix.vectorizer.transform(QUERIES)
    res = {
        "dense_batch": search.search_topk_batch(idx["dense"], q, 5, mesh=mesh,
                                                device=device),
        "dense_all": search.search_topk_batch(idx["dense"], q, 50, mesh=mesh,
                                              device=device),
        "dense_pos": search.search_topk_pos(idx["dense"], q[0], 5, mesh=mesh,
                                            device=device),
        "tfidf_batch": sparse_scoring.tfidf_batch_topk(
            tix, QUERIES, 3, vocab_block=8, mesh=mesh, device=device),
        "tfidf_pos": search.search_topk_pos(tix, Qs[0], 3, mesh=mesh,
                                            device=device),
    }
    if mesh is not None:
        res["dense_mesh"] = search.dense_topk_mesh(idx["dense"], q, 5, mesh,
                                                   device=device)
        res["tfidf_csr"] = sparse_scoring.tfidf_csr_topk(
            tix, Qs, 3, mesh, vocab_block=8, device=device)
    df = inp["ratings"]
    for name in ("hybrid_dense", "hybrid_tfidf"):
        r = evaluate_hybrid(df, idx[name], model=None, mesh=mesh, device=device,
                            **HYBRID)
        res[name] = (r.precision, r.recall, r.ndcg, r.n_users)
    return res


# ---------------------------------------------------------------------------
# What the ranks run (module level: the spawned ranks import this module)
# ---------------------------------------------------------------------------


def _rank_checkpoint(mesh, tag, inp):
    """A ``keep_sharded`` KernelMF fit on ``mesh``, written by
    ``save_model_sharded`` and read back onto the mesh and without one."""
    import torch

    from matrix_factorization_tpu_torch import (
        KernelMF,
        load_model_sharded,
        save_model,
        save_model_sharded,
    )
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    X, y = pd.DataFrame(inp["ckpt_X"]), pd.Series(inp["ckpt_y"])
    m = KernelMF(mesh=mesh, keep_sharded=True, device="cpu", **CKPT_KW).fit(X, y)
    path = f"{inp['dir']}/sharded_{tag}"
    save_model_sharded(m, path)
    m2 = load_model_sharded(path, mesh=mesh, device="cpu")
    uid = X["user_id"].iloc[0]
    out = {
        "saved": [t.numpy().copy() for t in m._params[:2]],
        "restored": [t.numpy().copy() for t in m2._params[:2]],
        "state": (m2._sharding, m2.keep_sharded, m2.mesh is mesh,
                  m2._topk_catalog is not None),
        "recs": (m.recommend(user=uid, amount=5), m2.recommend(user=uid, amount=5)),
        "predict": (np.asarray(m.predict(X.iloc[:50])),
                    np.asarray(m2.predict(X.iloc[:50]))),
    }
    whole = m._whole_params()
    m3 = load_model_sharded(path, device="cpu")
    out["whole"] = [t.numpy() for t in whole[:2]]
    out["meshless"] = ([t.numpy() for t in m3._params[:2]], m3.keep_sharded,
                       m3.mesh, m3._sharding)
    other = make_mesh(2, 2) if tag == "4x1" else make_mesh(4, 1)
    try:
        load_model_sharded(path, mesh=other, device="cpu")
        out["other_mesh"] = "loaded"
    except ValueError as e:
        out["other_mesh"] = str(e)
    if tag == "2x2":  # the shared layout: save_model gathers, rank 0 writes
        save_model(m, f"{inp['dir']}/gathered")
        torch.distributed.barrier()
        out["gathered"] = {"predict": out["predict"][0], "recs": out["recs"][0]}
    return out


def _rank_cases(rank, world, inp):
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    idx = _indexes(inp)
    out = {}
    for tag, shape in MESHES.items():
        mesh = make_mesh(*shape)
        out[tag] = _paths(idx, mesh, inp)
        out[tag]["ckpt"] = _rank_checkpoint(mesh, tag, inp)
    return out


# ---------------------------------------------------------------------------
# The inputs, JAX's results and the port's mesh-free results
# ---------------------------------------------------------------------------


def _inputs(tmp):
    from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings
    from matrix_factorization_tpu_torch.retrieval.encode import hash_embed

    X, y = lowrank_ratings(n_users=40, n_items=30, density=0.5, seed=8)
    df = X.copy()
    df["rating"] = y.clip(lower=0.5)
    hids, htexts = _hybrid_items(df)
    Xc, yc = lowrank_ratings(n_users=64, n_items=48, density=0.5, seed=9)
    return {"dir": tmp, "dense": _dense_corpus(), "ratings": df,
            "hybrid_items": (hids, htexts, hash_embed(htexts)),
            "ckpt_X": {c: Xc[c].to_numpy() for c in Xc.columns},
            "ckpt_y": yc.to_numpy()}


def _jax_results(inp):
    """JAX's results of every case on ``make_mesh`` of each shape."""
    from matrix_factorization_tpu.eval.hybrid_eval import evaluate_hybrid
    from matrix_factorization_tpu.parallel.mesh import make_mesh
    from matrix_factorization_tpu.retrieval import index as jindex
    from matrix_factorization_tpu.retrieval import search as jsearch
    from matrix_factorization_tpu.retrieval import sparse_scoring as jsparse

    ids, texts, emb, q = inp["dense"]
    hids, htexts, hemb = inp["hybrid_items"]
    dix = jindex.build_dense_index(ids, texts, emb)
    tix = jindex.build_tfidf_index(IDS, TEXTS, min_df=1)
    hybrid = {"hybrid_dense": jindex.build_dense_index(hids, htexts, hemb),
              "hybrid_tfidf": jindex.build_tfidf_index(hids, htexts, min_df=1)}
    Qs = tix.vectorizer.transform(QUERIES)
    ref = {}
    for tag, shape in MESHES.items():
        mesh = make_mesh(*shape)
        res = ref[tag] = {
            "dense_mesh": jsearch.dense_topk_mesh(dix, q, 5, mesh),
            "dense_pos": jsearch.search_topk_pos(dix, q[0], 5, mesh=mesh),
            "tfidf_batch": jsparse.tfidf_batch_topk(tix, QUERIES, 3,
                                                    vocab_block=8, mesh=mesh),
            "tfidf_csr": jsparse.tfidf_csr_topk(tix, Qs, 3, mesh, vocab_block=8),
            "tfidf_pos": jsearch.search_topk_pos(tix, Qs[0], 3, mesh=mesh),
        }
        for name, index in hybrid.items():
            r = evaluate_hybrid(inp["ratings"], index, model=None, mesh=mesh,
                                **HYBRID)
            res[name] = (r.precision, r.recall, r.ndcg, r.n_users)
    return ref


@pytest.fixture(scope="module")
def cases():
    """The inputs, JAX's results, the ranks' results, the port's mesh-free
    results, and the gathered checkpoint loaded by the JAX package. The
    world runs in a thread while JAX computes here."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from matrix_factorization_tpu.core import checkpoint as jckpt
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            inp = _inputs(tmp)
            with ThreadPoolExecutor(1) as pool:
                world = pool.submit(spawn_world, _rank_cases, WORLD,
                                    device="cpu", args=(inp,), timeout=600)
                ref = _jax_results(inp)
                free = _paths(_indexes(inp), None, inp)
                ranks = world.result()
            jm = jckpt.load_model(f"{tmp}/gathered")
            X = pd.DataFrame(inp["ckpt_X"])
            crossed = {"predict": np.asarray(jm.predict(X.iloc[:50])),
                       "recs": jm.recommend(user=X["user_id"].iloc[0], amount=5)}
    finally:
        torch.set_num_threads(n_threads)
    return inp, ref, ranks, free, crossed


def _hold_topk(got, want, n=None):
    """JAX's bars: values within 1e-5, positions equal wherever the value
    is at least 1e-6 above the next one (and below the one before: ties
    order by position in the port, arbitrarily in JAX)."""
    vals, pos = (np.asarray(a) for a in got)
    wv, wp = (np.asarray(a) for a in want)
    assert vals.shape == wv.shape and pos.shape == wp.shape
    np.testing.assert_allclose(vals, wv, atol=1e-5)
    gap = wv[:, :-1] - wv[:, 1:]
    edge = np.ones((len(wv), 1), bool)
    tied = np.concatenate([gap < 1e-6, edge], 1) | np.concatenate([edge, gap < 1e-6], 1)
    assert (pos == wp)[~tied].all()
    if n is not None:
        assert pos.max() < n  # no padding row reaches the result


def _rows_topk(rows):
    """``search_topk_pos``'s rows as (1, k) (values, positions)."""
    return (np.asarray([[r[2] for r in rows]], np.float32),
            np.asarray([[r[0] for r in rows]]))


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(MESHES))
def test_dense_mesh_topk_matches_jax_and_single_device(cases, tag):
    """37 items, 16 rows a rank: rank 2 holds 5 real rows and 11 padding
    rows, rank 3 none; every rank returns the same top-k."""
    _, ref, ranks, free, _ = cases
    for rk in ranks:
        got = rk[tag]
        for a, b in zip(got["dense_mesh"], ranks[0][tag]["dense_mesh"]):
            np.testing.assert_array_equal(a, b)
        _hold_topk(got["dense_mesh"], ref[tag]["dense_mesh"], n=37)
        _hold_topk(got["dense_mesh"], free["dense_batch"], n=37)
        _hold_topk(got["dense_batch"], free["dense_batch"], n=37)
        # k past the catalog is cut to it: every item once
        assert got["dense_all"][1].shape == (3, 37)
        assert (np.sort(got["dense_all"][1], axis=1) == np.arange(37)).all()
        _hold_topk(got["dense_all"], free["dense_all"], n=37)
        _hold_topk(_rows_topk(got["dense_pos"]), _rows_topk(ref[tag]["dense_pos"]))
        assert [r[1] for r in got["dense_pos"]] == [r[1] for r in free["dense_pos"]]


@pytest.mark.parametrize("tag", list(MESHES))
def test_tfidf_mesh_topk_matches_jax_and_single_device(cases, tag):
    """5 items, 8 rows a rank: rank 0 holds them all, ranks 1 to 3 none."""
    _, ref, ranks, free, _ = cases
    for rk in ranks:
        got = rk[tag]
        _hold_topk(got["tfidf_batch"], ref[tag]["tfidf_batch"], n=5)
        _hold_topk(got["tfidf_batch"], free["tfidf_batch"], n=5)
        _hold_topk(got["tfidf_csr"], ref[tag]["tfidf_csr"], n=5)
        for a, b in zip(got["tfidf_csr"], got["tfidf_batch"]):
            np.testing.assert_array_equal(a, b)
        _hold_topk(_rows_topk(got["tfidf_pos"]), _rows_topk(ref[tag]["tfidf_pos"]))
        _hold_topk(_rows_topk(got["tfidf_pos"]), _rows_topk(free["tfidf_pos"]))


@pytest.mark.parametrize("family", ["hybrid_dense", "hybrid_tfidf"])
@pytest.mark.parametrize("tag", list(MESHES))
def test_evaluate_hybrid_mesh_matches_jax_and_single_device(cases, tag, family):
    """The hybrid metrics on the mesh: JAX's within 0.05, and the port's
    mesh-free metrics within 0.05, the same users; every rank the same."""
    _, ref, ranks, free, _ = cases
    got = ranks[0][tag][family]
    assert all(rk[tag][family] == got for rk in ranks)
    for want in (ref[tag][family], free[family]):
        assert got[3] == want[3] and got[3] > 0
        np.testing.assert_allclose(got[:3], want[:3], atol=0.05)


def test_world_of_one_is_the_mesh_free_call(cases):
    """``mesh=make_mesh(1)`` in a gloo world of this process alone: every
    path bit for bit its mesh-free call (the rank's shard is the whole
    catalog, the merge a stable top-k of sorted candidates); the TF-IDF
    hybrid metrics within 0.05 (the mesh path's ``stable_topk`` against
    the host path's ``argsort``)."""
    from matrix_factorization_tpu_torch.parallel.launch import world_of_one
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    inp, _, _, free, _ = cases
    with world_of_one():
        got = _paths(_indexes(inp), make_mesh(1), inp)
    for name, want in free.items():
        if name == "hybrid_tfidf":
            assert got[name][3] == want[3]
            np.testing.assert_allclose(got[name][:3], want[:3], atol=0.05)
        elif isinstance(want, tuple) and len(want) == 2:
            for a, b in zip(got[name], want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        else:
            assert got[name] == want, name
    for a, b in zip(got["dense_mesh"], free["dense_batch"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["tfidf_csr"], free["tfidf_batch"]):
        np.testing.assert_array_equal(a, b)


def test_merge_keeps_the_tie_rule():
    """Equal scores from different ranks merge by global position, and a
    rank's ``-inf`` fill (positions past the catalog) never wins over a
    real row."""
    import torch

    from matrix_factorization_tpu_torch.parallel.topk import (
        merge_candidates,
        pad_candidates,
    )
    from matrix_factorization_tpu_torch.parallel.launch import world_of_one

    vals, gpos = pad_candidates(torch.tensor([[1.0, 0.5]]), torch.tensor([[7, 3]]),
                                4, 9)
    assert vals.tolist() == [[1.0, 0.5, float("-inf"), float("-inf")]]
    assert gpos.tolist() == [[7, 3, 9, 10]]
    with world_of_one():
        v, p = merge_candidates(torch.tensor([[2.0, 2.0, 1.0]]),
                                torch.tensor([[4, 6, 0]]), 2)
    assert v.tolist() == [[2.0, 2.0]] and p.tolist() == [[4, 6]]


# ---------------------------------------------------------------------------
# Sharded checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(MESHES))
def test_sharded_checkpoint_restores_the_shards(cases, tag):
    """``tests/test_serve_checkpoint.py:440``: a ``keep_sharded`` fit on the
    mesh restored into the same layout, each rank's shards equal to the
    ones it saved and fewer rows than the whole table (P on every mesh, Q
    on the 2 x 2), the catalog rebuilt, ``recommend`` equal, ``predict``
    1e-6; the meshless load gathers the whole tables and is not
    ``keep_sharded``; another mesh's shape raises naming both."""
    _, _, ranks, _, _ = cases
    for rk in ranks:
        c = rk[tag]["ckpt"]
        for saved, restored, whole in zip(c["saved"], c["restored"], c["whole"]):
            np.testing.assert_array_equal(restored, saved)
        assert c["saved"][0].shape[0] < c["whole"][0].shape[0]
        if tag == "2x2":
            assert c["saved"][1].shape[0] < c["whole"][1].shape[0]
        assert c["state"] == ({"4x1": "1d", "2x2": "2d"}[tag], True, True, True)
        pd.testing.assert_frame_equal(*c["recs"])
        np.testing.assert_allclose(*c["predict"], atol=1e-6)
        tables, keep, mesh, sharding = c["meshless"]
        for a, b in zip(tables, c["whole"]):
            np.testing.assert_array_equal(a, b)
        assert (keep, mesh, sharding) == (False, None, None)
        assert "sharded on a mesh of shape" in c["other_mesh"]
        assert "(4, 1)" in c["other_mesh"] and "(2, 2)" in c["other_mesh"]


def test_gathered_checkpoint_of_a_sharded_fit_loads_in_jax(cases):
    """``save_model`` of a ``keep_sharded`` fit (the whole tables gathered,
    rank 0 writing) loads in the JAX package: ``predict`` and
    ``recommend`` within 1e-4."""
    _, _, ranks, _, crossed = cases
    want = ranks[0]["2x2"]["ckpt"]["gathered"]
    np.testing.assert_allclose(crossed["predict"], want["predict"], atol=1e-4)
    assert list(crossed["recs"]["item_id"]) == list(want["recs"]["item_id"])
    np.testing.assert_allclose(crossed["recs"].iloc[:, 1].to_numpy(np.float64),
                               want["recs"].iloc[:, 1].to_numpy(np.float64),
                               atol=1e-4)


def _implicit_interactions(seed=0, n_users=40, n_items=48, n=700):
    """``tests/test_serve_checkpoint.py::_implicit_interactions``."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n)
    grp = u % 4
    i = rng.integers(0, n_items // 4, n) + grp * (n_items // 4)
    return pd.DataFrame({"user_id": u, "item_id": i}).drop_duplicates()


@pytest.mark.parametrize("family", ["KernelMF", "BPR", "Popularity"])
def test_sharded_checkpoint_round_trips_mesh_free_models(tmp_path, family):
    """``tests/test_serve_checkpoint.py:401``: models without a mesh write
    their params and aux arrays whole (``no_dist``) and read them back:
    KernelMF's ``predict``, BPR's tables and ``auc``, Popularity's
    ``predict`` and ``recommend``."""
    from matrix_factorization_tpu_torch import (
        BPR,
        KernelMF,
        Popularity,
        load_model_sharded,
        save_model_sharded,
    )
    from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings

    X, y = lowrank_ratings(n_users=30, n_items=20, density=0.5, seed=24)
    path = tmp_path / "ck"
    if family == "KernelMF":
        m = KernelMF(n_factors=4, n_epochs=5, lr=0.02, batch_size=64,
                     device="cpu").fit(X, y)
        save_model_sharded(m, path)
        m2 = load_model_sharded(path, device="cpu")
        np.testing.assert_allclose(m2.predict(X.iloc[:15]), m.predict(X.iloc[:15]),
                                   atol=1e-6)
        assert m2.known_items == m.known_items
    elif family == "BPR":
        Xi = _implicit_interactions(seed=9)
        m = BPR(n_factors=8, n_epochs=8, lr=0.1, batch_size=256, seed=3,
                device="cpu").fit(Xi)
        save_model_sharded(m, path)
        m2 = load_model_sharded(path, device="cpu")
        np.testing.assert_array_equal(m2.item_features, m.item_features)
        assert abs(m2.auc(Xi, n_neg=10, seed=0) - m.auc(Xi, n_neg=10, seed=0)) < 1e-9
    else:
        m = Popularity(score="mean").fit(X, y)
        save_model_sharded(m, path)
        m2 = load_model_sharded(path)
        np.testing.assert_allclose(m2.predict(X.iloc[:15]), m.predict(X.iloc[:15]),
                                   atol=1e-6)
        np.testing.assert_array_equal(
            m2.recommend(user=X["user_id"].iloc[0], amount=5)["item_id"].values,
            m.recommend(user=X["user_id"].iloc[0], amount=5)["item_id"].values)
    meta = pd.read_pickle(path / "meta.pkl")
    assert meta["layout"] is None and meta["model_class"] == family
    assert (path / "arrays_dcp" / ".metadata").exists()
