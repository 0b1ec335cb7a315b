"""Multi-device KernelMF of the PyTorch port against the JAX package's.

One ``torch.distributed`` world of 4 gloo ranks on the CPU
(``parallel.launch.spawn_world``, once for the file) runs every case of
``tests/test_parallel.py`` that the port has: each rank trains and serves
its part and returns numpy arrays. JAX runs the same cases here on
``make_mesh`` of the same shape over its 8 virtual CPU devices, from the
same initial tables (JAX's, carried to the ranks as numpy) and the same
per-device epoch orders (JAX's ``fold_in(split(key, n_epochs)[e], dev)``,
computed here and handed to the port's trainers).

Bars: tables within 2e-5 and the train-RMSE history within 1e-5 (rtol)
of JAX's, the single-device bar of ``tests/test_torch_sgd_train.py``;
the port's own schedules that must agree exactly (overlap with one-batch
epochs, the multislice mesh against the flat mesh, two runs of one seed,
the replicas of Q across ranks) bit for bit.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu.parallel import distributed as jdist
from matrix_factorization_tpu.parallel import topk as jtopk
from matrix_factorization_tpu.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, make_mesh as jmesh, make_multislice_mesh as jmslice)
from matrix_factorization_tpu.parallel.serving import ShardedCatalog as JCatalog

WORLD = 4
ATOL = 2e-5
RTOL = 1e-5
LIN = dict(kernel="linear", n_factors=8, lr=0.03, reg=0.01)


def _small():
    """The ratings of ``tests/test_parallel.py``'s fixture."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 30, 400).astype(np.int32)
    i = rng.integers(0, 20, 400).astype(np.int32)
    r = rng.uniform(1, 5, 400).astype(np.float32)
    return u, i, r, 30, 20


def _wide():
    """512 users x 64 items, 8,000 ratings: the tiled cases."""
    rng = np.random.default_rng(5)
    u = rng.integers(0, 512, 8000).astype(np.int32)
    i = rng.integers(0, 64, 8000).astype(np.int32)
    r = rng.uniform(1, 5, 8000).astype(np.float32)
    return u, i, r, 512, 64


def _orders(key, n_epochs, n, folds):
    """JAX's per-epoch, per-device permutations of ``n``: the epoch key
    ``split(key, n_epochs)[e]`` folded with each device's indices."""
    keys = jax.random.split(key, n_epochs)
    out = []
    for e in range(n_epochs):
        row = []
        for fold in folds:
            k = keys[e]
            for x in fold:
                k = jax.random.fold_in(k, x)
            row.append(np.asarray(jax.random.permutation(k, n)))
        out.append(row)
    return out


def _tables(p):
    return np.asarray(p.user_features), np.asarray(p.item_features)


def _jax_init(key, n_users, n_items, cfg, r, ucap, icap=None):
    p = jsgd.init_params(key, n_users, n_items, cfg, float(r.mean()), 0.0,
                         0.1, user_capacity=ucap, item_capacity=icap)
    return _tables(p) + (float(r.mean()),)


# ---------------------------------------------------------------------------
# What the ranks run (module level: the spawned ranks import this module)
# ---------------------------------------------------------------------------


def _params(torch_cfg, tables):
    from matrix_factorization_tpu_torch.ops.segment_sgd import params_from_numpy

    P0, Q0, mu = tables
    return params_from_numpy(P0, Q0, mu, device="cpu", cfg=torch_cfg)


def _np(params):
    return (params.user_features.numpy().copy(),
            params.item_features.numpy().copy())


def _held(m):
    """What a rank of a ``KernelMF`` holds: its sharding and the row
    counts of its P and Q."""
    return (m._sharding, m._params.user_features.shape[0],
            m._params.item_features.shape[0])


def _rank_cases(rank, world, inp):
    import pandas as pd
    import torch

    from matrix_factorization_tpu_torch import KernelMF, fit_resumable, load_model, save_model
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel import mesh as pmesh
    from matrix_factorization_tpu_torch.parallel import topk as ptopk
    from matrix_factorization_tpu_torch.parallel.serving import ShardedCatalog

    out = {}
    m41 = pmesh.make_mesh(4, 1)
    m22 = pmesh.make_mesh(2, 2)
    ms = pmesh.make_multislice_mesh(2, 2, 1)
    d41, d22, m_of = (pmesh.device_index(m41), pmesh.device_index(m22),
                      pmesh.model_index(m22))
    out["coords"] = (d41, d22, m_of, pmesh.device_index(ms))

    # flat one step (4 x 1): one local batch a rank
    c = inp["flat_one"]
    cfg = SGDConfig(**c["cfg"])
    p, h = pdist.dp_sgd_train(
        pdist.place_params(_params(cfg, c["tables"]), m41),
        pdist.local_ratings(c["stream"], d41, 4, "cpu"), cfg, 1, cfg.lr, m41,
        c["n_real"], orders=c["orders"])
    out["flat_one"] = _np(p) + (h.numpy(),)

    # tiled over 4 data ranks: item-primary (the accumulator mode) and
    # user-primary, psum_every 1, 2 and 'auto'
    c = inp["tiled"]
    cfg = SGDConfig(**c["cfg"])
    u, i, r, n_users, n_items = c["ratings"]
    for tag, order, T in c["variants"]:
        pack = sgd.pack_ratings(u, i, r, cfg.batch_size, shuffle_seed=0,
                                order=order, n_dev=4,
                                users_per_dev=c["ucap"] // 4, segment=d41,
                                device="cpu")
        p, h = pdist.dp_sgd_train_tiled(
            pdist.place_params(_params(cfg, c["tables"]), m41), pack, cfg, 3,
            0.03, m41, psum_every=T, orders=c["orders"])
        out[tag] = _np(p) + (h.numpy(), pack.primary)

    # overlap_psum: one-batch epochs (exact) and multi-batch (two runs)
    c = inp["overlap"]
    u, i, r, n_users, n_items = c["ratings"]
    for tag, kw in c["variants"]:
        cfg = SGDConfig(**kw["cfg"])
        p, h = pdist.dp_fit(u, i, r, n_users, n_items, cfg, 4, cfg.lr, m41,
                            overlap_psum=kw["overlap"], layout="flat",
                            params=_params(cfg, kw["tables"]), device="cpu")
        out[tag] = _np(p) + (h,)

    # 2D one step (2 x 2) and 2D fits
    c = inp["two_d_one"]
    cfg = SGDConfig(**c["cfg"])
    p, h = pdist.dp_tp_sgd_train(
        pdist.place_params_2d(_params(cfg, c["tables"]), m22),
        pdist.local_ratings(c["stream"], d22 * 2 + m_of, 4, "cpu"), cfg, 1,
        cfg.lr, m22, c["n_real"], orders=c["orders"])
    out["two_d_one"] = _np(pdist.gather_params(p, m22, True)) + (h.numpy(),)
    c = inp["two_d_fit"]
    u, i, r, n_users, n_items = c["ratings"]
    for tag, kw in c["variants"]:
        cfg = SGDConfig(**kw["cfg"])
        p, h = pdist.dp_tp_fit(
            u, i, r, n_users, n_items, cfg, kw["epochs"], cfg.lr, m22,
            psum_every=kw["T"], overlap_psum=kw["overlap"],
            params=_params(cfg, c["tables"]), orders=kw["orders"],
            device="cpu")
        out[tag] = _np(pdist.gather_params(p, m22, True)) + (h,)

    # multislice (2 x 2 x 1) against the flat 4-rank mesh
    c = inp["multislice"]
    u, i, r, n_users, n_items = c["ratings"]
    cfg = SGDConfig(**c["cfg"])
    for tag, mesh in (("ms", ms), ("ms_flat", m41)):
        for layout in ("flat", "tiled"):
            p, h = pdist.dp_fit(u, i, r, n_users, n_items, cfg, 5, cfg.lr,
                                mesh, layout=layout, pack_order="user",
                                params=_params(cfg, c["tables"]),
                                device="cpu")
            out[f"{tag}_{layout}"] = _np(p) + (h,)

    # psum_every=2 against the windowed oracle, and the checks
    c = inp["windowed"]
    cfg = SGDConfig(**c["cfg"])
    p, _ = pdist.dp_sgd_train(
        pdist.place_params(_params(cfg, c["tables"]), m41),
        pdist.local_ratings(c["stream"], d41, 4, "cpu"), cfg, 2, cfg.lr, m41,
        c["n_real"], psum_every=2)
    out["windowed"] = _np(p)
    u, i, r, n_users, n_items = inp["small"]
    errors = []
    for kw in ({"psum_every": 4}, {"psum_every": 0}, {"layout": "bogus"}):
        try:
            pdist.dp_fit(u, i, r, n_users, n_items, cfg, 1, cfg.lr, m41,
                         device="cpu", **{"layout": "flat", **kw})
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors

    # distributed top-k over every axis of the 2 x 2 mesh
    c = inp["topk"]
    cfg = SGDConfig(kernel="linear", n_factors=8)
    Q = torch.from_numpy(c["Q"])
    shard = d22 * 2 + m_of
    n_loc = Q.shape[0] // 4
    vals, idx = ptopk.distributed_topk(
        torch.from_numpy(c["pu"]), Q[shard * n_loc:(shard + 1) * n_loc],
        torch.tensor(c["mu"]), torch.from_numpy(c["valid"])[
            shard * n_loc:(shard + 1) * n_loc], 5, cfg, m22,
        ("data", "model"))
    whole = sgd.params_from_numpy(c["Q"][:32], c["Q"], c["mu"], device="cpu")
    by_shard = sgd.params_from_numpy(
        c["Q"][:32], c["Q"][m_of * 32:(m_of + 1) * 32], c["mu"], device="cpu")
    a = ShardedCatalog(whole, 20, cfg, m22).topk(c["pu"], 7)
    b = ShardedCatalog(by_shard, 20, cfg, m22, q_sharded=True).topk(c["pu"], 7)
    out["topk"] = (vals.numpy(), idx.numpy(), a, b)

    # the model API: keep_sharded on a 2 x 2 mesh, the warm-start rebuild,
    # checkpoints, and the windowed / overlapped schedules on 4 x 1
    X, y = (pd.DataFrame(inp["model"]["X"]), pd.Series(inp["model"]["y"]))
    users = list(X["user_id"].iloc[:2])
    m = KernelMF(n_factors=8, n_epochs=10, lr=0.03, reg=0.01, batch_size=64,
                 mesh=m22, keep_sharded=True, device="cpu").fit(X, y)
    res = {"hist": list(m.train_rmse),
           "held": _held(m),
           "tables": _np(m._whole_params()) + (float(m._params.global_mean),),
           "ud": m.user_vocab.encode(np.asarray(users, dtype=object)),
           "items": np.asarray(m.item_vocab.raw_ids),
           "batch": m.recommend_batch(users, amount=5, bound_ratings=False),
           "one": m.recommend(users[0], amount=5, items_known=set(
               X.loc[X["user_id"] == users[0], "item_id"])),
           "single": m._catalog_topk(m.user_vocab.encode(
               np.asarray(users, dtype=object)), 5),
           "predict": np.asarray(m.predict(X.iloc[:10]))}
    stale = m._topk_catalog
    m.fit(X, y, n_epochs=3, warm_start=True)
    res["rebuilt"] = m._topk_catalog is not stale and m._topk_catalog is not None
    res["warm_held"] = _held(m)
    res["warm_tables"] = _np(m._whole_params()) + (float(m._params.global_mean),)
    res["warm_one"] = m.recommend(users[0], amount=5, bound_ratings=False)
    # a new user and a known one: update_users gathers, trains, and keeps
    # this rank's shards of the grown tables
    upd = X.iloc[:6].assign(user_id=["new_user"] * 3 + [users[0]] * 3)
    upd = upd.drop_duplicates(["user_id", "item_id"])
    m.update_users(upd, y.iloc[upd.index], lr=0.03, n_epochs=3)
    res["update"] = (_held(m), _np(m._whole_params()),
                     m.user_vocab.encode(np.asarray(["new_user"], dtype=object)),
                     m.recommend("new_user", amount=5, bound_ratings=False))
    res["ckpt"] = None
    ckpt = inp["model"]["ckpt"]
    save_model(m, ckpt + "/saved")  # every rank: a collective, rank 0 writes
    pred = np.asarray(m.predict(X.iloc[:10]))  # a collective too
    if rank == 0:
        back = load_model(ckpt + "/saved", device="cpu")
        res["ckpt"] = (back.mesh, back.keep_sharded, back.psum_every,
                       np.asarray(back.predict(X.iloc[:10])), pred)
    fr = KernelMF(n_factors=8, n_epochs=3, lr=0.03, reg=0.01, batch_size=64,
                  mesh=m41, device="cpu")
    fr = fit_resumable(fr, X, y, ckpt + "/resume", segment_epochs=2)
    again = KernelMF(n_factors=8, n_epochs=4, lr=0.03, reg=0.01,
                     batch_size=64, mesh=m41, device="cpu")
    again = fit_resumable(again, X, y, ckpt + "/resume", total_epochs=4,
                          segment_epochs=2)
    res["resumable"] = (fr.mesh is m41, again.mesh is m41,
                        again._epochs_done, len(again.train_rmse))
    for tag, kw in (("auto", {"psum_every": "auto"}),
                    ("overlap", {"overlap_psum": True}),
                    ("flat", {"dp_layout": "flat", "epoch_order": "user"})):
        mm = KernelMF(n_factors=8, n_epochs=15, lr=0.03, reg=0.01,
                      batch_size=64, mesh=m41, device="cpu", **kw).fit(X, y)
        res[tag] = (list(mm.train_rmse), np.asarray(mm.predict(X)))
    try:
        KernelMF(n_factors=8, mesh=m41, epoch_order="block",
                 device="cpu").fit(X, y)
    except ValueError as e:
        res["block"] = str(e)
    out["model"] = res
    return out


# ---------------------------------------------------------------------------
# The inputs and JAX's results
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    """The numpy inputs of every case, the ranks' results and JAX's on its
    8-device virtual mesh. The world runs in a thread while JAX computes
    here (``later`` holds JAX's runs, each given its inputs)."""
    from concurrent.futures import ThreadPoolExecutor

    from matrix_factorization_tpu.data.synthetic import lowrank_ratings
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    inp, ref, later = {}, {}, []
    u, i, r, n_users, n_items = small = _small()
    inp["small"] = small
    mesh4 = jmesh(n_data=4, n_model=1)
    shard4 = NamedSharding(mesh4, P(DATA_AXIS))
    mesh22 = jmesh(n_data=2, n_model=2)

    def one_step(tag, two_d, kw, tables, stream):
        jcfg = JaxConfig(**kw)
        p0 = jsgd.MFParams(*(jnp.asarray(t) for t in tables))
        if two_d:
            cells = NamedSharding(mesh22, P((DATA_AXIS, MODEL_AXIS)))
            got, hist = jax.jit(lambda p, d, k: jdist.dp_tp_sgd_train(
                p, d, k, jcfg, 1, jcfg.lr, mesh22, len(r)))(
                    jdist.place_params_2d(p0, mesh22),
                    jdist.ShardedRatings(*(jax.device_put(a, cells)
                                           for a in stream)),
                    jax.random.PRNGKey(2))
        else:
            got, hist = jax.jit(lambda p, d, k: jdist.dp_sgd_train(
                p, d, k, jcfg, 1, jcfg.lr, mesh4, len(r)))(
                    jdist.place_params(p0, mesh4),
                    jdist.ShardedRatings(*(jax.device_put(a, shard4)
                                           for a in stream)),
                    jax.random.PRNGKey(2))
        single = jsgd.sgd_minibatch_step(
            p0, jnp.asarray(u), jnp.asarray(i), jnp.asarray(r),
            jnp.ones_like(r), jcfg, jcfg.lr)
        ref[tag] = (_tables(got), np.asarray(hist), _tables(single))

    # flat one step
    ucap = jsgd.round_up(n_users, 32)
    n_pad = jdist.shard_ratings_by_user(u, i, r, ucap, 4, 1)[4]
    kw = dict(LIN, batch_size=n_pad, compute_epoch_rmse=True)
    tables = _jax_init(jax.random.PRNGKey(1), n_users, n_items,
                       JaxConfig(**kw), r, ucap)
    stream = jdist.shard_ratings_by_user(u, i, r, ucap, 4, n_pad)[:4]
    inp["flat_one"] = {"cfg": kw, "tables": tables, "stream": stream,
                       "n_real": len(r), "orders": [[np.zeros(1, np.int64)] * 4]}
    later.append(lambda a=("flat_one", False, kw, tables, stream): one_step(*a))

    # tiled over 4 data ranks
    wide = _wide()
    wu, wi, wr, wn_users, wn_items = wide
    wucap = jsgd.round_up(wn_users, 32)
    kw = dict(LIN, lr=0.01, batch_size=96, compute_epoch_rmse=True)
    tables = _jax_init(jax.random.PRNGKey(0), wn_users, wn_items,
                       JaxConfig(**kw), wr, wucap)
    variants = [("tiled_item_T1", "shuffle", 1), ("tiled_user_T2", "user", 2),
                ("tiled_user_auto", "user", "auto")]
    nb_local = jsgd.pack_ratings(wu, wi, wr, 96, n_dev=4,
                                 users_per_dev=wucap // 4,
                                 aggregate=False).user_ids.shape[0] // 4
    assert nb_local == 22  # windows of 2 and of 11 ('auto')
    inp["tiled"] = {"cfg": kw, "tables": tables, "ratings": wide,
                    "ucap": wucap, "variants": variants,
                    "orders": _orders(jax.random.PRNGKey(1), 3, nb_local,
                                      [(d,) for d in range(4)])}

    def tiled(kw=kw, tables=tables):
        jcfg = JaxConfig(**kw)
        p0 = jdist.place_params(
            jsgd.MFParams(*(jnp.asarray(t) for t in tables)), mesh4)
        for tag, order, T in variants:
            data = jsgd.pack_ratings(wu, wi, wr, 96, shuffle_seed=0,
                                     order=order, n_dev=4,
                                     users_per_dev=wucap // 4,
                                     agg_min_gain=-1.0)
            data = jax.tree.map(lambda a: jax.device_put(a, shard4), data)
            got, hist = jax.jit(lambda p, d, k, T=T: jdist.dp_sgd_train_tiled(
                p, d, k, jcfg, 3, 0.03, mesh4, psum_every=T))(
                    p0, data, jax.random.PRNGKey(1))
            ref[tag] = (_tables(got), np.asarray(hist))

    later.append(tiled)

    # overlap_psum, flat, shuffle 'none'
    k_init, k_train = jax.random.split(jax.random.PRNGKey(0))
    ovl = []
    for tag, bs, overlap in (("sync_one", n_pad, False),
                             ("ovl_one", n_pad, True),
                             ("ovl_multi_a", 32, True),
                             ("ovl_multi_b", 32, True)):
        kw = dict(LIN, batch_size=bs, shuffle="none")
        tables = _jax_init(k_init, n_users, n_items, JaxConfig(**kw), r, ucap)
        ovl.append((tag, {"cfg": kw, "tables": tables, "overlap": overlap}))

        def overlapped(tag=tag, kw=kw, overlap=overlap):
            jcfg = JaxConfig(**kw)
            got, hist = jdist.dp_fit(u, i, r, n_users, n_items, jcfg, 4,
                                     jcfg.lr, mesh4, overlap_psum=overlap)
            ref[tag] = (_tables(got), np.asarray(hist))

        later.append(overlapped)
    inp["overlap"] = {"ratings": small, "variants": ovl}

    # 2D one step (2 x 2)
    ucap2, icap2 = jsgd.round_up(n_users, 16), jsgd.round_up(n_items, 16)
    n_pad = jdist.shard_ratings_2d(u, i, r, ucap2, icap2, 2, 2, 1)[4]
    kw = dict(LIN, batch_size=n_pad, compute_epoch_rmse=True)
    tables = _jax_init(jax.random.PRNGKey(1), n_users, n_items,
                       JaxConfig(**kw), r, ucap2, icap2)
    stream = jdist.shard_ratings_2d(u, i, r, ucap2, icap2, 2, 2, n_pad)[:4]
    inp["two_d_one"] = {"cfg": kw, "tables": tables, "stream": stream,
                        "n_real": len(r),
                        "orders": [[np.zeros(1, np.int64)] * 4]}
    later.append(lambda a=("two_d_one", True, kw, tables, stream): one_step(*a))

    # 2D fits: shuffled batches, windows of 2, one window overlapped
    kw = dict(LIN, batch_size=32)
    tables = _jax_init(k_init, n_users, n_items, JaxConfig(**kw), r, ucap2,
                       icap2)
    nb2 = jdist.shard_ratings_2d(u, i, r, ucap2, icap2, 2, 2, 32)[4] // 32
    assert nb2 == 6
    folds = [(d, m) for d in range(2) for m in range(2)]
    none = dict(LIN, batch_size=32, shuffle="none")
    two_d = [("two_d_fit", {"cfg": kw, "epochs": 4, "T": 1, "overlap": False,
                            "orders": _orders(k_train, 4, nb2, folds)}),
             ("two_d_T2", {"cfg": kw, "epochs": 4, "T": 2, "overlap": False,
                           "orders": _orders(k_train, 4, nb2, folds)}),
             ("two_d_epoch", {"cfg": none, "epochs": 3, "T": "epoch",
                              "overlap": False, "orders": None}),
             ("two_d_epoch_ovl", {"cfg": none, "epochs": 3, "T": "epoch",
                                  "overlap": True, "orders": None})]
    inp["two_d_fit"] = {"ratings": small, "tables": tables, "variants": two_d}

    def two_d_fits():
        for tag, v in two_d:
            jc = JaxConfig(**v["cfg"])
            got, hist = jdist.dp_tp_fit(u, i, r, n_users, n_items, jc,
                                        v["epochs"], jc.lr, mesh22,
                                        psum_every=v["T"],
                                        overlap_psum=v["overlap"])
            ref[tag] = (_tables(got), np.asarray(hist))

    later.append(two_d_fits)

    # multislice (2 x 2 x 1) = flat 4 data ranks
    kw = dict(LIN, batch_size=32, shuffle="none")
    inp["multislice"] = {"ratings": small, "cfg": kw, "tables": _jax_init(
        k_init, n_users, n_items, JaxConfig(**kw), r, ucap)}

    def multislice(kw=kw):
        jcfg = JaxConfig(**kw)
        ms = jmslice(n_slices=2, n_data=2, n_model=1)
        for tag, layout in (("ms_flat", "flat"), ("ms_tiled", "tiled")):
            got, hist = jdist.dp_fit(u, i, r, n_users, n_items, jcfg, 5,
                                     jcfg.lr, ms, layout=layout,
                                     pack_order="user")
            ref[tag] = (_tables(got), np.asarray(hist))

    later.append(multislice)

    # psum_every=2, flat, shuffle 'none', bs 8: the windowed oracle
    kw = dict(LIN, batch_size=8, shuffle="none")
    tables = _jax_init(jax.random.PRNGKey(4), n_users, n_items,
                       JaxConfig(**kw), r, ucap)
    stream = jdist.shard_ratings_by_user(u, i, r, ucap, 4, 8)
    assert stream[4] // 8 == 14
    inp["windowed"] = {"cfg": kw, "tables": tables, "stream": stream[:4],
                       "n_real": len(r)}
    later.append(lambda kw=kw, tables=tables, stream=stream: ref.update(
        windowed=_windowed_oracle(tables, JaxConfig(**kw), *stream[:4], ucap,
                                  4, 2, kw["lr"], 2)))

    # distributed top-k inputs (tests/test_parallel.py's)
    cfg = JaxConfig(kernel="linear", n_factors=8)
    kp = cfg.padded_factors
    rng = np.random.default_rng(3)
    Q = np.zeros((64, kp), np.float32)
    Q[:n_items, :8] = rng.normal(0, 0.5, (n_items, 8))
    Q[:n_items, jsgd.const_col(cfg, "item")] = 1.0
    Q[:n_items, jsgd.bias_col(cfg, "item")] = rng.normal(0, 0.2, n_items)
    Q[5] = Q[14]  # a tie across shards
    valid = (np.arange(64) < n_items).astype(np.float32)
    pu = np.zeros((6, kp), np.float32)
    pu[:, :8] = rng.normal(0, 0.5, (6, 8))
    pu[:, jsgd.const_col(cfg, "user")] = 1.0
    pu[:, jsgd.bias_col(cfg, "user")] = rng.normal(0, 0.2, 6)
    inp["topk"] = {"Q": Q, "valid": valid, "pu": pu, "mu": 3.3}

    def topk():
        mesh42 = jmesh(n_data=4, n_model=2)
        vals, idx = jax.jit(lambda pu, Q, valid: jtopk.distributed_topk(
            pu, Q, jnp.float32(3.3), valid, k=5, cfg=cfg, mesh=mesh42,
            axes=(DATA_AXIS, MODEL_AXIS)))(jnp.asarray(pu), jnp.asarray(Q),
                                           jnp.asarray(valid))
        ref["topk"] = (np.asarray(vals), np.asarray(idx))

    later.append(topk)

    X, y = lowrank_ratings(n_users=64, n_items=40, density=0.5, seed=21)
    with tempfile.TemporaryDirectory() as ckpt:
        inp["model"] = {"X": {c: X[c].to_numpy() for c in X.columns},
                        "y": y.to_numpy(), "ckpt": ckpt}
        with ThreadPoolExecutor(1) as pool:
            world = pool.submit(spawn_world, _rank_cases, WORLD,
                                device="cpu", args=(inp,), timeout=600)
            for job in later:
                job()
            ranks = world.result()
    return inp, ref, ranks, (X, y)


def _windowed_oracle(tables, cfg, su, si, sr, sw, ucap, n_dev, T, lr,
                     n_epochs):
    """``tests/test_parallel.py::_windowed_oracle``: numpy, every device
    reading the item table as of the last flush, user rows fresh."""
    P, Q = tables[0].copy(), tables[1].copy()
    mu = tables[2]
    users_per = ucap // n_dev
    nb = len(su) // n_dev // cfg.batch_size
    shp = (n_dev, nb, cfg.batch_size)
    uu, ii, rr, ww = (a.reshape(shp) for a in (su, si, sr, sw))
    umask, imask = jsgd.update_mask(cfg, "user"), jsgd.update_mask(cfg, "item")
    for _ in range(n_epochs):
        for w0 in range(0, nb, T):
            Qf, dQ = Q.copy(), np.zeros_like(Q)
            for t in range(w0, w0 + T):
                for d in range(n_dev):
                    ug = uu[d, t] + d * users_per
                    pu, qi = P[ug], Qf[ii[d, t]]
                    pred, d_pu, d_qi = jsgd.ext_forward_and_rowgrads(
                        cfg, mu, jnp.asarray(pu), jnp.asarray(qi))
                    err = (np.asarray(pred) - rr[d, t]) * ww[d, t]
                    g = (err[:, None] * np.asarray(d_pu)
                         + (cfg.reg * ww[d, t])[:, None] * pu) * umask
                    np.add.at(P, ug, -lr * g)
                    g = (err[:, None] * np.asarray(d_qi)
                         + (cfg.reg * ww[d, t])[:, None] * qi) * imask
                    np.add.at(dQ, ii[d, t], -lr * g)
            Q = Q + dQ
    return P, Q


def _p_whole(ranks, key, coord=0):
    """P assembled from the ranks' shards of a 1D data mesh in data order
    (``coords[coord]``), and every rank's Q."""
    shards = sorted((rk["coords"][coord], rk[key][0]) for rk in ranks)
    return np.concatenate([s for _, s in shards]), [rk[key][1] for rk in ranks]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------


def test_mesh_coordinates(cases):
    _, _, ranks, _ = cases
    assert [rk["coords"] for rk in ranks] == [
        (0, 0, 0, 0), (1, 0, 1, 1), (2, 1, 0, 2), (3, 1, 1, 3)]


def test_flat_one_step_matches_jax_and_single_device(cases):
    """``test_dp_one_step_matches_single_device``: one global synchronous
    step over 4 ranks is the single-device step over the union batch."""
    _, ref, ranks, _ = cases
    P, Qs = _p_whole(ranks, "flat_one")
    (jP, jQ), jh, (sP, sQ) = ref["flat_one"]
    for Q in Qs:
        assert np.array_equal(Q, Qs[0])  # replicas bit-equal
    _close(P, jP)
    _close(Qs[0], jQ)
    _close(P, sP)
    _close(Qs[0], sQ)
    np.testing.assert_allclose(ranks[0]["flat_one"][2], jh, rtol=RTOL)


@pytest.mark.parametrize("tag", ["tiled_item_T1", "tiled_user_T2",
                                 "tiled_user_auto"])
def test_tiled_trainer_matches_jax(cases, tag):
    """The tiled trainer on 4 data ranks (JAX's case on 8) with JAX's pack,
    tables and orders: item-primary at ``psum_every=1`` (the step's
    accumulator mode), user-primary with windows of 2 and 'auto' (11)."""
    _, ref, ranks, _ = cases
    P, Qs = _p_whole(ranks, tag)
    (jP, jQ), jh = ref[tag]
    assert ranks[0][tag][3] == ("item" if "item" in tag else "user")
    for Q in Qs:
        assert np.array_equal(Q, Qs[0])
    _close(P, jP)
    _close(Qs[0], jQ)
    np.testing.assert_allclose(ranks[0][tag][2], jh, rtol=RTOL)
    if tag == "tiled_item_T1":
        assert jh[-1] < jh[0]


def test_overlap_psum_exact_with_one_batch_epochs_and_deterministic(cases):
    """``test_overlap_psum_exact_with_one_batch_epochs`` and
    ``..._parity_and_determinism``: overlapped one-batch epochs are the
    synchronous schedule bit for bit; multi-batch overlap gives the same
    bits twice and JAX's trajectory."""
    _, ref, ranks, _ = cases
    for rk in ranks:
        for a, b in zip(rk["sync_one"], rk["ovl_one"]):
            assert np.array_equal(a, b)
        for a, b in zip(rk["ovl_multi_a"], rk["ovl_multi_b"]):
            assert np.array_equal(a, b)
    for tag in ("sync_one", "ovl_one", "ovl_multi_a"):
        P, Qs = _p_whole(ranks, tag)
        (jP, jQ), jh = ref[tag]
        _close(P, jP)
        _close(Qs[0], jQ)
        np.testing.assert_allclose(ranks[0][tag][2], jh, rtol=RTOL)


def test_two_d_one_step_matches_jax_and_single_device(cases):
    """``test_2d_one_step_matches_single_device`` on a 2 x 2 mesh: P
    sharded over data, Q over model, both deltas all-reduced."""
    _, ref, ranks, _ = cases
    (jP, jQ), jh, (sP, sQ) = ref["two_d_one"]
    for rk in ranks:  # gathered on every rank, the same bits
        assert np.array_equal(rk["two_d_one"][0], ranks[0]["two_d_one"][0])
        assert np.array_equal(rk["two_d_one"][1], ranks[0]["two_d_one"][1])
    P, Q, h = ranks[0]["two_d_one"]
    _close(P, jP)
    _close(Q, jQ)
    _close(P, sP)
    _close(Q, sQ)
    np.testing.assert_allclose(h, jh, rtol=RTOL)


@pytest.mark.parametrize("tag", ["two_d_fit", "two_d_T2", "two_d_epoch"])
def test_two_d_fit_matches_jax(cases, tag):
    """``dp_tp_fit`` on 2 x 2 with JAX's tables and per-cell orders:
    synchronous, windows of 2 (``test_psum_every_2d``) and one window an
    epoch."""
    _, ref, ranks, _ = cases
    P, Q, h = ranks[0][tag]
    (jP, jQ), jh = ref[tag]
    _close(P, jP)
    _close(Q, jQ)
    np.testing.assert_allclose(h, jh, rtol=RTOL)
    assert h[-1] < h[0]


def test_two_d_single_window_overlap_is_exact(cases):
    """``test_overlap_psum_2d`` / ``test_psum_every_2d``: one window an
    epoch, overlapped, is the non-overlapped schedule bit for bit."""
    _, ref, ranks, _ = cases
    for a, b in zip(ranks[0]["two_d_epoch"], ranks[0]["two_d_epoch_ovl"]):
        assert np.array_equal(a, b)
    _close(ranks[0]["two_d_epoch_ovl"][1], ref["two_d_epoch_ovl"][0][1])


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_multislice_equals_flat_mesh_exactly(cases, layout):
    """``test_multislice_dp_matches_flat_dp``: (2 slice x 2 data) trains
    bit for bit as the flat 4-rank data mesh, and as JAX's multislice."""
    _, ref, ranks, _ = cases
    for rk in ranks:
        for a, b in zip(rk[f"ms_{layout}"], rk[f"ms_flat_{layout}"]):
            assert np.array_equal(a, b)
    P, Qs = _p_whole(ranks, f"ms_{layout}", coord=3)
    (jP, jQ), jh = ref["ms_flat" if layout == "flat" else "ms_tiled"]
    _close(P, jP)
    _close(Qs[0], jQ)
    np.testing.assert_allclose(ranks[0][f"ms_{layout}"][2], jh, rtol=RTOL)
    assert jh[-1] < jh[0]


def test_psum_every_matches_numpy_oracle(cases):
    """``test_psum_every_matches_numpy_oracle``: windows of 2 on 4 ranks
    are the windowed stale-read schedule."""
    _, ref, ranks, _ = cases
    P, Qs = _p_whole(ranks, "windowed")
    _close(P, ref["windowed"][0], 1e-5)
    _close(Qs[0], ref["windowed"][1], 1e-5)


def test_validation_messages(cases):
    _, _, ranks, _ = cases
    errors = ranks[0]["errors"]
    assert len(errors) == 3
    assert "psum_every=4 must divide the 14 local batches" in errors[0]
    assert "psum_every must be a positive int" in errors[1]
    assert "layout" in errors[2]


def test_distributed_topk_matches_jax(cases):
    """``test_distributed_topk_matches_dense``: 4 shards here, 8 in JAX;
    the same top-5 (a tie across shards goes to the lower item), and a
    catalog cut from the model shards equals one cut from the whole Q."""
    inp, ref, ranks, _ = cases
    jv, ji = ref["topk"]
    c = inp["topk"]
    dense = 3.3 + c["pu"] @ c["Q"][:20].T
    for rk in ranks:
        vals, idx, a, b = rk["topk"]
        np.testing.assert_allclose(vals, jv, atol=1e-5)
        np.testing.assert_allclose(np.take_along_axis(dense, idx, 1), jv,
                                   atol=1e-5)
        want = np.argsort(-dense, axis=1, kind="stable")[:, :5]
        np.testing.assert_array_equal(idx, want)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[1], np.argsort(
            -dense, axis=1, kind="stable")[:, :7])


def test_keep_sharded_serves_from_the_catalog(cases):
    """``test_kernelmf_keep_sharded_serves_from_resident_shards``: on a
    2 x 2 mesh ``recommend`` and ``recommend_batch`` go through the
    sharded catalog and equal brute force on the gathered tables, the
    single-device top-k and JAX's ``ShardedCatalog`` over the same
    tables."""
    _, _, ranks, (X, y) = cases
    res = ranks[0]["model"]
    P, Q, mu = res["tables"]
    assert res["hist"][-1] < res["hist"][0]
    # the ranks hold their shards only: P over the 2 data ranks, Q over
    # the 2 model ranks
    for rk in ranks:
        assert rk["model"]["held"] == ("2d", len(P) // 2, len(Q) // 2)
    users = list(X["user_id"].iloc[:2])
    ud, items = res["ud"], res["items"]
    n_items = len(items)
    scores = mu + P[ud] @ Q[:n_items].T
    out = res["batch"]
    jcat = JCatalog(jsgd.MFParams(jnp.asarray(P), jnp.asarray(Q),
                                  jnp.float32(mu)), n_items,
                    JaxConfig(**LIN), jmesh(n_data=4, n_model=2))
    jv, ji = jcat.topk(P[ud], 5)
    sv, si = res["single"]
    for row, user in enumerate(users):
        got = out[out["user_id"] == user]
        exp = np.argsort(-scores[row], kind="stable")[:5]
        assert list(got["item_id"]) == list(items[exp])
        np.testing.assert_allclose(got["rating_pred"].to_numpy(),
                                   scores[row][exp], rtol=1e-5)
        assert list(got["item_id"]) == list(items[si[row]])
        np.testing.assert_allclose(got["rating_pred"].to_numpy(), jv[row],
                                   rtol=1e-5)
    known = set(X.loc[X["user_id"] == users[0], "item_id"])
    recs = res["one"]
    assert len(recs) == 5 and not set(recs["item_id"]) & known
    assert recs["rating_pred"].is_monotonic_decreasing
    assert np.isfinite(res["predict"]).all()
    for rk in ranks:  # every rank served the same answer
        assert rk["model"]["batch"].equals(out)


def test_keep_sharded_warm_start_rebuilds_catalog(cases):
    """``test_keep_sharded_warm_start_rebuilds_catalog``: the catalog is
    rebuilt from the continued tables."""
    _, _, ranks, _ = cases
    res = ranks[0]["model"]
    assert res["rebuilt"]
    P, Q, mu = res["warm_tables"]
    assert res["warm_held"] == ("2d", len(P) // 2, len(Q) // 2)
    assert not np.array_equal(Q, res["tables"][1])
    ud, items = res["ud"][0], res["items"]
    scores = mu + P[ud] @ Q[:len(items)].T
    exp = np.argsort(-scores, kind="stable")[:5]
    recs = res["warm_one"]
    assert list(recs["item_id"]) == list(items[exp])
    np.testing.assert_allclose(recs["rating_pred"].to_numpy(), scores[exp],
                               rtol=1e-5)


def test_keep_sharded_update_users_keeps_shards(cases):
    """``update_users`` on a ``keep_sharded`` model: the user table grows
    to a whole number of rows a data rank, each rank keeps its shards, and
    the new user is served from them as brute force on the whole tables
    serves them."""
    _, _, ranks, _ = cases
    held, (P, Q), (ud,), recs = ranks[0]["model"]["update"]
    res = ranks[0]["model"]
    assert held == ("2d", len(P) // 2, len(Q) // 2) and len(P) % 2 == 0
    assert len(P) > len(res["warm_tables"][0])
    np.testing.assert_array_equal(Q, res["warm_tables"][1])
    items, mu = res["items"], res["warm_tables"][2]
    scores = mu + P[ud] @ Q[:len(items)].T
    exp = np.argsort(-scores, kind="stable")[:5]
    assert list(recs["item_id"]) == list(items[exp])
    np.testing.assert_allclose(recs["rating_pred"].to_numpy(), scores[exp],
                               rtol=1e-5)
    for rk in ranks:
        assert rk["model"]["update"][3].equals(recs)


def test_mesh_checkpoint_loads_without_a_mesh_and_resumes(cases):
    """``save_model`` of a mesh-fitted model strips the mesh and the flags
    that need one; ``fit_resumable`` carries the caller's mesh across a
    resume (rank 0 writes)."""
    _, _, ranks, _ = cases
    mesh, keep, psum, back, orig = ranks[0]["model"]["ckpt"]
    assert mesh is None and keep is False and psum == 1
    np.testing.assert_array_equal(back, orig)
    for rk in ranks:
        assert rk["model"]["resumable"] == (True, True, 4, 4)


@pytest.mark.parametrize("tag", ["auto", "overlap", "flat"])
def test_model_api_trains_on_the_mesh(cases, tag):
    """``test_psum_every_model_api_and_validation`` /
    ``test_overlap_psum_model_api_and_validation`` /
    ``test_kernelmf_with_mesh_fits_and_serves``: ``KernelMF(mesh=)`` with
    ``psum_every='auto'``, ``overlap_psum`` and the flat layout trains and
    beats the global mean; every rank ends with the same model."""
    _, _, ranks, (X, y) = cases
    hist, pred = ranks[0]["model"][tag]
    assert hist[-1] < hist[0]
    yy = y.to_numpy()
    base = np.sqrt(np.mean((yy - yy.mean()) ** 2))
    assert np.sqrt(np.mean((np.clip(pred, 0, 5) - yy) ** 2)) < base
    for rk in ranks:
        np.testing.assert_array_equal(rk["model"][tag][1], pred)


def test_block_order_is_refused_on_a_mesh(cases):
    _, _, ranks, _ = cases
    assert "single-device layout" in ranks[0]["model"]["block"]
