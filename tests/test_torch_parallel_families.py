"""BPR and SVD++ on a mesh: the PyTorch port's data-parallel trainers and
``BPR(mesh=)`` / ``SVDpp(mesh=)`` against the JAX package's.

One ``torch.distributed`` world of 4 gloo ranks on the CPU
(``parallel.launch.spawn_world``, once for the file) runs every case: each
rank trains its part and returns numpy arrays. JAX runs the same trainer
cases here on ``make_mesh(4)`` over its 8 virtual CPU devices, from the
same initial tables (JAX's, carried to the ranks as numpy) and JAX's own
draws, rebuilt from its key splits and handed to the ranks: for BPR
``fold_in(split(key, n_epochs)[e], d)`` split into the permutation's and
the negatives' keys, for SVD++ the folded key's permutation. 37 users on 4
ranks leave uneven user ranges and a rank with no user at all, so the
local ids and the pads are exercised.

Bars: JAX's own. BPR tables within 2e-5 and the loss within rtol 1e-5
(``tests/test_bpr.py:113-115``), SVD++ within 1e-5
(``tests/test_svdpp.py:288-291``). The models: JAX's model tests as the
spec (AUC above 0.85 on ``_blocky_interactions``, falling RMSE, the dp
big-batch SVD++ within 1e-5 of the single-device big-batch fit). Exact
where the port must be exact: the replicas across ranks, two fits of one
seed, the multislice mesh against the flat one, and ``overlap_psum``
against the synchronous schedule when each rank's epoch is one batch.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.ops import bpr as jbpr
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu.ops import svdpp as jsvd
from matrix_factorization_tpu.parallel import distributed as jdist
from matrix_factorization_tpu.parallel.mesh import make_mesh as jmesh

WORLD = 4
N_USERS, N_ITEMS, BS, EPOCHS = 37, 23, 32, 3
BPR_LR = 0.05
BPR_CFG = dict(kernel="linear", n_factors=6, reg=0.01, min_rating=0.0,
               max_rating=1.0)
SVD_CFG = dict(kernel="linear", n_factors=6, lr=0.05, reg=0.02,
               min_rating=1.0, max_rating=5.0)
LR_Y, REG_Y = 0.05, 0.02
# (layout, overlap_psum, psum_every) of the trainer cases
CASES = [("flat", False, 1), ("flat", True, 1), ("tiled", False, 1),
         ("tiled", False, 2), ("tiled", True, 3)]
CASE_IDS = [f"{lay}-{'overlap' if ov else 'sync'}-T{t}" for lay, ov, t in CASES]
BPR_KW = dict(n_factors=16, n_epochs=40, lr=0.1, reg=0.002, batch_size=128,
              seed=3)
SVD_KW = dict(n_factors=8, n_epochs=20, lr=0.05, reg=0.02, batch_size=64,
              seed=6)
BIG_SVD = dict(n_factors=8, n_epochs=5, lr=0.05, reg=0.02, batch_size=4096,
               seed=7)
MODEL_RUNS = {"tiled": {"dp_layout": "tiled"}, "flat": {"dp_layout": "flat"},
              "windowed": {"dp_layout": "tiled", "psum_every": "auto",
                           "overlap_psum": True}}


def _pairs():
    """400 unique pairs of 37 x 23 (``tests/test_ials.py:148``'s shape):
    users 0-15 on rank 0, 16-31 on rank 1, 32-36 on rank 2, none on 3."""
    rng = np.random.default_rng(0)
    flat = rng.choice(N_USERS * N_ITEMS, size=400, replace=False)
    u = (flat // N_ITEMS).astype(np.int32)
    i = (flat % N_ITEMS).astype(np.int32)
    r = rng.uniform(1, 5, 400).astype(np.float32)
    return u, i, r


def _blocky_interactions(n_users=60, n_items=40, per_user=12, seed=0):
    """``tests/test_bpr.py``'s fixture: two user groups, each preferring one
    half of the catalog, with a little cross-group noise."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        own = np.arange(0, n_items // 2) if u < n_users // 2 else \
            np.arange(n_items // 2, n_items)
        other = np.setdiff1d(np.arange(n_items), own)
        pos = list(rng.choice(own, size=per_user, replace=False))
        if rng.random() < 0.3:
            pos.append(int(rng.choice(other)))
        rows += [(u, it) for it in dict.fromkeys(pos)]
    return pd.DataFrame(rows, columns=["user_id", "item_id"])


def _frame(X, y=None):
    return {"X": {c: X[c].to_numpy() for c in X.columns},
            "y": None if y is None else y.to_numpy()}


def _unframe(f):
    X = pd.DataFrame(f["X"])
    return X, (None if f["y"] is None else pd.Series(f["y"]))


# ---------------------------------------------------------------------------
# What the ranks run (module level: the spawned ranks import this module)
# ---------------------------------------------------------------------------


def _rank_trainers(inp, out):
    """Every trainer case on this rank, on the flat mesh and (for the
    tiled ones) the multislice mesh; the checks of the arguments."""
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import bpr, svdpp
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.ops.svdpp import SVDppParams
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel import mesh as pmesh

    m41 = pmesh.make_mesh(4, 1)
    ms = pmesh.make_multislice_mesh(2, 2, 1)
    d = pmesh.device_index(m41)
    group = pmesh.data_group(m41)
    u, i, r = inp["pairs"]
    ucap = inp["ucap"]
    rows = slice(d * ucap // 4, (d + 1) * ucap // 4)
    flat = pdist.local_ratings(inp["stream"], d, 4, "cpu")
    ones = np.ones(len(u), np.float32)

    def pack(vals):
        return sgd.pack_ratings(u, i, vals, BS, shuffle_seed=0, order="user",
                                n_dev=4, users_per_dev=ucap // 4, segment=d,
                                device="cpu")

    # BPR
    cfg = SGDConfig(**BPR_CFG)
    whole = sgd.params_from_numpy(*inp["bpr_tables"], device="cpu", cfg=cfg)
    local = pdist.place_params(whole, m41)
    bpack = pack(ones)
    res = {}
    for (layout, overlap, T), tag in zip(CASES, CASE_IDS):
        draws = inp["bpr_draws"][layout]
        meshes = (("flat", m41), ("multislice", ms)) if layout == "tiled" \
            else (("flat", m41),)
        for mtag, mesh in meshes:
            if layout == "flat":
                p, h = bpr.dp_bpr_train(local, flat, cfg, EPOCHS, BPR_LR,
                                        N_ITEMS, BS, len(u), mesh,
                                        overlap_psum=overlap, perms=draws[0],
                                        negatives=draws[1])
            else:
                p, h = bpr.dp_bpr_train_tiled(local, bpack, cfg, EPOCHS,
                                              BPR_LR, N_ITEMS, mesh,
                                              overlap_psum=overlap,
                                              psum_every=T,
                                              batch_orders=draws[0],
                                              negatives=draws[1])
            g = pdist.gather_params(p, m41, q_sharded=False)
            res[(tag, mtag)] = (g.user_features.numpy(),
                                g.item_features.numpy(), h.numpy(),
                                p.item_features.numpy())
    p, _ = bpr.dp_bpr_train_tiled(local, bpack, cfg, 2, BPR_LR, N_ITEMS, m41,
                                  key=(5, 1))
    again, _ = bpr.dp_bpr_train_tiled(local, bpack, cfg, 2, BPR_LR, N_ITEMS,
                                      m41, key=(5, 1))
    res["seeded_same_bits"] = all(torch.equal(a, b) for a, b in zip(p, again))
    out["bpr"] = res

    # SVD++
    cfg = SGDConfig(**SVD_CFG)
    P0, Q0, Y0, S0, mu = inp["svd_tables"]
    mf = sgd.params_from_numpy(P0, Q0, mu, device="cpu", cfg=cfg)
    local = SVDppParams(mf.user_features[rows].clone(), mf.item_features,
                        torch.from_numpy(Y0), torch.from_numpy(S0[rows]),
                        mf.global_mean)
    wvec = torch.from_numpy(inp["wvec"][rows])
    deg = torch.from_numpy(inp["deg"])
    spack = pack(r)
    res = {}
    for (layout, overlap, T), tag in zip(CASES, CASE_IDS):
        perms = inp["svd_draws"][layout]
        meshes = (("flat", m41), ("multislice", ms)) if layout == "tiled" \
            else (("flat", m41),)
        for mtag, mesh in meshes:
            if layout == "flat":
                p, h = svdpp.dp_svdpp_train(local, flat, wvec, deg, cfg, EPOCHS,
                                            LR_Y, REG_Y, BS, len(u), mesh,
                                            overlap_psum=overlap, perms=perms)
            else:
                p, h = svdpp.dp_svdpp_train_batched(
                    local, spack, wvec, deg, cfg, EPOCHS, LR_Y, REG_Y, mesh,
                    overlap_psum=overlap, psum_every=T, batch_orders=perms)
            res[(tag, mtag)] = (
                pdist.all_gather_rows(p.user_features, group).numpy(),
                p.item_features.numpy(), p.implicit_features.numpy(),
                pdist.all_gather_rows(p.user_implicit_sums, group).numpy(),
                h.numpy())
    out["svdpp"] = res

    # the checks of the trainers' arguments (each raises before any
    # collective, on every rank alike)
    errors = []
    bcfg = SGDConfig(**BPR_CFG)
    bl = pdist.place_params(sgd.params_from_numpy(
        *inp["bpr_tables"], device="cpu", cfg=bcfg), m41)
    for fn in (lambda: bpr.dp_bpr_train_tiled(bl, bpack, bcfg, 1, BPR_LR,
                                              N_ITEMS, m41, psum_every=4),
               lambda: bpr.dp_bpr_train_tiled(
                   bl, sgd.pack_ratings(u, i, ones, BS, order="item",
                                        device="cpu"),
                   bcfg, 1, BPR_LR, N_ITEMS, m41),
               lambda: bpr.dp_bpr_train(bl, flat, bcfg, 1, BPR_LR, N_ITEMS,
                                        BS + 1, len(u), m41),
               lambda: svdpp.dp_svdpp_train_batched(
                   local, spack, wvec, deg, cfg, 2, LR_Y, REG_Y, m41,
                   batch_orders=inp["svd_draws"]["tiled"][:1])):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors


def _rank_models(rank, inp, out):
    """``BPR(mesh=)`` and ``SVDpp(mesh=)`` on this rank: fits in both layouts
    and windowed, a second fit of one seed, the one-batch overlap case, a
    warm start, serving, and a checkpoint that rank 0 loads without a
    mesh."""
    import torch

    from matrix_factorization_tpu_torch import BPR, SVDpp, load_model, save_model
    from matrix_factorization_tpu_torch.parallel import mesh as pmesh

    m41 = pmesh.make_mesh(4, 1)
    res = {}
    X, _ = _unframe(inp["blocky"])
    for tag, kw in MODEL_RUNS.items():
        m = BPR(mesh=m41, device="cpu", **BPR_KW, **kw).fit(X)
        res[f"bpr_{tag}"] = {
            "loss": m.train_loss, "auc": m.auc(X, n_neg=30, seed=0),
            "P": m.user_features, "Q": m.item_features,
            "rows": m._params.user_features.shape[0],
            "recs": m.recommend(user=X.user_id.iloc[0], amount=5)}
        if tag == "tiled":
            again = BPR(mesh=m41, device="cpu", **BPR_KW, **kw).fit(X)
            res["bpr_same_bits"] = all(torch.equal(a, b) for a, b in
                                       zip(m._params, again._params))
            bm = m
    for layout in ("tiled", "flat"):
        big = dict(n_factors=8, n_epochs=5, lr=0.1, batch_size=4096, seed=1,
                   mesh=m41, dp_layout=layout, device="cpu")
        a = BPR(**big).fit(X)
        b = BPR(overlap_psum=True, **big).fit(X)
        res[f"bpr_one_batch_{layout}"] = all(
            torch.equal(x, y) for x, y in zip(a._params, b._params))
    warm = BPR(mesh=m41, device="cpu", **{**BPR_KW, "n_epochs": 3}).fit(X)
    warm.fit(X, n_epochs=2, warm_start=True)
    res["bpr_warm"] = (warm.train_loss, warm.user_features, warm.item_features)

    X, y = _unframe(inp["lowrank"])
    for tag, kw in MODEL_RUNS.items():
        m = SVDpp(mesh=m41, device="cpu", **SVD_KW, **kw).fit(X, y)
        res[f"svd_{tag}"] = {
            "rmse": m.train_rmse, "Q": m.item_features,
            "Y": m.implicit_features, "P": m.user_features,
            "recs": m.recommend(user=X.user_id.iloc[0], amount=5)}
        if tag == "tiled":
            again = SVDpp(mesh=m41, device="cpu", **SVD_KW, **kw).fit(X, y)
            res["svd_same_bits"] = all(torch.equal(a, b) for a, b in
                                       zip(m._params, again._params))
            sm = m
    for layout in ("tiled", "flat"):
        m = SVDpp(mesh=m41, dp_layout=layout, device="cpu", **BIG_SVD).fit(X, y)
        res[f"svd_big_{layout}"] = (m.user_features, m.item_features,
                                    m.implicit_features, m.train_rmse)

    # checkpoints: every rank calls save_model, rank 0 writes; it loads and
    # predicts on one device without a mesh
    ckpt = inp["ckpt"]
    Xb, _ = _unframe(inp["blocky"])
    for tag, model, Xc in (("bpr", bm, Xb), ("svdpp", sm, X)):
        save_model(model, f"{ckpt}/{tag}")
        torch.distributed.barrier()
        if rank == 0:
            back = load_model(f"{ckpt}/{tag}", device="cpu")
            res[f"ckpt_{tag}"] = (back.mesh, back.overlap_psum, back.psum_every,
                                  np.asarray(back.predict(Xc.iloc[:20])),
                                  np.asarray(model.predict(Xc.iloc[:20])))
        torch.distributed.barrier()
    out["models"] = res


def _rank_cases(rank, world, inp):
    out = {}
    _rank_trainers(inp, out)
    _rank_models(rank, inp, out)
    return out


# ---------------------------------------------------------------------------
# The inputs, JAX's draws and JAX's results
# ---------------------------------------------------------------------------


def _bpr_draws(key, n, shape):
    """JAX's per-epoch, per-device BPR draws: ``k = fold_in(split(key,
    E)[e], d)``, ``kp, kn = split(k)``, ``permutation(kp, n)`` and
    ``randint(kn, shape, 0, n_items)``."""
    perms, negs = [], []
    for k_e in jax.random.split(key, EPOCHS):
        row_p, row_n = [], []
        for d in range(WORLD):
            kp, kn = jax.random.split(jax.random.fold_in(k_e, d))
            row_p.append(np.asarray(jax.random.permutation(kp, n)))
            row_n.append(np.asarray(jax.random.randint(kn, shape, 0, N_ITEMS,
                                                       jnp.int32)))
        perms.append(row_p)
        negs.append(row_n)
    return perms, negs


def _svd_draws(key, n):
    """JAX's SVD++ orders: ``permutation(fold_in(split(key, E)[e], d), n)``."""
    return [[np.asarray(jax.random.permutation(jax.random.fold_in(k_e, d), n))
             for d in range(WORLD)] for k_e in jax.random.split(key, EPOCHS)]


def _inputs():
    u, i, r = _pairs()
    mesh = jmesh(n_data=WORLD)
    ones = np.ones(len(u), np.float32)
    ucap, bs, stream, shard, rep = jdist.dp_fit_plumbing(u, i, ones, N_USERS,
                                                         mesh, BS)
    _, _, sstream, _, _ = jdist.dp_fit_plumbing(u, i, r, N_USERS, mesh, BS)
    assert bs == BS and ucap == 64
    n_local = stream[0].shape[0] // WORLD
    inp = {"pairs": (u, i, r), "ucap": ucap, "stream": sstream}
    jp = jsgd.init_params(jax.random.PRNGKey(3), N_USERS, N_ITEMS,
                          JaxConfig(**BPR_CFG), global_mean=0.0, init_sd=0.1,
                          user_capacity=ucap)
    inp["bpr_tables"] = (np.asarray(jp.user_features),
                         np.asarray(jp.item_features), 0.0)
    packs = {}
    for name, vals in (("bpr", ones), ("svd", r)):
        packs[name] = jsgd.pack_ratings(
            u, i, vals, BS, shuffle_seed=0, order="user",
            row_width=JaxConfig(**BPR_CFG).padded_factors,
            n_dev=WORLD, users_per_dev=ucap // WORLD)
    nb_local = packs["bpr"].user_ids.shape[0] // WORLD
    assert nb_local == 6  # windows of 2 and 3 divide it
    inp["bpr_draws"] = {
        "flat": _bpr_draws(jax.random.PRNGKey(11), n_local, (n_local,)),
        "tiled": _bpr_draws(jax.random.PRNGKey(11), nb_local, (nb_local, BS))}
    mu = float(r.mean())
    js = jsvd.init_params(jax.random.PRNGKey(4), N_USERS, N_ITEMS,
                          JaxConfig(**SVD_CFG), mu, init_sd=0.1,
                          user_capacity=ucap)
    Y0 = np.zeros(np.asarray(js.implicit_features).shape, np.float32)
    Y0[:, :6] = np.random.default_rng(2).normal(0, 0.05, (Y0.shape[0], 6))
    inp["svd_tables"] = (np.asarray(js.user_features),
                         np.asarray(js.item_features), Y0,
                         np.asarray(js.user_implicit_sums), mu)
    inp["wvec"] = jsvd._neighbor_weights(u, N_USERS, ucap)
    deg = np.zeros(Y0.shape[0], np.float32)
    deg[:N_ITEMS] = np.bincount(i, minlength=N_ITEMS)
    inp["deg"] = deg
    inp["svd_draws"] = {"flat": _svd_draws(jax.random.PRNGKey(12), n_local),
                        "tiled": _svd_draws(jax.random.PRNGKey(12), nb_local)}
    jax_in = {"mesh": mesh, "shard": shard, "rep": rep, "stream": stream,
              "sstream": sstream, "packs": packs}
    return inp, jax_in


def _jax_results(inp, jx):
    mesh, shard, rep = jx["mesh"], jx["shard"], jx["rep"]
    u = inp["pairs"][0]
    ref = {"bpr": {}, "svdpp": {}}
    bcfg = JaxConfig(**BPR_CFG)
    scfg = JaxConfig(**SVD_CFG)
    su, si, _, sw = (jax.device_put(a, shard) for a in jx["stream"])
    tu, ti, tr, tw = (jax.device_put(a, shard) for a in jx["sstream"])
    bdata = jax.tree.map(lambda a: jax.device_put(a, shard), jx["packs"]["bpr"])
    sdata = jax.tree.map(lambda a: jax.device_put(a, shard), jx["packs"]["svd"])
    P0, Q0, Y0, S0, mu = inp["svd_tables"]
    wvec = jax.device_put(jnp.asarray(inp["wvec"]), shard)
    deg = jax.device_put(jnp.asarray(inp["deg"]), rep)
    for (layout, overlap, T), tag in zip(CASES, CASE_IDS):
        bp = jdist.place_params(jsgd.MFParams(
            *(jnp.asarray(t) for t in inp["bpr_tables"])), mesh)
        if layout == "flat":
            p, h = jbpr.jit_dp_bpr_train(bcfg, EPOCHS, BPR_LR, N_ITEMS, BS,
                                         len(u), mesh, overlap_psum=overlap)(
                bp, su, si, sw, jax.random.PRNGKey(11))
        else:
            p, h = jbpr.jit_dp_bpr_train_tiled(
                bcfg, EPOCHS, BPR_LR, N_ITEMS, mesh, overlap_psum=overlap,
                psum_every=T)(bp, bdata, jax.random.PRNGKey(11))
        ref["bpr"][tag] = (np.asarray(p.user_features),
                           np.asarray(p.item_features), np.asarray(h))
        sp = jsvd.SVDppParams(
            jax.device_put(jnp.asarray(P0), shard), jax.device_put(jnp.asarray(Q0), rep),
            jax.device_put(jnp.asarray(Y0), rep), jax.device_put(jnp.asarray(S0), shard),
            jax.device_put(jnp.float32(mu), rep))
        if layout == "flat":
            p, h = jsvd.jit_dp_svdpp_train(scfg, EPOCHS, LR_Y, REG_Y, BS,
                                           len(u), mesh, overlap_psum=overlap)(
                sp, tu, ti, tr, tw, wvec, deg, jax.random.PRNGKey(12))
        else:
            p, h = jsvd.jit_dp_svdpp_train_batched(
                scfg, EPOCHS, LR_Y, REG_Y, mesh, overlap_psum=overlap,
                psum_every=T)(sp, sdata, wvec, deg, jax.random.PRNGKey(12))
        ref["svdpp"][tag] = tuple(np.asarray(x) for x in (
            p.user_features, p.item_features, p.implicit_features,
            p.user_implicit_sums, h))
    return ref


@pytest.fixture(scope="module")
def cases():
    """The numpy inputs, JAX's results, the ranks' results and the port's
    mesh-free big-batch SVD++ fits. The world runs in a thread while JAX
    computes here."""
    from concurrent.futures import ThreadPoolExecutor

    from matrix_factorization_tpu_torch import SVDpp
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    inp, jx = _inputs()
    inp["blocky"] = _frame(_blocky_interactions())
    Xs, ys = lowrank_ratings(n_users=60, n_items=50, density=0.4, seed=11)
    inp["lowrank"] = _frame(Xs, ys)
    with tempfile.TemporaryDirectory() as ckpt:
        inp["ckpt"] = ckpt
        with ThreadPoolExecutor(1) as pool:
            world = pool.submit(spawn_world, _rank_cases, WORLD, device="cpu",
                                args=(inp,), timeout=600)
            ref = _jax_results(inp, jx)
            free = {"svd_big": SVDpp(device="cpu", **BIG_SVD).fit(Xs, ys)}
            ranks = world.result()
    return inp, ref, ranks, free


def _bpr_close(got, want):
    """``tests/test_bpr.py:113-115``: tables 2e-5, loss rtol 1e-5."""
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", CASE_IDS)
def test_dp_bpr_matches_jax(cases, tag):
    """Every rank's whole tables and loss within JAX's bars of JAX's dp
    trainer given its draws; the Q replicas bit-equal across ranks."""
    _, ref, ranks, _ = cases
    got = ranks[0]["bpr"][(tag, "flat")]
    for rk in ranks:
        for a, b in zip(rk["bpr"][(tag, "flat")], got):
            assert np.array_equal(a, b)
    _bpr_close(got, ref["bpr"][tag])
    assert got[2][-1] != got[2][0]


@pytest.mark.parametrize("tag", CASE_IDS)
def test_dp_svdpp_matches_jax(cases, tag):
    """P, Q, Y, S and the RMSE history within 1e-5 of JAX's
    (``tests/test_svdpp.py:288-291``); Q and Y bit-equal across ranks."""
    _, ref, ranks, _ = cases
    got = ranks[0]["svdpp"][(tag, "flat")]
    for rk in ranks:
        for a, b in zip(rk["svdpp"][(tag, "flat")], got):
            assert np.array_equal(a, b)
    for a, b in zip(got, ref["svdpp"][tag]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert np.abs(got[2]).max() > 0  # the Y update ran


@pytest.mark.parametrize("family", ["bpr", "svdpp"])
def test_multislice_mesh_is_the_flat_mesh(cases, family):
    """The (slice, data) data group of a 2 x 2 x 1 mesh reduces as the
    flat 4 x 1 mesh does: the same bits, at every window."""
    _, _, ranks, _ = cases
    for tag, (layout, _, _) in zip(CASE_IDS, CASES):
        if layout != "tiled":
            continue
        for rk in ranks:
            for a, b in zip(rk[family][(tag, "multislice")],
                            rk[family][(tag, "flat")]):
                assert np.array_equal(a, b)


def test_seeded_draws_repeat_bit_for_bit(cases):
    _, _, ranks, _ = cases
    assert all(rk["bpr"]["seeded_same_bits"] for rk in ranks)


def test_trainer_validation_messages(cases):
    _, _, ranks, _ = cases
    errors = ranks[0]["errors"]
    assert len(errors) == 4
    assert "psum_every=4 must divide the 6 local batches" in errors[0]
    assert "needs an aggregated pack_ratings(order='user') pack" in errors[1]
    assert "is not a whole number of batches of 33" in errors[2]
    assert "batch_orders has 1 epochs for 2" in errors[3]


# ---------------------------------------------------------------------------
# The models end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(MODEL_RUNS))
def test_bpr_on_the_mesh_learns_the_ranking(cases, tag):
    """``tests/test_bpr.py:173-207, 273-305`` on 4 ranks: the loss falls
    and the AUC is above 0.85; every rank holds the same whole tables
    (64 user rows: ``round_up(60, 8 x 4)``) and serves the same list."""
    _, _, ranks, _ = cases
    got = ranks[0]["models"][f"bpr_{tag}"]
    assert got["loss"][-1] < got["loss"][0]
    assert got["auc"] > 0.85, got["auc"]
    assert got["rows"] == 64
    assert len(got["recs"]) == 5
    for rk in ranks:
        m = rk["models"][f"bpr_{tag}"]
        assert np.array_equal(m["P"], got["P"]) and np.array_equal(m["Q"], got["Q"])
        assert m["recs"]["item_id"].tolist() == got["recs"]["item_id"].tolist()
    if tag == "tiled":
        assert all(rk["models"]["bpr_same_bits"] for rk in ranks)


@pytest.mark.parametrize("layout", ["tiled", "flat"])
def test_bpr_overlap_is_synchronous_with_one_batch_a_rank(cases, layout):
    """``tests/test_bpr.py:197-204``: with one batch a rank an epoch the
    deferred all-reduce is added before anything reads it: the same bits."""
    _, _, ranks, _ = cases
    assert all(rk["models"][f"bpr_one_batch_{layout}"] for rk in ranks)


def test_bpr_warm_start_with_a_mesh(cases):
    """A warm start with a mesh continues on the single-device path from
    the gathered tables: every rank continues alike."""
    _, _, ranks, _ = cases
    loss, P, Q = ranks[0]["models"]["bpr_warm"]
    assert len(loss) == 5 and np.isfinite(loss).all()
    for rk in ranks:
        assert np.array_equal(rk["models"]["bpr_warm"][1], P)
        assert np.array_equal(rk["models"]["bpr_warm"][2], Q)


@pytest.mark.parametrize("tag", list(MODEL_RUNS))
def test_svdpp_on_the_mesh_learns(cases, tag):
    """``tests/test_svdpp.py:259-325`` on 4 ranks: the train RMSE falls,
    every rank holds the same tables and serves 5 items; two fits of one
    seed are bit-equal."""
    _, _, ranks, _ = cases
    got = ranks[0]["models"][f"svd_{tag}"]
    assert got["rmse"][-1] < got["rmse"][0]
    assert len(got["recs"]) == 5
    for rk in ranks:
        m = rk["models"][f"svd_{tag}"]
        for name in ("P", "Q", "Y"):
            assert np.array_equal(m[name], got[name])
    if tag == "tiled":
        assert all(rk["models"]["svd_same_bits"] for rk in ranks)
        flat = ranks[0]["models"]["svd_flat"]["rmse"][-1]
        assert abs(got["rmse"][-1] - flat) < 0.05  # ``:318-320``


@pytest.mark.parametrize("layout", ["tiled", "flat"])
def test_svdpp_big_batch_on_the_mesh_is_the_single_device_fit(cases, layout):
    """``tests/test_svdpp.py:282-291``: one batch a rank is one global
    summed batch, so the mesh fit is the single-device big-batch fit
    within 1e-5 (the mesh fit's tables start as the mesh-free fit's)."""
    _, _, ranks, free = cases
    P, Q, Y, hist = ranks[0]["models"][f"svd_big_{layout}"]
    ref = free["svd_big"]
    for got, want in ((P, ref.user_features), (Q, ref.item_features),
                      (Y, ref.implicit_features), (hist, ref.train_rmse)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tag", ["bpr", "svdpp"])
def test_mesh_checkpoint_loads_without_a_mesh(cases, tag):
    _, _, ranks, _ = cases
    mesh, overlap, every, back, orig = ranks[0]["models"][f"ckpt_{tag}"]
    assert mesh is None and overlap is False and every == 1
    np.testing.assert_array_equal(back, orig)


def test_mesh_arguments_are_accepted():
    """The mesh and its knobs construct; JAX's refusals without a mesh
    stand."""
    from types import SimpleNamespace

    from matrix_factorization_tpu_torch import BPR, SVDpp

    stub = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 1))
    for cls in (BPR, SVDpp):
        m = cls(mesh=stub, overlap_psum=True, psum_every="auto",
                dp_layout="flat", device="cpu")
        assert (m.mesh, m.overlap_psum, m.psum_every) == (stub, True, "auto")
        for kw, msg in (({"overlap_psum": True}, "overlap_psum"),
                        ({"psum_every": 2}, "psum_every"),
                        ({"dp_layout": "ring"}, "dp_layout")):
            with pytest.raises(ValueError, match=msg):
                cls(device="cpu", **kw)


# ---------------------------------------------------------------------------
# World size 1: the single-device trainers
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, at one intra-op thread."""
    from matrix_factorization_tpu_torch.parallel import launch

    with launch.world_of_one():
        yield


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_one_rank_bpr_is_the_single_device_trainer(world_of_one, layout):
    """At one rank the dp trainer walks the same batches with the same
    draws as ``bpr_train`` / ``bpr_train_tiled``; ``Q + dQ`` rounds
    otherwise than the two in-place applies, so JAX's bars hold, not bits."""
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import bpr
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    u, i, _ = _pairs()
    ones = np.ones(len(u), np.float32)
    cfg = SGDConfig(**BPR_CFG)
    p0 = sgd.init_params(torch.Generator().manual_seed(1), N_USERS, N_ITEMS,
                         cfg, 0.0)
    g = torch.Generator().manual_seed(2)
    if layout == "flat":
        _, bs, stream = pdist.dp_fit_plumbing(u, i, ones, N_USERS, mesh, BS)
        data = pdist.local_ratings(stream, 0, 1, "cpu")
        n = data.user_ids.shape[0]
        perms = [torch.randperm(n, generator=g) for _ in range(EPOCHS)]
        negs = [torch.randint(0, N_ITEMS, (n,), generator=g, dtype=torch.int32)
                for _ in range(EPOCHS)]
        want = bpr.bpr_train(p0, data.user_ids, data.item_ids, data.weights,
                             None, cfg, EPOCHS, BPR_LR, N_ITEMS, bs, len(u),
                             perms=perms, negatives=negs)
        got = bpr.dp_bpr_train(p0, data, cfg, EPOCHS, BPR_LR, N_ITEMS, bs,
                               len(u), mesh, perms=[[p] for p in perms],
                               negatives=[[x] for x in negs])
    else:
        pack = sgd.pack_ratings(u, i, ones, BS, order="user", device="cpu")
        nb = pack.n_batches
        orders = [torch.randperm(nb, generator=g) for _ in range(EPOCHS)]
        negs = [torch.randint(0, N_ITEMS, (nb, BS), generator=g,
                              dtype=torch.int32) for _ in range(EPOCHS)]
        want = bpr.bpr_train_tiled(p0, pack, None, cfg, EPOCHS, BPR_LR,
                                   N_ITEMS, batch_orders=orders, negatives=negs)
        got = bpr.dp_bpr_train_tiled(p0, pack, cfg, EPOCHS, BPR_LR, N_ITEMS,
                                     mesh, batch_orders=[[o] for o in orders],
                                     negatives=[[x] for x in negs])
    _bpr_close([t.numpy() for t in (got[0].user_features,
                                    got[0].item_features, got[1])],
               [t.numpy() for t in (want[0].user_features,
                                    want[0].item_features, want[1])])
    assert not torch.equal(got[0].item_features, p0.item_features)


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_one_rank_svdpp_is_the_single_device_trainer(world_of_one, layout):
    """At one rank ``dp_svdpp_train`` / ``dp_svdpp_train_batched`` are
    ``svdpp_train`` / ``svdpp_train_batched`` on the same batches and
    orders, within 1e-5."""
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import svdpp
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    u, i, r = _pairs()
    cfg = SGDConfig(**SVD_CFG)
    p0 = svdpp.init_params(torch.Generator().manual_seed(1), N_USERS, N_ITEMS,
                           cfg, float(r.mean()))
    Y = torch.zeros_like(p0.implicit_features)
    Y[:, :6] = 0.05 * torch.randn((Y.shape[0], 6), generator=torch.Generator().manual_seed(3))
    p0 = p0._replace(implicit_features=Y)
    wvec = torch.from_numpy(svdpp._neighbor_weights(u, N_USERS,
                                                    p0.user_features.shape[0]))
    deg = torch.from_numpy(np.bincount(i, minlength=Y.shape[0]).astype(np.float32))
    g = torch.Generator().manual_seed(2)
    if layout == "flat":
        _, bs, stream = pdist.dp_fit_plumbing(u, i, r, N_USERS, mesh, BS)
        data = pdist.local_ratings(stream, 0, 1, "cpu")
        perms = [torch.randperm(data.user_ids.shape[0], generator=g)
                 for _ in range(EPOCHS)]
        want = svdpp.svdpp_train(p0, *data, wvec, deg, None, cfg, EPOCHS,
                                 LR_Y, REG_Y, bs, len(u), perms=perms)
        got = svdpp.dp_svdpp_train(p0, data, wvec, deg, cfg, EPOCHS, LR_Y,
                                   REG_Y, bs, len(u), mesh,
                                   perms=[[p] for p in perms])
    else:
        pack = sgd.pack_ratings(u, i, r, BS, order="user", device="cpu")
        orders = [torch.randperm(pack.n_batches, generator=g)
                  for _ in range(EPOCHS)]
        want = svdpp.svdpp_train_batched(p0, pack, wvec, deg, None, cfg,
                                         EPOCHS, LR_Y, REG_Y,
                                         batch_orders=orders)
        got = svdpp.dp_svdpp_train_batched(p0, pack, wvec, deg, cfg, EPOCHS,
                                           LR_Y, REG_Y, mesh,
                                           batch_orders=[[o] for o in orders])
    for a, b in zip(list(got[0]) + [got[1]], list(want[0]) + [want[1]]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
