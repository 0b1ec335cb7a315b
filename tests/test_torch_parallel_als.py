"""Factor ALS, the bias models and NMF on a mesh: the PyTorch port's
data-parallel trainers against the JAX package's.

One ``torch.distributed`` world of 4 gloo ranks on the CPU
(``parallel.launch.spawn_world``, once for the file) runs every case: each
rank trains its part and returns numpy arrays. JAX runs the same cases
here on ``make_mesh`` of the same shape over its 8 virtual CPU devices,
from the same initial tables (JAX's, carried to the ranks as numpy) and,
for bias SGD, JAX's batch orders (``permutation(split(key, n_epochs)[e],
nb)``).

Bars: JAX's own. ``dp_als_train`` and the padded ``dp_ials_train_bucketed``
within 1e-5 of JAX's and of the port's single-device trainers
(``tests/test_als_and_baseline.py:125-150``, ``tests/test_ials.py:120-
176``), ``dp_bias_sgd_train`` within 2e-5 of JAX's (``:152-179``),
``dp_nmf_train`` at rtol 2e-4 / atol 2e-5; the models against their
mesh-free fits at ``tests/test_ials.py:179-183``,
``tests/test_als_and_baseline.py:199`` and ``tests/test_nmf.py:181-186``.
Exact where the port must be exact: the replicas of every table across
ranks, two fits of one seed, and the multislice mesh against the flat one.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from matrix_factorization_tpu.core.config import SGDConfig as JaxConfig
from matrix_factorization_tpu.data.synthetic import lowrank_ratings
from matrix_factorization_tpu.ops import als as jals
from matrix_factorization_tpu.ops import ials as jials
from matrix_factorization_tpu.ops import nmf as jnmf
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu.parallel import distributed as jdist
from matrix_factorization_tpu.parallel.mesh import (
    make_mesh as jmesh, make_multislice_mesh as jmslice)

WORLD = 4
ALS_KW = dict(n_factors=6, n_epochs=3, method="als", reg=0.1, batch_size=128)
BASE_KW = dict(n_epochs=20, reg=0.5, lr=0.05, batch_size=256)
NMF_KW = dict(n_factors=6, n_epochs=12, reg=0.05, batch_size=256,
              min_rating=0.5, max_rating=5.0, seed=3)


def _bias_ratings():
    """``tests/test_als_and_baseline.py``'s dp case: 2,000 ratings of 60 x 40."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 60, 2000).astype(np.int32)
    i = rng.integers(0, 40, 2000).astype(np.int32)
    r = rng.uniform(1, 5, 2000).astype(np.float32)
    return u, i, r, 60, 40


def _ials_ratings():
    """``tests/test_ials.py:148``: 400 unique pairs of 37 x 23 (37 users on 4
    ranks leave pads in the bucket splits)."""
    rng = np.random.default_rng(0)
    flat = rng.choice(37 * 23, size=400, replace=False)
    u = (flat // 23).astype(np.int32)
    i = (flat % 23).astype(np.int32)
    r = rng.uniform(1, 5, 400).astype(np.float32)
    return u, i, r, 37, 23


def _frame(X, y):
    return {"X": {c: X[c].to_numpy() for c in X.columns}, "y": y.to_numpy()}


# ---------------------------------------------------------------------------
# What the ranks run (module level: the spawned ranks import this module)
# ---------------------------------------------------------------------------


def _rank_trainers(inp, out):
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import als, ials, nmf
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel import mesh as pmesh

    m41 = pmesh.make_mesh(4, 1)
    ms = pmesh.make_multislice_mesh(2, 2, 1)
    d = pmesh.device_index(m41)

    # bias ALS and SGD: this rank's columns of every (nb, 256) block
    u, i, r, nu, ni = inp["bias"]["ratings"]
    pack = sgd.pack_ratings(u, i, r, 256, aggregate=False, device="cpu")
    cols = als.shard_bias_data(pack, m41)
    p0 = als.init_bias_params(nu, ni, float(r.mean()), device="cpu")
    b, h = als.dp_als_train(p0, cols, 0.5, 5, m41)
    ref, href = als.als_train(p0, pack, 0.5, 5)
    out["dp_als"] = (b.user_biases.numpy(), b.item_biases.numpy(), h.numpy(),
                     ref.user_biases.numpy(), ref.item_biases.numpy(),
                     href.numpy(), tuple(cols.user_ids.shape))
    b, h = als.dp_bias_sgd_train(p0, cols, inp["bias"]["orders"], 0.05, 0.1,
                                 m41)
    again, _ = als.dp_bias_sgd_train(p0, cols, inp["bias"]["orders"], 0.05,
                                     0.1, m41)
    out["dp_sgd"] = (b.user_biases.numpy(), b.item_biases.numpy(), h.numpy(),
                     torch.equal(b.user_biases, again.user_biases)
                     and torch.equal(b.item_biases, again.item_biases))

    # factor ALS over count buckets with pads in every split
    c = inp["ials"]
    u, i, r, nu, ni = c["ratings"]
    cfg = SGDConfig(**c["cfg"])
    params = sgd.params_from_numpy(*c["tables"], device="cpu", cfg=cfg)
    bu = ials.group_by_entity_bucketed(u, i, r, nu, max_block_rows=64,
                                       device="cpu")
    bi = ials.group_by_entity_bucketed(i, u, r, ni, max_block_rows=64,
                                       device="cpu")
    data = sgd.pack_ratings(u, i, r, 64, device="cpu")
    pads = [ials._pad_bucket_for_mesh(b_, 4) for b_ in bu]
    out["pads"] = [(b_.entity_ids.numpy(), keep) for b_, keep in pads]
    res = {}
    for tag, mesh in (("flat", m41), ("multislice", ms)):
        p, h = ials.dp_ials_train_bucketed(params, bu, bi, data, cfg, 2, mesh)
        res[tag] = (p.user_features.numpy(), p.item_features.numpy(), h.numpy())
    p, h = ials.ials_train_bucketed(params, bu, bi, data, cfg, 2)
    res["single"] = (p.user_features.numpy(), p.item_features.numpy(), h.numpy())
    out["ials"] = res

    # NMF: this rank's rows of P over its segment of the device-major pack
    c = inp["nmf"]
    u, i, r, nu, ni = c["ratings"]
    cfg = SGDConfig(**c["cfg"])
    ucap = c["ucap"]
    rows = ucap // 4
    whole = sgd.params_from_numpy(*c["tables"], device="cpu", cfg=cfg)
    seg = sgd.pack_ratings(u, i, r, cfg.batch_size, order="auto", n_dev=4,
                           users_per_dev=rows, segment=d, device="cpu")
    cnt_u = torch.from_numpy(np.bincount(u, minlength=ucap).astype(np.float32))
    cnt_i = torch.from_numpy(np.bincount(
        i, minlength=whole.item_features.shape[0]).astype(np.float32))
    local, h = nmf.dp_nmf_train(pdist.place_params(whole, m41), seg,
                                cnt_u[d * rows:(d + 1) * rows], cnt_i, cfg,
                                c["epochs"], 0.05, 0.05, m41)
    g = pdist.gather_params(local, m41, q_sharded=False)
    out["nmf"] = (g.user_features.numpy(), g.item_features.numpy(), h.numpy(),
                  local.item_features.numpy())

    # the checks of the trainers' arguments
    errors = []
    for fn in (lambda: als.shard_bias_data(
                   sgd.pack_ratings(u, i, r, 6, aggregate=False, device="cpu"),
                   m41),
               lambda: ials.dp_ials_train_bucketed(
                   params, bu, bi, data, cfg, 1, m41, reg_scale="per_entity"),
               lambda: ials.dp_ials_train_bucketed(
                   params, bu, bi, data, SGDConfig(kernel="rbf", n_factors=4),
                   1, m41)):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors


def _rank_models(rank, inp, out):
    import torch

    from matrix_factorization_tpu_torch import (
        NMF, BaselineModel, KernelMF, load_model, save_model)
    from matrix_factorization_tpu_torch.parallel import mesh as pmesh

    m41 = pmesh.make_mesh(4, 1)
    ckpt = inp["ckpt"]
    res = {}

    X, y = pd.DataFrame(inp["als"]["X"]), pd.Series(inp["als"]["y"])
    fits = [KernelMF(mesh=m41, device="cpu", **ALS_KW).fit(X, y)
            for _ in range(2)]
    m = fits[0]
    users = list(X["user_id"].iloc[:3])
    kept = KernelMF(mesh=m41, keep_sharded=True, device="cpu", **ALS_KW).fit(X, y)
    res["als"] = {
        "P": m.user_features, "Q": m.item_features, "hist": m.train_rmse,
        "same_bits": all(torch.equal(getattr(fits[0]._params, f),
                                     getattr(fits[1]._params, f))
                         for f in ("user_features", "item_features")),
        "held": (m._sharding, kept._sharding, kept._topk_catalog is not None),
        "recs": m.recommend_batch(users, amount=4, bound_ratings=False),
        "kept_recs": kept.recommend_batch(users, amount=4, bound_ratings=False),
        "one": m.recommend(user=X["user_id"].iloc[0], amount=4),
        "predict": np.asarray(m.predict(X.iloc[:20]))}

    X, y = pd.DataFrame(inp["base"]["X"]), pd.Series(inp["base"]["y"])
    for method in ("als", "sgd"):
        runs = [BaselineModel(method=method, mesh=m41, device="cpu",
                              **BASE_KW).fit(X, y) for _ in range(2)]
        res[f"base_{method}"] = {
            "bu": runs[0].user_biases, "bi": runs[0].item_biases,
            "hist": runs[0].train_rmse, "predict": np.asarray(runs[0].predict(X)),
            "same_bits": (np.array_equal(runs[0].user_biases, runs[1].user_biases)
                          and np.array_equal(runs[0].item_biases,
                                             runs[1].item_biases))}
        if method == "als":
            bm = runs[0]

    X, y = pd.DataFrame(inp["nmf_model"]["X"]), pd.Series(inp["nmf_model"]["y"])
    nm = NMF(mesh=m41, device="cpu", **NMF_KW).fit(X, y)
    res["nmf"] = {"P": nm.user_features, "Q": nm.item_features,
                  "hist": nm.train_rmse, "predict": np.asarray(nm.predict(X)),
                  "rows": nm._params.user_features.shape[0]}

    # checkpoints: every rank calls save_model, rank 0 writes; it loads and
    # predicts on one device without a mesh
    for tag, model, Xc in (("als", m, pd.DataFrame(inp["als"]["X"])),
                           ("base", bm, pd.DataFrame(inp["base"]["X"])),
                           ("nmf", nm, X)):
        save_model(model, f"{ckpt}/{tag}")
        torch.distributed.barrier()
        if rank == 0:
            back = load_model(f"{ckpt}/{tag}", device="cpu")
            res[f"ckpt_{tag}"] = (back.mesh, np.asarray(back.predict(Xc.iloc[:20])),
                                  np.asarray(model.predict(Xc.iloc[:20])))
        torch.distributed.barrier()
    out["models"] = res


def _rank_cases(rank, world, inp):
    out = {}
    _rank_trainers(inp, out)
    _rank_models(rank, inp, out)
    return out


# ---------------------------------------------------------------------------
# The inputs and JAX's results
# ---------------------------------------------------------------------------


def _jax_bias(inp, ref):
    u, i, r, nu, ni = inp["bias"]["ratings"]
    mesh = jmesh(n_data=4)
    data = jsgd.pack_ratings(u, i, r, 256, aggregate=False)
    p0 = jals.init_bias_params(nu, ni, float(r.mean()))
    dd = jals.shard_bias_data(data, mesh)
    out, hist = jax.jit(lambda p, d: jals.dp_als_train(p, d, 0.5, 5, mesh))(p0, dd)
    ref["dp_als"] = (np.asarray(out.user_biases), np.asarray(out.item_biases),
                     np.asarray(hist))
    out, hist = jax.jit(lambda p, d, k: jals.dp_bias_sgd_train(
        p, d, k, 0.05, 0.1, 6, mesh))(p0, dd, jax.random.PRNGKey(3))
    ref["dp_sgd"] = (np.asarray(out.user_biases), np.asarray(out.item_biases),
                     np.asarray(hist))


def _jax_ials(inp, ref):
    u, i, r, nu, ni = inp["ials"]["ratings"]
    cfg = JaxConfig(**inp["ials"]["cfg"])
    data = jsgd.pack_ratings(u, i, r, 64)
    bu = jials.group_by_entity_bucketed(u, i, r, nu, max_block_rows=64)
    bi = jials.group_by_entity_bucketed(i, u, r, ni, max_block_rows=64)
    ref["pads"] = [(np.asarray(b.entity_ids), keep) for b, keep in
                   (jials._pad_bucket_for_mesh(b, 4) for b in bu)]

    def fresh():
        return jsgd.MFParams(*(jnp.asarray(t) for t in inp["ials"]["tables"]))

    res = {}
    for tag, mesh in (("flat", jmesh(n_data=4, n_model=1)),
                      ("multislice", jmslice(n_slices=2, n_data=2, n_model=1))):
        p, h = jials.dp_ials_train_bucketed(fresh(), bu, bi, data, cfg, 2,
                                            mesh=mesh)
        res[tag] = (np.asarray(p.user_features), np.asarray(p.item_features),
                    np.asarray(h))
    ref["ials"] = res


def _jax_nmf(inp, ref):
    c = inp["nmf"]
    u, i, r, nu, ni = c["ratings"]
    cfg = JaxConfig(**c["cfg"])
    mesh = jmesh(n_data=4, n_model=1)
    shard = NamedSharding(mesh, P(("data",)))
    rep = NamedSharding(mesh, P())
    params = jdist.place_params(
        jsgd.MFParams(*(jnp.asarray(t) for t in c["tables"])), mesh)
    data = jsgd.pack_ratings(u, i, r, cfg.batch_size, order="auto",
                             row_width=2 * cfg.n_factors, n_dev=4,
                             users_per_dev=c["ucap"] // 4)
    data = jax.tree.map(lambda a: jax.device_put(a, shard), data)
    cnt_u = jax.device_put(jnp.asarray(np.bincount(
        u, minlength=c["ucap"]).astype(np.float32)), shard)
    cnt_i = jax.device_put(jnp.asarray(np.bincount(
        i, minlength=c["tables"][1].shape[0]).astype(np.float32)), rep)
    got, hist = jnmf.jit_dp_nmf_train(cfg, c["epochs"], 0.05, 0.05, mesh)(
        params, data, cnt_u, cnt_i)
    ref["nmf"] = (np.asarray(got.user_features), np.asarray(got.item_features),
                  np.asarray(hist))


@pytest.fixture(scope="module")
def cases():
    """The numpy inputs, the ranks' results, JAX's and the port's mesh-free
    model fits. The world runs in a thread while JAX computes here."""
    from concurrent.futures import ThreadPoolExecutor

    from matrix_factorization_tpu_torch import NMF, BaselineModel, KernelMF
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    inp, ref = {}, {}
    bias = _bias_ratings()
    nb = -(-len(bias[2]) // 256)
    inp["bias"] = {"ratings": bias, "orders": [
        np.asarray(jax.random.permutation(k, nb))
        for k in jax.random.split(jax.random.PRNGKey(3), 6)]}

    ia = _ials_ratings()
    kw = dict(kernel="linear", n_factors=4, reg=0.2, batch_size=64,
              compute_epoch_rmse=True)
    p = jsgd.init_params(jax.random.PRNGKey(3), ia[3], ia[4], JaxConfig(**kw),
                         float(ia[2].mean()))
    inp["ials"] = {"ratings": ia, "cfg": kw, "tables": (
        np.asarray(p.user_features), np.asarray(p.item_features),
        float(p.global_mean))}

    Xn, yn = lowrank_ratings(n_users=50, n_items=35, density=0.5,
                             min_rating=0.5, max_rating=5.0, seed=11)
    u = np.asarray(pd.factorize(Xn["user_id"])[0], np.int32)
    i = np.asarray(pd.factorize(Xn["item_id"])[0], np.int32)
    r = yn.to_numpy().astype(np.float32)
    kw = dict(kernel="linear", n_factors=6, reg=0.05, batch_size=256,
              min_rating=0.5, max_rating=5.0)
    ucap = jsgd.round_up(int(u.max()) + 1, 32)
    p = jnmf.init_nmf_params(jax.random.PRNGKey(3), int(u.max()) + 1,
                             int(i.max()) + 1, JaxConfig(**kw),
                             user_capacity=ucap)
    inp["nmf"] = {"ratings": (u, i, r, int(u.max()) + 1, int(i.max()) + 1),
                  "cfg": kw, "ucap": ucap, "epochs": 12, "tables": (
                      np.asarray(p.user_features), np.asarray(p.item_features),
                      0.0)}

    Xa, ya = lowrank_ratings(n_users=50, n_items=30, n_factors=3, density=0.5,
                             noise_sd=0.05, seed=7)
    Xb, yb = lowrank_ratings(n_users=80, n_items=60, density=0.4, seed=3)
    inp["als"] = _frame(Xa, ya)
    inp["base"] = _frame(Xb, yb)
    inp["nmf_model"] = _frame(Xn, yn)
    free = {}
    with tempfile.TemporaryDirectory() as ckpt:
        inp["ckpt"] = ckpt
        with ThreadPoolExecutor(1) as pool:
            world = pool.submit(spawn_world, _rank_cases, WORLD, device="cpu",
                                args=(inp,), timeout=600)
            _jax_bias(inp, ref)
            _jax_ials(inp, ref)
            _jax_nmf(inp, ref)
            free["als"] = KernelMF(device="cpu", **ALS_KW).fit(Xa, ya)
            for method in ("als", "sgd"):
                free[f"base_{method}"] = BaselineModel(
                    method=method, device="cpu", **BASE_KW).fit(Xb, yb)
            free["nmf"] = NMF(device="cpu", **NMF_KW).fit(Xn, yn)
            ranks = world.result()
    return inp, ref, ranks, free, {"als": (Xa, ya), "base": (Xb, yb),
                                   "nmf": (Xn, yn)}


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------


def test_dp_als_matches_jax_and_single_device(cases):
    _, ref, ranks, _, _ = cases
    bu, bi, h, sbu, sbi, sh, shape = ranks[0]["dp_als"]
    assert shape == (8, 64)  # 8 batches of 256, 64 columns a rank
    for rk in ranks:
        assert np.array_equal(rk["dp_als"][0], bu)
        assert np.array_equal(rk["dp_als"][1], bi)
    jbu, jbi, jh = ref["dp_als"]
    for got, want in ((bu, jbu), (bi, jbi), (h, jh), (bu, sbu), (bi, sbi),
                      (h, sh)):
        _close(got, want, 1e-5)


def test_dp_bias_sgd_matches_jax_given_its_orders(cases):
    _, ref, ranks, _, _ = cases
    bu, bi, h, same = ranks[0]["dp_sgd"]
    assert same  # two runs of one order, the same bits
    for rk in ranks:
        assert np.array_equal(rk["dp_sgd"][0], bu)
        assert np.array_equal(rk["dp_sgd"][1], bi)
    jbu, jbi, jh = ref["dp_sgd"]
    _close(bu, jbu, 2e-5)
    _close(bi, jbi, 2e-5)
    _close(h, jh, 2e-5)
    r = cases[0]["bias"]["ratings"][2]
    assert h[-1] < np.sqrt(np.mean((r - r.mean()) ** 2))  # below the mean's


def test_bucket_pads_match_jax(cases):
    """Every user bucket is padded as JAX pads it: ``entity_ids[0]`` repeated
    at the tail with keep 0, where 4 ranks do not divide it (37 users)."""
    _, ref, ranks, _, _ = cases
    got, want = ranks[0]["pads"], ref["pads"]
    assert len(got) == len(want) and len(got) > 1
    assert sum(keep.sum() < len(keep) for _, keep in want) >= 2
    for (ids, keep), (jids, jkeep) in zip(got, want):
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(keep, jkeep)


@pytest.mark.parametrize("tag", ["flat", "multislice"])
def test_dp_ials_with_pads_matches_jax_and_single_device(cases, tag):
    """``tests/test_ials.py:120-176``: the solves split over 4 ranks with
    pads in every bucket give the single-device tables (1e-5), and JAX's;
    the multislice (2 x 2 x 1) mesh is the flat one bit for bit."""
    _, ref, ranks, _, _ = cases
    P, Q, h = ranks[0]["ials"][tag]
    for rk in ranks:
        for a, b in zip(rk["ials"][tag], (P, Q, h)):
            assert np.array_equal(a, b)
    sP, sQ, sh = ranks[0]["ials"]["single"]
    jP, jQ, jh = ref["ials"][tag]
    for got, want in ((P, sP), (Q, sQ), (h, sh), (P, jP), (Q, jQ), (h, jh)):
        _close(got, want, 1e-5)
    if tag == "multislice":
        for a, b in zip(ranks[0]["ials"]["flat"], (P, Q, h)):
            assert np.array_equal(a, b)


def test_dp_nmf_matches_jax(cases):
    _, ref, ranks, _, _ = cases
    P, Q, h, Q_local = ranks[0]["nmf"]
    for rk in ranks:
        assert np.array_equal(rk["nmf"][3], Q_local)  # Q replicas bit-equal
        assert np.array_equal(rk["nmf"][0], P)
    jP, jQ, jh = ref["nmf"]
    for got, want in ((P, jP), (Q, jQ), (h, jh)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert np.all(P >= 0) and np.all(Q >= 0)


def test_trainer_validation_messages(cases):
    _, _, ranks, _, _ = cases
    errors = ranks[0]["errors"]
    assert len(errors) == 3
    assert "not a multiple of the 4 data ranks" in errors[0]
    assert "reg_scale must be one of" in errors[1]
    assert "requires the linear kernel" in errors[2]


# ---------------------------------------------------------------------------
# The models end to end
# ---------------------------------------------------------------------------


def test_kernelmf_als_on_the_mesh_matches_mesh_free(cases):
    """``tests/test_ials.py:163-183``: the mesh fit within 1e-4 of the
    mesh-free fit; every rank holds the same whole tables, two fits of one
    seed are bit-equal; ``keep_sharded`` serves from the sharded catalog
    the lists of the whole tables."""
    _, _, ranks, free, frames = cases
    got = ranks[0]["models"]["als"]
    ref = free["als"]
    _close(got["P"], ref.user_features, 1e-4)
    _close(got["Q"], ref.item_features, 1e-4)
    _close(got["hist"], ref.train_rmse, 1e-4)
    assert got["same_bits"]
    assert got["held"] == (None, None, True)
    assert len(got["one"]) == 4
    assert got["kept_recs"]["item_id"].tolist() == got["recs"]["item_id"].tolist()
    np.testing.assert_allclose(got["kept_recs"]["rating_pred"],
                               got["recs"]["rating_pred"], atol=1e-5)
    X, _ = frames["als"]
    _close(got["predict"], np.asarray(ref.predict(X.iloc[:20])), 1e-4)
    for rk in ranks:
        m = rk["models"]["als"]
        assert np.array_equal(m["P"], got["P"]) and np.array_equal(m["Q"], got["Q"])


@pytest.mark.parametrize("method", ["als", "sgd"])
def test_baseline_on_the_mesh_matches_mesh_free(cases, method):
    """``tests/test_als_and_baseline.py:182-199``: both beat the global mean
    and come within 1e-4 (ALS) / 0.05 (SGD, other epoch orders) of the
    mesh-free fit's RMSE; ALS's biases within 1e-5 of the mesh-free ones."""
    _, _, ranks, free, frames = cases
    got = ranks[0]["models"][f"base_{method}"]
    ref = free[f"base_{method}"]
    X, y = frames["base"]
    yy = y.to_numpy()
    base = np.sqrt(np.mean((yy - yy.mean()) ** 2))
    err = np.sqrt(np.mean((got["predict"] - yy) ** 2))
    err_free = np.sqrt(np.mean((np.asarray(ref.predict(X)) - yy) ** 2))
    assert err < base
    assert abs(err - err_free) < (1e-4 if method == "als" else 0.05)
    if method == "als":
        _close(got["bu"], ref.user_biases, 1e-5)
        _close(got["bi"], ref.item_biases, 1e-5)
    assert got["same_bits"]
    for rk in ranks:
        m = rk["models"][f"base_{method}"]
        assert np.array_equal(m["bu"], got["bu"]) and np.array_equal(m["bi"], got["bi"])


def test_nmf_on_the_mesh_matches_mesh_free(cases):
    """``tests/test_nmf.py:170-186`` at 4 ranks."""
    _, _, ranks, free, _ = cases
    got = ranks[0]["models"]["nmf"]
    ref = free["nmf"]
    assert got["rows"] == 64  # round_up(50, 8 x 4)
    np.testing.assert_allclose(got["hist"], ref.train_rmse, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["Q"], ref.item_features, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got["P"], ref.user_features, rtol=2e-3, atol=2e-4)
    X, _ = cases[4]["nmf"]
    np.testing.assert_allclose(got["predict"], np.asarray(ref.predict(X)),
                               rtol=1e-3, atol=1e-3)
    for rk in ranks:
        assert np.array_equal(rk["models"]["nmf"]["Q"], got["Q"])


@pytest.mark.parametrize("tag", ["als", "base", "nmf"])
def test_mesh_checkpoint_loads_and_predicts_on_one_device(cases, tag):
    _, _, ranks, _, _ = cases
    mesh, back, orig = ranks[0]["models"][f"ckpt_{tag}"]
    assert mesh is None
    np.testing.assert_array_equal(back, orig)


def test_mesh_argument_checks():
    """The mesh is accepted by ``KernelMF(method='als')``, ``BaselineModel``,
    ``NMF``, ``BPR`` and ``SVDpp``; JAX's refusals stand (``overlap_psum`` /
    ``psum_every`` with ALS, ``als_warm_start`` with a mesh)."""
    from types import SimpleNamespace

    from matrix_factorization_tpu_torch import BPR, NMF, BaselineModel, KernelMF, SVDpp

    stub = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 1))
    assert KernelMF(method="als", mesh=stub, device="cpu").mesh is stub
    assert BaselineModel(mesh=stub, device="cpu").mesh is stub
    assert NMF(mesh=stub, device="cpu").mesh is stub
    for kw, msg in (({"method": "als", "overlap_psum": True}, "overlap_psum"),
                    ({"method": "als", "psum_every": 2}, "psum_every"),
                    ({"als_warm_start": 1}, "not supported with a mesh")):
        with pytest.raises(ValueError, match=msg):
            KernelMF(mesh=stub, device="cpu", **kw)
    for cls in (BPR, SVDpp):
        assert cls(mesh=stub, device="cpu").mesh is stub


# ---------------------------------------------------------------------------
# World size 1: the single-device trainers, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, at one intra-op thread."""
    from matrix_factorization_tpu_torch.parallel import launch

    with launch.world_of_one():
        yield


def test_one_rank_is_the_single_device_trainers(world_of_one):
    """At one rank the data-parallel ALS sweep solves the same chunks in the
    same order as ``ials_train_bucketed``, ``dp_als_train`` sums what
    ``als_train`` sums and ``dp_nmf_train`` is ``nmf_train`` on the same
    pack: the same bits."""
    import torch

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import als, ials, nmf
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    u, i, r, nu, ni = _ials_ratings()
    cfg = SGDConfig(kernel="linear", n_factors=4, reg=0.2, batch_size=64)
    p0 = sgd.init_params(torch.Generator().manual_seed(1), nu, ni, cfg,
                         float(r.mean()))
    bu, bi = ials.group_both_sides_bucketed(u, i, r, nu, ni, max_block_rows=64,
                                            device="cpu")
    data = sgd.pack_ratings(u, i, r, 64, aggregate=False, device="cpu")
    got = ials.dp_ials_train_bucketed(p0, bu, bi, data, cfg, 2, mesh)
    want = ials.ials_train_bucketed(p0, bu, bi, data, cfg, 2)
    for a, b in zip((got[0].user_features, got[0].item_features, got[1]),
                    (want[0].user_features, want[0].item_features, want[1])):
        assert torch.equal(a, b)

    b0 = als.init_bias_params(nu, ni, float(r.mean()), device="cpu")
    cols = als.shard_bias_data(data, mesh)
    got, want = als.dp_als_train(b0, cols, 0.5, 3, mesh), als.als_train(
        b0, data, 0.5, 3)
    for a, b in zip((got[0].user_biases, got[0].item_biases, got[1]),
                    (want[0].user_biases, want[0].item_biases, want[1])):
        assert torch.equal(a, b)

    q0 = nmf.init_nmf_params(torch.Generator().manual_seed(2), nu, ni, cfg)
    pack = sgd.pack_ratings(u, i, r, 64, order="auto", device="cpu")
    cnt_u = torch.from_numpy(np.bincount(u, minlength=q0.user_features.shape[0])
                             .astype(np.float32))
    cnt_i = torch.from_numpy(np.bincount(i, minlength=q0.item_features.shape[0])
                             .astype(np.float32))
    got = nmf.dp_nmf_train(pdist.place_params(q0, mesh), pack, cnt_u, cnt_i,
                           cfg, 3, 0.05, 0.05, mesh)
    want = nmf.nmf_train(q0, pack, cnt_u, cnt_i, cfg, 3, 0.05, 0.05)
    for a, b in zip((got[0].user_features, got[0].item_features, got[1]),
                    (want[0].user_features, want[0].item_features, want[1])):
        assert torch.equal(a, b)
