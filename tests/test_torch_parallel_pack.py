"""The multi-device host plumbing of the PyTorch port against the JAX
package's, in one process (no world of ranks):

* the device-major pack (``pack_ratings(n_dev > 1, users_per_dev=...)``)
  byte-equal to JAX's for 2, 4 and 8 devices in every order, through the
  native host library and through numpy;
* ``shard_ratings_by_user`` and ``shard_ratings_2d`` equal to JAX's;
* ``_check_psum_every`` accepting and refusing the same values with the
  same messages;
* ``make_mesh`` / ``make_multislice_mesh`` refusing a shape that is not
  the world's, and the one-rank world (gloo, in this process) training
  as the single-device trainer and serving as the single-device top-k.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu.parallel import distributed as jdist
from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import scoring
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
from matrix_factorization_tpu_torch.parallel import distributed as pdist
from matrix_factorization_tpu_torch.parallel import launch
from matrix_factorization_tpu_torch.parallel import mesh as pmesh
from matrix_factorization_tpu_torch.parallel.serving import ShardedCatalog


def _ratings(n=3000, n_users=301, n_items=97, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = rng.integers(0, n_items, n).astype(np.int32)
    r = (np.round(rng.uniform(0.5, 5, n) * 2) / 2).astype(np.float32)
    return u, i, r, n_users, n_items


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("order", ["shuffle", "item", "user", "auto"])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_device_major_pack_is_jax_pack(n_dev, order, native):
    u, i, r, n_users, _ = _ratings(seed=n_dev)
    ucap = sgd.round_up(n_users, 8 * n_dev)
    for bs, seed in ((64, 0), (256, 7)):
        want = jsgd.pack_ratings(u, i, r, bs, shuffle_seed=seed, order=order,
                                 n_dev=n_dev, users_per_dev=ucap // n_dev,
                                 agg_min_gain=-1.0)
        got = sgd.pack_ratings(u, i, r, bs, shuffle_seed=seed, order=order,
                               n_dev=n_dev, users_per_dev=ucap // n_dev,
                               device="cpu", native=native)
        for name in ("user_ids", "item_ids", "ratings", "weights"):
            a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.primary == want.primary and got.n_real == want.n_real
        # JAX keeps the secondary argsort only where its tile cost model
        # takes it; where it does not, the argsort of its secondary ids
        sec = np.asarray(want.user_ids if want.primary == "item"
                         else want.item_ids)
        perm = np.argsort(sec, axis=1, kind="stable").astype(np.int32)
        if want.sec_perm is not None:
            np.testing.assert_array_equal(np.asarray(want.sec_perm), perm)
        np.testing.assert_array_equal(got.sec_perm.numpy(), perm)
        np.testing.assert_array_equal(got.sec_ids_sorted.numpy(),
                                      np.take_along_axis(sec, perm, axis=1))
        assert got.n_batches % n_dev == 0
        # device d's segment holds only its users, with local ids
        nb = got.n_batches // n_dev
        w = got.weights.numpy().reshape(n_dev, nb, bs)
        assert w.sum() == len(r)
        assert got.user_ids.numpy().max() < ucap // n_dev


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("order", ["shuffle", "item", "user", "auto"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_one_segment_pack_is_its_slice_of_the_whole(n_dev, order, native):
    """``pack_ratings(segment=d)`` is device d's batches of the whole
    device-major pack, byte for byte: what each rank of a fit packs."""
    u, i, r, n_users, _ = _ratings(n=5000, seed=n_dev + 20)
    ucap = sgd.round_up(n_users, 8 * n_dev)
    kw = dict(shuffle_seed=5, order=order, n_dev=n_dev,
              users_per_dev=ucap // n_dev, device="cpu", native=native)
    whole = sgd.pack_ratings(u, i, r, 128, **kw)
    nb = whole.n_batches // n_dev
    for d in range(n_dev):
        part = sgd.pack_ratings(u, i, r, 128, segment=d, **kw)
        assert part.n_batches == nb and part.n_real == whole.n_real == len(r)
        assert part.primary == whole.primary
        for name in ("user_ids", "item_ids", "ratings", "weights",
                     "sec_perm", "sec_ids_sorted"):
            assert torch.equal(getattr(part, name),
                               getattr(whole, name)[d * nb:(d + 1) * nb]), name
    with pytest.raises(ValueError, match="not a device"):
        sgd.pack_ratings(u, i, r, 128, segment=n_dev, **kw)


def test_native_and_numpy_device_major_packs_are_byte_equal():
    u, i, r, n_users, _ = _ratings(n=20_000, n_users=5000, n_items=300, seed=3)
    for order in ("shuffle", "item", "user"):
        a, b = (sgd.pack_ratings(u, i, r, 512, shuffle_seed=11, order=order,
                                 n_dev=4, users_per_dev=1280, device="cpu",
                                 native=native) for native in (True, False))
        for name in ("user_ids", "item_ids", "ratings", "weights",
                     "sec_perm", "sec_ids_sorted"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_device_major_pack_with_an_empty_device():
    """A device whose user range holds no rating is all weight-0 pads."""
    u, i, r, _, _ = _ratings(n=500, n_users=40, n_items=20, seed=1)
    want = jsgd.pack_ratings(u, i, r, 32, n_dev=4, users_per_dev=16,
                             agg_min_gain=-1.0)
    got = sgd.pack_ratings(u, i, r, 32, n_dev=4, users_per_dev=16,
                           device="cpu")
    for name in ("user_ids", "item_ids", "ratings", "weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.weights.numpy().reshape(4, -1)[3].sum() == 0


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (2, 2), (8, 1), (2, 4)])
def test_shard_ratings_match_jax(shape, native):
    u, i, r, n_users, n_items = _ratings(seed=sum(shape))
    n_data, n_model = shape
    ucap = sgd.round_up(n_users, 8 * n_data)
    icap = sgd.round_up(n_items, 8 * n_model)
    for bs in (1, 16, 100):
        if n_model == 1:
            want = jdist.shard_ratings_by_user(u, i, r, ucap, n_data, bs)
            got = pdist.shard_ratings_by_user(u, i, r, ucap, n_data, bs,
                                              native)
        else:
            want = jdist.shard_ratings_2d(u, i, r, ucap, icap, n_data,
                                          n_model, bs)
            got = pdist.shard_ratings_2d(u, i, r, ucap, icap, n_data,
                                         n_model, bs, native)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[4] == want[4]


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (2, 2, 1)])
def test_dp_fit_plumbing_matches_jax(shape):
    """The capacity, batch size and user-range split that every data-
    parallel fit starts from, as JAX's ``dp_fit_plumbing`` makes them on
    a mesh of the same data size (the port reads only the mesh's axis
    names and sizes)."""
    from types import SimpleNamespace

    from matrix_factorization_tpu.parallel.mesh import make_mesh, make_multislice_mesh

    names = ("slice", "data", "model") if len(shape) == 3 else ("data", "model")
    stub = SimpleNamespace(mesh_dim_names=names, shape=shape)
    jm = (make_multislice_mesh(*shape) if len(shape) == 3
          else make_mesh(n_data=shape[0], n_model=shape[1]))
    u, i, r, n_users, _ = _ratings(seed=4)
    for bs in (64, 10_000):
        ucap, b, arrays = pdist.dp_fit_plumbing(u, i, r, n_users, stub, bs)
        jcap, jb, jarrays, _, _ = jdist.dp_fit_plumbing(u, i, r, n_users, jm, bs)
        assert (ucap, b) == (jcap, jb)
        for a, w in zip(arrays, jarrays):
            np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("nb", [1, 6, 12, 14, 17, 32])
def test_check_psum_every_matches_jax(nb):
    for value in (1, 2, 3, 4, 7, 16, "auto", "epoch", 0, -2, 2.0, "4",
                  None, True):
        try:
            want = jdist._check_psum_every(value, nb)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                pdist._check_psum_every(value, nb)
            assert str(got.value) == str(e)
        else:
            assert pdist._check_psum_every(value, nb) == want


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, at one intra-op thread."""
    with launch.world_of_one():
        yield


def test_make_mesh_needs_the_world_and_its_size(world_of_one):
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        pmesh.make_mesh(n_data=2)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        pmesh.make_mesh(n_data=1, n_model=2)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        pmesh.make_multislice_mesh(n_slices=2, n_data=1)
    m = pmesh.make_mesh()
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    assert pmesh.data_size_of(m) == 1 and pmesh.device_index(m) == 0
    ms = pmesh.make_multislice_mesh(n_slices=1)
    assert pmesh.data_axes_of(ms) == ("slice", "data")
    assert pmesh.model_index(ms) == 0


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.make_mesh()


@pytest.mark.parametrize("layout,order", [("flat", "shuffle"),
                                          ("tiled", "shuffle"),
                                          ("tiled", "user")])
def test_one_rank_trains_as_one_device(world_of_one, layout, order):
    """At world size 1 and ``psum_every=1`` the data-parallel fit is
    ``sgd_train`` on the same pack, tables and orders (the deltas of the
    window table land in the same rows: 1e-6)."""
    u, i, r, n_users, n_items = _ratings(n=4000, n_users=300, n_items=200)
    cfg = SGDConfig(kernel="sigmoid", n_factors=8, lr=0.05, reg=0.01,
                    batch_size=512, shuffle="full" if layout == "flat"
                    else "batch")
    ucap = sgd.round_up(n_users, 8)
    p0 = sgd.init_params(torch.Generator().manual_seed(0), n_users, n_items,
                         cfg, float(r.mean()), user_capacity=ucap)
    mesh = pmesh.make_mesh()
    if layout == "flat":
        su, si, sr, sw, n_pad = pdist.shard_ratings_by_user(u, i, r, ucap, 1,
                                                            512)
        rng = np.random.default_rng(5)
        orders = [rng.permutation(n_pad) for _ in range(2)]
        data = pdist.local_ratings((su, si, sr, sw), 0, 1, "cpu")
        got, hist = pdist.dp_sgd_train(
            pdist.place_params(p0, mesh), data, cfg, 2, 0.05, mesh, len(r),
            orders=[[o] for o in orders])
        one = sgd.RatingBatches(*(t.reshape(-1, 512) for t in data), len(r),
                                primary="user")
    else:
        one = sgd.pack_ratings(u, i, r, 512, shuffle_seed=0, order=order,
                               device="cpu")
        rng = np.random.default_rng(5)
        orders = [rng.permutation(one.n_batches) for _ in range(2)]
        got, hist = pdist.dp_fit(u, i, r, n_users, n_items, cfg, 2, 0.05,
                                 mesh, layout=layout, pack_order=order,
                                 params=p0, orders=[[o] for o in orders],
                                 device="cpu")
    want, whist = sgd.sgd_train(p0, one, None, cfg, 2, 0.05,
                                batch_orders=orders)
    np.testing.assert_allclose(got.user_features.numpy(),
                               want.user_features.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.item_features.numpy(),
                               want.item_features.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(hist), whist.numpy(), rtol=1e-6)


def test_one_rank_catalog_is_the_single_device_top_k(world_of_one):
    cfg = SGDConfig(kernel="sigmoid", n_factors=8)
    rng = np.random.default_rng(2)
    kp = cfg.padded_factors
    P = np.zeros((16, kp), np.float32)
    Q = np.zeros((72, kp), np.float32)
    P[:, :8] = rng.normal(0, 0.5, (16, 8))
    Q[:, :8] = rng.normal(0, 0.5, (72, 8))
    Q[:10] = Q[10:20]  # ties across rows
    params = sgd.params_from_numpy(P, Q, 3.1, device="cpu")
    cat = ShardedCatalog(params, 70, cfg, pmesh.make_mesh())
    ud = np.arange(11, dtype=np.int32)
    vals, idx = cat.topk(P[ud], 12)
    wv, wi = scoring.catalog_topk(cfg, params, 70, ud, 12)
    np.testing.assert_array_equal(idx, wi)
    np.testing.assert_array_equal(vals, wv)
    gathered = pdist.gather_params(params, pmesh.make_mesh(), q_sharded=True)
    assert torch.equal(gathered.user_features, params.user_features)
    assert torch.equal(gathered.item_features, params.item_features)

