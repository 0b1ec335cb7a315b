"""The PyTorch port's rating pack against the JAX package's.

The same numpy ratings go through both ``pack_ratings``; every leaf the
port keeps must be byte-equal to the JAX pack's (``np.asarray`` of it):
the ids, ratings, weights, the primary side and, where the JAX pack
keeps them (``agg_min_gain=-1.0`` forces its tile metadata on), the
secondary argsort ``sec_perm`` and the sorted ids ``sec_ids_sorted``."""

import numpy as np
import pytest
import torch

from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

ORDERS = ["shuffle", "item", "user", "block", "auto"]


def _ratings(n, n_users, n_items, seed, half_stars):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = rng.integers(0, n_items, n).astype(np.int32)
    if half_stars:
        r = (np.round(rng.uniform(0.5, 5, n) * 2) / 2).astype(np.float32)
    else:
        r = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, r


def _assert_same_pack(got, want, sorted_leaves=True):
    for name in ("user_ids", "item_ids", "ratings", "weights"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.primary == want.primary
    assert got.n_real == want.n_real
    if sorted_leaves:
        assert want.sec_perm is not None and got.sec_perm is not None
        np.testing.assert_array_equal(got.sec_perm.numpy(),
                                      np.asarray(want.sec_perm))
        np.testing.assert_array_equal(got.sec_ids_sorted.numpy(),
                                      np.asarray(want.sec_ids_sorted))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shape", [(1777, 200, 120, 256), (3001, 90, 400, 512)],
                         ids=["more-users", "more-items"])
def test_pack_equals_jax_pack(order, shape):
    """n is not a multiple of bs, so the last batch carries pads."""
    n, nu, ni, bs = shape
    u, i, r = _ratings(n, nu, ni, seed=n, half_stars=order == "block")
    want = jsgd.pack_ratings(u, i, r, bs, shuffle_seed=3, order=order,
                             agg_min_gain=-1.0)
    got = sgd.pack_ratings(u, i, r, bs, shuffle_seed=3, order=order,
                           device="cpu")
    _assert_same_pack(got, want)
    assert got.user_ids.device.type == "cpu"
    assert got.n_batches * got.batch_size >= n
    # every batch is stored sorted by its primary side, and the argsort
    # reproduces the sorted secondary ids
    prim = got.item_ids if got.primary == "item" else got.user_ids
    sec = got.user_ids if got.primary == "item" else got.item_ids
    assert bool((prim[:, 1:] >= prim[:, :-1]).all())
    assert torch.equal(torch.gather(sec, 1, got.sec_perm.long()),
                       got.sec_ids_sorted)


@pytest.mark.parametrize("kw", [
    {"order": "item", "item_sort_chunks": 3},
    {"order": "shuffle", "shuffle_seed": None},
    {"order": "block", "user_block": 32, "item_block": 64},
], ids=["chunks3", "no-shuffle", "given-blocks"])
def test_pack_options_equal_jax_pack(kw):
    u, i, r = _ratings(2500, 150, 300, seed=7, half_stars=True)
    want = jsgd.pack_ratings(u, i, r, 256, agg_min_gain=-1.0, **kw)
    got = sgd.pack_ratings(u, i, r, 256, device="cpu", **kw)
    _assert_same_pack(got, want)


def test_unaggregated_pack_keeps_stream_order():
    """``aggregate=False`` skips the per-batch sort; no argsort is kept."""
    u, i, r = _ratings(1000, 50, 60, seed=1, half_stars=False)
    want = jsgd.pack_ratings(u, i, r, 128, order="user", aggregate=False)
    got = sgd.pack_ratings(u, i, r, 128, order="user", aggregate=False,
                           device="cpu")
    _assert_same_pack(got, want, sorted_leaves=False)
    assert got.sec_perm is None and got.sec_ids_sorted is None


def test_tiny_and_empty_packs():
    u, i, r = _ratings(3, 5, 5, seed=2, half_stars=True)
    for n in (0, 1, 3):
        want = jsgd.pack_ratings(u[:n], i[:n], r[:n], 8)
        got = sgd.pack_ratings(u[:n], i[:n], r[:n], 8, device="cpu")
        for name in ("user_ids", "item_ids", "ratings", "weights"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert got.n_real == n and got.weights.sum().item() == n


def test_multi_device_pack_names_its_slice():
    """The device-major pack is ported (tests/test_torch_parallel_pack.py
    holds it to JAX's); like JAX's it needs ``users_per_dev`` and refuses
    the single-device ``block`` layout, and an unknown order raises."""
    u, i, r = _ratings(100, 10, 10, seed=0, half_stars=True)
    with pytest.raises(ValueError, match="users_per_dev"):
        sgd.pack_ratings(u, i, r, 16, n_dev=2, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        sgd.pack_ratings(u, i, r, 16, n_dev=2, users_per_dev=8,
                         order="block", device="cpu")
    got = sgd.pack_ratings(u, i, r, 16, n_dev=2, users_per_dev=8,
                           device="cpu")
    assert got.n_batches % 2 == 0 and got.weights.sum().item() == 100
    with pytest.raises(ValueError, match="order"):
        sgd.pack_ratings(u, i, r, 16, order="diagonal", device="cpu")


def test_block_geometry_matches():
    for args in ((162_000, 59_392, 25_000_000, 2_097_152),
                 (10_000, 20_000, 2_000_000, 131_072), (50, 40, 100, 8)):
        assert sgd.block_geometry(*args) == jsgd.block_geometry(*args)
