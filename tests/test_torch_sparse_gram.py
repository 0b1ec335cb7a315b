"""The port's sparse-gram top-k similarity against the JAX package's and
against a float64 dense centered cosine, at the JAX tests' shapes (120 x
50 ratings, k = 8, user blocks of 32, strips of 16 columns)."""

import numpy as np
import pytest

from matrix_factorization_tpu.ops import sparse_gram as jsg
from matrix_factorization_tpu_torch.ops import sparse_gram as sg
from matrix_factorization_tpu_torch.parallel import launch

ATOL = 2e-4  # f32 gram and cosine against the float64 oracle


def _coo(rng, n_users, n_items, n, half_stars=False):
    flat = rng.choice(n_users * n_items, size=n, replace=False)
    u = (flat // n_items).astype(np.int32)
    i = (flat % n_items).astype(np.int32)
    r = rng.uniform(1, 5, n).astype(np.float32)
    if half_stars:
        r = (np.round(r * 2) / 2).astype(np.float32)
    return u, i, r


def _dense_centered_cosine(u, i, r, n_users, n_items):
    R = np.zeros((n_users, n_items))
    R[u, i] = r
    means = R.mean(axis=0)
    C = R - means[None, :]
    norms = np.linalg.norm(C, axis=0)
    S = (C.T @ C) / np.maximum(np.outer(norms, norms), 1e-12)
    np.fill_diagonal(S, -np.inf)
    return S, means, norms


def _assert_topk(sims, ids, S, k, atol):
    """Values within ``atol`` of the oracle's top-k; each id where its value
    is more than ``atol`` from its neighbours in the list."""
    for j in range(S.shape[1]):
        want = np.sort(S[:, j])[::-1][:k]
        np.testing.assert_allclose(sims[j], want, atol=atol)
        np.testing.assert_allclose(S[ids[j], j], sims[j], atol=atol)
        col = np.sort(S[:, j])[::-1]
        for t in range(k):
            gaps = np.abs(col - sims[j, t])
            if (gaps < 2 * atol).sum() == 1:
                assert ids[j, t] == np.argsort(-S[:, j], kind="stable")[t]


@pytest.mark.parametrize("half_stars", [False, True], ids=["uniform", "half-stars"])
def test_similarity_topk_matches_jax_and_dense_oracle(half_stars):
    rng = np.random.default_rng(11)
    n_users, n_items, n = 120, 50, 1500
    u, i, r = _coo(rng, n_users, n_items, n, half_stars)
    got = sg.similarity_topk(u, i, r, n_users, n_items, k=8, user_block=32,
                             item_tile=16, device="cpu")
    want = jsg.similarity_topk(u, i, r, n_users, n_items, k=8, user_block=32,
                               item_tile=16)
    S, means, norms = _dense_centered_cosine(u, i, r, n_users, n_items)
    sims, ids, got_means, got_norms = got
    assert sims.dtype == np.float32 and ids.dtype == np.int32
    assert sims.shape == ids.shape == (n_items, 8)
    # the means and norms are the same host bincounts as the JAX package's
    np.testing.assert_array_equal(got_means, want[2])
    np.testing.assert_array_equal(got_norms, want[3])
    np.testing.assert_allclose(got_means, means, atol=1e-5)
    np.testing.assert_allclose(got_norms, norms, atol=1e-3)
    np.testing.assert_allclose(sims, want[0], atol=1e-5)
    _assert_topk(sims, ids, S, 8, ATOL)
    # ids equal to the JAX package's wherever the values are separated
    sep = np.ones_like(sims, bool)
    sep[:, 1:] &= np.abs(np.diff(sims, axis=1)) > 1e-5
    sep[:, :-1] &= np.abs(np.diff(sims, axis=1)) > 1e-5
    np.testing.assert_array_equal(ids[sep], want[1][sep])


def test_similarity_topk_grouped_matches_per_strip():
    """Wide accumulation groups give exactly the per-strip result."""
    rng = np.random.default_rng(5)
    n_users, n_items = 90, 60
    u, i, r = _coo(rng, n_users, n_items, 1200)
    per_strip = sg.similarity_topk(u, i, r, n_users, n_items, k=6,
                                   user_block=32, item_tile=16, device="cpu")
    # 64 padded items x 4 B = 256 B a column: 16 KiB is one group of 4 strips
    grouped = sg.similarity_topk(u, i, r, n_users, n_items, k=6,
                                 user_block=32, item_tile=16,
                                 group_budget_bytes=16 << 10, device="cpu")
    for a, b in zip(per_strip, grouped):
        np.testing.assert_array_equal(a, b)


def test_similarity_topk_user_mode():
    """User-user neighbours: the same call with the axes swapped."""
    rng = np.random.default_rng(8)
    n_users, n_items = 40, 70
    u, i, r = _coo(rng, n_users, n_items, 900)
    got = sg.similarity_topk(i, u, r, n_items, n_users, k=5, user_block=16,
                             item_tile=8, device="cpu")
    want = jsg.similarity_topk(i, u, r, n_items, n_users, k=5, user_block=16,
                               item_tile=8)
    S, _, _ = _dense_centered_cosine(i, u, r, n_items, n_users)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    _assert_topk(got[0], got[1], S, 5, ATOL)


def test_buckets_are_padded_block_windows():
    """Every block's window holds its entries in user order, then pads of
    rating 0; ``max_nnz`` is a power of two."""
    rng = np.random.default_rng(2)
    u, i, r = _coo(rng, 70, 30, 500)
    ub, ib, rb, counts = sg._bucket_by_block(u, i, r, 70, 16, "cpu")
    assert ub.shape[1] & (ub.shape[1] - 1) == 0 and ub.shape[0] == 5
    order = np.argsort(u, kind="stable")
    flat_u, flat_i, flat_r = u[order], i[order], r[order]
    start = 0
    for b, c in enumerate(counts):
        np.testing.assert_array_equal(ub[b, :c].numpy(), flat_u[start:start + c] - 16 * b)
        np.testing.assert_array_equal(ib[b, :c].numpy(), flat_i[start:start + c])
        np.testing.assert_array_equal(rb[b, :c].numpy(), flat_r[start:start + c])
        assert not rb[b, c:].any() and not ib[b, c:].any()
        start += c


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, at one intra-op thread."""
    with launch.world_of_one():
        yield


@pytest.mark.parametrize("swap", [False, True], ids=["item-item", "user-user"])
def test_similarity_topk_on_one_rank_is_the_mesh_free_call(world_of_one, swap):
    """``mesh=`` on one rank: the same blocks in the same order, and an
    all-reduce over one rank changes nothing, so every output is equal to
    the mesh-free call's."""
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    u, i, r = _coo(rng, 70, 40, 900)
    args = (i, u, r, 40, 70) if swap else (u, i, r, 70, 40)
    kw = dict(k=5, user_block=16, item_tile=16, device="cpu")
    want = sg.similarity_topk(*args, **kw)
    got = sg.similarity_topk(*args, mesh=make_mesh(1), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
