"""The port's retrieval (encoder, indexes, search, batched TF-IDF) against
the JAX package's on the same inputs.

Tolerances: ``hash_embed`` byte-equal; dense similarities within 1e-6 (an
f32 product in another summation order); batched TF-IDF within 1e-6 of
JAX at ``vocab_block=8``. Positions equal on tie-free scores; on ties the
port's stated rule (score descending, then position ascending)."""

import numpy as np
import pytest
import torch

from matrix_factorization_tpu.retrieval import encode as jencode
from matrix_factorization_tpu.retrieval import index as jindex
from matrix_factorization_tpu.retrieval import search as jsearch
from matrix_factorization_tpu.retrieval import sparse_scoring as jsparse
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.retrieval import encode, index, search, sparse_scoring

TEXTS = [
    "title: grilled chicken salad\ningredients: chicken breast; lettuce; olive oil\ndirections: grill chicken 10-15 minutes and toss",
    "title: peanut butter cookies\ningredients: peanut butter; sugar; flour; eggs\ndirections: bake 12 minutes",
    "title: creamy salmon pasta\ningredients: salmon; cream; pasta; cheese\ndirections: cook pasta 1 hour",
    "title: tofu stir fry\ningredients: tofu; soy sauce; broccoli\ndirections: fry tofu 5 minutes",
    "title: walnut brownies\ningredients: walnut; chocolate; butter; sugar\ndirections: bake 30 minutes",
]
IDS = ["a", "b", "c", "d", "e"]
QUERIES = ["grilled chicken salad", "peanut butter", "tofu broccoli",
           "chocolate walnut", "salmon pasta with cream cheese"]


def _separated(vals, tol=1e-6):
    """Rows whose score differs by more than ``tol`` from both neighbours
    (JAX's order among ties is arbitrary)."""
    gap = np.abs(np.diff(np.asarray(vals, np.float64))) > tol
    return np.concatenate([gap, [True]]) & np.concatenate([[True], gap])


def _assert_rows_match(got_ids, got_vals, want_ids, want_vals):
    """``want`` may hold one row past the cut, which tells whether the
    last row ties with a row left out."""
    k = len(got_ids)
    np.testing.assert_allclose(got_vals, want_vals[:k], atol=1e-6)
    sep = _separated(want_vals)[:k]
    if len(want_vals) == k and k:
        sep[-1] = False  # unknown: the next row may tie at the cut
    got = np.asarray(got_ids, object)
    assert (got == np.asarray(want_ids[:k], object))[sep].all()


def _corpus(n=41):
    ids = [f"d{i}" for i in range(n)]
    texts = [f"recipe {i} protein p{i % 7} veg v{i % 5} method m{i % 3}"
             for i in range(n)]
    return ids, texts


@pytest.mark.parametrize("dim", [64, 512])
def test_hash_embed_byte_equal(dim):
    texts = TEXTS + ["", "红烧 肉 braised pork", "a a a b", "x" * 300]
    got = encode.hash_embed(texts, dim=dim)
    want = jencode.hash_embed(texts, dim=dim)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert encode.embed_texts(texts, model_name="hash", dim=dim).tobytes() \
        == want.tobytes()


def _build(kind, pkg):
    if kind == "tfidf":
        return pkg.build_tfidf_index(IDS, TEXTS, min_df=1)
    return pkg.build_dense_index(IDS, TEXTS, jencode.hash_embed(TEXTS, dim=64))


@pytest.mark.parametrize("kind", ["dense", "tfidf"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_pickles_cross(tmp_path, kind, direction):
    """An index written by either package loads in the other, with equal
    contents and equal search results."""
    src, dst = (jindex, index) if direction == "jax_to_port" else (index, jindex)
    built = _build(kind, src)
    src.save_item_index(built, tmp_path / "ix.pkl")
    loaded = dst.load_item_index(tmp_path / "ix.pkl")
    assert loaded.item_ids == IDS and loaded.texts == TEXTS
    if kind == "dense":
        assert isinstance(loaded, dst.DenseItemIndex)
        np.testing.assert_array_equal(loaded.embeddings, built.embeddings)
    else:
        assert isinstance(loaded, dst.TfidfItemIndex)
        assert (loaded.matrix != built.matrix).nnz == 0
    port_ix = loaded if dst is index else built
    jax_ix = built if dst is index else loaded
    for q in QUERIES:
        got = search.search_topk(
            port_ix, search.encode_query_for_index(port_ix, q), 3, device="cpu")
        want = jsearch.search_topk(jax_ix, jsearch.encode_query_for_index(jax_ix, q), 4)
        _assert_rows_match([g[0] for g in got], [g[1] for g in got],
                           [w[0] for w in want], [w[1] for w in want])


@pytest.mark.parametrize("k", [1, 5, 41, 60])
def test_dense_search_matches_jax(k):
    ids, texts = _corpus()
    emb = jencode.hash_embed(texts, dim=64)
    pix = index.build_dense_index(ids, texts, emb)
    jix = jindex.build_dense_index(ids, texts, emb)
    qs = ["protein p3 veg v1", "method m2", "recipe 11", "veg v4 protein p6"]
    Q = np.stack([search.encode_query_for_index(pix, q) for q in qs])
    np.testing.assert_array_equal(
        Q, np.stack([jsearch.encode_query_for_index(jix, q) for q in qs]))
    vals, pos = search.search_topk_batch(pix, Q, k, device="cpu")
    jv, jp = jsearch.search_topk_batch(jix, Q, k + 1)
    for r in range(len(qs)):
        _assert_rows_match(pos[r], vals[r], jp[r], jv[r])
        rows = search.search_topk_pos(pix, Q[r], k, device="cpu")
        jrows = jsearch.search_topk_pos(jix, Q[r], k + 1)
        _assert_rows_match([x[0] for x in rows], [x[2] for x in rows],
                           [x[0] for x in jrows], [x[2] for x in jrows])
        assert [x[1] for x in rows] == [ids[x[0]] for x in rows]
        # the rule among the returned rows: equal scores by position
        assert all((a > b) or (a == b and pa < pb) for a, b, pa, pb in zip(
            vals[r][:-1], vals[r][1:], pos[r][:-1], pos[r][1:]))
    assert search.search_topk(pix, Q[0], 0, device="cpu") == []


def test_tie_rule_keeps_lower_positions():
    """Duplicate embeddings tie exactly: the port keeps them in position
    order, at the cut too (JAX's unstable argsort states no order)."""
    rng = np.random.default_rng(3)
    # small dyadic entries: every product and sum is exact in f32, in any
    # summation order, so duplicate rows tie bit for bit
    base = rng.integers(-4, 5, size=(6, 16)).astype(np.float32) / 8
    emb = base[[0, 1, 0, 2, 1, 0, 3, 4, 5, 0]]  # row 0 four times, 1 twice
    ids = [f"x{i}" for i in range(len(emb))]
    pix = index.build_dense_index(ids, ids, emb, normalize=False)
    for qrow in (0, 1, 3):
        q = emb[qrow]
        s = emb @ q
        for k in (1, 2, 3, 5, 10):
            want = sorted(range(len(ids)), key=lambda p: (-s[p], p))[:k]
            got = [r[0] for r in search.search_topk_pos(pix, q, k, device="cpu")]
            assert got == want
            _, bpos = search.search_topk_batch(pix, q[None], k, device="cpu")
            assert bpos[0].tolist() == want
            assert stable_topk(torch.from_numpy(s), k)[1].tolist() == want
    # negative zero ties positive zero
    t = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]])
    assert stable_topk(t, 4)[1].tolist() == [[2, 0, 1, 3]]


def test_tfidf_single_query_matches_jax():
    pix = index.build_tfidf_index(IDS, TEXTS, min_df=1)
    jix = jindex.build_tfidf_index(IDS, TEXTS, min_df=1)
    for q in QUERIES:
        rows = search.search_topk_pos(pix, search.encode_query_for_index(pix, q), 4)
        jrows = jsearch.search_topk_pos(jix, jsearch.encode_query_for_index(jix, q), 4)
        _assert_rows_match([r[0] for r in rows], [r[2] for r in rows],
                           [r[0] for r in jrows], [r[2] for r in jrows])


@pytest.mark.parametrize("vocab_block", [8, 16, 4096])
def test_tfidf_batch_matches_jax_and_scipy(vocab_block):
    pix = index.build_tfidf_index(IDS, TEXTS, min_df=1)
    got = sparse_scoring.tfidf_batch_scores(pix, QUERIES, vocab_block=vocab_block,
                                            device="cpu")
    want = jsparse.tfidf_batch_scores(pix, QUERIES, vocab_block=min(vocab_block, 8))
    np.testing.assert_allclose(got, want, atol=1e-6)
    scipy_ref = np.vstack([
        np.asarray((pix.matrix @ pix.vectorizer.transform([q]).T).todense()).ravel()
        for q in QUERIES])
    np.testing.assert_allclose(got, scipy_ref, atol=1e-6)
    vals, pos = sparse_scoring.tfidf_batch_topk(pix, QUERIES, k=2,
                                                vocab_block=vocab_block,
                                                device="cpu")
    jv, jp = jsparse.tfidf_batch_topk(pix, QUERIES, k=2, vocab_block=8)
    np.testing.assert_allclose(vals, jv, atol=1e-6)
    assert [IDS[p] for p in pos[:3, 0]] == ["a", "b", "d"]
    for r in range(len(QUERIES)):
        want = sorted(range(len(IDS)), key=lambda p: (-got[r, p], p))[:2]
        assert pos[r].tolist() == want


def test_tfidf_block_write_is_exact():
    """The densified blocks hold the matrix's entries bit for bit: the
    batch scores of one-hot queries are the matrix's columns."""
    pix = index.build_tfidf_index(IDS, TEXTS, min_df=1)
    vocab = pix.vectorizer.get_feature_names_out()
    got = sparse_scoring.tfidf_batch_scores(pix, list(vocab[:12]), vocab_block=8,
                                            device="cpu")
    onehot = pix.vectorizer.transform(list(vocab[:12]))
    want = (pix.matrix @ onehot.T).toarray().T.astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_tfidf_batch_sums_duplicate_entries_as_jax():
    """A non-canonical CSR (each entry split into two duplicates, columns
    unsorted, as a CSR built from ``(data, indices, indptr)`` may be):
    the duplicates add up, as JAX's ``.at[].add`` and scipy's product add
    them, within 1e-6; the caller's matrix is left as it was."""
    import scipy.sparse as sp

    pix = index.build_tfidf_index(IDS, TEXTS, min_df=1)
    m = pix.matrix.tocsr()
    data, cols, indptr = [], [], [0]
    for r in range(m.shape[0]):
        lo, hi = m.indptr[r], m.indptr[r + 1]
        c, v = m.indices[lo:hi][::-1], m.data[lo:hi][::-1]
        data += [*(0.25 * v), *(0.75 * v)]
        cols += [*c, *c]
        indptr.append(len(cols))
    dup = sp.csr_matrix((np.asarray(data), np.asarray(cols, np.int32),
                         np.asarray(indptr)), shape=m.shape)
    assert not dup.has_canonical_format
    dix = index.TfidfItemIndex(item_ids=IDS, texts=TEXTS,
                               vectorizer=pix.vectorizer, matrix=dup)
    got = sparse_scoring.tfidf_batch_scores(dix, QUERIES, vocab_block=8,
                                            device="cpu")
    want = jsparse.tfidf_batch_scores(dix, QUERIES, vocab_block=8)
    np.testing.assert_allclose(got, want, atol=1e-6)
    ref = (dup @ pix.vectorizer.transform(QUERIES).T).toarray().T
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert not dup.has_canonical_format and dup.nnz == 2 * m.nnz


def test_mesh_raises_and_names_slice_6():
    """``mesh=`` is accepted by the four entry points (the item-sharded
    search, ``tests/test_torch_parallel_retrieval.py``): on a mesh of one
    rank (a gloo world of this process alone) each gives its mesh-free
    result, bit for bit."""
    from matrix_factorization_tpu_torch.parallel.launch import world_of_one
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    ids, texts = _corpus(8)
    pix = index.build_dense_index(ids, texts, jencode.hash_embed(texts, dim=16))
    tix = index.build_tfidf_index(IDS, TEXTS, min_df=1)
    q = pix.embeddings[0]
    calls = (lambda m: search.search_topk(pix, q, 2, mesh=m, device="cpu"),
             lambda m: search.search_topk_pos(pix, q, 2, mesh=m, device="cpu"),
             lambda m: search.search_topk_batch(pix, q[None], 2, mesh=m,
                                                device="cpu"),
             lambda m: sparse_scoring.tfidf_batch_topk(tix, QUERIES, 2, mesh=m,
                                                       device="cpu"))
    want = [call(None) for call in calls]
    with world_of_one():
        mesh = make_mesh(1)
        got = [call(mesh) for call in calls]
    assert got[0] == want[0] and got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_device_none_raises_without_gpu():
    """``device=None`` means CUDA: without a GPU the dense search raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    ids, texts = _corpus(8)
    pix = index.build_dense_index(ids, texts, jencode.hash_embed(texts, dim=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.search_topk(pix, pix.embeddings[0], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse_scoring.tfidf_batch_topk(index.build_tfidf_index(IDS, TEXTS, min_df=1),
                                        ["x"], 2)


def test_device_copy_cached_per_index_and_device():
    ids, texts = _corpus(8)
    pix = index.build_dense_index(ids, texts, jencode.hash_embed(texts, dim=16))
    a = search.device_embeddings(pix, "cpu")
    assert search.device_embeddings(pix, torch.device("cpu")) is a
    other = index.build_dense_index(ids, texts, pix.embeddings)
    assert search.device_embeddings(other, "cpu") is not a
    n = len(search._device_cache)
    del other
    import gc

    gc.collect()
    assert len(search._device_cache) == n - 1  # weak-keyed: dies with its index
