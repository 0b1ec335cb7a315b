"""The port's deterministic segment sum and secondary apply on the CPU.

``ops/segment_sum.py``: the plain version (``index_add_`` over a stable
sort) against a float64 ``np.add.at`` (atol 1e-4, rtol 1e-5: f32 sums of
up to ~700 terms of size ~1, whose running sums reach ~70), and
``segmented_segment_sum`` (the CUDA kernels' summation: pieces of
``CHUNK`` entries, in the entries layout cut further into lane slices of
``SLICE``, each from zero in entry order, the slice pieces of a run in
lane order, then the pieces of a run in chunk order) against the plain
version at rtol 1e-6 of the row's absolute sum (``|out| + sum |vals|``:
the two orders round differently where a sum cancels), and bitwise
against ``_emulate``, a lane-by-lane float32 replay of what the kernels
of ``csrc/segment_sum.cu`` do. The kernels themselves run in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from matrix_factorization_tpu_torch.ops import cuda_sgd
from matrix_factorization_tpu_torch.ops import segment_sum as ss


def _stream(case, n_rows, d, seed=0):
    """(ids, vals) of one case: uniform ids; ids with empty segments and
    one segment longer than the chunk; one id only; nothing."""
    rng = np.random.default_rng(seed)
    if case == "uniform":
        ids = rng.integers(0, n_rows, 3000)
    elif case == "long_and_empty":
        # every third row empty, row 1 holds 2.5 chunks and more
        ids = np.concatenate([rng.integers(0, n_rows // 3, 900) * 3,
                              np.full(5 * ss.CHUNK // 2 + 17, 1)])
        rng.shuffle(ids)
    elif case == "one_id":
        ids = np.full(ss.CHUNK * 3 + 5, n_rows - 1)
    else:
        ids = np.zeros(0, np.int64)
    vals = rng.normal(size=(len(ids), d)).astype(np.float32)
    return torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(vals)


def _oracle(ids, vals, n_rows):
    want = np.zeros((n_rows, vals.shape[1]))
    np.add.at(want, ids.numpy(), vals.numpy().astype(np.float64))
    return want


CASES = ["uniform", "long_and_empty", "one_id", "empty"]


@pytest.mark.parametrize("d", [1, 3, 18])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_float64(case, d):
    ids, vals = _stream(case, 60, d)
    out = torch.zeros(60, d)
    ss.segment_sum(out, vals, *ss.sorted_order(ids))
    np.testing.assert_allclose(out.numpy(), _oracle(ids, vals, 60),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("chunk", [1, 7, 32, ss.CHUNK])
@pytest.mark.parametrize("d", [1, 18])
@pytest.mark.parametrize("case", CASES)
def test_pieces_in_chunk_order_match_index_add(case, d, chunk):
    """The kernel's summation, modelled in plain PyTorch, from a non-zero
    ``out`` (a sum adds to what the row holds)."""
    ids, vals = _stream(case, 60, d, seed=1)
    base = torch.from_numpy(
        np.random.default_rng(2).normal(size=(60, d)).astype(np.float32))
    order = ss.sorted_order(ids)
    want = base.clone()
    ss.plain_segment_sum(want, vals, *order)
    got = base.clone()
    ss.segmented_segment_sum(got, vals, *order, chunk=chunk, layout="columns")
    scale = base.abs().double()
    ss.plain_segment_sum(scale, vals.abs().double(), *order)
    assert torch.all((got - want).abs().double() <= 1e-6 * scale)
    if chunk == 1:
        # one entry a piece: the pieces add in entry order from zero, as
        # one piece a run does
        whole = base.clone()
        ss.segmented_segment_sum(whole, vals, *order, chunk=10**9,
                                 layout="columns")
        assert torch.equal(whole, got)


def test_one_column_views_and_segment_sums():
    ids, vals = _stream("long_and_empty", 60, 1)
    order = ss.sorted_order(ids)
    flat = ss.segment_sums(vals[:, 0], order, 60)
    assert flat.shape == (60,)
    np.testing.assert_allclose(flat.numpy(), _oracle(ids, vals, 60)[:, 0],
                               atol=1e-4, rtol=1e-5)
    wide = ss.segment_sums(vals, order, 60)
    assert torch.equal(wide[:, 0], flat)
    with pytest.raises(ValueError, match="must be"):
        ss.plain_segment_sum(torch.zeros(60, 2), vals, *order)


def test_sorted_order_is_stable():
    ids = torch.tensor([3, 1, 3, 0, 1, 3, 0], dtype=torch.int64)
    perm, srt = ss.sorted_order(ids)
    assert perm.dtype == srt.dtype == torch.int32
    assert srt.tolist() == [0, 0, 1, 1, 3, 3, 3]
    assert perm.tolist() == [3, 6, 1, 4, 0, 2, 5]  # equal ids keep input order
    perm2, _ = ss.sorted_order(ids.view(7, 1))
    assert torch.equal(perm2, perm)


def test_routing_by_device_and_kernel_wrapper_refuses_cpu():
    ids, vals = _stream("uniform", 60, 3)
    order = ss.sorted_order(ids)
    with pytest.raises(ValueError, match="CUDA"):
        ss.cuda_segment_sum(torch.zeros(60, 3), vals, *order)
    with pytest.raises(ValueError, match="no segment sum"):
        ss.segment_sum(torch.zeros(60, 3, device="meta"), vals, *order)
    before = ss.launches
    ss.segment_sum(torch.zeros(60, 3), vals, *order)
    assert ss.launches == before  # the CPU path launches nothing


# ---------------------------------------------------------------------------
# The kernels' order, replayed lane by lane
# ---------------------------------------------------------------------------


def _emulate(out, vals, perm, ids, chunk, lane_len):
    """What ``csrc/segment_sum.cu`` does, in float32 numpy, one lane at a
    time: chunks of ``chunk`` entries, lanes of ``lane_len`` entries
    (``SLICE`` for the entries layout; ``chunk``, one walk in entry order,
    for the columns layout and the apply). A lane adds each run-piece of
    its entries from zero; the lane holding a run's first entry in the
    chunk adds from zero its last piece and the first pieces of the later
    lanes that begin with the run, in lane order; a run crossing a chunk
    boundary parks its piece in slot 2c (the piece begins the chunk) or
    2c + 1, and the finishing pass adds a run's pieces from zero in chunk
    order. Returns the new ``out``."""
    out = out.copy()
    n, f32 = len(ids), np.float32
    zero = np.zeros(out.shape[1], f32)
    x_all = vals[perm]
    n_chunks = -(-n // chunk)
    scratch = {}
    for c in range(n_chunks):
        lo, hi = c * chunk, min(c * chunk + chunk, n)
        first_id, last_id = ids[lo], ids[hi - 1]
        cross_in = lo > 0 and ids[lo - 1] == first_id
        cross_out = hi < n and ids[hi] == last_id

        def emit(rid, acc):
            if rid == first_id and cross_in:
                scratch[2 * c] = acc
            elif rid == last_id and cross_out:
                scratch[2 * c + (0 if rid == first_id else 1)] = acc
            else:
                out[rid] = out[rid] + acc

        lanes = []  # (first id, first piece, last id, last piece, head)
        for j0 in range(lo, hi, lane_len):
            e = ids[j0:min(j0 + lane_len, hi)]
            pieces, acc = [], zero.copy()
            for k in range(len(e)):
                if k and e[k] != e[k - 1]:
                    pieces.append((e[k - 1], acc))
                    acc = zero.copy()
                acc = acc + x_all[j0 + k]
            pieces.append((e[-1], acc))
            head = j0 == lo or ids[j0 - 1] != e[0]
            if len(pieces) > 1 and head:
                emit(*pieces[0])
            for rid, acc in pieces[1:-1]:  # runs wholly inside the lane
                emit(rid, acc)
            lanes.append((e[0], pieces[0][1], e[-1], pieces[-1][1],
                          len(pieces) > 1 or head))
        for l, (_, _, rid, acc, head) in enumerate(lanes):
            if not head:
                continue
            tot = zero + acc
            for f, p_first, _, _, _ in lanes[l + 1:]:
                if f == rid:
                    tot = tot + p_first
            emit(rid, tot)
    for c in range(n_chunks - 1):
        lo, hi = c * chunk, c * chunk + chunk
        rid = ids[hi - 1]
        if ids[hi] != rid or (c > 0 and ids[lo - 1] == rid):
            continue
        acc = zero + scratch[2 * c if ids[lo] == rid else 2 * c + 1]
        q = c + 1
        while q < n_chunks and ids[q * chunk] == rid:
            acc = acc + scratch[2 * q]
            q += 1
        out[rid] = out[rid] + acc
    return out


def _layout_stream(case, rng):
    """Sorted ids that put runs where the entries layout has to decide:
    inside one lane's slice of 8, across slices, across chunks, over a
    whole chunk; one entry; n a multiple of neither 8 nor 256."""
    C = ss.CHUNK
    if case == "run_in_one_lane":  # 3 + 1 + 4 fills each slice
        ids = np.repeat(np.arange(300), np.tile([3, 1, 4], 100))
    elif case == "run_across_lanes":  # runs of 13 from entry 5
        ids = np.r_[np.zeros(5, np.int64), np.repeat(np.arange(1, 81), 13)]
    elif case == "run_across_chunks":  # 600 entries from entry 100
        ids = np.r_[np.repeat(np.arange(20), 5), np.full(600, 20),
                    np.repeat(np.arange(21, 61), 7)]
    elif case == "whole_chunk_one_id":  # chunk 1 alone; chunks 2-3 and on
        ids = np.r_[np.sort(rng.integers(0, 50, C)), np.full(C, 50),
                    np.full(2 * C + 40, 51), np.arange(52, 70)]
    elif case == "n_1":
        ids = np.array([7])
    else:  # ragged: n = 2 * 256 + 13
        ids = np.sort(rng.integers(0, 90, 2 * C + 13))
    return ids


LAYOUT_CASES = ["run_in_one_lane", "run_across_lanes", "run_across_chunks",
                "whole_chunk_one_id", "n_1", "ragged"]


@pytest.mark.parametrize("d", [1, 18])
@pytest.mark.parametrize("case", LAYOUT_CASES)
@pytest.mark.parametrize("layout", ["entries", "columns"])
def test_layout_model_matches_index_add_float64_and_the_kernels(layout, case,
                                                                 d):
    """Each layout's order: bitwise the lane-by-lane replay (lanes of
    ``SLICE`` entries, or one walk a chunk), and within the stated
    tolerances of ``index_add_`` and of float64, from a non-zero
    ``out``; the layout ``segsum_plan`` picks is the default."""
    rng = np.random.default_rng(len(case) + d)
    ids = _layout_stream(case, rng)
    n_rows = int(ids.max()) + 3
    vals = rng.normal(size=(len(ids), d)).astype(np.float32)
    base = rng.normal(size=(n_rows, d)).astype(np.float32)
    perm_np = rng.permutation(len(ids))  # vals reached through perm
    order = (torch.from_numpy(perm_np.astype(np.int32)),
             torch.from_numpy(ids.astype(np.int32)))
    v = torch.from_numpy(vals)
    got = torch.from_numpy(base.copy())
    ss.segmented_segment_sum(got, v, *order, layout=layout)
    lane_len = ss.SLICE if layout == "entries" else ss.CHUNK
    want = _emulate(base, vals, perm_np, ids, ss.CHUNK, lane_len)
    assert torch.equal(got, torch.from_numpy(want))
    plain = torch.from_numpy(base.copy())
    ss.plain_segment_sum(plain, v, *order)
    scale = torch.from_numpy(np.abs(base)).double()
    ss.plain_segment_sum(scale, v.abs().double(), *order)
    assert torch.all((got - plain).abs().double() <= 1e-6 * scale)
    oracle = base.astype(np.float64)
    np.add.at(oracle, ids, vals[perm_np].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-5)
    if layout == ss.segsum_plan(len(ids), d).layout:
        again = torch.from_numpy(base.copy())
        ss.segmented_segment_sum(again, v, *order)
        assert torch.equal(again, got)


@pytest.mark.parametrize("kp", [128, 256])
def test_apply_chunk_model_matches_plain_apply(kp):
    """``mf_segment_apply``'s order (chunks of ``APPLY_CHUNK``, one walk a
    chunk in entry order, crossing runs in chunk order) on a skewed
    secondary stream with one run of 700: bitwise the replay, within rtol
    1e-6 of the row's absolute sum of ``plain_segment_apply``, and within
    atol 1e-4 of float64."""
    rng = np.random.default_rng(kp)
    ids = np.sort(np.r_[(300 * rng.random(3000) ** 2).astype(np.int64),
                        np.full(700, 150)])
    n = len(ids)
    rows = (0.01 * rng.normal(size=(n, kp))).astype(np.float32)
    table = rng.normal(size=(300, kp)).astype(np.float32)
    perm_np = rng.permutation(n)
    order = (torch.from_numpy(perm_np.astype(np.int32)),
             torch.from_numpy(ids.astype(np.int32)))
    got = torch.from_numpy(table.copy())
    ss.segmented_segment_sum(got, torch.from_numpy(rows), *order,
                             chunk=cuda_sgd.APPLY_CHUNK, layout="columns")
    want = _emulate(table, rows, perm_np, ids, cuda_sgd.APPLY_CHUNK,
                    cuda_sgd.APPLY_CHUNK)
    assert torch.equal(got, torch.from_numpy(want))
    plain = torch.from_numpy(table.copy())
    cuda_sgd.segment_apply(plain, torch.from_numpy(rows), *order)
    scale = torch.from_numpy(np.abs(table)).double()
    ss.plain_segment_sum(scale, torch.from_numpy(np.abs(rows)).double(),
                         *order)
    assert torch.all((got - plain).abs().double() <= 1e-6 * scale)
    oracle = table.astype(np.float64)
    np.add.at(oracle, ids, rows[perm_np].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-5)
    assert int(np.bincount(ids).max()) >= 700  # the long run is there


def test_model_refuses_what_no_kernel_does():
    ids, vals = _stream("uniform", 60, 1)
    order = ss.sorted_order(ids)
    for kw in ({"chunk": 0}, {"layout": "rows"},
               {"chunk": 12, "layout": "entries"}):
        with pytest.raises(ValueError):
            ss.segmented_segment_sum(torch.zeros(60, 1), vals, *order, **kw)
