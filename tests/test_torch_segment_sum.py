"""The port's deterministic segment sum on the CPU.

``ops/segment_sum.py``: the plain version (``index_add_`` over a stable
sort) against a float64 ``np.add.at`` (atol 1e-4, rtol 1e-5: f32 sums of
up to ~700 terms of size ~1, whose running sums reach ~70), and
``segmented_segment_sum`` (the CUDA kernel's summation: pieces of
``CHUNK`` entries, each from zero in entry order, then the pieces of a run
in chunk order) against the plain version at rtol 1e-6 of the row's
absolute sum (``|out| + sum |vals|``: the two orders round differently
where a sum cancels). The kernel itself runs in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

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
    ss.segmented_segment_sum(got, vals, *order, chunk=chunk)
    scale = base.abs().double()
    ss.plain_segment_sum(scale, vals.abs().double(), *order)
    assert torch.all((got - want).abs().double() <= 1e-6 * scale)
    if chunk == 1:
        # one entry a piece: the pieces add in entry order from zero, as
        # one piece a run does
        whole = base.clone()
        ss.segmented_segment_sum(whole, vals, *order, chunk=10**9)
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
