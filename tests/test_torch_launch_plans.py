"""The launch plans of the port's redesigned kernels, on the CPU.

``ops/cuda_scores.py::score_plan``, ``ops/cuda_spd.py::gj_plan``,
``ops/cuda_sgd.py::step_plan`` and ``apply_plan``, and
``ops/segment_sum.py::segsum_plan`` decide in Python how
``csrc/score_catalog.cu``, ``csrc/spd_gj.cu``, ``csrc/sgd_step.cu`` and
``csrc/segment_sum.cu`` cover a call; the kernels refuse a plan that does
not match what they compute.
These tests need no GPU: every plan covers its call, fits the card's
limits, and names a shape the CUDA sources are compiled for.
"""

import re
from pathlib import Path

import pytest

from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd, cuda_spd
from matrix_factorization_tpu_torch.ops import segment_sum

CSRC = Path(cuda_scores.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132


def _instantiations(source, pattern):
    return {tuple(int(x) for x in m) if isinstance(m, tuple) else int(m)
            for m in re.findall(pattern, (CSRC / source).read_text())}


def test_plans_name_compiled_shapes():
    stream = _instantiations("score_catalog.cu",
                             r"launch_stream<T, KERNEL, (\d+)>\(g\)")
    assert stream == set(cuda_scores.STREAM_USERS)
    src = (CSRC / "score_catalog.cu").read_text()
    assert f"kTileM = {cuda_scores.TILE_M};" in src
    assert f"kTileN = {cuda_scores.TILE_N};" in src
    gj = _instantiations("spd_gj.cu", r"return launch<(\d+), (\d+), (\d+)>")
    assert gj == {t[1:] for t in cuda_spd._GJ_TILES}
    for src in ("score_catalog.cu", "spd_gj.cu"):
        assert f"kMaxSmem = {cuda_scores.SMEM_LIMIT}" in (CSRC / src).read_text()


@pytest.mark.parametrize("kp", [128, 256, 512, 1024])
@pytest.mark.parametrize("itemsize", [4, 2])  # float32, bfloat16
def test_score_plan_covers_every_batch(itemsize, kp):
    for I in (1, 255, 256, 257, 1000, 59_392):
        for B in range(1, 301):
            p = cuda_scores.score_plan(B, I, kp, itemsize, H100_SMS)
            assert 0 < p.smem_bytes <= cuda_scores.SMEM_LIMIT
            assert 2 <= p.stages <= cuda_scores.MAX_STAGES
            assert p.k_chunk * itemsize == cuda_scores.ROW_BYTES
            assert kp % p.k_chunk == 0
            gx, gy = p.grid
            assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535
            if B <= cuda_scores.STREAM_MAX_B:
                assert p.path == "stream"
                assert p.tile in cuda_scores.STREAM_USERS and B <= p.tile
                n_tiles = -(-I // p.items)
                # a persistent grid: every block has a tile, every tile a block
                assert gy == 1 and gx == min(n_tiles, H100_SMS)
                assert p.smem_bytes == cuda_scores.stream_smem(p.tile, kp, p.stages)
            else:
                assert p.path == "tile" and p.tile == cuda_scores.TILE_M
                # one block per (item tile, row block)
                assert gx == -(-I // p.items) and gy == -(-B // p.tile)
                assert p.smem_bytes == cuda_scores.tile_smem(p.stages)


def test_score_plan_boundary_and_stages():
    b_s = cuda_scores.STREAM_MAX_B
    assert b_s >= 16
    assert cuda_scores.score_plan(b_s, 59_392, 256, 4).path == "stream"
    assert cuda_scores.score_plan(b_s + 1, 59_392, 256, 4).path == "tile"
    # B = 1 at config 3's width keeps the most stages in flight
    one = cuda_scores.score_plan(1, 59_392, 256, 4)
    assert one.tile == 1 and one.stages == cuda_scores.MAX_STAGES
    # the streaming path stages the user rows whole; where they do not fit
    # beside two stages the batch tiles, whatever its size
    wide = cuda_scores.score_plan(16, 1000, 8192, 4)
    assert wide.path == "tile" and wide.smem_bytes <= cuda_scores.SMEM_LIMIT
    for bad in ((0, 10, 128), (1, 0, 128), (1, 10, 96)):
        with pytest.raises(ValueError):
            cuda_scores.score_plan(*bad, 4)


@pytest.mark.parametrize("max_d,side,regs,per_block", cuda_spd._GJ_TILES)
def test_gj_plan_covers_every_d(max_d, side, regs, per_block):
    lo = max(d for d, *_ in cuda_spd._GJ_TILES if d < max_d) + 1 if max_d > 8 else 1
    for d in range(lo, max_d + 1):
        p = cuda_spd.gj_plan(d)
        assert (p.side, p.regs, p.per_block) == (side, regs, per_block)
        assert p.side * p.regs >= d  # the register tile covers d x d
        assert p.side * p.side * p.per_block <= 1024  # threads a block
        assert (p.side * p.side) % 32 == 0  # a warp never spans two matrices
        assert 0 < p.smem_bytes <= cuda_spd.SMEM_LIMIT
        assert p.smem_bytes >= 4 * p.per_block * d * d


def test_gj_plan_refuses_what_the_kernel_does_not_take():
    assert cuda_spd.gj_plan(1).regs == 1 and cuda_spd.gj_plan(128).regs == 8
    for d in (0, 129, -3):
        with pytest.raises(ValueError):
            cuda_spd.gj_plan(d)


def test_step_plan_names_what_the_source_is_compiled_for():
    src = (CSRC / "sgd_step.cu").read_text()
    assert f"#define MF_SEG_LEN {cuda_sgd.SEG_LEN}\n" in src
    assert f"#define MF_STAGES {cuda_sgd.STEP_STAGES}\n" in src
    assert f"constexpr int kWarps = {cuda_sgd.STEP_WARPS};" in src
    assert f"constexpr int kMaxSmem = {cuda_sgd.SMEM_LIMIT};" in src
    assert f"constexpr int kMaxVec = {cuda_sgd.MAX_WIDTH // 128};" in src
    assert cuda_sgd.SEG_LEN % 32 == 0 and 32 <= cuda_sgd.SEG_LEN <= 128
    # the kernel's own layout: masks, rings, entry words, primary ids
    m = re.search(r"return 16 \* \(2 \* nv \* 32 \+ kWarps \* kStages \* nv "
                  r"\* 32 \+ kWarps \* kSegLen\) \+\s+4 \* kWarps \* kSegLen;",
                  src)
    assert m, "step_smem_bytes changed: bring cuda_sgd.step_smem up to date"
    for nv in range(1, 9):
        W, S, L = cuda_sgd.STEP_WARPS, cuda_sgd.STEP_STAGES, cuda_sgd.SEG_LEN
        assert cuda_sgd.step_smem(128 * nv) == (
            16 * (2 * nv * 32 + W * S * nv * 32 + W * L) + 4 * W * L)


@pytest.mark.parametrize("kp", [128, 256, 512, 1024])
@pytest.mark.parametrize("mult", [1, 2, 7, 528, 529, 2048, 32_768])
def test_step_plan_covers_every_n(kp, mult):
    """Every n around a multiple of the segment length: the segments cover
    the batch, the grid has a segment for every warp and fits the card,
    and the scratch has a head and a tail slot a segment."""
    L, W = cuda_sgd.SEG_LEN, cuda_sgd.STEP_WARPS
    for n in range(max(1, mult * L - L - 1), mult * L + L + 2):
        p = cuda_sgd.step_plan(n, kp, H100_SMS)
        assert p.seg_len == L and p.stages == cuda_sgd.STEP_STAGES
        assert (p.n_segments - 1) * L < n <= p.n_segments * L
        assert 1 <= p.grid <= -(-p.n_segments // W)  # no block without work
        assert p.grid <= H100_SMS * cuda_sgd.STEP_MAX_BLOCKS_PER_SM
        assert p.smem_bytes == cuda_sgd.step_smem(kp) <= cuda_sgd.SMEM_LIMIT
        # the blocks the plan puts on an SM fit its shared memory
        per_sm = -(-p.grid // H100_SMS)
        assert per_sm * (p.smem_bytes + 1024) <= cuda_sgd.SMEM_PER_SM
        assert p.scratch_shape == (2 * p.n_segments, kp)


def test_step_plan_at_the_main_path_shapes_and_refusals():
    big = cuda_sgd.step_plan(2_097_152, 256, H100_SMS)
    assert big.n_segments == 2_097_152 // cuda_sgd.SEG_LEN
    assert big.grid % H100_SMS == 0  # a persistent grid, whole blocks an SM
    head = cuda_sgd.step_plan(131_072, 128, H100_SMS)
    assert head.grid == -(-head.n_segments // cuda_sgd.STEP_WARPS)
    # the probe's other builds: the plan follows the constants it is given
    other = cuda_sgd.step_plan(1000, 256, H100_SMS, seg_len=32, stages=2)
    assert (other.seg_len, other.n_segments, other.stages) == (32, 32, 2)
    assert other.smem_bytes == cuda_sgd.step_smem(256, 2, 32)
    for bad in ((0, 128), (-5, 128), (10, 96), (10, 0), (10, 1152)):
        with pytest.raises(ValueError):
            cuda_sgd.step_plan(*bad)
    with pytest.raises(ValueError):  # a ring that does not fit a block
        cuda_sgd.step_plan(10, 1024, H100_SMS, stages=8)


def test_segsum_plan_names_what_the_source_is_compiled_for():
    src = (CSRC / "segment_sum.cu").read_text()
    assert f"constexpr int kChunk = {segment_sum.CHUNK};" in src
    assert f"constexpr int kWarps = {segment_sum.WARPS};" in src
    assert f"#define MF_ENTRIES_MAX_D {segment_sum.ENTRIES_MAX_D}\n" in src
    assert "constexpr int kSlice = kChunk / 32;" in src
    assert segment_sum.SLICE * 32 == segment_sum.CHUNK  # a slice a lane
    assert segment_sum.CHUNK % 32 == 0  # whole groups of 32 entries a warp
    # the C entry's layout codes, in the order of LAYOUTS
    assert "layout != (d <= kEntriesMaxD ? 1 : 0)" in src
    assert segment_sum.LAYOUTS == ("columns", "entries")


@pytest.mark.parametrize("d", [1, 2, 18, 33, 1024])
def test_segsum_plan_picks_the_layout_from_d_alone(d):
    """Lanes over entries for the one-column sums, lanes over columns
    above ``ENTRIES_MAX_D``, whatever n is; a probe build with another
    ``MF_ENTRIES_MAX_D`` plans with the value it is given."""
    want = "entries" if d <= segment_sum.ENTRIES_MAX_D else "columns"
    assert segment_sum.ENTRIES_MAX_D == 1
    for n in (1, 255, 256, 4096, 1_000_000):
        assert segment_sum.segsum_plan(n, d).layout == want
    assert segment_sum.segsum_plan(10, d, entries_max_d=32).layout == (
        "entries" if d <= 32 else "columns")


def test_apply_plan_names_what_the_source_is_compiled_for():
    src = (CSRC / "segment_sum.cu").read_text()
    assert f"#define MF_APPLY_CHUNK {cuda_sgd.APPLY_CHUNK}\n" in src
    assert cuda_sgd.APPLY_CHUNK % 32 == 0 and 32 <= cuda_sgd.APPLY_CHUNK <= 256
    rows = int(re.search(r"#define MF_APPLY_ROWS (\d+)\n", src).group(1))
    assert rows >= 4 and 32 % rows == 0  # at least 4 rows in flight a warp
    for nv in range(1, 9):  # every width the wrapper takes
        assert f"case {nv}: launch_apply<{nv}>" in src
    assert f"kMaxVec = {cuda_sgd.MAX_WIDTH // 128};" in src
    step_src = (CSRC / "sgd_step.cu").read_text()  # the apply left it
    assert 'extern "C" int mf_segment_apply' not in step_src
    assert "segment_apply_kernel" not in step_src


@pytest.mark.parametrize("kp", [128, 256, 1024])
@pytest.mark.parametrize("mult", [1, 2, 8, 9, 128, 4096, 65_536])
def test_apply_plan_covers_every_n(kp, mult):
    """Every n around a multiple of the chunk: the chunks cover the batch,
    a warp a chunk, a finishing warp for every chunk but the last and two
    scratch slots of ``kp`` a chunk. The sweep's batch (4,096) and the
    headline's (131,072) give 128 and 4,096 warps."""
    C, W = cuda_sgd.APPLY_CHUNK, segment_sum.WARPS
    for n in range(max(1, mult * C - C - 1), mult * C + C + 2, 5):
        p = cuda_sgd.apply_plan(n, kp)
        assert p.chunk == C and (p.n_chunks - 1) * C < n <= p.n_chunks * C
        assert (p.grid - 1) * W < p.n_chunks <= p.grid * W
        assert (p.finish_grid - 1) * W < p.n_chunks - 1 <= p.finish_grid * W \
            or p.n_chunks == 1 and p.finish_grid == 0
        assert p.grid <= 2**31 - 1
        assert p.scratch_shape == (2 * p.n_chunks, kp)
    assert cuda_sgd.apply_plan(4096, 128).n_chunks >= 64
    assert cuda_sgd.apply_plan(131_072, 128).n_chunks >= 2048
    assert cuda_sgd.apply_plan(1000, 256, chunk=64).n_chunks == 16
    for bad in ((0, 128), (-1, 128), (10, 96), (10, 0), (10, 1152)):
        with pytest.raises(ValueError):
            cuda_sgd.apply_plan(*bad)


@pytest.mark.parametrize("d", [1, 18, 33])
@pytest.mark.parametrize("mult", [1, 2, 8, 9, 3907])
def test_segsum_plan_covers_every_n(d, mult):
    """Every n around a multiple of the chunk: the chunks cover the
    stream, a warp a chunk, a finishing warp for every chunk but the last
    and two scratch slots a chunk."""
    C, W = segment_sum.CHUNK, segment_sum.WARPS
    for n in range(max(1, mult * C - C - 1), mult * C + C + 2, 7):
        p = segment_sum.segsum_plan(n, d)
        assert p.chunk == C and (p.n_chunks - 1) * C < n <= p.n_chunks * C
        assert (p.grid - 1) * W < p.n_chunks <= p.grid * W
        assert (p.finish_grid - 1) * W < p.n_chunks - 1 <= p.finish_grid * W \
            or p.n_chunks == 1 and p.finish_grid == 0
        assert p.grid <= 2**31 - 1
        assert p.scratch_shape == (2 * p.n_chunks, d)
    for bad in ((0, 1), (-3, 1), (10, 0)):
        with pytest.raises(ValueError):
            segment_sum.segsum_plan(*bad)
