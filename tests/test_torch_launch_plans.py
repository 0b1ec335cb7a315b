"""The launch plans of the port's redesigned kernels, on the CPU.

``ops/cuda_scores.py::score_plan``, ``ops/cuda_spd.py::gj_plan``,
``ops/cuda_sgd.py::step_plan``, ``ops/segment_sum.py::segsum_plan`` and
``apply_plan`` and ``ops/cuda_topk.py::select_plan``
decide in Python how ``csrc/score_catalog.cu``, ``csrc/spd_gj.cu``,
``csrc/sgd_step.cu``, ``csrc/segment_sum.cu`` and ``csrc/topk_select.cu``
cover a call; the kernels refuse a plan that does
not match what they compute.
These tests need no GPU: every plan covers its call, fits the card's
limits, and names a shape the CUDA sources are compiled for; and every
C entry point of ``csrc/`` has its signature in its wrapper's table.
"""

import ctypes
import re
from pathlib import Path

import pytest

from matrix_factorization_tpu_torch.data import loader  # noqa: F401 (binds host_loader)
from matrix_factorization_tpu_torch.ops import _build, cuda_gram, cuda_normal_eq  # noqa: F401
from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd, cuda_spd, cuda_spd_solve
from matrix_factorization_tpu_torch.ops import cuda_topk
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


@pytest.mark.parametrize("src", ["score_catalog.cu", "spd_gj.cu", "sgd_step.cu",
                                 "als_normal_eq.cu", "spd_block_solve.cu"])
def test_sources_take_the_one_smem_limit(src):
    """Every source that bounds a block's dynamic shared memory is compiled
    for ``_build.SMEM_LIMIT``, the one limit the launch plans use."""
    assert re.search(rf"constexpr int kMaxSmem = {_build.SMEM_LIMIT};",
                     (CSRC / src).read_text())


@pytest.mark.parametrize("kp", [128, 256, 512, 1024])
@pytest.mark.parametrize("itemsize", [4, 2])  # float32, bfloat16
def test_score_plan_covers_every_batch(itemsize, kp):
    for I in (1, 255, 256, 257, 1000, 59_392):
        for B in range(1, 301):
            p = cuda_scores.score_plan(B, I, kp, itemsize, H100_SMS)
            assert 0 < p.smem_bytes <= _build.SMEM_LIMIT
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
    assert wide.path == "tile" and wide.smem_bytes <= _build.SMEM_LIMIT
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
        assert 0 < p.smem_bytes <= _build.SMEM_LIMIT
        assert p.smem_bytes >= 4 * p.per_block * d * d


def test_gj_plan_refuses_what_the_kernel_does_not_take():
    assert cuda_spd.gj_plan(1).regs == 1 and cuda_spd.gj_plan(128).regs == 8
    for d in (0, 129, -3):
        with pytest.raises(ValueError):
            cuda_spd.gj_plan(d)


def test_block_solve_plan_is_what_the_source_computes():
    """``ops/cuda_spd_solve.py`` states the constants of
    ``csrc/spd_block_solve.cu``; its plan, ``solve_smem``, fits one block
    for every d the block solve takes (129 to 232, where the leaf's 128
    stops), with each side of the split within the row and column
    products' reach, and refuses every other d; ``solve_grid`` is one
    block an SM, at most one a system."""
    src = (CSRC / "spd_block_solve.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxD"] == cuda_spd_solve.MAX_D == 232
    assert const["kMinD"] == cuda_spd.MAX_D + 1
    assert const["kSolveThreads"] == cuda_spd_solve.SOLVE_THREADS
    assert const["kColTile"] == cuda_spd_solve.COL_TILE
    for d in range(cuda_spd.MAX_D + 1, cuda_spd_solve.MAX_D + 1):
        m = cuda_spd_solve.split_point(d)
        assert m % 8 == 0 and m <= 32 * const["kHalfLanes"]
        assert d - m <= cuda_spd_solve.COL_TILE and d - m <= cuda_spd.MAX_D
        assert 4 * d * d < cuda_spd_solve.solve_smem(d) <= _build.SMEM_LIMIT
    assert cuda_spd_solve.solve_smem(232) == 222_976
    # one persistent block an SM, never more blocks than systems
    assert cuda_spd_solve.solve_grid(15_625, H100_SMS) == H100_SMS
    assert cuda_spd_solve.solve_grid(5, H100_SMS) == 5
    assert "grid < 1 || grid > E" in src
    for d in (cuda_spd.MAX_D, cuda_spd_solve.MAX_D + 1, 0):
        with pytest.raises(ValueError):
            cuda_spd_solve.solve_smem(d)


def test_step_plan_names_what_the_source_is_compiled_for():
    src = (CSRC / "sgd_step.cu").read_text()
    assert f"#define MF_SEG_LEN {cuda_sgd.SEG_LEN}\n" in src
    assert f"#define MF_STAGES {cuda_sgd.STEP_STAGES}\n" in src
    assert f"constexpr int kWarps = {cuda_sgd.STEP_WARPS};" in src
    assert f"constexpr int kMaxVec = {segment_sum.MAX_WIDTH // 128};" in src
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
        assert p.smem_bytes == cuda_sgd.step_smem(kp) <= _build.SMEM_LIMIT
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
    assert f"#define MF_APPLY_CHUNK {segment_sum.APPLY_CHUNK}\n" in src
    assert segment_sum.APPLY_CHUNK % 32 == 0 and 32 <= segment_sum.APPLY_CHUNK <= 256
    rows = int(re.search(r"#define MF_APPLY_ROWS (\d+)\n", src).group(1))
    assert rows >= 4 and 32 % rows == 0  # at least 4 rows in flight a warp
    for nv in range(1, 9):  # every width the wrapper takes
        assert f"case {nv}: launch_apply<{nv}>" in src
    assert f"kMaxVec = {segment_sum.MAX_WIDTH // 128};" in src
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
    C, W = segment_sum.APPLY_CHUNK, segment_sum.WARPS
    for n in range(max(1, mult * C - C - 1), mult * C + C + 2, 5):
        p = segment_sum.apply_plan(n, kp)
        assert p.chunk == C and (p.n_chunks - 1) * C < n <= p.n_chunks * C
        assert (p.grid - 1) * W < p.n_chunks <= p.grid * W
        assert (p.finish_grid - 1) * W < p.n_chunks - 1 <= p.finish_grid * W \
            or p.n_chunks == 1 and p.finish_grid == 0
        assert p.grid <= 2**31 - 1
        assert p.scratch_shape == (2 * p.n_chunks, kp)
    assert segment_sum.apply_plan(4096, 128).n_chunks >= 64
    assert segment_sum.apply_plan(131_072, 128).n_chunks >= 2048
    assert segment_sum.apply_plan(1000, 256, chunk=64).n_chunks == 16
    for bad in ((0, 128), (-1, 128), (10, 96), (10, 0), (10, 1152)):
        with pytest.raises(ValueError):
            segment_sum.apply_plan(*bad)


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


def test_select_plan_names_the_kernels_shapes():
    src = (CSRC / "topk_select.cu").read_text()
    assert f"kThreads = {cuda_topk.THREADS};" in src
    assert f"kCap = {cuda_topk.POOL};" in src
    assert f"kMaxK = {cuda_topk.MAX_K};" in src
    # kept keys and one round of 2 float4 loads a thread fit the pool
    assert cuda_topk.MAX_K + cuda_topk.THREADS * 2 * 4 <= cuda_topk.POOL


@pytest.mark.parametrize("k", [1, 10, 100, 500, 1024])
def test_select_plan_covers_every_call(k):
    """Every chunk is non-empty, 4-aligned in length, and the chunks cover
    the row; no chunk is shorter than the plan's floor unless the row is;
    the blocks of ``dense_topk``'s row blocks over RecipeNLG's catalog
    (60 rows and the 16-row tail) fill every SM several times. 5 resident
    blocks an SM is what the occupancy query reports for the kernel's
    build on an H100."""
    bps = 5
    for n in (k, k + 3, 1_024, 16_383, 65_537, 2_231_142, 2_500_000):
        for rows in (1, 2, 16, 60, 64, 256, 4_096, 100_000):
            p = cuda_topk.select_plan(rows, n, k, H100_SMS, bps)
            assert p.chunks >= 1 and p.chunk_len % 4 == 0
            assert p.chunks * p.chunk_len >= n > (p.chunks - 1) * p.chunk_len
            assert rows * p.chunks <= 2**31 - 1
            floor = max(cuda_topk.MIN_CHUNK, cuda_topk.CHUNK_PER_K * k)
            assert p.chunks == 1 or p.chunk_len >= floor
            slots = bps * H100_SMS
            assert p.chunks == 1 or rows * p.chunks <= slots  # one wave
    for rows in (16, 60):
        for bps in (3, 4, 6):
            slots = bps * H100_SMS
            p = cuda_topk.select_plan(rows, 2_231_142, min(k, 500), H100_SMS, bps)
            assert slots - rows < rows * p.chunks <= slots
    for bad in ((0, 10, 1), (4, 0, 1), (4, 10, 11), (4, 5_000, 1_025),
                (4, 10, 0)):
        with pytest.raises(ValueError):
            cuda_topk.select_plan(*bad, H100_SMS, bps)


def test_ease_gram_tiles_match_the_source():
    """``ops/cuda_gram.py`` pads the slab's rows to ``TILE`` and a chunk's
    users to ``K_TILE``: the tile and stage widths of
    ``csrc/ease_gram.cu``, whose shared memory fits two blocks an SM."""
    src = (CSRC / "ease_gram.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kTile"] == cuda_gram.TILE and const["kBK"] == cuda_gram.K_TILE
    smem = const["kStages"] * 2 * const["kTile"] * const["kBK"]
    assert 2 * smem <= _build.SMEM_LIMIT
    assert const["kThreads"] == 128 and "__launch_bounds__(kThreads, 2)" in src


# The ctypes type each C parameter or return type of the sources binds as
# (a pointer: an address, a C string or a numpy array's data).
_POINTER = (ctypes.c_void_p, ctypes.c_char_p)
_C_TYPES = {"int": ctypes.c_int, "int32_t": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float, "void": None}


def _entry_points(text):
    """{name: (return type, [parameter types])} of every ``extern "C"``
    function of a source: one declared ``extern "C"`` on its own, or at
    the top level of an ``extern "C" { ... }`` block."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    sig = r"((?:const )?[\w ]+?\s*\*?)\s*\b(mf_\w+)\s*\(([^)]*)\)\s*\{"
    found = re.findall(r'extern "C" ' + sig, text)
    for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
        found += re.findall(r"^" + sig, block, re.M)
    out = {}
    for ret, name, params in found:
        params = re.sub(r"//[^\n]*", "", params)
        params = [" ".join(p.split()) for p in params.split(",") if p.strip()]
        # drop each parameter's name: what is left is its type
        out[name] = (ret.strip(), [re.sub(r"\s*\w+$", "", p) for p in params])
    return out


def _binds(c_type, ctype):
    c_type = c_type.replace("const ", "").strip()
    if c_type.endswith("*"):
        return ctype is not None and issubclass(ctype, _POINTER)
    return ctype is _C_TYPES[c_type]


@pytest.mark.parametrize("src", sorted(p.name for p in CSRC.iterdir()
                                       if p.suffix in (".cu", ".cpp")))
def test_every_entry_point_has_its_signature_in_one_table(src):
    """Each ``extern "C"`` entry point of ``csrc/<src>`` has exactly one
    entry in its wrapper's table (``_build.LIBRARIES``), with as many
    arguments, each bound as the C type it is declared as, and the same
    return type: ctypes would pass a wrong one without a word."""
    entries = _entry_points((CSRC / src).read_text())
    assert entries
    lib = _build.LIBRARIES[src.rsplit(".", 1)[0]]
    assert set(lib.entries) == set(entries)
    others = [e for name, other in _build.LIBRARIES.items()
              if name != lib.name for e in other.entries]
    assert not set(entries) & set(others)
    for name, (ret, params) in entries.items():
        argtypes, restype = lib.entries[name]
        assert len(argtypes) == len(params), name
        assert all(_binds(c, t) for c, t in zip(params, argtypes)), name
        assert _binds(ret, restype), name
