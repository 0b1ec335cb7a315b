"""The launch plans of the port's two redesigned kernels, on the CPU.

``ops/cuda_scores.py::score_plan`` and ``ops/cuda_spd.py::gj_plan`` decide
in Python how ``csrc/score_catalog.cu`` and ``csrc/spd_gj.cu`` cover a
call; the kernels refuse a plan that does not match what they compute.
These tests need no GPU: every plan covers its call, fits the card's
limits, and names a shape the CUDA sources are compiled for.
"""

import re
from pathlib import Path

import pytest

from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_spd

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
