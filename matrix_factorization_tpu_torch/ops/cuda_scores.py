"""Hand-written CUDA catalog scorer with fused kernel epilogues.

Counterpart of ``matrix_factorization_tpu/ops/pallas_scores.py``: the
kernel ``csrc/score_catalog.cu`` replaces the Pallas ``_score_kernel``
and computes the (B, I) scores of B extended user rows against I
extended item rows (layout: ``ops/segment_sgd.py``), f32 or bf16 tables,
sums in f32. Its source says what bounds it and how it is tiled.

``cuda_score_catalog`` launches the kernel and only takes CUDA tensors;
``score_plan`` is its launch plan (the path, the tile, the stages, the
grid and the shared memory), computed here so that the CPU tests reach
it. ``plain_score_catalog`` is the same function in plain PyTorch; the
CPU path and the tests use it, and ``chip_smoke.py`` holds the kernel
against it on the card. ``ops.scoring.score_catalog`` picks between them
by the tensors' device: a CUDA tensor always launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from matrix_factorization_tpu_torch.core.config import LANE, SGDConfig
from matrix_factorization_tpu_torch.ops import _build

_KERNEL_CODES = {"linear": 0, "sigmoid": 1, "rbf": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Shapes of csrc/score_catalog.cu; the kernel checks a plan against them.
ROW_BYTES = 128           # k bytes of one stage row (32 f32 / 64 bf16)
ROW_STRIDE = ROW_BYTES + 16
STREAM_ITEMS = 256        # items of a streaming tile, one per thread
STREAM_USERS = (1, 4, 16)  # users a streaming block is compiled for
STREAM_MAX_B = 16         # B_s: batches up to it stream, larger ones tile
TILE_M = 64               # users of a tiled block
TILE_N = 128              # items of a tiled block
TILE_STAGES = 3
MAX_STAGES = 4

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = _build.Library("score_catalog", {
    "mf_score_catalog": ([_vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _cf,
                          _cf, _ci, _ci, _ci, _ci, _ci, _ci, _vp], _ci),
}, error="mf_error_string")


class ScorePlan(NamedTuple):
    """How ``mf_score_catalog`` covers a (B, I, Kp) call: ``path``
    "stream" (``tile`` users a block, a persistent grid over tiles of
    ``items`` items) or "tile" (``tile`` x ``items`` block tiles, one
    block each); ``stages`` shared-memory stages of ``k_chunk`` k;
    ``grid`` (x, y); ``smem_bytes`` of dynamic shared memory."""

    path: str
    tile: int
    items: int
    k_chunk: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int


def stream_smem(users: int, kp: int, stages: int) -> int:
    """The streaming block's shared memory: its user rows in f32 and
    their norms, then the ring of item stages."""
    return (users * kp + -(-users // 4) * 4) * 4 + stages * STREAM_ITEMS * ROW_STRIDE


def tile_smem(stages: int) -> int:
    rows = TILE_M + TILE_N
    return stages * rows * ROW_STRIDE + rows * 4


def score_plan(B: int, I: int, kp: int, itemsize: int, n_sms: int = 132) -> ScorePlan:
    """The launch plan of a (B, I) scoring of width ``kp`` (a multiple of
    128) on tables of ``itemsize`` bytes a value, on a card of ``n_sms``
    SMs. B <= ``STREAM_MAX_B`` streams the items past the staged users
    with as many stages (at most 4) as fit; a larger B takes 64 x 128
    block tiles with 3 stages."""
    if B <= 0 or I <= 0 or kp <= 0 or kp % ROW_BYTES:
        raise ValueError(f"no plan for B={B} I={I} Kp={kp}")
    k_chunk = ROW_BYTES // itemsize
    if B <= STREAM_MAX_B:
        users = next(u for u in STREAM_USERS if u >= B)
        for stages in range(MAX_STAGES, 1, -1):
            smem = stream_smem(users, kp, stages)
            if smem <= _build.SMEM_LIMIT:
                n_tiles = -(-I // STREAM_ITEMS)
                return ScorePlan("stream", users, STREAM_ITEMS, k_chunk, stages,
                                 (min(n_tiles, n_sms), 1), smem)
    grid = (-(-I // TILE_N), -(-B // TILE_M))
    if grid[1] > 65535:
        raise ValueError(f"B={B} needs more than 65535 row blocks")
    return ScorePlan("tile", TILE_M, TILE_N, k_chunk, TILE_STAGES, grid,
                     tile_smem(TILE_STAGES))


def plain_score_catalog(cfg: SGDConfig, mu: torch.Tensor, pu: torch.Tensor,
                        Q: torch.Tensor) -> torch.Tensor:
    """(B, I) scores as ``torch.matmul`` plus the epilogue, in f32
    (``matrix_factorization_tpu/ops/scoring.py::score_catalog``). bf16
    tables are upcast first: a bf16 product is exact in f32, so only the
    summation order differs from the kernel."""
    pu32, Q32 = pu.float(), Q.float()
    dots = torch.matmul(pu32, Q32.T)
    if cfg.kernel == "linear":
        return mu + dots
    if cfg.kernel == "sigmoid":
        return cfg.a + cfg.c * torch.sigmoid(mu + dots)
    if cfg.kernel == "rbf":
        sq = ((pu32 * pu32).sum(1)[:, None] + (Q32 * Q32).sum(1)[None, :]
              - 2.0 * dots)
        return cfg.a + cfg.c * torch.exp(-cfg.gamma * sq.clamp(min=0.0))
    raise ValueError(f"unknown kernel {cfg.kernel!r}")


def cuda_score_catalog(cfg: SGDConfig, mu: torch.Tensor, pu: torch.Tensor,
                       Q: torch.Tensor) -> torch.Tensor:
    """(B, I) f32 scores from the CUDA kernel, on ``pu``'s stream.

    ``pu`` (B, Kp) and ``Q`` (I, Kp): contiguous CUDA tensors of one dtype,
    float32 or bfloat16, with Kp a multiple of 128, 16-byte aligned;
    ``mu``: one f32 on the same device (read by the kernel, so the call
    never syncs)."""
    return score_with_plan(cfg, mu, pu, Q, None)


def score_with_plan(cfg: SGDConfig, mu: torch.Tensor, pu: torch.Tensor,
                    Q: torch.Tensor, plan) -> torch.Tensor:
    """``cuda_score_catalog`` under the launch plan ``plan`` (None: the
    one ``score_plan`` gives). ``tools/probe_kernels.py`` times the
    two paths against each other through it; the kernel refuses a plan
    that does not cover the call."""
    if cfg.kernel not in _KERNEL_CODES:
        raise ValueError(f"unknown kernel {cfg.kernel!r}")
    for name, t in (("mu", mu), ("pu", pu), ("Q", Q)):
        if t.device.type != "cuda" or t.device != pu.device:
            raise ValueError(f"{name} must be on pu's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pu.dim() != 2 or Q.dim() != 2 or pu.shape[1] != Q.shape[1]:
        raise ValueError(f"pu {tuple(pu.shape)} and Q {tuple(Q.shape)} must be "
                         "2-D with one width")
    if pu.dtype != Q.dtype or pu.dtype not in _DTYPE_CODES:
        raise ValueError(f"pu and Q must both be float32 or bfloat16, got "
                         f"{pu.dtype} and {Q.dtype}")
    if mu.dtype != torch.float32 or mu.numel() != 1:
        raise ValueError("mu must be one float32")
    B, kp = pu.shape
    I = Q.shape[0]
    if kp % LANE:
        raise ValueError(f"row width {kp} is not a multiple of {LANE}")
    if pu.data_ptr() % 16 or Q.data_ptr() % 16:
        raise ValueError("pu and Q must start on a 16-byte boundary")
    out = torch.empty((B, I), dtype=torch.float32, device=pu.device)
    if B == 0 or I == 0:
        return out
    if plan is None:
        plan = score_plan(B, I, kp, pu.element_size(), _build.sm_count(pu.device))
    LIB("mf_score_catalog",
        mu.data_ptr(), pu.data_ptr(), Q.data_ptr(), out.data_ptr(), B, I, kp,
        _KERNEL_CODES[cfg.kernel], _DTYPE_CODES[pu.dtype], float(cfg.gamma),
        float(cfg.a), float(cfg.c), 0 if plan.path == "stream" else 1,
        plan.tile, plan.stages, *plan.grid, plan.smem_bytes,
        torch.cuda.current_stream(pu.device).cuda_stream)
    return out


def recommend_topk(cfg: SGDConfig, mu: torch.Tensor, pu: torch.Tensor,
                   Q: torch.Tensor, valid_items: torch.Tensor, k: int):
    """Full-catalog top-k for a block of users: scoring, then a
    descending top-k with ties to the lower index; items whose
    ``valid_items`` entry is 0 score ``-inf``. Returns (values, indices)."""
    from matrix_factorization_tpu_torch.ops.scoring import score_catalog, stable_topk

    scores = score_catalog(cfg, mu, pu, Q)
    scores = torch.where(valid_items[None, :] > 0, scores, float("-inf"))
    return stable_topk(scores, k)
