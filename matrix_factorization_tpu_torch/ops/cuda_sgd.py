"""Hand-written CUDA mini-batch SGD step.

Counterpart of ``matrix_factorization_tpu/ops/pallas_sgd.py``: the kernel
``mf_sgd_step`` (``csrc/sgd_step.cu``) replaces the Pallas
``_step_kernel``. For one batch sorted by the primary side's id it
updates the primary table in place (every row from the pre-step tables,
deltas of one row summed) and writes the per-entry secondary deltas ``dq``
(bs, Kp). A warp owns a fixed segment of ``SEG_LEN`` consecutive entries;
a run of equal ids that crosses a segment boundary is summed in pieces,
which a second small launch of the same call adds in segment order
(``step_plan`` lays the call out, ``segmented_sgd_step`` is that summation
in plain PyTorch). Given ``prim_out`` (the accumulator mode, the TPU
step's ``agg`` output), it leaves the primary table as it is and adds each
run's summed delta to that run's row of ``prim_out`` instead: the
data-parallel trainers (``parallel/distributed.py``) read a table frozen
for a window and collect its deltas apart. The deltas ``dq`` are added to
the secondary table by ``ops/segment_sum.py::segment_apply``, one writer
per row and a fixed summation order, where XLA's scatter did it on the
TPU: a float-atomic ``index_add_`` would break same-seed, same-bits
determinism. The source says what bounds the step and how it is laid out.

``cuda_sgd_step`` launches the kernel and takes only CUDA tensors.
``plain_sgd_step`` is the same function in plain PyTorch (a gather,
``ext_forward_and_rowgrads`` and ``index_add_``); the CPU path and the
comparisons use it. Only tests call ``segmented_sgd_step``. ``sgd_step``
picks between the two by the tensors' device: a CUDA tensor always
launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import _build
from matrix_factorization_tpu_torch.ops.segment_sum import check_width, piece_sums

_KERNEL_CODES = {"linear": 0, "sigmoid": 1, "rbf": 2}

# The step's launch geometry; csrc/sgd_step.cu is compiled for the same
# values (kSegLen, kStages, kWarps, kMaxSmem) and refuses any other.
SEG_LEN = 64  # consecutive entries one warp owns
STEP_STAGES = 6  # secondary rows a warp keeps in flight (its cp.async ring)
STEP_WARPS = 8  # warps a block
STEP_MAX_BLOCKS_PER_SM = 4
SMEM_PER_SM = 233_472  # of which a resident block reserves 1 KB

_vp, _ci, _cf, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_STEP_ARGS = [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _cf,
              _cf, _cf, _cf, _cf, _ci, _vp, _ci, _cll, _ci, _ci, _ci]
LIB = _build.Library("sgd_step", {
    "mf_sgd_step": (_STEP_ARGS + [_vp], _ci),
    "mf_sgd_step_acc": (_STEP_ARGS + [_vp, _vp], _ci),  # ... prim_out, stream
}, error="mf_sgd_error_string")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors, and the comparisons on the card)
# ---------------------------------------------------------------------------


def plain_sgd_step(cfg: SGDConfig, mu: torch.Tensor, prim_tbl: torch.Tensor,
                   sec_tbl: torch.Tensor, prim_ids: torch.Tensor,
                   sec_ids: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                   pmask: torch.Tensor, smask: torch.Tensor, lr: float,
                   reg: float, update_prim: bool = True,
                   write_dq: bool = True,
                   prim_out: Optional[torch.Tensor] = None
                   ) -> Optional[torch.Tensor]:
    """The step of ``cuda_sgd_step`` as gather + row math + ``index_add_``
    (``segment_sgd._minibatch_update``'s per-side deltas). The forward and
    gradients are symmetric in the two sides, so the primary rows go in as
    ``pu`` whichever side they are. With ``prim_out`` the primary deltas
    are added to it, and ``prim_tbl`` is only read."""
    from matrix_factorization_tpu_torch.ops.segment_sgd import (
        ext_forward_and_rowgrads)

    x = prim_tbl[prim_ids.long()]
    y = sec_tbl[sec_ids.long()]
    pred, dx, dy = ext_forward_and_rowgrads(cfg, mu, x, y)
    err = (pred - r) * w
    rw = reg * w
    if update_prim:
        g = (err[:, None] * dx + rw[:, None] * x) * pmask[None, :]
        target = prim_tbl if prim_out is None else prim_out
        target.index_add_(0, prim_ids.long(), -lr * g)
    if not write_dq:
        return None
    return -lr * ((err[:, None] * dy + rw[:, None] * y) * smask[None, :])


def segmented_sgd_step(cfg: SGDConfig, mu: torch.Tensor,
                       prim_tbl: torch.Tensor, sec_tbl: torch.Tensor,
                       prim_ids: torch.Tensor, sec_ids: torch.Tensor,
                       r: torch.Tensor, w: torch.Tensor, pmask: torch.Tensor,
                       smask: torch.Tensor, lr: float, reg: float,
                       update_prim: bool = True, write_dq: bool = True,
                       seg_len: int = SEG_LEN,
                       prim_out: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
    """``plain_sgd_step`` with the primary deltas summed as ``mf_sgd_step``
    sums them: the batch is cut into segments of ``seg_len`` entries, the
    deltas of a run of equal primary ids are added in entry order inside
    each segment, and the pieces of a run that crosses segment boundaries
    are then added in segment order before the pre-step row (or, with
    ``prim_out``, to the run's row of ``prim_out``). Plain PyTorch for the
    tests of the boundary logic; the entry points never call it."""
    from matrix_factorization_tpu_torch.ops.segment_sgd import (
        ext_forward_and_rowgrads)

    if seg_len <= 0:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    n = prim_ids.numel()
    ids = prim_ids.long()
    x = prim_tbl[ids]
    y = sec_tbl[sec_ids.long()]
    pred, dx, dy = ext_forward_and_rowgrads(cfg, mu, x, y)
    err = (pred - r) * w
    rw = reg * w
    if update_prim and n:
        g = -lr * ((err[:, None] * dx + rw[:, None] * x) * pmask[None, :])
        pos = torch.arange(n, device=ids.device)
        new_run = torch.ones(n, dtype=torch.bool, device=ids.device)
        new_run[1:] = ids[1:] != ids[:-1]
        starts = (new_run | (pos % seg_len == 0)).nonzero().squeeze(1)
        lengths = torch.diff(starts, append=pos.new_tensor([n]))
        pieces = piece_sums(g, starts, lengths)
        # the pieces of one run, in segment order: piece sums of piece sums
        run_of_piece = torch.cumsum(new_run, 0)[starts] - 1
        first = torch.ones_like(starts, dtype=torch.bool)
        first[1:] = run_of_piece[1:] != run_of_piece[:-1]
        run_starts = first.nonzero().squeeze(1)
        run_lengths = torch.diff(run_starts,
                                 append=pos.new_tensor([starts.numel()]))
        total = piece_sums(pieces, run_starts, run_lengths)
        rows = ids[starts[run_starts]]
        target = prim_tbl if prim_out is None else prim_out
        target[rows] = target[rows] + total
    if not write_dq:
        return None
    return -lr * ((err[:, None] * dy + rw[:, None] * y) * smask[None, :])


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


class StepPlan(NamedTuple):
    """How one ``mf_sgd_step`` call is laid out on the card."""

    seg_len: int  # entries a warp owns at a time
    n_segments: int  # ceil(n / seg_len)
    grid: int  # blocks of STEP_WARPS warps, persistent over the segments
    smem_bytes: int  # dynamic shared memory a block
    stages: int  # secondary rows in flight a warp
    scratch_shape: Tuple[int, int]  # f32 partial sums of crossing runs


def step_smem(kp: int, stages: int = STEP_STAGES,
              seg_len: int = SEG_LEN) -> int:
    """Shared bytes of a step block: the two masks, each warp's ring of
    ``stages`` rows, and each warp's segment metadata (16 + 4 bytes an
    entry)."""
    return 4 * kp * (2 + STEP_WARPS * stages) + 20 * seg_len * STEP_WARPS


def step_plan(n: int, kp: int, n_sms: int = 132, seg_len: int = SEG_LEN,
              stages: int = STEP_STAGES) -> StepPlan:
    """The launch plan of the step for ``n`` entries of width ``kp`` on a
    card with ``n_sms`` SMs; needs no look at the data, so the wrapper
    allocates the scratch without waiting for the card. The scratch
    holds a head and a tail slot of ``kp`` floats for every segment: the
    partial sum of a run that reaches over the segment's start (or fills
    it), and of another that reaches over its end. ``seg_len`` and
    ``stages`` other than the defaults are for a build of the source
    with other constants (``tools/probe_kernels.py``)."""
    if n <= 0:
        raise ValueError(f"the step needs n > 0, got {n}")
    check_width(kp)
    n_segments = -(-n // seg_len)
    smem = step_smem(kp, stages, seg_len)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"{stages} stages of width {kp} need {smem} bytes "
                         f"of shared memory, over {_build.SMEM_LIMIT}")
    per_sm = max(1, min(STEP_MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    grid = min(-(-n_segments // STEP_WARPS), n_sms * per_sm)
    return StepPlan(seg_len, n_segments, grid, smem, stages,
                    (2 * n_segments, kp))


def cuda_sgd_step(cfg: SGDConfig, mu: torch.Tensor, prim_tbl: torch.Tensor,
                  sec_tbl: torch.Tensor, prim_ids: torch.Tensor,
                  sec_ids: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                  pmask: torch.Tensor, smask: torch.Tensor, lr: float,
                  reg: float, update_prim: bool = True,
                  write_dq: bool = True,
                  prim_out: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
    """One step of ``mf_sgd_step`` on ``prim_tbl``'s stream: the segment
    launch and, when the primary side is updated, the launch that
    finishes the runs crossing a segment boundary.

    ``prim_ids`` and ``sec_ids`` (n,) int32 sorted by ``prim_ids``; ``r``
    and ``w`` (n,) f32; tables (rows, Kp) and masks (Kp,) f32; ``mu`` one
    f32 on the card (read by the kernel, so the call never syncs). Ids are
    not bounds-checked (that would sync): they come from the vocabulary.
    Updates ``prim_tbl`` in place unless ``update_prim`` is false, or,
    given ``prim_out`` (a table of ``prim_tbl``'s shape, another tensor),
    adds the primary deltas to it and only reads ``prim_tbl``
    (``mf_sgd_step_acc``); returns the secondary deltas (n, Kp), or None
    when ``write_dq`` is false."""
    if cfg.kernel not in _KERNEL_CODES:
        raise ValueError(f"unknown kernel {cfg.kernel!r}")
    dev = prim_tbl.device
    if dev.type != "cuda":
        raise ValueError(f"cuda_sgd_step takes CUDA tensors, got {dev}")
    if prim_tbl.dim() != 2 or sec_tbl.dim() != 2:
        raise ValueError("tables must be 2-D")
    kp = prim_tbl.shape[1]
    check_width(kp)
    n = prim_ids.numel()
    f32, i32 = torch.float32, torch.int32
    tensors = [("mu", mu, f32, ()), ("prim_tbl", prim_tbl, f32, None),
               ("sec_tbl", sec_tbl, f32, (sec_tbl.shape[0], kp)),
               ("prim_ids", prim_ids, i32, (n,)), ("sec_ids", sec_ids, i32, (n,)),
               ("r", r, f32, (n,)), ("w", w, f32, (n,)),
               ("pmask", pmask, f32, (kp,)), ("smask", smask, f32, (kp,))]
    if prim_out is not None:
        tensors.append(("prim_out", prim_out, f32, prim_tbl.shape))
    for name, t, dt, shape in tensors:
        _build.check(name, t, dev, dt, shape, aligned=True)
    if prim_out is not None and prim_out.data_ptr() == prim_tbl.data_ptr():
        raise ValueError("prim_out must be another tensor than prim_tbl")
    dq = torch.empty((n, kp), dtype=f32, device=dev) if write_dq else None
    if n == 0:
        return dq
    plan = step_plan(n, kp, _build.sm_count(dev))
    scratch = (torch.empty(plan.scratch_shape, dtype=f32, device=dev)
               if update_prim else None)
    args = [
        mu.data_ptr(), prim_tbl.data_ptr(), sec_tbl.data_ptr(),
        prim_ids.data_ptr(), sec_ids.data_ptr(), r.data_ptr(), w.data_ptr(),
        pmask.data_ptr(), smask.data_ptr(),
        dq.data_ptr() if dq is not None else None, n, kp,
        _KERNEL_CODES[cfg.kernel], float(cfg.gamma), float(cfg.a),
        float(cfg.c), float(lr), float(reg), int(bool(update_prim)),
        scratch.data_ptr() if scratch is not None else None, plan.seg_len,
        plan.n_segments, plan.grid, plan.smem_bytes, plan.stages]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prim_out is None:
        LIB("mf_sgd_step", *args, stream)
    else:
        LIB("mf_sgd_step_acc", *args, prim_out.data_ptr(), stream)
    return dq


# ---------------------------------------------------------------------------
# Routing by device
# ---------------------------------------------------------------------------


def sgd_step(cfg: SGDConfig, mu, prim_tbl, sec_tbl, prim_ids, sec_ids, r, w,
             pmask, smask, lr, reg, update_prim=True, write_dq=True,
             prim_out=None):
    """``cuda_sgd_step`` for CUDA tables, ``plain_sgd_step`` for CPU
    tables; any other device raises."""
    if prim_tbl.device.type == "cuda":
        fn = cuda_sgd_step
    elif prim_tbl.device.type == "cpu":
        fn = plain_sgd_step
    else:
        raise ValueError(f"no SGD step for device {prim_tbl.device}")
    return fn(cfg, mu, prim_tbl, sec_tbl, prim_ids, sec_ids, r, w, pmask,
              smask, lr, reg, update_prim, write_dq, prim_out)
