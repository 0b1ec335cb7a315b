"""Hand-written CUDA Gauss-Jordan inverse of a batch of SPD matrices.

Counterpart of ``matrix_factorization_tpu/ops/pallas_spd.py``: the kernel
``csrc/spd_gj.cu`` replaces the Pallas ``_gj_kernel`` and inverts (E, d, d)
f32 SPD matrices, d <= 128, by Gauss-Jordan elimination without pivoting
in exact f32. It is the leaf of ``ops.spd.spd_inverse``, so every ALS and
iALS solve reaches it. Its source says what bounds it and how it is laid
out.

The TPU design does not carry over: no (d, d, 128) lane-batched layout, no
identity padding of E to a multiple of 128 or of d to a multiple of 8. The
kernel takes the matrices as they are, each in the registers of a square
of threads; ``gj_plan`` is its launch plan for a d.

``cuda_gj_inverse`` launches the kernel and takes only CUDA tensors.
``plain_gj_inverse`` is the same arithmetic in plain PyTorch, vectorised
over E; the CPU path and the comparisons on the card use it.
``gj_inverse`` picks between the two by the tensor's device: a CUDA tensor
always launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from matrix_factorization_tpu_torch.ops import _build

MAX_D = 128  # the leaf's largest block, as on the TPU (pallas_spd.py:110)

# (largest d, side S, R, matrices a block): the instantiations of
# csrc/spd_gj.cu. A matrix takes S x S threads holding R x R elements each.
_GJ_TILES = ((8, 8, 1, 4), (16, 8, 2, 4), (32, 8, 4, 4), (64, 8, 8, 4),
             (80, 16, 5, 1), (96, 16, 6, 1), (112, 16, 7, 1), (128, 16, 8, 1))

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _build.Library("spd_gj", {
    "mf_gj_inverse": ([_vp, _vp, ctypes.c_longlong, _ci, _ci, _ci, _ci, _ci, _vp],
                      _ci),
}, error="mf_spd_error_string")


class GJPlan(NamedTuple):
    """How ``mf_gj_inverse`` lays out a (d, d) matrix: ``side`` x ``side``
    threads of ``regs`` x ``regs`` elements each, ``per_block`` matrices
    a block, ``smem_bytes`` of dynamic shared memory."""

    side: int
    regs: int
    per_block: int
    smem_bytes: int


def gj_plan(d: int) -> GJPlan:
    """The launch plan for d in [1, 128]; the shared memory is
    ``csrc/spd_gj.cu::gj_smem`` (the pivot column and row slots of a
    round's two steps, for both parities, then the staged matrices)."""
    for max_d, side, regs, per_block in _GJ_TILES:
        if 1 <= d <= max_d:
            slot = 4 if regs <= 4 else 12
            smem = (per_block * 8 * side * slot + per_block * d * d + 4) * 4
            return GJPlan(side, regs, per_block, smem)
    raise ValueError(f"gj_inverse leaf handles 1 <= d <= {MAX_D}, got {d}")


def _check_batch(A: torch.Tensor) -> int:
    """``d`` of an (E, d, d) batch; ``ValueError`` for any other shape or
    for d > ``MAX_D``."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"gj_inverse takes (E, d, d), got {tuple(A.shape)}")
    d = A.shape[-1]
    if d > MAX_D:
        raise ValueError(f"gj_inverse leaf handles d <= {MAX_D}, got {d}")
    return d


def plain_gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: d steps of pivot,
    ``u = M[:, j] - e_j``, ``v = (M[j, :] + e_j) * (1 / p)`` with an exact
    reciprocal, and ``M -= u (x) v``, all E matrices at once. Returns a
    new (E, d, d) f32 tensor on ``A``'s device."""
    d = _check_batch(A)
    M = A.to(torch.float32, copy=True)
    eye = torch.eye(d, dtype=torch.float32, device=M.device)
    for j in range(d):
        inv_p = 1.0 / M[:, j, j]
        u = M[:, :, j] - eye[j]
        v = (M[:, j, :] + eye[j]) * inv_p[:, None]
        M.addcmul_(u[:, :, None], v[:, None, :], value=-1.0)
    return M


def cuda_gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverses of the (E, d, d) f32 SPD batch ``A`` by ``mf_gj_inverse``,
    on ``A``'s stream, into a new tensor. ``A`` must be a contiguous CUDA
    f32 tensor; E may be 0 (nothing is launched)."""
    d = _check_batch(A)
    if A.device.type != "cuda":
        raise ValueError(f"cuda_gj_inverse takes CUDA tensors, got {A.device}")
    _build.check("A", A, A.device, torch.float32)
    E = A.shape[0]
    if E >= 2**31:
        raise ValueError(f"gj_inverse launches at most 2^31 - 1 matrices, got {E}")
    out = torch.empty_like(A)
    if E == 0 or d == 0:
        return out
    plan = gj_plan(d)
    LIB("mf_gj_inverse", A.data_ptr(), out.data_ptr(), E, d, plan.side,
        plan.regs, plan.per_block, plan.smem_bytes,
        torch.cuda.current_stream(A.device).cuda_stream)
    return out


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """``cuda_gj_inverse`` for a CUDA tensor, ``plain_gj_inverse`` for a
    CPU tensor; any other device raises."""
    if A.device.type == "cuda":
        return cuda_gj_inverse(A)
    if A.device.type == "cpu":
        return plain_gj_inverse(A)
    raise ValueError(f"no gj_inverse for device {A.device}")
