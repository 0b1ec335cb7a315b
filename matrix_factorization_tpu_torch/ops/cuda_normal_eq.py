"""The ALS normal equations on Hopper: the hand-written kernels of
``csrc/als_normal_eq.cu``, their launch plan and their wrapper.

For E entities' padded rating lists (``other_ids``, ``ratings``, ``mask``,
each (E, L)) the kernel gathers every live slot's row straight from the
other side's table and forms the ridged grams ``A`` (E, d, d), both
triangles, and the right-hand sides ``b`` (E, d), d = k + 1, in exact f32:
what ``ops/ials.py::plain_normal_equations`` returns, without the (E, L, d)
design block. It replaces no TPU kernel (the JAX package leaves the gather
and the batched products to XLA); its source says why it was added, what
bounds it and how it is laid out.

``normal_eq_plan`` is the launch plan for a (d, L): one thread an 8 x 8
microtile of the upper triangle of the augmented rows' gram, the slices a
long list is cut into (their partial sums added in slice order by the
finish kernel), and the rows of A staged at a time for the write;
``mf_normal_eq`` refuses a plan that does not cover its (d, L).
``cuda_normal_equations`` launches the kernels and takes only CUDA
tensors; ``ops/ials.py::normal_equations`` calls it for every CUDA table
and ``plain_normal_equations`` elsewhere.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple, Union

import torch

from matrix_factorization_tpu_torch.ops import _build

TILE = 8  # kMT: a thread's microtile side
STAGES = 3  # kStages: staged row chunks
SLICE = 1024  # kSlice: slots a block takes; longer lists are cut into slices
MAX_THREADS = 384  # kMaxThreads: one block an SM
MAX_ROWS = 64  # rows a stage holds, where the shared memory allows

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = _build.Library("als_normal_eq", {
    "mf_normal_eq": ([_vp, _cll, _vp, _vp, _vp, _cll, _ci, _vp, _ci, _ci, _ci,
                      ctypes.c_float, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
                      _ci, _ci, _vp, _vp, _vp, _vp], _ci),
}, error="mf_normal_eq_error_string")


class NormalEqPlan(NamedTuple):
    """How ``mf_normal_eq`` covers E entities of L slots at width d:
    ``tiles`` microtiles a side of the augmented row (``microtiles`` in the
    upper triangle), ``groups`` blocks an entity of ``per_group``
    microtiles and ``threads`` threads, ``rows`` staged rows of ``width``
    floats a stage, ``band`` rows of A staged at a time for the write at
    row ``stride`` floats, ``slices`` blocks along the list (1: the block
    writes A and b; more: partial grams added in slice order by the finish
    kernel), and ``smem_bytes`` of dynamic shared memory a block."""

    tiles: int
    microtiles: int
    groups: int
    per_group: int
    threads: int
    rows: int
    width: int
    band: int
    stride: int
    slices: int
    smem_bytes: int


# the compacted slots (ids, constants, targets, masks), then 32 group
# offsets, the count and a flag: ``csrc/als_normal_eq.cu::smem_bytes``
_SLOT_FLOATS = 4 * SLICE + 34


def normal_eq_plan(d: int, L: int) -> NormalEqPlan:
    """The launch plan for d >= 2 (k = d - 1 factors) and L >= 0 slots.
    A staged row holds the factors rounded up to 4 columns, the constant
    and the target; A's rows are staged at an odd stride with a pad word
    after every 8 columns. The shared region holds the ring of ``rows``
    rows a stage, the uncompacted slots and ``band`` rows of A, whichever
    is largest (``work_floats`` in the source)."""
    if d < 2:
        raise ValueError(f"the normal-equation kernel takes d >= 2, got {d}")
    kc = -(-(d - 1) // 4) * 4
    t = -(-(kc + 2) // TILE)
    M = t * (t + 1) // 2
    groups = -(-M // MAX_THREADS)
    per = -(-M // groups)
    threads = -(-per // 32) * 32
    width = t * TILE
    stride = (d + (d - 1) // 8) | 1
    avail = _build.SMEM_LIMIT // 4 - _SLOT_FLOATS
    rows = MAX_ROWS
    while rows > 1 and STAGES * rows * width > avail:
        rows //= 2
    band = min(d, avail // stride)
    if STAGES * rows * width > avail or band < 1:
        raise ValueError(f"the normal-equation kernel stages rows of at most "
                         f"{avail // STAGES} floats, got d = {d}")
    work = max(STAGES * rows * width, 4 * SLICE, band * stride)
    slices = 1 if L <= SLICE else -(-L // SLICE)
    return NormalEqPlan(t, M, groups, per, threads, rows, width, band, stride,
                        slices, (work + _SLOT_FLOATS) * 4)


def cuda_normal_equations(other: torch.Tensor, other_ids: torch.Tensor,
                          ratings: torch.Tensor, mask: torch.Tensor,
                          mu: torch.Tensor, k: int, o_bias: int, o_const: int,
                          ridge: Union[float, torch.Tensor], bf16: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, b) of E entities' (E, L) slots against the CUDA table ``other``
    by ``mf_normal_eq``, on the current stream: the design row of a slot is
    ``other[id, :k]`` and its constant column ``o_const``, scaled by the
    slot's mask, its target ``(r - mu - other[id, o_bias]) * mask``;
    ``ridge`` is added to every diagonal (a float, or one value an entity
    as an (E,) or (E, 1) tensor); ``bf16`` rounds the gram's operands to
    bf16. ``other`` must be f32 with unit column stride, 16-byte aligned
    rows and at least ``k + 2`` columns; the slots int32 ids (rows of
    ``other``: the packs' padding slots hold row 0) and f32 ratings and
    mask on its device."""
    dev = other.device
    if dev.type != "cuda":
        raise ValueError(f"cuda_normal_equations takes CUDA tensors, got {dev}")
    if other.dim() != 2 or other.dtype != torch.float32 or other.stride(1) != 1:
        raise ValueError("other must be a 2-D float32 table with unit column stride")
    ldo = other.stride(0)
    if ldo % 4 or other.data_ptr() % 16 or other.shape[1] < -(-(k + 2) // 4) * 4:
        raise ValueError("other's rows must be 16-byte aligned and hold the k + 2 "
                         "columns rounded up to 4")
    if sorted((o_bias, o_const)) != [k, k + 1]:
        raise ValueError(f"the bias and constant columns must be {k} and {k + 1}")
    if other_ids.dim() != 2 or not other_ids.shape == ratings.shape == mask.shape:
        raise ValueError("other_ids, ratings and mask must share one (E, L) shape")
    if (other_ids.dtype, ratings.dtype, mask.dtype) != (torch.int32, torch.float32,
                                                        torch.float32):
        raise ValueError("the slots take int32 ids and float32 ratings and mask")
    E, L = other_ids.shape
    ids, r, m = (x.contiguous() for x in (other_ids, ratings, mask))
    mu_t = torch.as_tensor(mu, dtype=torch.float32, device=dev).reshape(())
    ridge_t = None
    if isinstance(ridge, torch.Tensor):
        ridge_t = ridge.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
        if ridge_t.numel() != E:
            raise ValueError(f"ridge holds {ridge_t.numel()} values for {E} entities")
    for t in (ids, r, m):
        if t.device != dev:
            raise ValueError("the slots must lie on the table's device")
    d = k + 1
    plan = normal_eq_plan(d, L)
    A = torch.empty((E, d, d), dtype=torch.float32, device=dev)
    b = torch.empty((E, d), dtype=torch.float32, device=dev)
    if E == 0:
        return A, b
    partial = None
    if plan.slices > 1:
        partial = torch.empty((E * plan.slices, plan.microtiles, TILE * TILE),
                              dtype=torch.float32, device=dev)
    LIB("mf_normal_eq",
        other.data_ptr(), ldo, ids.data_ptr(), r.data_ptr(), m.data_ptr(), E, L,
        mu_t.data_ptr(), k, o_bias, o_const,
        float(ridge) if ridge_t is None else 0.0,
        None if ridge_t is None else ridge_t.data_ptr(), int(bf16), plan.groups,
        plan.per_group, plan.threads, plan.rows, plan.width, plan.band,
        plan.stride, plan.slices, plan.smem_bytes, A.data_ptr(), b.data_ptr(),
        None if partial is None else partial.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    return A, b
