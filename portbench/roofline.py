"""The yardstick: one H100's published peaks, and the least time of each
kernel and of each whole unit of work from its shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity):
67 TFLOP/s in float32 outside the tensor cores (the port's products run
exact f32, TF32 off), 3.35 TB/s of HBM. A least time is the larger of
operations over the peak rate and bytes over the bandwidth, each input
byte read once and each output byte written once.

``sgd_bounds`` and ``spd_bound`` are copies of ``chip_smoke.py``'s
(kept here so that the yardstick does not move with the program's
files).
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def least_seconds(flops: float, nbytes: float,
                  dtype: str = "float32") -> Tuple[float, str]:
    """(seconds, 'operations' | 'bytes'): the larger of the two bounds,
    and which one binds."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sgd_bounds(n, kp, runs_prim, runs_sec):
    """{kernel: (bound_ms, bound_by, bytes)} of the SGD step and of the
    apply on one batch of ``n`` entries whose primary ids form
    ``runs_prim`` runs and whose sorted secondary ids ``runs_sec``: each
    input read once (ids, r, w; each distinct secondary row; each primary
    run's row), each output written once (the primary rows, dq; the
    apply's touched rows), at 3.35 TB/s; about 12 f32 operations per
    entry and column for the step, 1 for the apply, at 67 TFLOP/s."""
    row = kp * 4
    step_bytes = n * 16 + runs_sec * row + 2 * runs_prim * row + n * row
    apply_bytes = n * (row + 8) + 2 * runs_sec * row
    out = {}
    for name, nbytes, flops in (("sgd_step", step_bytes, 12 * n * kp),
                                ("segment_apply", apply_bytes, n * kp)):
        t, by = least_seconds(flops, nbytes)
        out[name] = (t * 1e3, by, nbytes)
    return out


def spd_bound(E, d):
    """(bound_ms, bound_by) of E Gauss-Jordan inverses: 2 d^3 f32
    operations and 8 d^2 bytes (read once, written once) a matrix."""
    t, by = least_seconds(2.0 * d ** 3 * E, 8.0 * d * d * E)
    return t * 1e3, by


def sgd_epoch_work(batches, k: int) -> Tuple[float, float]:
    """(operations, bytes) that any SGD epoch over these batches must do:
    per batch, each distinct user and item row (k factors and a bias, f32)
    read once and written once and the 16 bytes of each rating entry
    (two ids, the rating, its weight) read once; per entry a prediction
    (2 k), the two rows' gradients and updates (3 k each). ``batches``
    holds (entries, distinct users, distinct items) per batch."""
    row = (k + 1) * 4
    flops = nbytes = 0.0
    for n, users, items in batches:
        nbytes += 2.0 * (users + items) * row + 16.0 * n
        flops += 8.0 * k * n
    return flops, nbytes


def als_epoch_work(n_ratings: int, n_users: int, n_items: int,
                   k: int) -> Tuple[float, float]:
    """(operations, bytes) that any ALS epoch (a user and an item sweep)
    must do, with d = k + 1 unknowns an entity (factors and bias): each
    side's normal-equation products, 2 d^2 operations a rating, and one
    d x d SPD solve an entity (a Cholesky factor and two triangular
    solves, d^3 / 3 + 2 d^2); each side reads the other side's rows and
    the ratings (12 bytes) once and writes its own rows once."""
    d = k + 1
    flops = 2 * (2.0 * d * d * n_ratings) + (n_users + n_items) * (
        d ** 3 / 3.0 + 2.0 * d * d)
    nbytes = 2 * 12.0 * n_ratings + 2 * (n_users + n_items) * d * 4.0
    return flops, nbytes


def search_work(B: int, N: int, D: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of one exact dense search of B queries over an
    (N, D) f32 catalog: 2 B N D product operations; the catalog and the
    queries read once, the (B, k) scores (f32) and positions (int64)
    written once."""
    return 2.0 * B * N * D, 4.0 * N * D + 4.0 * B * D + 12.0 * B * k


def gemm_work(B: int, N: int, D: int) -> Tuple[float, float]:
    """(operations, bytes) of the search's score product alone: 2 B N D
    operations; the catalog and queries read once, the (B, N) f32 scores
    written once."""
    return 2.0 * B * N * D, 4.0 * N * D + 4.0 * B * D + 4.0 * B * N


def topk_work(B: int, N: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of a top-k over (B, N) f32 scores: the scores
    read once, the (B, k) scores and int64 positions written once; one
    comparison a score."""
    return float(B * N), 4.0 * B * N + 12.0 * B * k
