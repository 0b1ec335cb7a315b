"""The yardstick of an EASE fit on one H100: the least work of the whole
fit and of its gram, counted from the data, whatever implements them.

Peaks (NVIDIA's H100 SXM data sheet, dense): 1,979 TOP/s in int8 on the
tensor cores, and ``roofline.py``'s 67 TFLOP/s in float32 outside them
and 3.35 TB/s of HBM.

* ``fit_work``: the least of any explicit EASE fit. An SPD inverse of the
  n x n system costs at least n^3 operations (a Cholesky factor n^3 / 3
  and its inverse 2 n^3 / 3); the gram at least ``2 sum_u n_u^2``, one
  multiply and one add for each ordered pair of a user's plays. Bytes: the
  plays' two int32 ids read once, the gram and ``B`` (n x n f32) written
  once.
* ``gram_least_s``: the least time of the gram as the int8 path computes
  it, the symmetric half of the dense slab product over the real users,
  U n (n + 1) int8 operations at 1,979 TOP/s (0.49 s at 571,355 users and
  41,140 items), or, if larger, its bytes at 3.35 TB/s: the users' slabs
  (U x n int8) read once and the f32 gram written once. A gram that skips
  empty tiles would do less than this product and could read over 100%;
  such a kernel needs a ``benchmark`` PR to recount first.
"""

from __future__ import annotations

from typing import Tuple

from portbench.roofline import HBM_BYTES_PER_S, least_seconds

INT8_OPS_PER_S = 1979e12


def fit_work(n_items: int, sum_sq_counts: float, plays: int) -> Tuple[float, float]:
    """(f32 operations, bytes) of the least work of one fit."""
    n = float(n_items)
    return n ** 3 + 2.0 * sum_sq_counts, 8.0 * plays + 2.0 * 4.0 * n * n


def gram_least_s(n_users: int, n_items: int) -> float:
    """Seconds of the gram's least time on the int8 tensor cores."""
    U, n = float(n_users), float(n_items)
    t_ops = U * n * (n + 1.0) / INT8_OPS_PER_S
    t_bytes = (U * n + 4.0 * n * n) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes)


def fit_least_s(n_items: int, sum_sq_counts: float, plays: int) -> float:
    """Seconds of one fit's least time at the float32 peak."""
    return least_seconds(*fit_work(n_items, sum_sq_counts, plays))[0]
