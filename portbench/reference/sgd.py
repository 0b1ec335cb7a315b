"""Plain mini-batch SGD of kernel matrix factorization, in PyTorch, for
the benchmark's comparison. Nothing here comes from the program.

The model: ``x = mu + <p_u, q_i> + b_u + b_i``; the linear kernel
predicts ``x``, the sigmoid kernel ``a + c * sigmoid(x)`` with ``a`` the
least rating and ``c`` the range. A step reads every row as it stood
before the step and adds the sum of the batch's per-rating updates to each
row: for a rating with error ``e = pred - r`` and ``g = dpred/dx / c``
(the gradient convention of the reference implementation, which leaves
``c`` out: 1 for linear, ``s (1 - s)`` for sigmoid),

    p_u -= lr (e g q_i + reg p_u)     b_u -= lr (e g + reg b_u)
    q_i -= lr (e g p_u + reg q_i)     b_i -= lr (e g + reg b_i)

The batches are the program's documented pack: the ratings in the order
of ``numpy.random.default_rng(shuffle_seed).permutation(n)``, cut into
consecutive batches of ``batch_size`` (the last one short).

``precision='f64'`` computes in float64, the reference. ``'bf16'``, the
control, keeps the tables in bfloat16 (rounded after every step) and
computes in float32: the precision a faster SGD would be tempted by.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def batch_entries(n: int, batch_size: int, shuffle_seed: int) -> List[np.ndarray]:
    """The rating indices of each batch of the pack."""
    perm = np.random.default_rng(shuffle_seed).permutation(n)
    return [perm[lo:lo + batch_size] for lo in range(0, n, batch_size)]


class SGD:
    """The reference's tables and steps. ``T`` holds ``user_factors``,
    ``user_bias``, ``item_factors`` and ``item_bias``."""

    def __init__(self, T: Dict[str, torch.Tensor], mu: float, kernel: str,
                 lr: float, reg: float, min_rating: float, max_rating: float,
                 precision: str = "f64"):
        if kernel not in ("linear", "sigmoid"):
            raise ValueError(f"no reference for the {kernel!r} kernel")
        if precision not in ("f64", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.store = torch.float64 if precision == "f64" else torch.bfloat16
        self.T = {n: t.to(self.store) for n, t in T.items()}
        self.mu = mu
        self.kernel, self.lr, self.reg = kernel, lr, reg
        self.a, self.c = min_rating, max_rating - min_rating

    def _rows(self, u, i):
        c = lambda n, ix: self.T[n][ix].to(self.dtype)  # noqa: E731
        return (c("user_factors", u), c("user_bias", u),
                c("item_factors", i), c("item_bias", i))

    def predict(self, u: torch.Tensor, i: torch.Tensor):
        """(prediction, dpred/dx without c) of each pair."""
        p, bu, q, bi = self._rows(u, i)
        x = self.mu + (p * q).sum(-1) + bu + bi
        if self.kernel == "linear":
            return x, torch.ones_like(x)
        s = torch.sigmoid(x)
        return self.a + self.c * s, s * (1 - s)

    def step(self, u: torch.Tensor, i: torch.Tensor, r: torch.Tensor) -> None:
        p, bu, q, bi = self._rows(u, i)
        pred, g = self.predict(u, i)
        eg = (pred - r.to(self.dtype)) * g
        upd = {"user_factors": (u, eg[:, None] * q + self.reg * p),
               "user_bias": (u, eg + self.reg * bu),
               "item_factors": (i, eg[:, None] * p + self.reg * q),
               "item_bias": (i, eg + self.reg * bi)}
        for n, (ix, grad) in upd.items():
            t = self.T[n].to(self.dtype)
            t.index_add_(0, ix, grad, alpha=-self.lr)
            self.T[n] = t.to(self.store)

    def rmse(self, u: torch.Tensor, i: torch.Tensor, r: torch.Tensor) -> float:
        pred, _ = self.predict(u, i)
        return float(torch.sqrt(torch.mean((pred - r.to(self.dtype)) ** 2)))
