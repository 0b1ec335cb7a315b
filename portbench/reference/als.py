"""Plain alternating least squares of the biased factor model, in PyTorch,
for the benchmark's comparison. Nothing here comes from the program.

The model is ``mu + <p_u, q_i> + b_u + b_i``. An epoch solves every user
with ratings, then every item with ratings, each exactly: a user's
unknowns ``[p_u, b_u]`` (d = k + 1) minimise

    sum over its ratings of (r - mu - b_i - <p_u, q_i> - b_u)^2
        + reg * n_u * (|p_u|^2 + b_u^2)

(``reg_scale='per_obs'``: the ridge grows with the entity's count n_u),
so ``(X^T X + reg n_u I) w = X^T y`` with design rows ``x = [q_i, 1]`` and
targets ``y = r - mu - b_i``; items likewise against the new user rows.
Entities without ratings keep their rows.

Entities are taken in order of their count, in chunks whose padded design
blocks and grams stay under a budget of elements, and solved by
Cholesky.
``precision='f64'`` is the reference; ``'tf32'``, the control, computes
in float32 with TF32 allowed in the products.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

BLOCK_ELEMS = 1 << 27


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class ALS:
    """The reference's tables and sweeps; ``T`` as in ``reference.sgd``."""

    def __init__(self, T: Dict[str, torch.Tensor], mu: float, reg: float,
                 precision: str = "f64"):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.tf32 = precision == "tf32"
        self.T = {n: t.to(self.dtype).clone() for n, t in T.items()}
        self.mu, self.reg = mu, reg

    def _half(self, own: str, other: str, ids, oids, r) -> None:
        F, b = self.T[f"{own}_factors"], self.T[f"{own}_bias"]
        G, gb = self.T[f"{other}_factors"], self.T[f"{other}_bias"]
        d = F.shape[1] + 1
        dev = F.device
        order = torch.argsort(ids, stable=True)
        oid_s, r_s = oids[order].long(), r[order].to(self.dtype)
        counts = torch.bincount(ids.long(), minlength=F.shape[0])
        starts = torch.cumsum(counts, 0) - counts
        ent = torch.nonzero(counts).flatten()
        ent = ent[torch.argsort(counts[ent], stable=True)]
        cnt = counts[ent].cpu().tolist()
        design = torch.cat([G, torch.ones((G.shape[0], 1), dtype=self.dtype,
                                          device=dev)], dim=1)
        lo = 0
        while lo < len(cnt):
            hi = lo + 1
            while (hi < len(cnt)
                   and (hi + 1 - lo) * max(cnt[hi], d) * d <= BLOCK_ELEMS):
                hi += 1
            L = cnt[hi - 1]
            e = ent[lo:hi]
            slot = torch.arange(L, device=dev)
            mask = slot[None, :] < counts[e][:, None]
            pos = torch.where(mask, starts[e][:, None] + slot[None, :], 0)
            o = oid_s[pos]
            X = design[o] * mask[..., None]
            y = (r_s[pos] - self.mu - gb[o]) * mask
            with _tf32(self.tf32):
                A = X.transpose(1, 2) @ X
                rhs = X.transpose(1, 2) @ y[..., None]
            A.diagonal(dim1=-2, dim2=-1).add_(
                (self.reg * counts[e].to(self.dtype))[:, None])
            w = torch.cholesky_solve(rhs, torch.linalg.cholesky(A))[..., 0]
            F[e] = w[:, :-1]
            b[e] = w[:, -1]
            lo = hi

    def epoch(self, u, i, r) -> None:
        self._half("user", "item", u, i, r)
        self._half("item", "user", i, u, r)

    def rmse(self, u, i, r, chunk: int = 1 << 20) -> float:
        T = self.T
        sse = 0.0
        for lo in range(0, r.numel(), chunk):
            ul, il = u[lo:lo + chunk].long(), i[lo:lo + chunk].long()
            pred = (self.mu + (T["user_factors"][ul] * T["item_factors"][il]).sum(-1)
                    + T["user_bias"][ul] + T["item_bias"][il])
            sse += float(((pred - r[lo:lo + chunk].to(self.dtype)) ** 2).sum())
        return (sse / r.numel()) ** 0.5
