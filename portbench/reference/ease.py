"""Plain EASE (Steck, WWW 2019) in PyTorch, for the benchmark's comparison.
Nothing here comes from the program.

With ``X`` the users' 0/1 (or weighted) plays and its gram ``G = X^T X``:

    P = (G + lam I)^{-1},    B = I - P diag(1 / diag P)   (diag B = 0)

and a user is served the ``k`` best items of ``x_u B`` that the user has
not played, ties to the lower index (the port's rule).

* ``gram``: ``G`` by plain scatters of each user's pairs of plays: users
  taken in order of their count, in blocks whose padded (users, L, L)
  pairs stay under ``PAIR_BLOCK``, every pair's ``w_a w_b`` added at
  ``(a, b)`` by ``index_add_`` (exact: the counts are integers far below
  2^53 in float64, 2^24 in float32).
* ``weights``: ``P`` from the Cholesky factor ``L`` of ``G + lam I`` as
  ``L^-T L^-1`` (``torch.cholesky_inverse``), then ``B``.
* ``serve``: the scores of given histories and their top ``k`` unseen.

``precision='f64'`` is the reference: float64, TF32 off. ``'tf32'``, the
control, computes in float32 and forms ``L^-T L^-1`` as a product with
TF32 allowed (``L^-1`` by a triangular solve): the one place where
TF32 acts on this computation.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

PAIR_BLOCK = 1 << 27
ROW_BLOCK = 4096


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dtype(precision: str) -> torch.dtype:
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def histories(u: torch.Tensor, i: torch.Tensor, w: torch.Tensor, n_users: int):
    """(order, starts, counts): the plays sorted by user (a stable order),
    where each user's plays start, and how many."""
    order = torch.argsort(u.long(), stable=True)
    counts = torch.bincount(u.long(), minlength=n_users)
    starts = torch.cumsum(counts, 0) - counts
    return order, starts, counts


def padded(users: torch.Tensor, L: int, i_s: torch.Tensor, w_s: torch.Tensor,
            starts: torch.Tensor, counts: torch.Tensor):
    """(len(users), L) item ids and weights of the users' plays, pads 0."""
    slot = torch.arange(L, device=users.device)
    mask = slot[None, :] < counts[users][:, None]
    pos = torch.where(mask, starts[users][:, None] + slot[None, :], 0)
    return i_s[pos].long() * mask, w_s[pos] * mask


def gram(u: torch.Tensor, i: torch.Tensor, w: torch.Tensor, n_users: int,
         n_items: int, precision: str = "f64") -> torch.Tensor:
    """``X^T X`` (n_items, n_items) by scatters of each user's pairs."""
    dt = _dtype(precision)
    dev = u.device
    order, starts, counts = histories(u, i, w, n_users)
    i_s, w_s = i[order], w[order].to(dt)
    G = torch.zeros(n_items * n_items, dtype=dt, device=dev)
    users = torch.nonzero(counts).flatten()
    users = users[torch.argsort(counts[users], descending=True, stable=True)]
    cnt = counts[users].cpu().numpy()
    lo = 0
    while lo < len(cnt):
        L = int(cnt[lo])
        hi = lo + max(1, PAIR_BLOCK // (L * L))
        ids, ws = padded(users[lo:hi], L, i_s, w_s, starts, counts)
        key = (ids[:, :, None] * n_items + ids[:, None, :]).reshape(-1)
        val = (ws[:, :, None] * ws[:, None, :]).reshape(-1)
        G.index_add_(0, key, val)
        del ids, ws, key, val
        lo = hi
    return G.view(n_items, n_items)


def weights(G: torch.Tensor, lam: float, precision: str = "f64") -> torch.Tensor:
    """``B`` (n, n) from the gram, which it consumes (pass the last
    reference: the system is formed in place)."""
    dt = _dtype(precision)
    A = G.to(dt)
    del G
    A.diagonal().add_(lam)
    L = torch.linalg.cholesky(A)
    del A
    if precision == "f64":
        P = torch.cholesky_inverse(L)
        del L
    else:
        eye = torch.eye(L.shape[0], dtype=dt, device=L.device)
        inv_l = torch.linalg.solve_triangular(L, eye, upper=False)
        del eye, L
        with _tf32(True):
            P = inv_l.T @ inv_l
        del inv_l
    d = P.diagonal().clone()
    B = P.div_(d[None, :]).neg_()
    B.diagonal().zero_()
    return B


def history_block(users: torch.Tensor, u: torch.Tensor, i: torch.Tensor,
                  w: torch.Tensor, n_users: int, n_items: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Dense (len(users), n_items) plays of the given users."""
    order, starts, counts = histories(u, i, w, n_users)
    L = max(1, int(counts[users].max()))
    ids, ws = padded(users, L, i[order], w[order].to(dtype), starts, counts)
    X = torch.zeros((len(users), n_items), dtype=dtype, device=u.device)
    rows = torch.arange(len(users), device=u.device)[:, None].expand_as(ids)
    return X.index_put_((rows, ids), ws, accumulate=True)


def scores(X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``X B`` in B's dtype (TF32 off)."""
    with _tf32(False):
        return X.to(B.dtype) @ B


def serve(X: torch.Tensor, B: torch.Tensor, k: int):
    """(values, items), each (users, k): the ``k`` best scores of ``X B``
    among the items each user has not played, score descending, ties to
    the lower index."""
    s = scores(X, B)
    s.masked_fill_(X != 0, float("-inf"))
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return s.gather(1, order), order


def max_abs_gap(B: torch.Tensor, R: torch.Tensor) -> tuple:
    """(max |B - R|, max |R|) over row blocks, in float64."""
    gap = top = 0.0
    for lo in range(0, R.shape[0], ROW_BLOCK):
        hi = min(lo + ROW_BLOCK, R.shape[0])
        r = R[lo:hi].double()
        b = B[lo:hi, :R.shape[1]].to(r.device).double()
        gap = max(gap, float((b - r).abs().max()))
        top = max(top, float(r.abs().max()))
    return gap, top


def sample_users(n_users: int, counts: np.ndarray, n: int, seed: int) -> np.ndarray:
    """``n`` users with plays, drawn without replacement from ``seed``,
    sorted."""
    rng = np.random.default_rng(seed)
    have = np.flatnonzero(counts > 0)
    return np.sort(rng.choice(have, size=min(n, len(have)), replace=False))
