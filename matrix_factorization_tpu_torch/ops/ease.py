"""EASE, the embarrassingly shallow autoencoder (Steck, WWW 2019), PyTorch
port.

Counterpart of ``matrix_factorization_tpu/ops/ease.py``, single device.
With ``X`` the (users x items) interaction matrix and its gram
``G = X^T X``, the problem

    min_B ||X - X B||_F^2 + lam ||B||_F^2   s.t.  diag(B) = 0

has the closed form

    P = (G + lam I)^{-1}
    B = I - P . diag(1 / diag(P))        (so diag(B) = 0)

one regularized SPD inverse of the item gram. Serving is ``s_u = x_u B``.

* The gram (:func:`item_gram`) is a sum over user chunks: each chunk's
  (user, item) pairs are written into a dense ``(chunk_users, I_p)`` slab
  and ``D^T D`` is added in exact f32 (co-occurrence counts are exact in
  f32, and the inverse is precision-sensitive).
* The inverse (:func:`ease_weights`) is ``ops/spd.py::spd_inverse_scaled``:
  Jacobi scaling, the Schur recursion split at multiples of 8 down to
  leaves of d <= 128, which the Gauss-Jordan leaf inverts (the hand-written
  kernel of ``csrc/spd_gj.cu`` on a CUDA tensor), then one Newton-Schulz
  step. Item padding to a multiple of 8 is exact: pad rows of ``G`` are 0,
  so the pad block of ``P`` is ``(1/lam) I`` and the pad rows and columns
  of ``B`` are 0.
* The gram and the inverse hold O(I_p^2) f32 (a few live copies through
  the recursion); :func:`check_item_budget` refuses catalogs above 16,384
  items.
* Serving (:func:`history_scores`) writes user histories into a dense
  ``(B, I_p)`` block and scores the catalog with one product.

The data-parallel gram and the sharded inverses (``dp_item_gram``,
``ease_weights_sharded``) come with slice 6.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.spd import _mm, exact_f32, spd_inverse_scaled


class EASEParams(NamedTuple):
    """The trained state: one (I_p, I_p) item-item weight matrix."""

    item_weights: torch.Tensor


def round8(n: int) -> int:
    return ((max(n, 1) + 7) // 8) * 8


def check_item_budget(n_items: int, item_limit: int = 16384) -> None:
    """Raise before building a gram above the item budget: the gram, the
    inverse and the recursion's temporaries are O(items^2)."""
    if round8(n_items) > item_limit:
        raise ValueError(
            f"EASE at {n_items} items needs O(items^2) device memory; the "
            f"budget here is {item_limit} items. Past it use ImplicitALS, "
            f"which ranks implicit feedback with O(items x k) memory.")


def _gram_chunks(u: np.ndarray, i: np.ndarray, w: np.ndarray,
                 n_users: int, chunk_users: int):
    """Host pack: pairs sorted by user, split at user-chunk boundaries,
    every chunk's list padded to the longest (a power of two; weight-0
    pads are inert). Returns (lu, ii, ww), each (n_chunks, P_max): user
    ids local to the chunk, item ids, weights."""
    order = np.argsort(u, kind="stable")
    u, i, w = u[order], i[order], w[order]
    n_chunks = max(1, (n_users + chunk_users - 1) // chunk_users)
    starts = np.searchsorted(u, np.arange(n_chunks) * chunk_users)
    ends = np.append(starts[1:], len(u))
    pmax = max(1, int((ends - starts).max()))
    pmax = 1 << (pmax - 1).bit_length()
    lu = np.zeros((n_chunks, pmax), np.int32)
    ii = np.zeros((n_chunks, pmax), np.int32)
    ww = np.zeros((n_chunks, pmax), np.float32)
    for c in range(n_chunks):
        s, e = starts[c], ends[c]
        lu[c, : e - s] = u[s:e] - c * chunk_users
        ii[c, : e - s] = i[s:e]
        ww[c, : e - s] = w[s:e]
    return lu, ii, ww


def item_gram(u: np.ndarray, i: np.ndarray, w: np.ndarray, n_users: int,
              n_items: int, chunk_users: int = 2048, device=None) -> torch.Tensor:
    """(I_p, I_p) item co-occurrence gram ``X^T X`` on ``device`` (``None``
    = CUDA). ``w``: per-pair weights (all ones for binary EASE). No
    (users x items) matrix is formed: one chunk's dense slab at a time."""
    dev = resolve_device(device)
    ip = round8(n_items)
    cu = min(chunk_users, round8(n_users))
    lu, ii, ww = (torch.from_numpy(a).to(dev)
                  for a in _gram_chunks(u, i, w, n_users, cu))
    G = torch.zeros((ip, ip), dtype=torch.float32, device=dev)
    D = torch.empty((cu, ip), dtype=torch.float32, device=dev)
    with exact_f32():
        for c in range(lu.shape[0]):
            D.zero_()
            # pads add 0.0 at (0, 0): exact, so the order of the sum is moot
            D.index_put_((lu[c].long(), ii[c].long()), ww[c], accumulate=True)
            G.addmm_(D.T, D)
    return G


def _closed_form(P: torch.Tensor) -> torch.Tensor:
    """``B = -P / diag(P)`` column-wise with an exactly zero diagonal."""
    d = torch.diagonal(P, dim1=-2, dim2=-1)
    B = -P / d[..., None, :]
    B.diagonal(dim1=-2, dim2=-1).zero_()
    return B


def ease_weights(G: torch.Tensor, lam: float, leaf: str = "auto") -> torch.Tensor:
    """The closed-form EASE matrix ``B`` from the gram, (I_p, I_p) on
    ``G``'s device; ``leaf`` as in ``ops/spd.py``."""
    ip = G.shape[-1]
    A = G + lam * torch.eye(ip, dtype=torch.float32, device=G.device)
    return _closed_form(spd_inverse_scaled(A, leaf=leaf))


def ease_weights_multi(G: torch.Tensor, lams) -> torch.Tensor:
    """The closed form for several ridges at once: the gram does not depend
    on lam, so a sweep is one batched Schur-recursion inverse of the
    stacked ``G + lam_l I``, in batches of at most ~2 GiB of systems.
    Returns (L, I_p, I_p)."""
    lams = torch.as_tensor(np.asarray(lams, np.float32), device=G.device)
    ip = G.shape[-1]
    chunk = max(1, int((2 << 30) // (16 * ip * ip)))
    eye = torch.eye(ip, dtype=torch.float32, device=G.device)
    outs = []
    for lo in range(0, len(lams), chunk):
        part = lams[lo:lo + chunk]
        A = G[None] + part[:, None, None] * eye
        outs.append(_closed_form(spd_inverse_scaled(A)))
    return torch.cat(outs, dim=0)


def _scatter_block(ids: torch.Tensor, w: torch.Tensor, ip: int) -> torch.Tensor:
    """(nb, L) padded histories -> dense (nb, I_p) interaction block
    (weight-0 pads add an exact 0)."""
    nb, L = ids.shape
    rows = torch.arange(nb, device=ids.device)[:, None].expand(nb, L)
    X = torch.zeros((nb, ip), dtype=torch.float32, device=ids.device)
    return X.index_put_((rows, ids.long()), w, accumulate=True)


def _scores(X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``X B`` in f32 with ``X`` rounded to ``B``'s dtype, then both
    multiplied in exact f32 (the product of two bf16 values is exact in
    f32): a bf16 product with an f32 accumulator for a bf16 ``B``."""
    return _mm(X.to(B.dtype).float(), B.float())


def score_history_block(B: torch.Tensor, ids: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Catalog scores (nb, I_p) f32 of (nb, L) padded histories: the dense
    history block times ``B``. Binary histories are exact in bf16;
    rating-valued weights round there when ``B`` is bf16."""
    return _scores(_scatter_block(ids, w, B.shape[0]), B)


def history_topk_unseen(B: torch.Tensor, ids: np.ndarray, w: np.ndarray,
                        k: int, n_valid: int):
    """Top-``k`` unseen items per history row (the ranking evaluation's
    leave-out protocol): the rows' own items and the pad columns score
    ``-inf``; ties to the lower index. Returns host (vals, idx), each
    (nb, k)."""
    X = _scatter_block(torch.from_numpy(np.asarray(ids, np.int32)).to(B.device),
                       torch.from_numpy(np.asarray(w, np.float32)).to(B.device),
                       B.shape[0])
    s = _scores(X, B)
    s.masked_fill_(X > 0, float("-inf"))
    s[:, n_valid:] = float("-inf")
    vals, idx = stable_topk(s, k)
    return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()


def history_scores(B: torch.Tensor, ids: np.ndarray, w: np.ndarray) -> torch.Tensor:
    """Full catalog scores ``x_u B`` (n_users, I_p) of a cohort's padded
    histories ``ids`` / ``w`` (n_users, L), on ``B``'s device."""
    return score_history_block(
        B, torch.from_numpy(np.asarray(ids, np.int32)).to(B.device),
        torch.from_numpy(np.asarray(w, np.float32)).to(B.device))
