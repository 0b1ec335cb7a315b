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
  the recursion); :func:`check_item_budget` refuses catalogs above the
  item budget of the data ranks (:func:`item_limit`: 16,384 items on one,
  32,768 on 4 or more, 65,536 on 8 or more, the JAX package's tiers).
* Serving (:func:`history_scores`) writes user histories into a dense
  ``(B, I_p)`` block and scores the catalog with one product.

On a mesh (one process a rank, ``torch.distributed``):

* :func:`dp_item_gram` splits the users over the data ranks, each builds
  its gram by the same chunk scan, and one ``all_reduce`` over the data
  group sums them: co-occurrence counts are integers, so the gram is
  equal to :func:`item_gram`'s.
* :func:`ease_weights_sharded` leaves ``B`` row-sharded over the mesh's
  first axis (``ops/spd.py::ns_layout``). From 16,384 items it takes the
  row-sharded Newton-Schulz inverse (``ops/spd.py::ns_sharded_steps``),
  whose memory is three row shards and one column slab a rank; below, the
  Schur recursion. JAX partitions that recursion with GSPMD, which torch
  has not: here every rank runs the single-device :func:`ease_weights`
  (the Gauss-Jordan leaf on the card) on its replicated gram and keeps
  its rows, a stated departure held to JAX's result at JAX's bar.
* :func:`score_history_rows` scores a cohort with a row-sharded ``B``:
  each rank multiplies its columns of the history block by its rows of
  ``B``, and one ``all_reduce`` sums the partial products.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.spd import (
    _mm,
    exact_f32,
    ns_layout,
    ns_sharded_steps,
    padded_rows,
    spd_inverse_scaled,
)

NS_ITEM_THRESHOLD = 16384  # the Schur recursion below, Newton-Schulz at or above


class EASEParams(NamedTuple):
    """The trained state: one (I_p, I_p) item-item weight matrix."""

    item_weights: torch.Tensor


def round8(n: int) -> int:
    return ((max(n, 1) + 7) // 8) * 8


def item_limit(n_data: int) -> int:
    """The item budget on ``n_data`` data ranks, the JAX package's tiers
    (``models/ease.py:125-137``): 16,384 on one, 32,768 on 4 or more,
    65,536 on 8 or more."""
    if n_data >= 8:
        return 65536
    if n_data >= 4:
        return 32768
    return 16384


def check_item_budget(n_items: int, item_limit: int = 16384) -> None:
    """Raise before building a gram above the item budget: the gram, the
    inverse and the recursion's temporaries are O(items^2)."""
    if round8(n_items) > item_limit:
        raise ValueError(
            f"EASE at {n_items} items needs O(items^2) device memory; the "
            f"budget here is {item_limit} items (16,384 on one data rank, "
            f"32,768 on 4 or more, 65,536 on 8 or more: pass mesh= to raise "
            f"it). Past it use ImplicitALS, which ranks implicit feedback "
            f"with O(items x k) memory.")


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
    return _gram_scan(u, i, w, n_users, round8(n_items),
                      min(chunk_users, round8(n_users)), dev)


def _gram_scan(u, i, w, n_users: int, ip: int, cu: int, dev) -> torch.Tensor:
    """``X^T X`` of the users ``[0, n_users)``, one chunk of ``cu`` users'
    dense slab at a time."""
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


def dp_item_gram(u: np.ndarray, i: np.ndarray, w: np.ndarray, n_users: int,
                 n_items: int, mesh, chunk_users: int = 2048,
                 device=None) -> torch.Tensor:
    """The data-parallel gram (JAX ``ops/ease.py:157-226``): data rank d
    takes the ``upd = round8(ceil(n_users / N))`` users ``[d upd, (d + 1)
    upd)``, rebased to 0, builds their gram by :func:`item_gram`'s scan,
    and one ``all_reduce`` over the data group (not the world: on a 2D
    mesh the model ranks hold the same users) sums the ranks' grams.
    Returns the (I_p, I_p) gram, replicated, on ``device`` (``None`` =
    CUDA)."""
    import torch.distributed as dist

    from matrix_factorization_tpu_torch.parallel.mesh import (
        data_group,
        data_size_of,
        device_index,
    )

    dev = resolve_device(device)
    n_dev, d = data_size_of(mesh), device_index(mesh)
    upd = round8(max(1, -(-n_users // n_dev)))
    u = np.asarray(u).astype(np.int64)
    mine = (u // upd) == d
    G = _gram_scan(u[mine] - d * upd, np.asarray(i)[mine], np.asarray(w)[mine],
                   upd, round8(n_items), min(chunk_users, upd), dev)
    dist.all_reduce(G, group=data_group(mesh))
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


def ease_weights_sharded(G: torch.Tensor, lam: float, mesh, leaf: str = "auto",
                         inverse: str = "auto", ns_tol: float = 1e-5
                         ) -> torch.Tensor:
    """The closed form with ``B`` row-sharded over ``mesh``'s first axis
    (JAX ``ops/ease.py:262-336``): this rank's rows ``[lo, hi)``
    (``ops/spd.py::ns_layout``) of ``B``, (hi - lo, I_p), from the
    replicated gram ``G``.

    ``inverse``: ``'ns'``, the row-sharded Newton-Schulz inverse: the
    rank's rows of ``G + lam I`` are padded and the replicated gram is
    let go before the steps (pass the last reference to ``G``, as
    ``EASE.fit`` does, and a rank's memory during the steps is three row
    shards and one slab), then the closed form on the rank's rows, the
    diagonal of ``P`` all-gathered from the ranks' pieces. ``'schur'``:
    every rank runs :func:`ease_weights` (the Schur recursion with the
    ``leaf``, Gauss-Jordan by default) on its whole gram and keeps its
    rows. ``'auto'``: ``'ns'`` from ``NS_ITEM_THRESHOLD`` items, else
    ``'schur'``. The diagonal of ``B`` is exactly zero."""
    from matrix_factorization_tpu_torch.parallel.distributed import all_gather_rows

    ip = G.shape[-1]
    if inverse == "auto":
        inverse = "ns" if ip >= NS_ITEM_THRESHOLD else "schur"
    if inverse not in ("schur", "ns"):
        raise ValueError(f"unknown inverse {inverse!r}: 'auto', 'schur' or 'ns'")
    lay = ns_layout(ip, mesh)
    if inverse == "schur":
        B = ease_weights(G, lam, leaf)
        del G
        return B[lay.lo:lay.hi].clone()
    Ap = padded_rows(G[lay.lo:lay.hi], lay)
    del G
    Ap.diagonal(offset=lay.row0)[:lay.hi - lay.lo].add_(lam)
    P = ns_sharded_steps(Ap, lay, tol=ns_tol)
    del Ap
    diag = all_gather_rows(P.diagonal(offset=lay.row0).contiguous(), lay.group)[:ip]
    B = P[:lay.hi - lay.lo, :ip].div_(diag[None, :]).neg_()
    B.diagonal(offset=lay.lo).zero_()
    return B.clone()


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


def score_history_rows(B_rows: torch.Tensor, lo: int, ids: torch.Tensor,
                       w: torch.Tensor, ip: int, group) -> torch.Tensor:
    """Catalog scores (nb, I_p) f32 with ``B`` row-sharded over ``group``:
    this rank's columns ``[lo, lo + rows)`` of the history block times its
    rows ``B_rows`` of ``B``, the ranks' partial products summed by one
    ``all_reduce``. No rank holds the whole ``B``."""
    import torch.distributed as dist

    X = _scatter_block(ids, w, ip)[:, lo:lo + B_rows.shape[0]]
    s = _scores(X, B_rows)
    dist.all_reduce(s, group=group)
    return s


def history_scores(B: torch.Tensor, ids: np.ndarray, w: np.ndarray) -> torch.Tensor:
    """Full catalog scores ``x_u B`` (n_users, I_p) of a cohort's padded
    histories ``ids`` / ``w`` (n_users, L), on ``B``'s device."""
    return score_history_block(
        B, torch.from_numpy(np.asarray(ids, np.int32)).to(B.device),
        torch.from_numpy(np.asarray(w, np.float32)).to(B.device))
