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

* The gram (:func:`item_gram`) is a sum over user chunks, in two calls:
  :func:`gram_pack` sorts the (user, item, weight) triples by user on the
  host (an argsort of every pair) and records where each user chunk
  starts, and
  :func:`gram_scan` runs the chunks on the device. It takes one of two
  paths, both exact and equal bit for bit. Where every weight is an
  integer of magnitude at most 127, no pair repeats and every count is
  below 2^24 (:func:`int8_exact`), a CUDA device writes each chunk of
  ``INT8_CHUNK_USERS`` users into an item-major int8 slab and adds its
  upper tiles of ``D^T D`` to an int32 gram on the tensor cores, then
  converts it to f32 once (``ops/cuda_gram.py``, the kernels of
  ``csrc/ease_gram.cu``). Otherwise, and always on the CPU, each chunk's
  pairs are written into a dense ``(chunk_users, I_p)`` f32 slab and
  ``D^T D`` is added in exact f32 (co-occurrence counts are exact in f32,
  and the inverse is precision-sensitive).
* The inverse (:func:`ease_weights`) is ``ops/spd.py::spd_inverse_scaled``:
  Jacobi scaling, the Schur recursion split at multiples of 8 down to
  leaves of d <= 128, which the Gauss-Jordan leaf inverts (the hand-written
  kernel of ``csrc/spd_gj.cu`` on a CUDA tensor), then one Newton-Schulz
  step. Item padding to a multiple of 8 is exact: pad rows of ``G`` are 0,
  so the pad block of ``P`` is ``(1/lam) I`` and the pad rows and columns
  of ``B`` are 0. :func:`fit_packed` runs the scan, the inverse and the
  closed form on a pack, the ridge added to the gram in place and the
  closed form written over ``P``, so that a fit holds at most about
  ``FIT_PEAK_COPIES`` (I_p, I_p) f32 matrices at once.
* The gram and the inverse hold O(I_p^2) f32; :func:`check_item_budget`
  refuses catalogs above the item budget (:func:`device_item_limit`). On
  one data rank of a CUDA card it is the largest multiple of 8 whose fit
  peak, ``FIT_PEAK_COPIES * I_p^2 * 4`` bytes above ``PLAY_BYTES`` a play
  (both measured on the card), fits in ``BUDGET_SHARE`` of the card's
  memory. This departs from the JAX package, whose tiers were set for a
  16 GB TPU v5e and which the CPU and the mesh keep (:func:`item_limit`:
  16,384 items on one data rank, 32,768 on 4 or more, 65,536 on 8 or
  more).
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

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.device import resolve_device
from matrix_factorization_tpu_torch.ops import cuda_gram
from matrix_factorization_tpu_torch.ops.scoring import stable_topk
from matrix_factorization_tpu_torch.ops.spd import (
    _mm,
    exact_f32,
    ns_layout,
    ns_sharded_steps,
    padded_rows,
    spd_inverse_scaled,
)
from matrix_factorization_tpu_torch.utils.profiling import span

NS_ITEM_THRESHOLD = 16384  # the Schur recursion below, Newton-Schulz at or above
INT8_CHUNK_USERS = 16384  # users a slab on the int8 path (its int8 slab at
# 41,144 items is 0.68 GB; the int32 gram is read and written once a chunk)
EXACT_COUNT = 1 << 24  # counts below it convert to f32 exactly
# A one-rank fit's peak on a CUDA card is ``FIT_PEAK_COPIES`` (I_p, I_p) f32
# matrices (the inverse's; the gram's, one int32 matrix and a slab, is lower)
# above what stays resident through it, ``PLAY_BYTES`` a play (the pack's two
# int32 ids and f32 weight, 12, and the model's own state). Measured by
# ``torch.cuda.max_memory_allocated`` at 571,355 users x 41,144 items and
# 33,633,450 plays on an H100 (``tools/probe_ease.py --model``): the fit
# 22,044,183,552 bytes = 3.2555 x 41,144^2 x 4 above 404,018,688 resident
# (12.01 bytes a play); ``EASE.fit`` in all 22,495,125,504 (13.41 a play).
# Both rounded up; the card's last tenth (``BUDGET_SHARE``) is left for the
# CUDA context, cuBLAS's workspace and the caching allocator's slack. A fit at
# the budget this gives an 80 GB H100 for those plays, 76,328 items, ran there
# (``tools/probe_ease.py --at-budget``): 76,313,774,592 bytes allocated at its
# peak, 81,166,073,856 reserved of 85,017,493,504.
FIT_PEAK_COPIES = 3.26
PLAY_BYTES = 16
BUDGET_SHARE = 0.9  # of the card's memory that the item budget fills


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


def device_item_limit(n_data: int, device, n_plays: int = 0) -> int:
    """The item budget of a fit of ``n_plays`` plays on ``n_data`` data
    ranks whose state lives on ``device``. On one data rank of a CUDA card
    the largest multiple of 8, I_p, with ``FIT_PEAK_COPIES * I_p^2 * 4 +
    PLAY_BYTES * n_plays <= BUDGET_SHARE * total_memory`` (a departure from
    the JAX package's 16,384, which was set for a 16 GB TPU), else
    :func:`item_limit`'s tiers."""
    dev = torch.device(device)
    if n_data > 1 or dev.type != "cuda":
        return item_limit(n_data)
    room = (BUDGET_SHARE * torch.cuda.get_device_properties(dev).total_memory
            - PLAY_BYTES * n_plays)
    return math.isqrt(max(0, int(room / (4.0 * FIT_PEAK_COPIES)))) // 8 * 8


def check_item_budget(n_items: int, item_limit: int = 16384) -> None:
    """Raise before building a gram above the item budget: the gram, the
    inverse and the recursion's temporaries are O(items^2)."""
    if round8(n_items) > item_limit:
        raise ValueError(
            f"EASE at {n_items} items needs O(items^2) device memory; the "
            f"budget here is {item_limit} items (on one data rank 16,384 on "
            f"the CPU and, on a CUDA card, as many as {BUDGET_SHARE:.0%} of "
            f"its memory holds; 32,768 on 4 or more data ranks, 65,536 on 8 "
            f"or more: pass mesh= to raise it). Past it use ImplicitALS, "
            f"which ranks implicit feedback with O(items x k) memory.")


def _gram_chunks(u: np.ndarray, i: np.ndarray, w: np.ndarray,
                 n_users: int, chunk_users: int):
    """Host pack: the pairs sorted by user (a stable argsort), split at
    user-chunk boundaries. Returns (lu, ii, ww, bounds): user ids local to
    their chunk (int32), item ids (int32), weights (f32), and the
    (n_chunks + 1,) offsets, chunk c's pairs lying at
    ``[bounds[c], bounds[c + 1])``. Its size is the pairs', whatever the
    order of the users."""
    order = np.argsort(u, kind="stable")
    u = np.asarray(u, np.int64)[order]
    n_chunks = max(1, (n_users + chunk_users - 1) // chunk_users)
    bounds = np.searchsorted(u, np.arange(n_chunks + 1) * chunk_users)
    return ((u % chunk_users).astype(np.int32), np.asarray(i)[order].astype(np.int32),
            np.asarray(w)[order].astype(np.float32), bounds)


class GramPack(NamedTuple):
    """The host pack of a gram (:func:`gram_pack`): chunk-local user ids,
    item ids and weights of the pairs sorted by user, on the device; the
    chunks' offsets into them (host ints, :func:`_gram_chunks`); the padded
    items, the users a chunk; and for the int8 path the order of its tiles
    (``None`` on the f32 path)."""

    lu: torch.Tensor
    ii: torch.Tensor
    ww: torch.Tensor
    bounds: tuple
    ip: int
    cu: int
    tiles: Optional[torch.Tensor]


def int8_exact(i: np.ndarray, w: np.ndarray, n_items: int) -> bool:
    """Whether the int8 gram is exact for these pairs, if no pair repeats
    (:func:`gram_pack` checks that on the device): every weight an integer
    of magnitude at most 127, and the largest diagonal count, the most any
    item's plays give ``sum w^2``, below 2^24, which bounds every partial
    sum of the gram (Cauchy-Schwarz), so that it fits an int32 and converts
    to f32 exactly."""
    w = np.asarray(w)
    if not len(w) or not (np.all(np.abs(w) <= 127) and np.all(w == np.rint(w))):
        return False
    diag = np.bincount(np.asarray(i, np.int64), weights=np.square(w.astype(np.float64)),
                       minlength=n_items)
    return float(diag.max()) < EXACT_COUNT


def _pairs_unique(lu: torch.Tensor, ii: torch.Tensor, ww: torch.Tensor,
                  bounds, cu: int, ip: int) -> bool:
    """No (user, item) pair with a nonzero weight repeats: one sort of the
    pairs' keys on their device."""
    counts = torch.as_tensor(np.diff(bounds), device=lu.device)
    chunk = torch.repeat_interleave(torch.arange(len(counts), device=lu.device), counts)
    key = ((chunk * cu + lu) * ip + ii)[ww != 0].sort().values
    return not bool((key[1:] == key[:-1]).any())


def _pack(u, i, w, n_users: int, ip: int, cu: int, dev) -> GramPack:
    """:func:`gram_pack` of the users ``[0, n_users)`` at ``ip`` padded
    items, ``cu`` users a chunk on the f32 path."""
    def put(c):
        lu, ii, ww, bounds = _gram_chunks(u, i, w, n_users, c)
        return (*(torch.from_numpy(a).to(dev) for a in (lu, ii, ww)),
                tuple(int(b) for b in bounds))

    if dev.type == "cuda" and int8_exact(i, w, ip):
        c8 = min(INT8_CHUNK_USERS,
                 -(-max(n_users, 1) // cuda_gram.K_TILE) * cuda_gram.K_TILE)
        packed = put(c8)
        if _pairs_unique(*packed, c8, ip):
            tiles = torch.from_numpy(cuda_gram.tile_order(ip)).to(dev)
            return GramPack(*packed, ip, c8, tiles)
        del packed
    return GramPack(*put(cu), ip, cu, None)


def gram_pack(u: np.ndarray, i: np.ndarray, w: np.ndarray, n_users: int,
              n_items: int, chunk_users: int = 2048, device=None) -> GramPack:
    """The host pack of :func:`item_gram`'s scan, put on ``device``
    (``None`` = CUDA): the pairs sorted by user and split into chunks of
    users (``chunk_users`` on the f32 path, ``INT8_CHUNK_USERS`` on the
    int8 path, which a CUDA device takes where :func:`int8_exact` holds
    and no pair repeats)."""
    dev = resolve_device(device)
    return _pack(u, i, w, n_users, round8(n_items),
                 min(chunk_users, round8(n_users)), dev)


def gram_scan(pack: GramPack) -> torch.Tensor:
    """``X^T X`` (I_p, I_p) f32 of a pack, on its device: the int8 kernels
    of ``ops/cuda_gram.py`` where the pack has tiles, else one chunk's
    dense f32 slab at a time."""
    with span("ease.gram"):
        if pack.tiles is not None:
            return cuda_gram.int8_gram(pack.lu, pack.ii, pack.ww, pack.bounds,
                                       pack.ip, pack.cu, pack.tiles)
        dev = pack.lu.device
        G = torch.zeros((pack.ip, pack.ip), dtype=torch.float32, device=dev)
        D = torch.empty((pack.cu, pack.ip), dtype=torch.float32, device=dev)
        with exact_f32():
            for s, e in zip(pack.bounds[:-1], pack.bounds[1:]):
                D.zero_()
                D.index_put_((pack.lu[s:e].long(), pack.ii[s:e].long()), pack.ww[s:e],
                             accumulate=True)
                G.addmm_(D.T, D)
        return G


def item_gram(u: np.ndarray, i: np.ndarray, w: np.ndarray, n_users: int,
              n_items: int, chunk_users: int = 2048, device=None) -> torch.Tensor:
    """(I_p, I_p) item co-occurrence gram ``X^T X`` on ``device`` (``None``
    = CUDA). ``w``: per-pair weights (all ones for binary EASE). No
    (users x items) matrix is formed: one chunk's slab at a time."""
    return gram_scan(gram_pack(u, i, w, n_users, n_items, chunk_users, device))


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
    G = gram_scan(_pack(u[mine] - d * upd, np.asarray(i)[mine],
                        np.asarray(w)[mine], upd, round8(n_items),
                        min(chunk_users, upd), dev))
    dist.all_reduce(G, group=data_group(mesh))
    return G


def _closed_form(P: torch.Tensor) -> torch.Tensor:
    """``B = -P / diag(P)`` column-wise with an exactly zero diagonal,
    written over ``P``."""
    with span("ease.closed_form"):
        d = torch.diagonal(P, dim1=-2, dim2=-1).clone()
        B = P.div_(d[..., None, :]).neg_()
        B.diagonal(dim1=-2, dim2=-1).zero_()
        return B


def _with_ridge(G: torch.Tensor, lam: float) -> torch.Tensor:
    """``G + lam I``, added to ``G`` in place."""
    G.diagonal(dim1=-2, dim2=-1).add_(lam)
    return G


def ease_weights(G: torch.Tensor, lam: float, leaf: str = "auto") -> torch.Tensor:
    """The closed-form EASE matrix ``B`` from the gram, (I_p, I_p) on
    ``G``'s device; ``leaf`` as in ``ops/spd.py``. ``G`` is not changed."""
    with span("ease.inverse"):
        # the system goes in as a temporary, let go inside the refinement
        P = spd_inverse_scaled(_with_ridge(G.clone(), lam), leaf=leaf)
    return _closed_form(P)


def fit_packed(pack: GramPack, lam: float, leaf: str = "auto") -> torch.Tensor:
    """One whole fit on a pack: the scan, the ridge, the inverse and the
    closed form, on the pack's device (``B``, (I_p, I_p) f32). The gram
    becomes the system in place, the system is let go before the
    refinement's last product, and ``B`` is written over ``P``; the pack
    is left as it was."""
    # the system's one reference, handed over whole to the inverse
    system = [_with_ridge(gram_scan(pack), lam)]
    with span("ease.inverse"):
        P = spd_inverse_scaled(system.pop(), leaf=leaf)
    return _closed_form(P)


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
