"""Full-catalog scoring and top-k over bias-folded rows (PyTorch port).

Counterpart of ``matrix_factorization_tpu/ops/scoring.py``. The whole
(users x items) score block is one product over the extended rows
(``ops/segment_sgd.py``): the biases ride inside ``P_ext Q_ext^T``, so

* linear : mu + P_ext Q_ext^T
* sigmoid: a + c * sigma(mu + P_ext Q_ext^T)
* rbf    : a + c * exp(-gamma * (|p|^2 + |q|^2 - 2 P Q^T)), exact because
  the extension columns are zero for rbf.

On a CUDA device the product and its epilogue are the hand-written
kernel of ``ops/cuda_scores.py``, and the top-k's selection body the
hand-written kernel of ``ops/cuda_topk.py``; on the CPU, their plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from matrix_factorization_tpu_torch.core.config import SGDConfig
from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_topk
from matrix_factorization_tpu_torch.utils.profiling import span


def score_catalog(cfg: SGDConfig, mu: torch.Tensor, pu: torch.Tensor,
                  Q: torch.Tensor) -> torch.Tensor:
    """Scores of every item for each queried user: (B, I) f32.

    Accepts f32 or bf16 row tables; sums are taken in f32 either way.
    CUDA tensors go to the CUDA kernel, CPU tensors to its plain version;
    any other device raises."""
    if pu.device.type == "cuda":
        return cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)
    if pu.device.type == "cpu":
        return cuda_scores.plain_score_catalog(cfg, mu, pu, Q)
    raise ValueError(f"no catalog scorer for device {pu.device}")


# score blocks up to this size take the sort body of ``stable_topk``,
# larger ones the selection body; a row of the plain selection body whose
# cut ties more than ``SELECT_MAX_TIED`` scores is sorted whole
# (``tools/time_topk.py``)
SORT_MAX_SCORES = 1 << 22
SELECT_MAX_TIED = 4096


def _sort_topk(s: torch.Tensor, k: int):
    """``stable_topk`` of (rows, n) scores by a stable sort of whole rows
    (``-0.0`` sorted as ``0.0``)."""
    _, idx = torch.sort(s + 0.0, dim=-1, descending=True, stable=True)
    idx = idx[:, :k]
    return s.gather(-1, idx), idx


def _order(vals: torch.Tensor, idx: torch.Tensor):
    """(rows, w) candidates ordered by score descending, then position
    ascending (``-0.0`` as ``0.0``, a NaN first)."""
    o = idx.argsort(dim=-1)
    vals, idx = vals.gather(-1, o), idx.gather(-1, o)
    o = (vals + 0.0).argsort(dim=-1, descending=True, stable=True)
    return vals.gather(-1, o), idx.gather(-1, o)


def _select_topk(s: torch.Tensor, k: int):
    """``stable_topk`` of (rows, n) scores by selection. A CUDA tensor
    with k up to ``cuda_topk.MAX_K`` launches the hand-written kernel
    (``ops/cuda_topk.py``): one 64-bit key a score makes the rule's order
    total, so it takes no tie test and never syncs the host. Any other
    tensor or a wider k takes ``_plain_select_topk``, the kernel's plain
    version."""
    if s.device.type == "cuda" and k <= cuda_topk.MAX_K:
        return cuda_topk.cuda_select_topk(s.contiguous(), k)
    return _plain_select_topk(s, k)


def _plain_select_topk(s: torch.Tensor, k: int):
    """``stable_topk`` of (rows, n) scores by ``torch.topk``, whose order
    among ties is unstated. Its pick is the rule's where no more than k
    scores lie at or above the k-th (IEEE compared, a NaN counting as
    above). A row where more do, a tie straddling the cut, is taken again
    with every score at or above its k-th (a ``torch.topk`` as wide as
    the widest such row, or the whole row sorted past
    ``SELECT_MAX_TIED``). Then the k are ordered by score and position."""
    vals, idx = torch.topk(s, k, dim=-1, sorted=True)
    if k:
        at_or_above = (~(s < vals[:, -1:])).sum(-1)
        with span("topk.sync"):
            rows = (at_or_above > k).nonzero().flatten()
        if rows.numel():
            with span("topk.ties"):
                m = s[rows]
                wide = int(at_or_above[rows].max())
                if wide <= SELECT_MAX_TIED:
                    tv, ti = _order(*torch.topk(m, wide, dim=-1, sorted=False))
                else:
                    tv, ti = _sort_topk(m, k)
                vals[rows], idx[rows] = tv[:, :k], ti[:, :k]
    return _order(vals, idx)


def stable_topk(scores: torch.Tensor, k: int):
    """Top-``k`` along the last axis, descending, ties to the lower index
    (the order of ``lax.top_k`` and of the reference's stable
    sort-then-head, ``recommender_base.py:259-260``): the one tie rule of
    every top-k in the port, exact and the same on every device. ``-0.0``
    counts as ``0.0``; a NaN ranks first. ``k`` is clamped to the axis.

    Blocks of up to ``SORT_MAX_SCORES`` scores take ``_sort_topk``, larger
    ones ``_select_topk`` (on CUDA a hand-written kernel): on the H100
    the sort won at one row of 2.2M scores and at small blocks, the torch
    selection at 60 rows and more (``tools/time_topk.py``). f32 scores
    (f16 / bf16 widen exactly); other dtypes raise."""
    if scores.dtype in (torch.float16, torch.bfloat16):
        vals, idx = stable_topk(scores.float(), k)
        return vals.to(scores.dtype), idx
    if scores.dtype != torch.float32:
        raise TypeError(f"stable_topk takes float32 scores, not {scores.dtype}")
    n = scores.shape[-1]
    k = min(k, n)
    lead = scores.shape[:-1]
    if k == 0:  # nothing to take (an empty row: a mesh rank with no rows)
        return (scores.new_empty((*lead, 0)),
                torch.empty((*lead, 0), dtype=torch.int64, device=scores.device))
    s = scores.reshape(-1, n)
    if s.numel() <= SORT_MAX_SCORES:
        with span("topk.sort"):
            vals, idx = _sort_topk(s, k)
    else:
        with span("topk.select"):
            vals, idx = _select_topk(s, k)
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


def _user_rows(P: torch.Tensor, u_dense) -> torch.Tensor:
    u = torch.as_tensor(np.asarray(u_dense, np.int64)).to(P.device)
    return P[u]


def catalog_scores(cfg: SGDConfig, params, n_items: int, u_dense) -> np.ndarray:
    """(B, n_items) unbounded scores for a user cohort, as a host array
    (eval harnesses, batch serving)."""
    pu = _user_rows(params.user_features, u_dense)
    scores = score_catalog(cfg, params.global_mean, pu,
                           params.item_features[:n_items])
    return scores.cpu().numpy()


def topk_harness(run, n_items: int, u_dense, k: int, prep=None):
    """Shared plumbing for catalog top-k: clamps ``k`` to the catalog,
    calls ``run(u_dense, k, *extra) -> (vals, idx)`` (tensors, (B, k)
    each) and returns them as host arrays. Only (B, k) values and indices
    cross to the host, never the (B, n_items) scores.

    ``prep``: an optional host hook for models whose device inputs derive
    from the user batch rather than from fixed tables (EASE's history
    rows): ``prep(u_dense)`` returns the ``extra`` arguments of ``run``."""
    extra = tuple(prep(u_dense)) if prep is not None else ()
    vals, idx = run(u_dense, min(k, n_items), *extra)
    return vals.cpu().numpy(), idx.cpu().numpy()


def catalog_topk(cfg: SGDConfig, params, n_items: int, u_dense, k: int):
    """Top-``k`` catalog scores per user: the user-row gather, the scorer
    over the first ``n_items`` item rows and the top-k. The slice matters:
    the tables are padded to their capacity, and a zero padding row would
    score ``a + c exp(-gamma |p|^2)`` under rbf and leak into the top-k.
    Returns host ``(values, indices)``, each (B, k)."""

    def run(ud, kk):
        pu = _user_rows(params.user_features, ud)
        return stable_topk(
            score_catalog(cfg, params.global_mean, pu,
                          params.item_features[:n_items]), kk)

    return topk_harness(run, n_items, u_dense, k)


def streaming_topk(cfg: SGDConfig, mu: torch.Tensor, pu: torch.Tensor,
                   Q: torch.Tensor, valid_items: torch.Tensor, k: int,
                   tile: int = 8192):
    """Memory-bounded full-catalog top-k: walks the item tiles keeping a
    running (B, k) candidate set, never materializing the (B, I) score
    block. ``Q``'s row count must be a multiple of ``tile``; items whose
    ``valid_items`` entry is 0 score ``-inf``. Returns (scores, global
    item indices), each (B, k)."""
    B, I = pu.shape[0], Q.shape[0]
    if I % tile:
        raise ValueError("pad the item table to a multiple of tile")
    kk = min(k, tile)
    best_v = torch.full((B, kk), float("-inf"), dtype=torch.float32,
                        device=pu.device)
    best_i = torch.zeros((B, kk), dtype=torch.int64, device=pu.device)
    for t in range(I // tile):
        s = score_catalog(cfg, mu, pu, Q[t * tile:(t + 1) * tile])
        s = torch.where(valid_items[None, t * tile:(t + 1) * tile] > 0, s,
                        float("-inf"))
        tv, ti = stable_topk(s, kk)
        # the running set holds lower indices than this tile, so the
        # stable merge keeps ties at the lower index
        merged_v = torch.cat([best_v, tv], dim=1)
        merged_i = torch.cat([best_i, ti + t * tile], dim=1)
        best_v, pos = stable_topk(merged_v, kk)
        best_i = torch.gather(merged_i, 1, pos)
    return best_v[:, :k], best_i[:, :k]
