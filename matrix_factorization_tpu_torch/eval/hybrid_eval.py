"""Hybrid (embedding-recall + model-rerank) Top-K evaluation / ablation
(PyTorch port of ``matrix_factorization_tpu/eval/hybrid_eval.py``).

Reference: ``project_template/pipeline/evaluate_hybrid.py:82-167`` — per
user: build a profile as the mean of the train items' embeddings
(``:121-130``), recall candidates by dot product against the catalog,
alpha-blend min-maxed model scores with the sims (``:143-151``), and
report Precision/Recall/NDCG@K.  ``alpha=0`` gives the embedding-only
ablation arm.

The profile-against-catalog scoring for ALL evaluated users is one
batched product and top-k: a dense index's on the device
(``search_topk_batch``: f32, ties to the lower position), a TF-IDF
index's as JAX's host scipy product (blocked; ``argpartition`` then an
unstable ``argsort``, so the order among tied sims is numpy's). The
blend's ``np.argsort(-score)`` is JAX's too: equal blended scores keep
numpy's order, the same for the same scores in both packages (on the
card the sims may differ from a CPU run's in the last bits, and the
order among near ties follows the card's). With ``max_users`` set only
the evaluated users' rows are grouped (``topk_eval.users_and_histories``).
``mesh=`` comes with slice 6 of the port and raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

from matrix_factorization_tpu_torch.core.config import require_columns
from matrix_factorization_tpu_torch.eval.topk_eval import (
    TopKResult,
    _ndcg_from_hits,
    pick_test_items,
    users_and_histories,
)
from matrix_factorization_tpu_torch.ops.segment_sgd import SLICE_6
from matrix_factorization_tpu_torch.rank.hybrid import minmax, model_scores
from matrix_factorization_tpu_torch.retrieval.index import (
    DenseItemIndex,
    TfidfItemIndex,
)
from matrix_factorization_tpu_torch.retrieval.search import search_topk_batch


def _profile_topk(index, profiles, k: int, device=None):
    """(sims, positions) of each profile vs the whole catalog, for either
    index family: dense -> device product and top-k on ``device``
    (``None`` = CUDA); tfidf -> sparse host product."""
    if isinstance(index, TfidfItemIndex):
        import scipy.sparse as sp

        prof = sp.vstack([sp.csr_matrix(p) for p in profiles])
        n_items = index.matrix.shape[0]
        k = min(k, n_items)
        # blocked: never materialize the full (users x items) similarity
        # matrix — at 25M-scale catalogs a dense U x I blows host memory
        block = max(1, min(prof.shape[0], 4_000_000 // n_items + 1))
        vals_out = np.empty((prof.shape[0], k), np.float32)
        pos_out = np.empty((prof.shape[0], k), np.int64)
        for lo in range(0, prof.shape[0], block):
            hi = min(lo + block, prof.shape[0])
            sims_blk = np.asarray(
                (prof[lo:hi] @ index.matrix.T).todense(), np.float32
            )
            part = np.argpartition(-sims_blk, kth=k - 1, axis=1)[:, :k]
            vals = np.take_along_axis(sims_blk, part, axis=1)
            order = np.argsort(-vals, axis=1)
            vals_out[lo:hi] = np.take_along_axis(vals, order, axis=1)
            pos_out[lo:hi] = np.take_along_axis(part, order, axis=1)
        return vals_out, pos_out
    return search_topk_batch(index, np.stack(profiles), k=k, device=device)


def evaluate_hybrid(
    ratings: pd.DataFrame,
    index: DenseItemIndex,
    model=None,
    alpha: float = 0.5,
    k: int = 10,
    candidate_k: int = 100,
    positive_threshold: float = 4.0,
    n_test: int = 2,
    seed: int = 0,
    max_users: int = 0,
    mesh=None,
    device=None,
) -> TopKResult:
    """Precision/Recall/NDCG@``k`` of the alpha blend; ``device``: where a
    dense index scores (``None`` = CUDA)."""
    require_columns(ratings, ["user_id", "item_id", "rating"], "ratings")
    id_to_pos: Dict[object, int] = {
        str(iid): pos for pos, iid in enumerate(index.item_ids)
    }

    if mesh is not None:
        raise NotImplementedError(f"evaluate_hybrid(mesh=) comes with {SLICE_6}")
    users, by_user = users_and_histories(ratings, max_users)
    rng = np.random.RandomState(seed)

    # 1) split + profiles for every evaluable user (host), then one batched
    #    profile-vs-catalog top-k on device
    eval_users, profiles, train_sets, relevant_sets = [], [], [], []
    for u in users:
        train_items, test_items = pick_test_items(
            by_user[u], n_test=n_test, positive_threshold=positive_threshold,
            rng=rng,
        )
        if not train_items or not test_items:
            continue
        pos = [id_to_pos[str(it)] for it in train_items if str(it) in id_to_pos]
        if not pos:
            continue
        eval_users.append(u)
        if isinstance(index, TfidfItemIndex):
            profiles.append(index.matrix[pos].mean(axis=0))
        else:
            profiles.append(index.embeddings[pos].mean(axis=0))
        train_sets.append({str(it) for it in train_items})
        relevant_sets.append({str(it) for it in test_items})

    if not eval_users:
        return TopKResult(0.0, 0.0, 0.0, 0)

    sims, cand_pos = _profile_topk(
        index, profiles, k=candidate_k + max(len(s) for s in train_sets),
        device=device,
    )

    # 2) per user: drop train items, blend, take top-k, score
    precisions, recalls, ndcgs = [], [], []
    for row, u in enumerate(eval_users):
        keep = [
            c for c in range(cand_pos.shape[1])
            if str(index.item_ids[cand_pos[row, c]]) not in train_sets[row]
        ][:candidate_k]
        ids = [index.item_ids[cand_pos[row, c]] for c in keep]
        s_e = sims[row, keep]
        score = alpha * minmax(model_scores(model, u, ids)) + (1 - alpha) * minmax(s_e)
        order = np.argsort(-score)[:k]
        rec_ids = [str(ids[int(o)]) for o in order]
        rel = relevant_sets[row]
        hits = np.asarray([1 if it in rel else 0 for it in rec_ids], np.int32)
        precisions.append(float(hits.mean()) if hits.size else 0.0)
        recalls.append(float(hits.sum() / max(1, len(rel))))
        ndcgs.append(_ndcg_from_hits(hits, k))

    return TopKResult(
        precision=float(np.mean(precisions)),
        recall=float(np.mean(recalls)),
        ndcg=float(np.mean(ndcgs)),
        n_users=len(precisions),
    )
