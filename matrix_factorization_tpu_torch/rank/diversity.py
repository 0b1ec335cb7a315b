"""Greedy diversity selection with cross-call carry-over (a copy of
``matrix_factorization_tpu/rank/diversity.py``).

Reference: ``streamlit_app.py:73-111`` ``_select_diverse_greedy`` — pick
``argmax_i (base_score[i] - penalty * max_jaccard(i, selected))``
repeatedly; previously selected ingredient sets can be carried in so a
multi-meal plan stays diverse across meals (``:349-350, 571-577``).

This implementation is vectorized: the max-Jaccard-to-selected column is
maintained incrementally (O(n) per pick instead of O(n * |selected|)).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from matrix_factorization_tpu_torch.rank.recipe_features import jaccard


def select_diverse_greedy(
    *,
    base_score: np.ndarray,
    cand_sets: Sequence[Set[str]],
    n: int,
    diversity_penalty: float,
    already_selected_sets: Optional[List[Set[str]]] = None,
) -> Tuple[List[int], List[Set[str]]]:
    """Returns (selected positions, updated selected ingredient sets)."""
    base_score = np.asarray(base_score, np.float64)
    n = int(n)
    carried = list(already_selected_sets or [])
    if n <= 0 or base_score.size == 0:
        return [], carried

    m = base_score.size
    # running max Jaccard of each candidate vs everything selected so far
    max_overlap = np.zeros(m)
    for s in carried:
        if s:
            for i in range(m):
                if cand_sets[i]:
                    max_overlap[i] = max(max_overlap[i], jaccard(cand_sets[i], s))

    available = np.ones(m, bool)
    selected: List[int] = []
    selected_sets: List[Set[str]] = carried

    while available.any() and len(selected) < n:
        eff = np.where(available, base_score - diversity_penalty * max_overlap,
                       -np.inf)
        best = int(np.argmax(eff))
        if not np.isfinite(eff[best]):
            break
        selected.append(best)
        selected_sets.append(cand_sets[best])
        available[best] = False
        picked = cand_sets[best]
        if picked:
            for i in np.nonzero(available)[0]:
                if cand_sets[i]:
                    max_overlap[i] = max(
                        max_overlap[i], jaccard(cand_sets[i], picked)
                    )

    return selected, selected_sets
