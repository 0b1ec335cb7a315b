"""Hard candidate filters for the serving/meal-plan path (a copy of
``matrix_factorization_tpu/rank/filters.py``).

Reference behavior (``streamlit_app.py:375-445``):
* avoid terms (after synonym expansion) — drop items whose text contains
  any term;
* must-include — keep items whose text contains any of the terms;
* structured metadata filters (time / protein / low-calorie) — items with
  MISSING metadata pass (otherwise everything filters away); thresholds:
  ``time_min <= max_time``, ``protein_score >= 2.0``,
  ``low_calorie_score >= 1.0``;
* ``under N minutes`` / ``ready in N minutes`` query parsing.

Candidates are ``(pos, item_id, sim)`` rows as produced by
``retrieval.search_topk_pos``.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import pandas as pd

from matrix_factorization_tpu_torch.rank.recipe_features import contains_any

Candidate = Tuple[int, object, float]

PROTEIN_THRESHOLD = 2.0
LOW_CAL_THRESHOLD = 1.0


def parse_time_constraint_from_query(q: Optional[str]) -> Optional[int]:
    ql = (q or "").lower()
    m = re.search(r"under\s+(\d+)\s+minutes?", ql)
    if m:
        return int(m.group(1))
    m = re.search(r"ready\s+in\s+(\d+)\s+minutes?", ql)
    if m:
        return int(m.group(1))
    return None


def filter_avoid(
    candidates: List[Candidate], texts: Sequence[str], avoid_terms: List[str]
) -> List[Candidate]:
    if not avoid_terms:
        return candidates
    return [
        c for c in candidates if not contains_any(texts[c[0]], avoid_terms)
    ]


def filter_must_include(
    candidates: List[Candidate], texts: Sequence[str], must_terms: List[str]
) -> List[Candidate]:
    if not must_terms:
        return candidates
    return [c for c in candidates if contains_any(texts[c[0]], must_terms)]


def _meta_value(meta: pd.DataFrame, item_id, column: str) -> Optional[float]:
    key = str(item_id)
    if key not in meta.index or column not in meta.columns:
        return None
    v = meta.loc[key, column]
    if pd.isna(v):
        return None
    try:
        return float(v)
    except Exception:
        return None


def filter_by_meta(
    candidates: List[Candidate],
    meta: Optional[pd.DataFrame],
    column: str,
    predicate,
) -> List[Candidate]:
    """Keep candidates whose metadata value passes ``predicate``; missing
    metadata passes (reference's default-permit policy)."""
    if meta is None:
        return candidates
    out = []
    for c in candidates:
        v = _meta_value(meta, c[1], column)
        if v is None or predicate(v):
            out.append(c)
    return out


def filter_time(candidates, meta, max_time_min: float):
    return filter_by_meta(candidates, meta, "time_min",
                          lambda v: v <= float(max_time_min))


def filter_high_protein(candidates, meta, threshold: float = PROTEIN_THRESHOLD):
    return filter_by_meta(candidates, meta, "protein_score",
                          lambda v: v >= threshold)


def filter_low_calorie(candidates, meta, threshold: float = LOW_CAL_THRESHOLD):
    return filter_by_meta(candidates, meta, "low_calorie_score",
                          lambda v: v >= threshold)


def apply_hard_filters(
    candidates: List[Candidate],
    texts: Sequence[str],
    *,
    avoid_terms: Optional[List[str]] = None,
    must_terms: Optional[List[str]] = None,
    meta: Optional[pd.DataFrame] = None,
    max_time_min: Optional[float] = None,
    require_high_protein: bool = False,
    require_low_calorie: bool = False,
) -> List[Candidate]:
    """The full serving-path filter chain, in the reference's order."""
    out = filter_avoid(candidates, texts, avoid_terms or [])
    out = filter_must_include(out, texts, must_terms or [])
    if max_time_min is not None:
        out = filter_time(out, meta, max_time_min)
    if require_high_protein:
        out = filter_high_protein(out, meta)
    if require_low_calorie:
        out = filter_low_calorie(out, meta)
    return out
