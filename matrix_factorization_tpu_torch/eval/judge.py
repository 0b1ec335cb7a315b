"""Constraint-violation + relevance judge for retrieval quality audits
(PyTorch port of ``matrix_factorization_tpu/eval/judge.py``; a dense
index retrieves on the device).

Reference: ``project_template/pipeline/evaluate_llm.py`` — a hermetic
``keywords`` provider (``:159-187``, the no-network fake backend) and an
optional LLM provider, a violation sanitizer (``:272-293``), and per-case
metrics avg_relevance / violation_rate / diversity
(1 - mean pairwise ingredient-Jaccard, ``:94-107``).

Fixes the reference's ``_contains_any`` NameError at ``evaluate_llm.py:181``
(crashes whenever the keywords provider runs with a non-empty
``must_include``) — see PARITY.md #12.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from matrix_factorization_tpu_torch.rank.recipe_features import (
    contains_any,
    expand_avoid_terms,
    extract_ingredient_phrases,
    jaccard,
)


@dataclass(frozen=True)
class ItemEval:
    item_id: Any
    relevance: float  # 0..5
    violations: List[str]
    reason: str


@dataclass(frozen=True)
class CaseReport:
    query: str
    k: int
    must_include: List[str]
    avoid: List[str]
    index_type: str
    n_retrieved: int
    n_after_filter: int
    diversity: float
    avg_relevance: float
    violation_rate: float
    items: List[ItemEval]

    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "query": self.query,
            "k": int(self.k),
            "must_include": list(self.must_include),
            "avoid": list(self.avoid),
            "index_type": self.index_type,
            "n_retrieved": int(self.n_retrieved),
            "n_after_filter": int(self.n_after_filter),
            "diversity": float(self.diversity),
            "avg_relevance": float(self.avg_relevance),
            "violation_rate": float(self.violation_rate),
            "items": [
                {
                    "item_id": str(it.item_id),
                    "relevance": float(it.relevance),
                    "violations": list(it.violations),
                    "reason": str(it.reason),
                }
                for it in self.items
            ],
        }


def diversity_score(texts: List[str]) -> float:
    """1 - mean pairwise Jaccard of ingredient sets, clipped to [0,1]."""
    sets = [extract_ingredient_phrases(t) for t in texts]
    if len(sets) <= 1:
        return 1.0
    js = [
        jaccard(sets[i], sets[j])
        for i in range(len(sets))
        for j in range(i + 1, len(sets))
    ]
    mean_j = float(np.mean(js)) if js else 0.0
    return float(max(0.0, min(1.0, 1.0 - mean_j)))


def keywords_judge(
    *,
    query: str,
    item_id: Any,
    text: str,
    must_include: List[str],
    avoid: List[str],
) -> ItemEval:
    """Hermetic relevance heuristic: base 1, +2 if a must-include term hits,
    +1 if any query token hits, -2 when violations exist; clipped [0,5]."""
    violations: List[str] = []
    if avoid and contains_any(text, avoid):
        violations.append("contains_avoid_term")
    if must_include and not contains_any(text, must_include):
        violations.append("missing_must_include")

    q_terms = [t for t in re.split(r"\W+", (query or "").lower()) if t]
    hit_q = bool(q_terms) and any(t in (text or "").lower() for t in q_terms[:10])
    rel = 1.0
    if must_include and contains_any(text, must_include):
        rel += 2.0
    if hit_q:
        rel += 1.0
    if violations:
        rel = max(0.0, rel - 2.0)
    return ItemEval(
        item_id=item_id,
        relevance=float(max(0.0, min(5.0, rel))),
        violations=violations,
        reason="keywords_fallback",
    )


def openai_judge(
    *,
    query: str,
    items: List[Tuple[Any, str]],
    must_include: List[str],
    avoid: List[str],
    openai_model: str = "gpt-4o-mini",
) -> List[ItemEval]:
    """LLM judge; requires OPENAI_API_KEY + the openai package.  Falls back
    to the keywords judge per item when the call/parse fails (reference
    ``evaluate_llm.py:261-269``)."""
    api_key = os.getenv("OPENAI_API_KEY")
    if not api_key:
        raise RuntimeError("OPENAI_API_KEY is not set")
    try:
        from openai import OpenAI  # gated optional dep
    except ImportError as e:
        raise RuntimeError("openai package is not installed") from e

    client = OpenAI(api_key=api_key)
    out: List[ItemEval] = []
    for item_id, text in items:
        try:
            prompt = json.dumps(
                {
                    "task": "Rate recipe relevance 0-5 for the query and "
                    "list violations among [contains_avoid_term, "
                    "missing_must_include].",
                    "query": query,
                    "must_include": must_include,
                    "avoid": avoid,
                    "item_text": text[:2000],
                }
            )
            resp = client.chat.completions.create(
                model=openai_model,
                messages=[{"role": "user", "content": prompt}],
                response_format={"type": "json_object"},
            )
            obj = json.loads(resp.choices[0].message.content)
            out.append(
                ItemEval(
                    item_id=item_id,
                    relevance=float(max(0.0, min(5.0, obj.get("relevance", 0)))),
                    violations=[str(v) for v in obj.get("violations", [])],
                    reason=str(obj.get("reason", "llm")),
                )
            )
        except Exception:
            out.append(
                keywords_judge(
                    query=query, item_id=item_id, text=text,
                    must_include=must_include, avoid=avoid,
                )
            )
    return out


def sanitize_violations(
    judged: List[ItemEval], *, must_include: List[str], avoid: List[str]
) -> List[ItemEval]:
    """Strip violation labels that cannot apply because the corresponding
    constraint input is empty (reference ``:270-293``)."""
    mi_empty = not (must_include or [])
    av_empty = not (avoid or [])
    if not (mi_empty or av_empty):
        return judged
    out = []
    for it in judged:
        viol = list(it.violations or [])
        if mi_empty:
            viol = [v for v in viol if v != "missing_must_include"]
        if av_empty:
            viol = [v for v in viol if v != "contains_avoid_term"]
        out.append(ItemEval(it.item_id, it.relevance, viol, it.reason))
    return out


def evaluate_case(
    *,
    index,
    query: str,
    k: int = 5,
    candidate_k: int = 50,
    embedding_model: Optional[str] = None,
    provider: str = "keywords",
    must_include: Optional[List[str]] = None,
    avoid: Optional[List[str]] = None,
    openai_model: str = "gpt-4o-mini",
    apply_filters: bool = True,
    device=None,
) -> CaseReport:
    """One audited retrieval case; hard-filter parity with serving
    (reference ``evaluate_case`` ``:296-379``). ``device``: where a dense
    index scores (``None`` = CUDA)."""
    from matrix_factorization_tpu_torch.retrieval.index import TfidfItemIndex
    from matrix_factorization_tpu_torch.retrieval.search import (
        encode_query_for_index,
        search_topk_pos,
    )

    must_include = must_include or []
    avoid = avoid or []
    index_type = "tfidf" if isinstance(index, TfidfItemIndex) else "dense"

    qvec = encode_query_for_index(index, query, model_name=embedding_model)
    candidates = search_topk_pos(index, qvec, k=candidate_k, device=device)
    n_retrieved = len(candidates)

    avoid_expanded = expand_avoid_terms(avoid, enable=True) if avoid else []
    if apply_filters:
        if avoid_expanded:
            candidates = [
                c for c in candidates
                if not contains_any(index.texts[c[0]], avoid_expanded)
            ]
        if must_include:
            candidates = [
                c for c in candidates
                if contains_any(index.texts[c[0]], must_include)
            ]
    candidates = candidates[: max(1, int(k))]

    item_ids = [item_id for (_, item_id, _) in candidates]
    texts = [index.texts[pos] for (pos, _, _) in candidates]

    if provider == "keywords":
        judged = [
            keywords_judge(
                query=query, item_id=iid, text=t,
                must_include=must_include, avoid=avoid_expanded,
            )
            for iid, t in zip(item_ids, texts)
        ]
    elif provider == "openai":
        judged = openai_judge(
            query=query, items=list(zip(item_ids, texts)),
            must_include=must_include, avoid=avoid_expanded,
            openai_model=openai_model,
        )
    else:
        raise ValueError("provider must be one of: keywords | openai")

    judged = sanitize_violations(
        judged, must_include=must_include, avoid=avoid_expanded
    )
    avg_rel = float(np.mean([x.relevance for x in judged])) if judged else 0.0
    viol = (
        float(np.mean([1.0 if x.violations else 0.0 for x in judged]))
        if judged else 0.0
    )
    return CaseReport(
        query=query,
        k=int(k),
        must_include=must_include,
        avoid=avoid,
        index_type=index_type,
        n_retrieved=n_retrieved,
        n_after_filter=len(candidates),
        diversity=diversity_score(texts[: int(k)]),
        avg_relevance=avg_rel,
        violation_rate=viol,
        items=judged,
    )
