"""Meal-plan engine: questionnaire -> per-meal query -> retrieval -> hard
filters -> optional reranker -> greedy diversity with cross-meal carry-over
(a copy of ``matrix_factorization_tpu/serve/planner.py`` on the port's
retrieval and rank; retrieval scores on the service's ``device``).

Reference: ``project_template/app/streamlit_app.py`` — query synthesis with
the CN->EN need mappings (``:125-192``), the filter chain (``:375-445``),
reranker blending (``:460-566``) and cross-meal diversity state
(``:349-350, 568-577``).  The engine is UI-agnostic; the Streamlit/CLI
frontends in ``serve.app`` are thin wrappers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

from matrix_factorization_tpu_torch.rank.diversity import select_diverse_greedy
from matrix_factorization_tpu_torch.rank.filters import apply_hard_filters
from matrix_factorization_tpu_torch.rank.hybrid import blend, model_scores
from matrix_factorization_tpu_torch.rank.recipe_features import (
    expand_avoid_terms,
    extract_ingredient_phrases,
)
from matrix_factorization_tpu_torch.rank.reranker import rerank_scores
from matrix_factorization_tpu_torch.retrieval.search import (
    encode_query_for_index,
    search_topk_pos,
)

GOAL_MAP = {
    "随便推荐": "",
    "减脂/低卡": "low calorie",
    "增肌/高蛋白": "high protein",
    "控糖/低碳": "low carb",
    "清淡/低盐": "low sodium",
}
MEAL_MAP = {
    "不限": "", "早餐": "breakfast", "午餐": "lunch", "晚餐": "dinner",
    "加餐/零食": "snack",
}
CUISINE_MAP = {
    "家常": "home cooking", "中式": "chinese", "川菜": "sichuan",
    "粤菜": "cantonese", "日式": "japanese", "韩式": "korean",
    "泰式": "thai", "西式": "western", "地中海": "mediterranean",
    "墨西哥": "mexican", "印度": "indian",
}
DIETARY_MAP = {
    "素食": "vegetarian", "纯素": "vegan", "无麸质": "gluten-free",
    "无乳糖": "lactose-free", "不吃猪肉": "no pork", "不吃牛肉": "no beef",
    "清真": "halal",
}


def build_query_from_needs(
    *,
    goal: str = "",
    meal_type: str = "",
    cuisines: Sequence[str] = (),
    dietary: Sequence[str] = (),
    must_include: Sequence[str] = (),
    avoid: Sequence[str] = (),
    max_time_min: int = 0,
    extra: str = "",
) -> str:
    """Questionnaire -> retrieval query (reference ``:125-192``)."""
    parts: List[str] = []
    goal_en = GOAL_MAP.get(goal, goal)
    if goal_en:
        parts.append(goal_en)
    meal_en = MEAL_MAP.get(meal_type, meal_type)
    if meal_en:
        parts.append(meal_en)
    if cuisines:
        parts.append("cuisine: " + ", ".join(CUISINE_MAP.get(c, c) for c in cuisines))
    if dietary:
        parts.append("dietary: " + ", ".join(DIETARY_MAP.get(d, d) for d in dietary))
    if max_time_min:
        parts.append(f"ready in {max_time_min} minutes")
    if must_include:
        parts.append("include: " + ", ".join(must_include))
    if avoid:
        parts.append("avoid: " + ", ".join(avoid))
    if extra and extra.strip():
        parts.append(extra.strip())
    return "; ".join(parts) if parts else "random"


@dataclass
class PlanRequest:
    goal: str = ""
    meals: Sequence[str] = ("早餐", "午餐", "晚餐")
    cuisines: Sequence[str] = ()
    dietary: Sequence[str] = ()
    must_include: Sequence[str] = ()
    avoid: Sequence[str] = ()
    max_time_min: int = 0
    per_meal_k: int = 3
    candidate_k: int = 100
    alpha: float = 0.0
    user_id: Optional[Any] = None
    use_reranker: bool = True
    rerank_weight: float = 0.5
    diversity_penalty: float = 0.6
    expand_avoid: bool = True
    strict_filters: bool = True
    extra: str = ""


def plan_meals(service, req: PlanRequest) -> List[Dict[str, Any]]:
    """Full meal-plan flow over a ``RecommendService``; returns rows with
    meal / rank / item_id / score / sim / metadata / preview."""
    index = service.index
    avoid_terms = expand_avoid_terms(list(req.avoid), enable=req.expand_avoid)
    chosen_sets: List[Set[str]] = []  # cross-meal diversity carry-over
    rows: List[Dict[str, Any]] = []

    for meal in req.meals:
        query = build_query_from_needs(
            goal=req.goal, meal_type=meal, cuisines=req.cuisines,
            dietary=req.dietary, must_include=req.must_include,
            avoid=avoid_terms, max_time_min=req.max_time_min, extra=req.extra,
        )
        qvec = encode_query_for_index(index, query)
        candidates = search_topk_pos(index, qvec, k=req.candidate_k,
                                     device=service.device)
        if req.strict_filters:
            candidates = apply_hard_filters(
                candidates, index.texts,
                avoid_terms=avoid_terms,
                must_terms=list(req.must_include),
                meta=service.meta,
                max_time_min=req.max_time_min or None,
                require_high_protein=(req.goal == "增肌/高蛋白"),
                require_low_calorie=(req.goal == "减脂/低卡"),
            )
        if not candidates:
            continue

        ids = [c[1] for c in candidates]
        pos = [c[0] for c in candidates]
        sims = np.asarray([c[2] for c in candidates], np.float32)
        base = blend(model_scores(service.model, req.user_id, ids), sims,
                     req.alpha)

        if req.use_reranker and service.reranker is not None:
            meta_map = None
            if service.meta is not None:
                meta_map = {
                    str(i): service.meta.loc[str(i)]
                    for i in ids if str(i) in service.meta.index
                }
            try:
                rr = rerank_scores(
                    service.reranker, query,
                    [(index.texts[p], float(s)) for p, s in zip(pos, sims)],
                    meta_map=meta_map, item_ids=ids,
                )
                from matrix_factorization_tpu_torch.rank.hybrid import minmax

                base = (1.0 - req.rerank_weight) * minmax(base) \
                    + req.rerank_weight * minmax(rr)
            except Exception:
                pass  # degrade softly, same as the reference

        cand_sets = [extract_ingredient_phrases(index.texts[p]) for p in pos]
        picked, chosen_sets = select_diverse_greedy(
            base_score=base, cand_sets=cand_sets, n=req.per_meal_k,
            diversity_penalty=req.diversity_penalty,
            already_selected_sets=chosen_sets,
        )
        for rank, i in enumerate(picked, start=1):
            text = index.texts[pos[i]]
            preview = (text or "").replace("\n", " ").strip()
            row: Dict[str, Any] = {
                "meal": meal,
                "rank": rank,
                "item_id": ids[i],
                "score": float(base[i]),
                "sim": float(sims[i]),
                "preview": preview[:140] + ("…" if len(preview) > 140 else ""),
            }
            if service.meta is not None and str(ids[i]) in service.meta.index:
                m = service.meta.loc[str(ids[i])]
                for col in ("time_min", "protein_score", "low_calorie_score"):
                    if col in m and not (m[col] != m[col]):  # not NaN
                        row[col] = float(m[col])
            rows.append(row)
    return rows
