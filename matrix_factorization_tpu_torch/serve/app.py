"""Meal-planner frontends over :mod:`serve.planner` (PyTorch port of
``matrix_factorization_tpu/serve/app.py``: the service's model and dense
index live on ``--platform``'s / ``device``'s device, default the GPU).

The reference UI is Streamlit (``project_template/app/streamlit_app.py``);
this module provides:

* ``main()`` — a CLI frontend (always available; prints the plan table);
* ``streamlit_main()`` — the Streamlit UI when the package is installed
  (gated import; absent in this image).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from matrix_factorization_tpu_torch.rank.recipe_features import split_terms
from matrix_factorization_tpu_torch.serve.planner import PlanRequest, plan_meals
from matrix_factorization_tpu_torch.serve.service import RecommendService


def main() -> None:
    p = argparse.ArgumentParser(description="Daily meal-plan recommender")
    p.add_argument("--artifacts", type=str, default="workdir/artifacts")
    p.add_argument("--features", type=str, default="workdir/features")
    p.add_argument("--query", default="",
                   help="free-text mode: retrieve for this query directly "
                   "(the reference UI's second tab)")
    p.add_argument("--goal", default="")
    p.add_argument("--meals", default="早餐,午餐,晚餐")
    p.add_argument("--cuisines", default="")
    p.add_argument("--dietary", default="")
    p.add_argument("--must-include", default="")
    p.add_argument("--avoid", default="")
    p.add_argument("--max-time-min", type=int, default=0)
    p.add_argument("--per-meal-k", type=int, default=3)
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--no-reranker", action="store_true")
    p.add_argument("--diversity-penalty", type=float, default=0.6)
    p.add_argument("--json", action="store_true", help="print JSON rows")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="the service's device (default: cuda, which raises "
                   "without a GPU)")
    a = p.parse_args()

    service = RecommendService.from_artifacts(
        Path(a.artifacts),
        Path(a.features) if Path(a.features).exists() else None,
        device=a.platform,
    )
    req = PlanRequest(
        goal=a.goal,
        meals=["不限"] if a.query else split_terms(a.meals),
        extra=a.query,
        cuisines=split_terms(a.cuisines),
        dietary=split_terms(a.dietary),
        must_include=split_terms(a.must_include),
        avoid=split_terms(a.avoid),
        max_time_min=a.max_time_min,
        per_meal_k=a.per_meal_k,
        alpha=a.alpha,
        use_reranker=not a.no_reranker,
        diversity_penalty=a.diversity_penalty,
    )
    rows = plan_meals(service, req)
    if a.json:
        print(json.dumps(rows, ensure_ascii=False, default=str))
        return
    if not rows:
        print("no candidates after filtering — relax the constraints or "
              "increase candidate_k")
        return
    current = None
    for r in rows:
        if r["meal"] != current:
            current = r["meal"]
            print(f"\n== {current} ==")
        extras = " ".join(
            f"{k}={r[k]:.1f}" for k in ("time_min", "protein_score",
                                        "low_calorie_score") if k in r
        )
        print(f"  {r['rank']}. [{r['item_id']}] score={r['score']:.3f} "
              f"{extras}\n     {r['preview']}")


def streamlit_main(st=None, device=None) -> None:
    """Two-tab Streamlit UI mirroring the reference's structure
    (``project_template/app/streamlit_app.py:195-625``): a questionnaire
    tab (goal/meals/filters -> daily plan) and a free-text retrieval tab,
    with ``st.cache_resource``-cached artifacts and sidebar controls for
    the alpha blend, reranker and diversity penalty.

    ``st`` defaults to the installed streamlit module; tests inject a
    recording stub (``tests/test_streamlit_app.py``) so the full widget
    flow is exercised without the streamlit runtime (absent in CI).
    ``device``: the service's device (``None`` = CUDA).
    """
    if st is None:  # pragma: no cover - needs streamlit installed
        try:
            import streamlit as st
        except ImportError as e:
            raise ImportError(
                "streamlit is not installed; use the CLI frontend: "
                "python -m matrix_factorization_tpu_torch.serve.app"
            ) from e

    st.title("Meal-plan recommender")
    artifacts = st.sidebar.text_input("artifacts dir", "workdir/artifacts")
    features = st.sidebar.text_input("features dir", "workdir/features")
    alpha = st.sidebar.slider("alpha (model/retrieval blend)", 0.0, 1.0, 0.0)
    use_reranker = st.sidebar.checkbox("use reranker", True)
    per_meal_k = st.sidebar.number_input("results per meal", 1, 10, 3)
    diversity = st.sidebar.slider("diversity penalty", 0.0, 1.0, 0.6)
    # hard filters are shared by both tabs (reference applies them at
    # serve time in both flows — streamlit_app.py:375-445)
    must = st.sidebar.text_input("must include (comma separated)", "")
    avoid = st.sidebar.text_input("avoid (comma separated)", "")
    max_time = st.sidebar.number_input("max cook time (min, 0=any)", 0, 240, 0)

    @st.cache_resource
    def _load_service(artifacts_dir: str, features_dir: str):
        return RecommendService.from_artifacts(
            Path(artifacts_dir),
            Path(features_dir) if Path(features_dir).exists() else None,
            device=device,
        )

    service = _load_service(artifacts, features)
    tab_plan, tab_free = st.tabs(["问卷推荐", "自由检索"])

    with tab_plan:
        goal = st.selectbox("goal", ["随便推荐", "减脂/低卡", "增肌/高蛋白",
                                     "控糖/低碳", "清淡/低盐"])
        daily = st.checkbox("daily plan (3 meals)", True)
        cuisines = st.text_input("cuisines (comma separated)", "")
        dietary = st.text_input("dietary (comma separated)", "")
        if st.button("recommend", key="plan"):
            req = PlanRequest(
                goal=goal,
                meals=["早餐", "午餐", "晚餐"] if daily else ["不限"],
                cuisines=split_terms(cuisines),
                dietary=split_terms(dietary),
                must_include=split_terms(must),
                avoid=split_terms(avoid),
                max_time_min=int(max_time),
                per_meal_k=int(per_meal_k),
                alpha=float(alpha),
                use_reranker=bool(use_reranker),
                diversity_penalty=float(diversity),
            )
            rows = plan_meals(service, req)
            if rows:
                import pandas as pd

                st.dataframe(pd.DataFrame(rows))
            else:
                st.warning("no candidates after filtering — relax the "
                           "constraints or increase candidate_k")

    with tab_free:
        query = st.text_input("free-text query", "")
        if st.button("search", key="free"):
            if not query:
                st.warning("enter a query first")
            else:
                req = PlanRequest(
                    goal="",
                    meals=["不限"],
                    extra=query,
                    must_include=split_terms(must),
                    avoid=split_terms(avoid),
                    max_time_min=int(max_time),
                    per_meal_k=int(per_meal_k),
                    alpha=float(alpha),
                    use_reranker=bool(use_reranker),
                    diversity_penalty=float(diversity),
                )
                rows = plan_meals(service, req)
                if rows:
                    import pandas as pd

                    st.dataframe(pd.DataFrame(rows))
                else:
                    st.warning("no results for this query")


if __name__ == "__main__":
    main()
