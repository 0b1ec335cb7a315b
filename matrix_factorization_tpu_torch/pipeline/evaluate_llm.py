"""Recommendation quality audit CLI (reference evaluate_llm.py):
retrieval + hard filters (serving parity) judged by the hermetic
``keywords`` provider or an LLM, producing a JSON report with
avg_relevance / violation_rate / diversity per case. PyTorch port of
``matrix_factorization_tpu/pipeline/evaluate_llm.py``: a dense index
retrieves on ``--platform``'s device (default: the GPU)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from matrix_factorization_tpu_torch.eval.judge import evaluate_case
from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup
from matrix_factorization_tpu_torch.rank.recipe_features import split_terms
from matrix_factorization_tpu_torch.retrieval.index import load_item_index


def main() -> None:
    p = argparse.ArgumentParser(description="Judge retrieval cases")
    add_paths_arg(p)
    p.add_argument("--query", type=str, default=None)
    p.add_argument("--cases", type=str, default=None,
                   help="JSON file: [{query, must_include, avoid, k}, ...]")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--candidate-k", type=int, default=50)
    p.add_argument("--provider", choices=["keywords", "openai"],
                   default="keywords")
    p.add_argument("--openai-model", default="gpt-4o-mini")
    p.add_argument("--embedding-model", type=str, default=None)
    p.add_argument("--must-include", type=str, default="")
    p.add_argument("--avoid", type=str, default="")
    p.add_argument("--no-filters", action="store_true")
    p.add_argument("--out", type=str, default=None)
    a = p.parse_args()
    paths = cli_setup(a)
    index = load_item_index(paths.artifacts / "item_index.pkl")

    if a.cases:
        cases = json.loads(Path(a.cases).read_text())
    elif a.query:
        cases = [{
            "query": a.query,
            "must_include": split_terms(a.must_include),
            "avoid": split_terms(a.avoid),
            "k": a.k,
        }]
    else:
        raise SystemExit("provide --query or --cases")

    reports = []
    for case in cases:
        rep = evaluate_case(
            index=index,
            query=case["query"],
            k=int(case.get("k", a.k)),
            candidate_k=a.candidate_k,
            embedding_model=a.embedding_model,
            provider=a.provider,
            must_include=case.get("must_include", []),
            avoid=case.get("avoid", []),
            openai_model=a.openai_model,
            apply_filters=not a.no_filters,
            device=a.platform,
        )
        reports.append(rep.to_jsonable())

    summary = {
        "n_cases": len(reports),
        "avg_relevance": sum(r["avg_relevance"] for r in reports) / max(1, len(reports)),
        "violation_rate": sum(r["violation_rate"] for r in reports) / max(1, len(reports)),
        "diversity": sum(r["diversity"] for r in reports) / max(1, len(reports)),
        "cases": reports,
    }
    out_path = Path(a.out) if a.out else paths.artifacts / "llm_eval_report.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: v for k, v in summary.items() if k != "cases"}))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
