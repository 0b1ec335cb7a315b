"""Convenience orchestrator: run the whole batch pipeline in order.

Mirrors the reference README's step-by-step recipe (prepare -> index ->
metadata -> features -> train -> evaluate -> reranker) as one command
(PyTorch port of ``matrix_factorization_tpu/pipeline/run_all.py``; without
``--platform`` every stage runs on the GPU):

    python -m matrix_factorization_tpu_torch.pipeline.run_all --root workdir \
        --synthetic --platform cpu

Each stage stays independently runnable; this just sequences them with
shared arguments and stops at the first failure.
"""

from __future__ import annotations

import argparse
import sys


def _run(module, argv) -> None:
    print(f"\n==> {module.__name__.split('.')[-1]} {' '.join(argv)}")
    old = sys.argv
    sys.argv = [module.__name__] + argv
    try:
        module.main()
    finally:
        sys.argv = old


def main() -> None:
    p = argparse.ArgumentParser(description="Run the full pipeline")
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic MovieLens-small (zero-egress envs)")
    p.add_argument("--model", default="baseline")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--skip-reranker", action="store_true")
    p.add_argument("--max-rows", type=int, default=0)
    a = p.parse_args()

    from matrix_factorization_tpu_torch.pipeline import (
        build_recipe_metadata,
        build_structured_features,
        build_tfidf_index,
        download_movielens_small,
        evaluate as evaluate_cli,
        train as train_cli,
        train_reranker,
    )

    base = ["--root", a.root]
    if a.platform:
        base += ["--platform", a.platform]

    _run(download_movielens_small, base + (["--synthetic"] if a.synthetic else []))
    _run(build_tfidf_index, base + ["--min-df", "1"])
    _run(build_recipe_metadata, base)
    _run(build_structured_features, base)
    _run(train_cli, base + ["--model", a.model, "--epochs", str(a.epochs)])
    _run(evaluate_cli, base + ["--max-users", "200"])
    if not a.skip_reranker:
        _run(train_reranker, base + ["--n-seed-items", "100",
                                     "--log-every", "0"])
    print("\npipeline complete:", a.root)


if __name__ == "__main__":
    main()
