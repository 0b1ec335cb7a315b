"""Hybrid ablation CLI (reference evaluate_hybrid.py:82-218): embedding-only
vs alpha-blended Top-K metrics side by side. PyTorch port of
``matrix_factorization_tpu/pipeline/evaluate_hybrid.py``: a dense index
scores and ``model.pkl`` loads on ``--platform``'s device (default: the
GPU).

``--mesh-devices N`` scores the candidates item-sharded over a mesh of N
ranks (``make_mesh(n_data=N)``, JAX ``:29-38``), one process a rank:

* under ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` set), each process
  joins the world (NCCL on ``cuda:LOCAL_RANK``; gloo with ``--platform
  cpu``), which must hold N ranks;
* otherwise the stage starts the N ranks itself
  (``parallel.launch.spawn_world``): NCCL with one GPU a rank, raising
  ``ValueError`` when the host has fewer than N GPUs (as JAX's
  ``make_mesh`` raises on too few devices); gloo ranks on the CPU with
  ``--platform cpu``.

Rank 0 alone prints the report, the same JSON as without a mesh.
"""

from __future__ import annotations

import argparse
import json
import os

import pandas as pd

from matrix_factorization_tpu_torch.core.artifacts import load_pickle
from matrix_factorization_tpu_torch.eval.hybrid_eval import evaluate_hybrid
from matrix_factorization_tpu_torch.pipeline.common import add_paths_arg, cli_setup
from matrix_factorization_tpu_torch.retrieval.index import load_item_index


def _report(a, device, mesh=None) -> dict:
    """Both arms' metrics on ``device``, item-sharded over ``mesh`` when
    one is given (every rank of it calls this)."""
    paths = cli_setup(a)
    ratings = pd.read_parquet(paths.data / "ratings.parquet")
    index = load_item_index(paths.artifacts / "item_index.pkl")
    model = None
    if not a.no_model and (paths.artifacts / "model.pkl").exists():
        model = load_pickle(paths.artifacts / "model.pkl", device)

    report = {}
    for name, alpha, m in (
        ("embedding_only", 0.0, None),
        (f"blended_alpha_{a.alpha}", a.alpha, model),
    ):
        res = evaluate_hybrid(
            ratings, index, model=m, alpha=alpha, k=a.k,
            candidate_k=a.candidate_k, positive_threshold=a.positive_threshold,
            n_test=a.n_test, seed=a.seed, max_users=a.max_users, mesh=mesh,
            device=device,
        )
        report[name] = {
            "precision": res.precision, "recall": res.recall,
            "ndcg": res.ndcg, "n_users": res.n_users,
        }
    return report


def _rank_report(rank: int, world: int, a) -> dict:
    """One rank of the stage's own world (``spawn_world`` has set its
    device: ``cuda:rank`` under NCCL)."""
    import torch

    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    device = "cpu" if a.platform == "cpu" else torch.device("cuda", rank)
    return _report(a, device, make_mesh(n_data=world))


def _torchrun_report(a):
    """This process's part under ``torchrun``: the report on rank 0, None
    on the others."""
    import torch
    import torch.distributed as dist

    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    world = int(os.environ["WORLD_SIZE"])
    if world != a.mesh_devices:
        raise ValueError(f"--mesh-devices {a.mesh_devices} under a torchrun "
                         f"world of {world} ranks")
    if a.platform == "cpu":
        device, backend = "cpu", "gloo"
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend)
    try:
        report = _report(a, device, make_mesh(n_data=a.mesh_devices))
        return report if dist.get_rank() == 0 else None
    finally:
        dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser(description="Hybrid Top-K evaluation/ablation")
    add_paths_arg(p)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--candidate-k", type=int, default=100)
    p.add_argument("--positive-threshold", type=float, default=4.0)
    p.add_argument("--n-test", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-users", type=int, default=0)
    p.add_argument("--no-model", action="store_true",
                   help="embedding-only arm")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard candidate scoring over an n-rank mesh (0 = "
                        "single device): under torchrun the world's ranks, "
                        "else n ranks the stage starts, NCCL with one GPU "
                        "each (fewer GPUs raise) or gloo on the CPU with "
                        "--platform cpu")
    a = p.parse_args()
    cli_setup(a)
    if not a.mesh_devices:
        report = _report(a, a.platform)
    elif "WORLD_SIZE" in os.environ:
        report = _torchrun_report(a)
    else:
        from matrix_factorization_tpu_torch.parallel.launch import spawn_world

        backend = "gloo" if a.platform == "cpu" else "nccl"
        report = spawn_world(_rank_report, a.mesh_devices, backend,
                             a.platform, args=(a,), timeout=float("inf"))[0]
    if report is not None:
        print(json.dumps(report))


if __name__ == "__main__":
    main()
