#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s multi-device phases alone on one CUDA GPU.

    python3 tools/run_parallel.py [--seed N] [--out FILE]

Builds the port's kernels, makes config 3's 25M ratings (with the held-out
pairs) and config 2's 1M (``chip_smoke.gen_ratings`` / ``ml1m_ratings``,
as the full run makes them) and runs the phases with their checks:
``phase_cf_topk`` (config 4's mesh-free fits; ``parallel_gram`` holds its
mesh fit to the item-item lists), then inside one NCCL world of this
process alone ``phase_parallel_nccl`` (data-parallel SGD at config 3),
``phase_parallel_kernels``, ``phase_parallel_als`` (factor ALS, the bias
models and NMF), ``phase_parallel_families`` (BPR and SVD++) and
``phase_parallel_gram_nccl`` (the gram models), ``phase_parallel_retrieval``
(the row-sharded dense and TF-IDF top-k at the recipe catalog at NCCL
world 1, the catalog written to files) and ``phase_sharded_checkpoint_nccl``
(config 3 through ``save_model_sharded``), then ``phase_parallel_gloo``
(gloo ranks on the card, with the slice-6b and slice-6c models and the
sharded checkpoints) and ``phase_parallel_gram_gloo`` (with the
row-sharded retrieval on the same ranks); first of all
``phase_hybrid_mesh`` (``evaluate_hybrid --mesh-devices 1``) on a small
pipeline root of config 2's ratings (``hybrid_root``; the full run
evaluates the pipeline phase's own artifacts). Prints the card's name
and power limit, then each phase's JSON line as it ends, also appended to
``--out``. A failed check exits non-zero. Needs a GPU; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("run_parallel: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.out:
        Path(args.out).write_text("")

    def emit(obj):  # each phase's line as soon as it is done
        print(json.dumps(obj), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(obj) + "\n")

    emit({"phase": "device", "nvidia_smi": smi})
    t0 = time.perf_counter()
    emit({"phase": "build", "seconds": _build.build(
        sorted(p.stem for p in _build.CSRC.glob("*.cu")))})
    t1 = time.perf_counter()
    u, i, r = cs.gen_ratings(cs.N_USERS, cs.N_ITEMS, cs.N_RATINGS + cs.N_HELD_OUT,
                             args.seed)
    n = cs.N_RATINGS
    data3 = (u[:n], i[:n], r[:n], u[n:], i[n:])
    train1m, _ = cs.ml1m_ratings(args.seed)
    emit({"phase": "data", "seconds": time.perf_counter() - t1})
    rng = np.random.default_rng(args.seed)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t3 = time.perf_counter()
        out = cs.phase_hybrid_mesh(cs.hybrid_root(torch, rng, train1m, tmp))
        out["seconds"] = time.perf_counter() - t3
        emit(out)
    out, item_lists = cs.phase_cf_topk(torch, rng, data3)
    emit(out)
    torch.cuda.empty_cache()
    # the recipe catalog's files, from parallel_retrieval to the gram gloo worlds
    files = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp, \
            cs.nccl_world(torch, tmp):
        out, packs = cs.phase_parallel_nccl(torch, rng, data3, r[n:], args.seed)
        emit(out)
        rows, worst = cs.phase_parallel_kernels(torch, rng, packs, train1m,
                                                cs.Timer(torch))
        for row in rows:
            emit(row)
        emit({"phase": "parallel_kernels_worst", **worst})
        del packs
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        out = cs.phase_parallel_als(torch, rng, data3, train1m, args.seed)
        out["seconds"] = time.perf_counter() - t3
        emit(out)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        out = cs.phase_parallel_families(torch, rng, data3, args.seed)
        out["seconds"] = time.perf_counter() - t3
        emit(out)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        gram = cs.phase_parallel_gram_nccl(torch, data3, train1m, item_lists,
                                           args.seed)
        gram["seconds"] = time.perf_counter() - t3
        emit(gram)
        del item_lists
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        out, retrieval_gloo = cs.phase_parallel_retrieval(
            torch, rng, files.name, args.seed, cs.Timer(torch))
        out["seconds"] = time.perf_counter() - t3
        emit(out)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        out = cs.phase_sharded_checkpoint_nccl(torch, data3, args.seed, tmp)
        out["seconds"] = time.perf_counter() - t3
        emit(out)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    out = cs.phase_parallel_gloo(torch, train1m, args.seed)
    out["seconds"] = time.perf_counter() - t3
    ckpt = out.pop("sharded_checkpoint")
    emit(out)
    emit(ckpt)
    t3 = time.perf_counter()
    out = cs.phase_parallel_gram_gloo(torch, train1m, args.seed,
                                      gram["ml1m_ns"]["peak_mib"], retrieval_gloo)
    out["seconds"] = time.perf_counter() - t3
    files.cleanup()
    retrieval = out.pop("parallel_retrieval")
    emit(out)
    emit(retrieval)
    emit({"phase": "done", "parallel_seconds": time.perf_counter() - t2,
          "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"run_parallel: {e}", file=sys.stderr)
        sys.exit(1)
