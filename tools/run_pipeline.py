#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``pipeline`` phase alone on one CUDA GPU.

    python3 tools/run_pipeline.py [--seed N] [--out FILE]

Builds the port's kernels, makes config 3's 25M ratings
(``chip_smoke.gen_ratings``, as the full run makes them) and runs
``chip_smoke.phase_pipeline`` with its checks: every stage of the batch
pipeline through its ``main()`` with no ``--platform`` (the card), under a
directory in ``build/``. Prints the card's name and power limit, then the
phase's JSON lines, also written to ``--out``. A failed check exits
non-zero. Needs a GPU; imports nothing of JAX.
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
        print("run_pipeline: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lines = [{"phase": "device", "nvidia_smi": smi}]
    t0 = time.perf_counter()
    lines.append({"phase": "build", "seconds": _build.build(
        sorted(p.stem for p in _build.CSRC.glob("*.cu")))})
    t1 = time.perf_counter()
    u, i, r = cs.gen_ratings(cs.N_USERS, cs.N_ITEMS, cs.N_RATINGS + cs.N_HELD_OUT,
                             args.seed)
    data3 = (u[:cs.N_RATINGS], i[:cs.N_RATINGS], r[:cs.N_RATINGS])
    lines.append({"phase": "data", "seconds": time.perf_counter() - t1})
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        lines.append(cs.phase_pipeline(torch, rng, data3, tmp, args.seed))
    lines.append({"phase": "done", "seconds": time.perf_counter() - t0})
    for obj in lines:
        print(json.dumps(obj), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(o) + "\n" for o in lines))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"run_pipeline: {e}", file=sys.stderr)
        sys.exit(1)
