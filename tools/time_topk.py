#!/usr/bin/env python3
"""Time the bodies of the port's tie-rule top-k on one CUDA GPU.

    python3 tools/time_topk.py [--out FILE] [--seed N] [--shapes A,B]

Every top-k of the port (``ops/scoring.py::stable_topk``) orders by
score descending, then by position ascending. Four bodies give that
order:

* ``sort`` (``scoring._sort_topk``): a stable ``torch.sort`` of whole
  rows, then their heads;
* ``select`` (``scoring._plain_select_topk``): ``torch.topk`` of the
  scores, its pick kept on rows where no tie straddles the cut, the tied
  scores counted on the others, then the k ordered by score and position;
* ``key``: ``torch.topk`` of a 64-bit key, the score's order-preserving
  integer above the reversed position, held in memory (the port's body
  before the torch selection, kept here for comparison);
* ``kernel`` (``scoring._select_topk`` on the card, k up to
  ``cuda_topk.MAX_K``): the hand-written kernel pair of
  ``csrc/topk_select.cu``, which forms the same key in registers.

``stable_topk`` takes ``sort`` up to ``scoring.SORT_MAX_SCORES`` scores
and ``kernel`` above; it is timed too.

At each shape the four and ``stable_topk`` are first held equal
(``torch.equal`` of values and positions), then timed in turns with ``chip_smoke.Timer`` (device
time, L2 flushed), beside ``torch.topk`` of the scores alone (the
library call, whose order among ties is unstated). The shapes are those
the port's callers give it: the recipe search (one query and 60-row
blocks of ``retrieval/search.py::dense_topk`` over 2,231,142 items, k 10
and ``candidate_k`` 500; the blocks' scores also rounded, so that ties
straddle the cuts), the batched TF-IDF top-k (64 rows, mostly
zero scores; and with every row's cut among the zeros), the catalog
scorer's serving top-k (config 3's 59,392 items, B 1 and 256, k 10), the streaming merge (2k candidates), EASE's
and the sparse-gram CF's strips. Last, ``dense_topk`` at B 1 and 256
over the 2,231,142 x 512 catalog with each body, and the product alone.

One JSON line a shape on stdout and in ``--out``. Needs a GPU; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (name, rows, n, k, scores): "normal" draws; "steps", the draws rounded
# to 1/64 (a few dozen scores tie at each cut); "sparse", about 7,000
# non-zero scores a row and the rest 0.0 (a TF-IDF batch); "ties", 5
# non-zero scores a row, so that every row's cut falls among the zeros
SHAPES = (
    ("recipe_search_b1_k10", 1, 2_231_142, 10, "normal"),
    ("recipe_search_b1_k500", 1, 2_231_142, 500, "normal"),
    ("recipe_batch_block_b60_k10", 60, 2_231_142, 10, "normal"),
    ("recipe_batch_block_b60_k100", 60, 2_231_142, 100, "normal"),
    ("recipe_batch_tail_b16_k100", 16, 2_231_142, 100, "normal"),
    ("recipe_batch_block_b60_k500", 60, 2_231_142, 500, "normal"),
    ("recipe_batch_block_steps_b60_k10", 60, 2_231_142, 10, "steps"),
    ("tfidf_batch_b64_k10", 64, 2_231_142, 10, "sparse"),
    ("tfidf_ties_at_cut_b64_k10", 64, 2_231_142, 10, "ties"),
    ("scorer_b1_k10", 1, 59_392, 10, "normal"),
    ("scorer_b256_k10", 256, 59_392, 10, "normal"),
    ("streaming_merge_b256_k10", 256, 20, 10, "normal"),
    ("ease_b256_k10", 256, 16_384, 10, "normal"),
    ("cf_strip_items_k50", 4096, 59_392, 50, "normal"),
    ("cf_strip_users_k50", 4096, 162_048, 50, "normal"),
)


def key_body(torch, s, k):
    """The 64-bit key body: ``torch.topk`` of the score's order-preserving
    integer above the reversed position (``-0.0`` as ``0.0``)."""
    n = s.shape[-1]
    key = (s + 0.0).view(torch.int32).to(torch.int64)
    key = torch.where(key < 0, key ^ 0x7FFFFFFF, key)
    key.bitwise_left_shift_(32).bitwise_or_(
        (n - 1) - torch.arange(n, device=s.device, dtype=torch.int64))
    _, idx = torch.topk(key, k, dim=-1, sorted=True)
    return torch.gather(s, -1, idx), idx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape names (default: all, and "
                         "the dense_topk rows)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_topk: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch.ops import cuda_topk, scoring
    from matrix_factorization_tpu_torch.ops.scoring import stable_topk
    from matrix_factorization_tpu_torch.retrieval import search

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__})
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = cs.Timer(torch)
    rules = {"stable_topk": stable_topk, "sort": scoring._sort_topk,
             "select": scoring._plain_select_topk,
             "key": lambda s, k: key_body(torch, s, k),
             "kernel": scoring._select_topk}
    bodies = {**rules, "torch_topk": lambda s, k: torch.topk(s, k, dim=-1)}
    wanted = set(args.shapes.split(",")) if args.shapes else None
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

    for name, rows, n, k, kind in SHAPES:
        if wanted is not None and name not in wanted:
            continue
        s = torch.randn((rows, n), generator=g, device="cuda")
        if kind == "steps":
            s = torch.round(s * 64) / 64
        elif kind != "normal":
            keep = torch.rand((rows, n), generator=g, device="cuda") < (
                7_000 if kind == "sparse" else 5) / n
            s = torch.where(keep, s.abs(), 0.0)
        want = [f(s, k) for f in rules.values()]
        check = all(torch.equal(w[0], want[0][0]) and torch.equal(w[1], want[0][1])
                    for w in want[1:])
        cs.check(check, f"{name}: the bodies disagree")
        row = {"phase": "topk", "shape": name, "rows": rows, "n": n, "k": k,
               "scores": kind, "equal": check}
        # in turns, each body twice, the minimum kept
        times = {b: [] for b in bodies}
        for b in (*bodies, *reversed(bodies)):
            times[b].append(timer.ms(lambda: bodies[b](s, k), reps=10))
        for b, t in times.items():
            row[f"{b}_ms"] = min(t)
        row["kernel_chunks"] = cuda_topk.select_plan(
            rows, n, k, n_sms, cuda_topk.blocks_per_sm()).chunks
        row["bytes_bound_ms"] = (rows * n * 4 + rows * k * 12) / cs.HBM_BYTES_PER_S * 1e3
        row["fastest_rule_body"] = min(("sort", "select", "key", "kernel"),
                                       key=lambda b: row[f"{b}_ms"])
        emit(row)
        del s, want
        torch.cuda.empty_cache()

    if wanted is not None:
        emit({"phase": "done", "nvidia_smi": smi})
        return 0
    # the dense search end to end with each body, and the product alone
    n, dim = 2_231_142, 512
    emb = torch.randn((n, dim), generator=g, device="cuda")
    emb /= emb.norm(dim=1, keepdim=True)
    for B in (1, 256):
        q = emb[:B].clone()
        row = {"phase": "dense_topk", "B": B, "n": n, "dim": dim, "k": 10}
        for b in rules:
            search.stable_topk = rules[b]
            try:
                row[f"{b}_ms"] = timer.ms(lambda: search.dense_topk(emb, q, 10),
                                          reps=5)
            finally:
                search.stable_topk = stable_topk

        block = max(1, search._TOPK_ELEMS // n)  # dense_topk's row block

        def product():
            with search.exact_f32():
                for lo in range(0, B, block):
                    q[lo:lo + block] @ emb.T

        row["product_ms"] = timer.ms(product, reps=5)
        row["bound_ms"] = max(n * dim * 4 / cs.HBM_BYTES_PER_S * 1e3,
                              2 * B * n * dim / cs.PEAK_FLOPS["float32"] * 1e3)
        emit(row)
    emit({"phase": "done", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
