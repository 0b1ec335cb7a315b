#!/usr/bin/env python3
"""Drive the PyTorch port's serving, SGD training and ALS paths, its bias,
neighbourhood and content models, its KernelMF sweep, its native host
packs, its sparse-gram top-k CF, EASE, BPR, SVD++, NMF and Popularity, the
recipe recommender's serving path and the batch pipeline on one CUDA GPU
and check them.

    python3 chip_smoke.py [--seed N]

Needs one CUDA GPU, ``nvcc`` and the checkout around this file; it fails
(non-zero exit, no result line) without them. Imports nothing of JAX or
of ``matrix_factorization_tpu``. Each phase prints one JSON line; any
failed check ends the run with a non-zero exit:

1. device: the card (``nvidia-smi`` name and power limit), torch, CUDA;
   TF32 off for every f32 product.
2. build: every ``csrc/*.cu`` of the port (the scorer, the SGD step and
   apply, the GJ SPD leaf, the segment sum), compiled for sm_90a, all
   ``nvcc`` processes at once; each kernel's registers, spill and stack
   bytes from ptxas (the scorer, the GJ leaf, the SGD step and the segment
   sum must not spill).
3. compare: the catalog-scoring kernel against its plain PyTorch version
   on the card, for kernels linear/sigmoid/rbf, f32 and bf16 tables, at
   (B, I, Kp) = (1, 59392, 256), (B_s, 59392, 256), (B_s + 1, 59392, 256)
   and (256, 59392, 256) (the two sides of the streaming/tiled boundary
   B_s), (5, 1000, 128), (3, 777, 1024) and (70, 1000, 1024) (I not a
   multiple of any tile); atol = rtol = 1e-4 (both sum in f32, in
   different orders). Then the cross-path check: every row of the B=256
   scores equals, bitwise, the same user scored alone (B=1, streaming)
   and inside a batch of B_s.
4. serve: MovieLens-25M KernelMF at full width (162,000 x 59,392, k=200,
   gamma 1/200, ratings in [0.5, 5]; ``BASELINE.json`` config 3) for
   sigmoid and rbf, random tables from ``--seed``: ``params_from_numpy``
   -> ``save_model`` -> ``load_model`` on the card -> ``predict`` (4,096
   pairs with unknown ids, against a float64 numpy reference) ->
   ``recommend`` with known items -> ``recommend_batch`` of 256 users
   (top-k sets against the plain scorer on the card) -> 64 concurrent
   requests through ``CoalescingRecommender`` (each equal to a direct
   ``recommend``). Launch counts are zeroed before this phase; each
   catalog step must launch the kernel.
5. latency / kernel_time: serving latencies; the scorer's kernel, plain
   and library (cuBLAS GEMM + torch epilogue: f32 for f32 tables, bf16
   with f32 output for bf16 tables, and the f32 GEMM on the widened bf16
   values as ``library_f32_ms``) times with CUDA events (median, L2
   flushed before each launch, then a device spin so that the window
   holds device time only: ``Timer``) and the bound of each shape, at
   B = 1, 16, 64 and 256, every kernel and table type.
6. data / pack: config-3 ratings (25M unique pairs of 162,000 x 59,392,
   half stars, as ``benchmarks/run_configs.py::_gen`` makes them, plus
   4,096 held out), the headline ratings of ``bench.py`` (2M, 10,000 x
   20,000), each packed once on the card (``pack_ratings``,
   ``order='auto'``).
6a. host_native: the host library (``csrc/host_loader.cpp``, g++) built
   and its seconds; ``load_ratings_csv`` of a 1M-row CSV of the config-2
   ratings, native against pandas (equal arrays); the config-3 pack
   (``order='auto'``, bs 2,097,152) and the config-3 ALS bucket packs,
   native against numpy (every tensor equal), seconds for each. Every
   later pack and fit packs natively.
7. compare_sgd: the SGD step kernel + the apply kernel against the plain
   step on the card, same tables and batch: config-3 sigmoid (bs 2M, Kp
   256, user-primary), config-3 rbf (bs 1M), a skewed config-3 batch
   (both ids drawn as floor(rows * U^2): one user run of ~5,000 entries),
   the headline linear batch (bs 131,072, Kp 128, item-primary), k=126
   (Kp 128, no spare lane), a frozen item side and the config-1 sweep's
   pack (first and last batch); both tables at atol = rtol = 1e-5, and
   two runs of the kernels bitwise equal; the apply alone on the plain
   step's deltas bitwise equal to its plain order model and to a second
   run.
8. train (sigmoid, rbf): config 3 through ``KernelMF.fit`` (3 epochs,
   falling train RMSE) and ``update_users`` (1,000 users, half of them
   known; the item table bitwise unchanged) with the step and apply
   counts zeroed just before and read just after; ``predict`` on the
   held-out pairs and ``recommend``; then updates/s (median of 3
   one-epoch windows on the pack made once), one epoch against the plain
   step (atol 1e-4), the epoch repeated (bitwise equal) and a profiled
   epoch (device busy share, top kernels).
9. golden: the golden mini fixture trained on the card, held-out RMSE
   within 1e-3 of the pinned oracle values (3 kernels x 2 pack orders).
10. train_headline: ``bench.py``'s shape, updates/s over a 20-epoch
    window, median of 5, beside the card's name and power limit.
11. sgd_kernel_time: the step and the apply on the first batch of the
    config-3 sigmoid and rbf packs, on the skewed config-3 batch, on the
    first batch of the headline pack and of the config-1 sweep's pack:
    kernel, plain and library (``index_add_`` for the apply) times
    (``Timer``), the bounds computed from that batch, and its longest
    primary run.

12. als_pack: config 3 grouped into count buckets once (by user: chunks of
    15,625 x 256; by item: 7,812 x 512).
13. compare_spd: the GJ leaf kernel against its plain version on the card,
    both against the float64 inverse, at (E, d) = (15,625, 104),
    (15,625, 97), (7,812, 101), (1,000, 128), (4,096, 64), (3, 8), (5, 1)
    on Jacobi-scaled ridged grams of seeded rows, and on the two leaves
    (104 and 97) of the first full config-3 user chunk at k=200; atol =
    rtol = 1e-4 between the two, ``max|A X - I| < 5e-3``.
14. train_als: ``KernelMF(method='als')`` at config 3, k=200, reg 0.1 per
    observation, through ``fit`` (3 sweeps, bucketed, falling RMSE) and
    ``update_users`` (1,000 users, half known; items bitwise unchanged)
    with the GJ count zeroed just before and read just after; ``predict``,
    ``recommend`` and a checkpoint round trip. als_sweeps: one sweep's
    seconds at k=200 and k=100 on the buckets of 12; the first full user
    chunk's system solved with the Cholesky leaf against the GJ leaf (atol
    1e-4); the sweep repeated (bitwise equal); a profiled sweep and the
    GJ leaf's share of its device time.
15. warm_start: a sigmoid ``KernelMF`` (k=200, bs 2,097,152) with one ALS
    warm sweep and one SGD epoch on the first 2.5M config-3 ratings, GJ
    and SGD counts > 0, its train RMSE below a cold fit's.
16. implicit: ``ImplicitALS()`` (k=64) on 1M seeded interactions of
    6,040 x 3,706: ``fit`` (3 epochs, falling loss), ``update_users`` of
    100 new users, ``recommend``; GJ count > 0.
17. spd_kernel_time: the GJ leaf's kernel, plain and library
    (``torch.linalg.inv``) times at the first five shapes of 13, and
    their bounds.
17a. cf_topk: ``BASELINE.json`` config 4 at full scale: ``TopKItemItemCF``
    (50 neighbours) on the 25M config-3 ratings, ``fit`` seconds and peak
    memory, one strip timed by its parts (host sort and windows, tile
    builds + exact f32 GEMMs, cosine + ``stable_topk``, the top-k alone), a
    bulk ``predict`` of 1M seeded pairs, 64 sampled columns against a
    float64 scipy.sparse centered cosine (values within 1e-5, ids where
    separated by more than 1e-5), 4,096 predictions against a float64
    replay of the formula on the fitted lists (1e-4); then user-user
    ``similarity_topk(i, u, r, ...)`` once, timed, 16 of its columns held
    the same way, and its strip split.
17b. bpr, svdpp, nmf: each family at the MovieLens-25M shape its JAX
    bench uses (k=64, Kp 128, bs 1,048,576, 3 epochs) on the config-3
    ratings (BPR takes them as positives), from one user-primary pack
    made once: one epoch through ``mf_segment_apply`` (BPR, SVD++)
    or ``mf_segment_sum`` (NMF) against the same epoch through their plain
    versions on the card, same tables and draws (atol 1e-4, SVD++ 2e-4),
    the kernel epoch twice bitwise; updates/s (median of 3 one-epoch
    windows on the pack made once); then ``fit`` and ``update_users``
    (1,000 users, half known; the item table, and SVD++'s Y, bitwise
    unchanged) with the apply, segment-sum and scorer counts zeroed just
    before and read after serving: BPR's visited loss and SVD++'s train
    RMSE fall, NMF's never rises and its factors stay >= 0; ``predict`` on
    the held-out pairs against a float64 replay of the served formula
    (1e-4); ``recommend`` and a 256-user ``recommend_batch`` on the scorer,
    top-10 sets equal to the plain scorer's; BPR's ``auc`` on the held-out
    pairs (at chance: the ratings are uniform) and on 4,096 trained pairs
    (> 0.5); a checkpoint round trip, bitwise.
17c. popularity: ``Popularity`` ('mean') on the config-3 ratings: counts
    against ``bincount``, scores against float64 (1e-4), 256 equal lists,
    ``update_users``, a checkpoint round trip.
17d. family_kernel_time: the apply and the segment sum on the first batch
    of the families' pack (n = 1,048,576, d = 128) over the batch's user
    order, its secondary order and (the apply) sorted uniform negatives:
    kernel, plain and library (``index_add_``) times and bounds.

18. ml1m_data / compare_segsum: MovieLens-1M-shaped ratings
    (``BASELINE.json`` config 2: 1M unique pairs of 6,040 x 3,706, half
    stars, as ``run_configs._gen`` makes them, plus 10,000 held out); the
    segment-sum kernel against ``index_add_`` on the card (rtol 1e-5, atol
    1e-5 x the row's absolute sum), bitwise against its plain model and a
    second run: the 1M ratings by user and by item, by user with 18
    columns, a 4,096-entry batch, a stream with one 200,000-entry segment,
    1M entries in runs of 1-19 straddling the lanes' slices of 8.
19. baseline: ``BaselineModel`` at config 2 by ALS (reg 0.5) and by SGD
    (lr 0.02, reg 0.02, bs 4,096), 20 epochs each: ``fit`` (falling train
    RMSE, seconds), ``update_users`` (1,000 users, half known; item biases
    bitwise unchanged), ``predict`` on the held-out pairs (float64 numpy,
    atol 1e-5), ``recommend``, ``recommend_batch`` of 256 users, with the
    segment-sum count zeroed just before and read just after; the fit
    repeated (bitwise equal), a checkpoint round trip, the ALS-SGD gap.
20. cf: ``UserUserCF`` and ``ItemItemCF`` (50 neighbours) on the config-2
    ratings: ``fit`` seconds (a second fit bitwise equal), ``predict`` of
    100,000 pairs, 2,000 of them against a float64 oracle (atol 6e-3),
    ``recommend``.
21. content: ``ContentBasedRecommender`` with 18 seeded binary genre
    columns and without: profiles and both ``predict_mode``s against
    float64 numpy (atol 1e-5); segment-sum count > 0.
22. sweep: ``grid_search_kernel_mf`` at config 1 (MovieLens-100K shape,
    linear, k=100, bs 4,096, 20 epochs, the 3 x 3 grid, 10,000 held out):
    seconds, aggregate updates/s, step and apply counts = 9 x batches x 20,
    ``recommend`` on the winner (scorer count > 0); the sweep again through
    ``grid_train`` (the winner bitwise), its best and worst candidates
    against ``sgd_train`` alone (atol 1e-5).
23. segsum_kernel_time: the segment sum's kernel, plain and library
    (``index_add_``) times at the shapes of 18 (``Timer``), and their
    bounds.
24. ease: EASE at MovieLens-1M shape (the config-2 ratings as implicit
    feedback, lam 250) through ``fit`` with the GJ count zeroed just
    before and read just after, ``B`` against float64 numpy EASE (atol
    1e-4), the top-10 of 256 users against float64 where separated by
    more than 1e-5, a checkpoint round trip; at the item budget (16,384
    items, 100,000 users x 100 interactions, lam 100) ``item_gram`` and
    ``ease_weights`` timed apart with peak memory, held by
    ``(G + lam I)(I - B) = diag(1 / diag P)`` on 256 columns (off-diagonal
    within 1e-3 of the diagonal).
25. spd_kernel_time at EASE's leaves: every leaf input the two EASE fits'
    Schur recursions handed the GJ leaf, the kernel held to its plain
    version (atol = rtol = 1e-4) and both to the float64 inverse
    (``|A X - I|`` < 5e-3); the kernel, plain and library times on the
    first input of each width.

26. recipe_serve: the recipe recommender at RecipeNLG's catalog
    (2,231,142 recipes): a dense index of 2,231,142 x 512 (the first 3,706
    rows ``hash_embed`` of seeded recipe texts, the rest seeded unit rows)
    on the card; a ``KernelMF`` (linear, k=200, Kp 256) fitted there by SGD
    on the config-2 ratings (3 epochs, bs 131,072; the step and apply counts
    zeroed just before, read just after), the step and apply held against
    the plain step on that fit's own pack (its first and last batch, as
    compare_sgd holds them), pickled to ``model.pkl``; a
    ``TorchLogisticRegression`` reranker trained there on ``featurize`` rows
    of ``generate_queries`` over 200 recipes; the service loaded by
    ``from_artifacts`` (index, model, reranker) with a seeded metadata
    frame; ``search_topk`` of 64 queries at k 10 and at ``candidate_k``
    500, and ``search_topk_batch`` of 256, against a float64 numpy top-k on
    the host (``np.partition`` then ``np.lexsort``; values within 1e-5,
    positions equal except where scores tie within 1e-6 at the cut), their
    device times (``Timer``) against the bytes / operations bound; 64
    hybrid ``recommend`` calls (k 10, ``candidate_k`` 500, alpha 0.5; model
    scores not the zeros fallback, within 1e-5 of the model loaded on the
    CPU; the scores the blend), p50 / p99; 4 ``plan_meals`` with the
    reranker and avoid terms at the default diversity penalty (no avoided
    ingredient, no repeat within a meal; repeats across meals, which the
    planner allows as JAX's does, counted); the HTTP
    routes' statuses; the batched TF-IDF scores of 64 queries at
    ``vocab_block`` 1,024 on a seeded l2-normalized 2,231,142 x 50,000 CSR
    (32 terms a row) within 1e-5 of scipy's product, and their top-10.

27. pipeline: the batch pipeline end to end, every stage through its
    ``main()`` with no ``--platform`` (the default device, the card): config
    3's 25M ratings (item ids written as strings, as the MovieLens stage
    writes them) and 59,392 seeded recipe texts in; ``build_recipe_metadata``,
    ``build_structured_features``, ``build_item_embeddings --dim 512``,
    ``export_artifacts`` (the dense index), ``train`` of config 3's sigmoid
    KernelMF (k=200, bs 2,097,152, 3 epochs), ``evaluate`` of 2,000 users
    inside ``utils.profiling.trace`` (the first 200 lists against a float64
    numpy top-k of the model's tables with the same known items excluded,
    users whose 10th and 11th scores tie within 1e-5 skipped and counted;
    the metrics recomputed from every list equal to the stage's JSON; the
    trace's scorer kernels equal to the scorer's launch count; the
    device's busy share of the trace's window read from it); the same
    ``train`` (a narrow sigmoid KernelMF) and ``evaluate`` on 100,000
    seeded low-rank ratings (2,000 x 1,000), whose held-out items the model
    ranks high: the recomputed metrics equal to the JSON and above 0
    (config 3's uniform draws hit nothing at k 10), the first 200 lists
    held as above;
    ``evaluate_hybrid`` (64 of its batched profile top-k against a float64
    ``np.lexsort`` top-k, ties within 1e-5 allowed), ``train_reranker`` as
    logreg then mlp, ``evaluate_llm``, ``serve.app`` (one plan, no repeat
    within a meal), then ``train --model baseline --method als`` (its
    biases, made by 12 segment sums over the 25M entries, within 1e-5 of
    a float64 numpy replay of the same sweeps) and ``evaluate`` again;
    each stage's file checked with its rows; seconds
    per stage, ``fit`` seconds, ``evaluate`` users/s, peak device memory,
    host RSS and the launches of the scorer, the step, the apply and the
    segment sum, each stage's counted apart.

Then the ``kernels`` line (``score_catalog``, ``sgd_step``,
``segment_apply``, ``spd_gj`` with its EASE launches and shapes,
``segment_sum``; the apply's and the sum's launches and shapes on the
families' paths beside the rest), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 on the CUDA
# cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
N_USERS, N_ITEMS, N_FACTORS = 162_000, 59_392, 200  # config 3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def ext_tables(rng, n_rows, cfg, side, sd=0.1):
    """Bias-folded rows as ``init_params`` lays them out: factors and
    biases N(0, sd), the const column 1 (rbf: no extension columns)."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    t = np.zeros((n_rows, cfg.padded_factors), np.float32)
    t[:, : cfg.n_factors] = sd * rng.standard_normal((n_rows, cfg.n_factors),
                                                     dtype=np.float32)
    if cfg.kernel != "rbf":
        t[:, sgd.bias_col(cfg, side)] = sd * rng.standard_normal(
            n_rows, dtype=np.float32)
        t[:, sgd.const_col(cfg, side)] = 1.0
    return t


def bound(B, I, kp, kernel, dtype):
    """(bound_ms, bound_by): each input read once, the (B, I) f32 scores
    written once; 2 B I Kp product operations (+ the rbf norms) at the
    peak of the tables' type."""
    size = 4 if dtype == "float32" else 2
    nbytes = (B + I) * kp * size + B * I * 4 + 4
    flops = 2 * B * I * kp + (2 * (B + I) * kp if kernel == "rbf" else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(logs):
    """[kernel, registers, spill bytes (stores + loads), stack frame bytes]
    of every kernel in ``nvcc -Xptxas -v`` logs."""
    import re

    out, name, spill = [], None, None
    for log in logs:
        for ln in log.splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            if m:
                spill = (int(m.group(2)) + int(m.group(3)), int(m.group(1)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                out.append([name[:120], int(m.group(1)), *(spill or (0, 0))])
                name, spill = None, None
    return out


class Timer:
    """Median device time of one call, by CUDA events, the L2 cache
    flushed (a 256 MB write) before each timed call as a serving request
    would find it cold. Between the flush and the start event the card
    spins for ``SPIN_CYCLES`` (``torch.cuda._sleep``, which touches no
    memory): the host enqueues the call while the card still spins, so
    a wrapper's host work, when it outlasts the flush, does not fall
    inside the timed window. Readings before this spin included that host
    time."""

    SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's 1.98 GHz boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")

    def ms(self, fn, reps=25, warmup=3, before=None):
        """``before`` (default: the written flush) runs ahead of each
        timed call, then the spin."""
        torch = self.torch
        before = self.flush.zero_ if before is None else before
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            before()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def compare_shapes(b_s):
    """(B, I, Kp) of the compare phase: both sides of the path boundary
    B_s at config 3's width, and ragged item counts at Kp 128 and 1024."""
    return ((1, N_ITEMS, 256), (b_s, N_ITEMS, 256), (b_s + 1, N_ITEMS, 256),
            (256, N_ITEMS, 256), (5, 1000, 128), (3, 777, 1024),
            (70, 1000, 1024))


def score_cfg(SGDConfig, kernel, kp):
    n_factors = {256: N_FACTORS, 128: 100, 1024: 1000}[kp]
    return SGDConfig(kernel=kernel, n_factors=n_factors, gamma=1.0 / n_factors,
                     min_rating=0.5, max_rating=5.0)


def cross_path_equal(torch, cuda_scores, cfg, mu, pu, Q, whole, b_s):
    """Whether every row of ``whole`` (the scores of ``pu`` against ``Q``)
    equals, bitwise, the same user scored alone and inside its batch of
    ``b_s``: each score is one k-ordered f32 FMA chain on every path."""
    for r in range(pu.shape[0]):
        solo = cuda_scores.cuda_score_catalog(cfg, mu, pu[r:r + 1], Q)
        if not torch.equal(solo[0], whole[r]):
            return False
    for g in range(0, pu.shape[0], b_s):
        part = cuda_scores.cuda_score_catalog(cfg, mu, pu[g:g + b_s], Q)
        if not torch.equal(part, whole[g:g + b_s]):
            return False
    return True


def phase_compare(torch, rng, SGDConfig, cuda_scores):
    """Kernel vs plain version on the card, and at B=256 the cross-path
    bitwise check; returns the largest error."""
    worst = 0.0
    b_s = cuda_scores.STREAM_MAX_B
    for B, I, kp in compare_shapes(b_s):
        for kernel in ("linear", "sigmoid", "rbf"):
            cfg = score_cfg(SGDConfig, kernel, kp)
            pu32 = torch.from_numpy(ext_tables(rng, B, cfg, "user")).to("cuda")
            Q32 = torch.from_numpy(ext_tables(rng, I, cfg, "item")).to("cuda")
            mu = torch.tensor(3.5, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                pu, Q = pu32.to(dtype), Q32.to(dtype)
                got = cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)
                want = cuda_scores.plain_score_catalog(cfg, mu, pu, Q)
                err = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got, want, atol=1e-4, rtol=1e-4)
                out = {"phase": "compare", "B": B, "I": I, "Kp": kp,
                       "kernel": kernel, "dtype": str(dtype).split(".")[-1],
                       "path": cuda_scores.score_plan(
                           B, I, kp, pu.element_size()).path,
                       "max_abs_err": err, "ok": ok}
                if B == 256:
                    out["cross_path_equal"] = cross_path_equal(
                        torch, cuda_scores, cfg, mu, pu, Q, got, b_s)
                emit(out)
                check(ok, f"kernel disagrees with its plain version at "
                          f"B={B} I={I} Kp={kp} {kernel} {dtype}: {err}")
                check(out.get("cross_path_equal", True),
                      f"B=256 scores differ from B=1 / B={b_s} ones "
                      f"({kernel} {dtype})")
                worst = max(worst, err)
    return worst


def phase_serve(torch, rng, kernel, tmpdir, launches):
    """Config 3 through the port's public entry points."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import (
        CoalescingRecommender, KernelMF, load_model, params_from_numpy,
        save_model)
    from matrix_factorization_tpu_torch.core.ids import IdVocab
    from matrix_factorization_tpu_torch.ops import cuda_scores
    from matrix_factorization_tpu_torch.ops.scoring import stable_topk

    out = {"phase": "serve", "kernel": kernel}
    t0 = time.perf_counter()
    src = KernelMF(n_factors=N_FACTORS, kernel=kernel, gamma=1.0 / N_FACTORS,
                   min_rating=0.5, max_rating=5.0, device="cuda")
    cfg = src._cfg()
    P = ext_tables(rng, N_USERS, cfg, "user")
    Q = ext_tables(rng, N_ITEMS, cfg, "item")
    mean = 3.5
    src.user_vocab = IdVocab(range(N_USERS))
    src.item_vocab = IdVocab(range(10_000_000, 10_000_000 + N_ITEMS))
    src.global_mean = mean
    src._params = params_from_numpy(P, Q, mean, device="cuda", cfg=cfg)
    save_model(src, f"{tmpdir}/{kernel}")
    del src
    model = load_model(f"{tmpdir}/{kernel}")
    check(model._params.item_features.device.type == "cuda",
          "load_model put the tables elsewhere")
    out["setup_s"] = time.perf_counter() - t0

    # predict: known and unknown ids, against float64 numpy
    n = 4096
    u = rng.integers(0, N_USERS, n)
    i = rng.integers(0, N_ITEMS, n)
    u_raw = u.astype(object)
    i_raw = (i + 10_000_000).astype(object)
    u_raw[::37] = -1  # unknown user
    i_raw[::41] = -2  # unknown item
    n0 = launches()
    preds = np.asarray(model.predict(
        pd.DataFrame({"user_id": u_raw, "item_id": i_raw})))
    possible = np.asarray(model.predictions_possible)
    kp = cfg.padded_factors
    cold_u = np.zeros(kp)
    cold_i = np.zeros(kp)
    if kernel != "rbf":
        cold_u[cfg.n_factors + 1] = cold_i[cfg.n_factors] = 1.0
    pu = np.where((u_raw == -1)[:, None], cold_u, P[u].astype(np.float64))
    qi = np.where((i_raw == -2)[:, None], cold_i, Q[i].astype(np.float64))
    if kernel == "rbf":
        ref = cfg.a + cfg.c * np.exp(-cfg.gamma * ((pu - qi) ** 2).sum(1))
    else:
        ref = cfg.a + cfg.c / (1 + np.exp(-(mean + (pu * qi).sum(1))))
    ref = np.clip(ref, 0.5, 5.0)
    err = float(np.abs(preds - ref).max())
    check(preds.shape == (n,) and np.isfinite(preds).all(), "predict shape")
    check(preds.min() >= 0.5 and preds.max() <= 5.0, "predict outside [0.5, 5]")
    check(err < 1e-4, f"predict differs from the numpy reference by {err}")
    check((possible == ((u_raw != -1) & (i_raw != -2))).all(),
          "predictions_possible")
    out["predict_max_abs_err"] = err
    out["predict_launches"] = launches() - n0

    # recommend with known items
    user = int(rng.integers(N_USERS))
    base = model.recommend(user, amount=10)
    known = list(base["item_id"].iloc[:5]) + list(
        rng.integers(0, N_ITEMS, 15) + 10_000_000)
    n0 = launches()
    rec = model.recommend(user, amount=10, items_known=known)
    check(launches() > n0, "recommend did not launch the kernel")
    check(len(rec) == 10 and not set(rec["item_id"]) & set(known),
          "recommend returned a known item")
    s = rec["rating_pred"].to_numpy()
    check(bool((np.diff(s) <= 0).all()), "recommend scores not descending")

    # an unknown user is scored pair by pair from the cold row
    cold = model.recommend(-1, amount=10)
    check(len(cold) == 10 and not any(model.predictions_possible),
          "recommend for an unknown user")

    # recommend_batch, top-k sets against the plain scorer on the card
    users = [int(x) for x in rng.choice(N_USERS, 256, replace=False)]
    n0 = launches()
    batch = model.recommend_batch(users, amount=10)
    check(launches() > n0, "recommend_batch did not launch the kernel")
    check(len(batch) == 2560, "recommend_batch row count")
    params = model._params
    ud = torch.as_tensor(users, device="cuda")
    plain = cuda_scores.plain_score_catalog(
        cfg, params.global_mean, params.user_features[ud],
        params.item_features[:N_ITEMS])
    pv, pi = stable_topk(plain, 11)
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy() + 10_000_000
    compared = 0
    for row, usr in enumerate(users):
        got = batch.loc[batch.user_id == usr]
        check(bool((np.diff(got["rating_pred"].to_numpy()) <= 0).all()),
              "recommend_batch scores not descending")
        if pv[row, 9] - pv[row, 10] >= 1e-4:
            compared += 1
            check(set(got["item_id"]) == set(pi[row, :10]),
                  f"recommend_batch top-10 of user {usr} differs from plain")
    out["topk_rows_compared"] = compared
    check(compared >= 128, "too few rows without a near-tie to compare")

    # concurrent requests through the coalescer
    co_users = users[:64]
    solo = {usr: model.recommend(usr, amount=10) for usr in co_users}
    results, errors = {}, []
    co = CoalescingRecommender(model, window_ms=5.0, max_batch=64)
    n0 = launches()
    try:
        def work(usr):
            try:
                results[usr] = co.recommend(usr, amount=10)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=work, args=(usr,)) for usr in co_users]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), "coalesced callers hung")
    finally:
        co.close()
    check(not errors, f"coalesced requests failed: {errors[:3]}")
    check(launches() > n0, "the coalescer did not launch the kernel")
    for usr in co_users:
        got, want = results[usr], solo[usr]
        check((got["user_id"] == usr).all(), "a caller got another user's rows")
        check(list(got["item_id"]) == list(want["item_id"]) and np.array_equal(
            got["rating_pred"].to_numpy(), want["rating_pred"].to_numpy()),
            f"coalesced rows of user {usr} differ from recommend")
    out["coalesce_dispatches"] = co.dispatches
    out["coalesce_served"] = co.served
    return model, out


def device_time(events):
    """The device's work in a Chrome trace's ``events``: its kernel, copy
    and memset intervals ((start, end, name), microseconds, by start), the
    milliseconds of each name, and the busy microseconds (the union of the
    intervals)."""
    ev = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                for e in events if e.get("ph") == "X"
                and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    by_name, busy_us, cur = {}, 0.0, None
    for t_start, t_end, name in ev:
        by_name[name] = by_name.get(name, 0.0) + (t_end - t_start) / 1e3
        if cur is None or t_start > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [t_start, t_end]
        else:
            cur[1] = max(cur[1], t_end)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    return ev, by_name, busy_us


def _device_share(torch, fn, calls, match=None):
    """Run ``fn`` over ``calls`` under ``torch.profiler`` and read the
    exported trace: the device time per call, the device's busy share
    (the union of its kernel and copy intervals over the span from the
    first to the last; the rest is idle, waiting on the host), the device
    time over the host's wall time (a lower bound: the profiler slows the
    host), the kernels that took most of the time and, for ``match``, the
    time and share of device time of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in calls:
            fn(c)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        trace = json.loads(Path(f"{d}/trace.json").read_text())
    ev, by_name, busy_us = device_time(trace["traceEvents"])
    dev_ms = sum(by_name.values())
    span_us = ev[-1][1] - ev[0][0] if ev else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"device_ms_per_call": dev_ms / len(calls),
           "device_busy_share": busy_us / span_us if span_us else None,
           "device_share_of_wall": dev_ms / wall_ms if dev_ms else None,
           "top_kernels_ms_per_call": [[n[:80], t / len(calls)] for n, t in top]}
    if match is not None:
        hit = [(n, t) for n, t in by_name.items() if match in n]
        ms = sum(t for _, t in hit)
        out[f"{match}_calls"] = sum(1 for e in ev if match in e[2]) / len(calls)
        out[f"{match}_ms_per_call"] = ms / len(calls)
        out[f"{match}_share"] = ms / dev_ms if dev_ms else None
    return out


def phase_latency(torch, rng, model):
    """Host-clock serving latency (the calls return host frames, so each
    ends synchronised with the card), and the device's share of it."""
    import numpy as np

    users = [int(x) for x in rng.choice(N_USERS, 256, replace=False)]
    for usr in users[:5]:
        model.recommend(usr, amount=10)
    lat, topk = [], []
    for usr in users[:50]:
        t0 = time.perf_counter()
        model.recommend(usr, amount=10)
        lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        model._catalog_topk(np.asarray([usr], np.int32), 10)
        topk.append((time.perf_counter() - t0) * 1e3)
    batch = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.recommend_batch(users, amount=10)
        batch.append((time.perf_counter() - t0) * 1e3)
    return {
        "recommend_p50_ms": float(np.median(lat)),
        "catalog_topk_b1_p50_ms": float(np.median(topk)),
        "recommend_batch_ms_per_user": float(np.median(batch)) / len(users),
        "recommend_profile": _device_share(
            torch, lambda u: model.recommend(u, amount=10), users[50:70]),
        "recommend_batch_profile": _device_share(
            torch, lambda us: model.recommend_batch(us, amount=10), [users] * 3),
    }


def library_scores(torch, cfg, mu, pu, Q):
    """One cuBLAS GEMM (f32, or bf16 with f32 output for bf16 tables) plus
    the torch epilogue: a yardstick of the same function; the port never
    calls it."""
    if pu.dtype == torch.float32:
        dots = torch.mm(pu, Q.t())
    else:
        dots = torch.mm(pu, Q.t(), out_dtype=torch.float32)
    if cfg.kernel == "linear":
        return dots.add_(mu)
    if cfg.kernel == "sigmoid":
        return dots.add_(mu).sigmoid_().mul_(cfg.c).add_(cfg.a)
    pn = pu.float().square().sum(1)
    qn = Q.float().square().sum(1)
    sq = pn[:, None] + qn[None, :] - 2 * dots
    return sq.clamp_(min=0).mul_(-cfg.gamma).exp_().mul_(cfg.c).add_(cfg.a)


SCORE_TIMED_B = (1, 16, 64, 256)


def phase_kernel_times(torch, rng, SGDConfig, cuda_scores, timer):
    """Kernel, plain and library times at the serving shapes of config 3,
    every kernel and table type."""
    rows = []
    for B in SCORE_TIMED_B:
        for kernel in ("linear", "sigmoid", "rbf"):
            cfg = score_cfg(SGDConfig, kernel, 256)
            pu32 = torch.from_numpy(ext_tables(rng, B, cfg, "user")).to("cuda")
            Q32 = torch.from_numpy(ext_tables(rng, N_ITEMS, cfg, "item")).to("cuda")
            mu = torch.tensor(3.5, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                pu, Q = pu32.to(dtype), Q32.to(dtype)
                name = str(dtype).split(".")[-1]
                b_ms, b_by = bound(B, N_ITEMS, cfg.padded_factors, kernel, name)
                row = {
                    "B": B, "I": N_ITEMS, "Kp": cfg.padded_factors,
                    "kernel": kernel, "dtype": name,
                    "path": cuda_scores.score_plan(B, N_ITEMS, cfg.padded_factors,
                                                   pu.element_size()).path,
                    "ms": timer.ms(lambda: cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)),
                    "plain_ms": timer.ms(lambda: cuda_scores.plain_score_catalog(cfg, mu, pu, Q)),
                    "library_ms": timer.ms(lambda: library_scores(torch, cfg, mu, pu, Q)),
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                if dtype != torch.float32:
                    # the f32 GEMM on the widened values, the earlier yardstick
                    pw, Qw = pu.float(), Q.float()
                    row["library_f32_ms"] = timer.ms(
                        lambda: library_scores(torch, cfg, mu, pw, Qw))
                    del pw, Qw
                rows.append(row)
                emit({"phase": "kernel_time", **row})
    return rows


# ---------------------------------------------------------------------------
# Training (slice 2): the SGD step and apply kernels
# ---------------------------------------------------------------------------

# config 3 (benchmarks/run_configs.py:170-185): bs 2M for sigmoid, 1M for rbf
CONFIG3 = {"sigmoid": {"lr": 0.01, "batch_size": 2_097_152},
           "rbf": {"lr": 0.05, "batch_size": 1_048_576}}
N_RATINGS = 25_000_000
N_HELD_OUT = 4096
# the headline shape of bench.py:29-39
HEAD = {"n_ratings": 2_000_000, "n_users": 10_000, "n_items": 20_000,
        "n_factors": 100, "batch_size": 131_072, "lr": 0.002, "reg": 0.005,
        "epochs": 20, "trials": 5}


def gen_ratings(n_users, n_items, n_ratings, seed):
    """Unique (user, item) pairs with half-star ratings in [0.5, 5], made
    as ``benchmarks/run_configs.py::_gen`` makes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    flat = rng.integers(0, n_users * n_items, int(n_ratings * 1.15),
                        dtype=np.int64)
    flat = np.unique(flat)[:n_ratings]
    rng.shuffle(flat)
    u = (flat // n_items).astype(np.int32)
    i = (flat % n_items).astype(np.int32)
    r = np.round(rng.uniform(0.5, 5, len(u)) * 2).astype(np.float32) / 2
    return u, i, r


def headline_ratings(seed):
    """The uniform ratings of ``bench.py``'s headline shape."""
    import numpy as np

    hr = np.random.default_rng(seed)
    return (hr.integers(0, HEAD["n_users"], HEAD["n_ratings"]).astype(np.int32),
            hr.integers(0, HEAD["n_items"], HEAD["n_ratings"]).astype(np.int32),
            hr.uniform(0.5, 5.0, HEAD["n_ratings"]).astype(np.float32))


def skewed_pack(n_users, n_items, batch_size, seed):
    """One user-primary batch of a skewed rating log: both ids drawn as
    ``floor(n_rows * U**2)``, U uniform in [0, 1), so that id 0 holds
    ~0.25% of the users' entries and ~0.41% of the items' at config 3 (the
    head of MovieLens-25M is close to that); stored as the pack stores a
    batch (stable sort by user, stable secondary argsort). A pair may
    repeat: the batch is for the kernels, not for a fit."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    rng = np.random.default_rng(seed)
    u = (n_users * rng.random(batch_size) ** 2).astype(np.int32)
    i = (n_items * rng.random(batch_size) ** 2).astype(np.int32)
    r = np.round(rng.uniform(0.5, 5, batch_size) * 2).astype(np.float32) / 2
    return sgd.pack_ratings(u, i, r, batch_size, shuffle_seed=None,
                            order="user", device="cuda")


def sgd_kernel_shapes(seed):
    """(shape, cfg, pack, n_users, n_items) of the step's and the apply's
    measured shapes without the 25M ratings (``tools/probe_kernels.py``),
    each pack made directly from the seed: a config-3 sigmoid batch as the
    25M-rating pack lays one out (two batches of uniform ratings sorted by
    user as one chunk; batch 0 is the lower half of the users), the skewed
    config-3 batch, the headline pack, and the config-1 sweep's pack."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    bs = CONFIG3["sigmoid"]["batch_size"]
    cfg3 = sgd_cfg("sigmoid", N_FACTORS, CONFIG3["sigmoid"]["lr"], bs)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, 2 * bs).astype(np.int32)
    i = rng.integers(0, N_ITEMS, 2 * bs).astype(np.int32)
    r = np.round(rng.uniform(0.5, 5, 2 * bs) * 2).astype(np.float32) / 2
    yield ("config3_sigmoid", cfg3,
           sgd.pack_ratings(u, i, r, bs, shuffle_seed=None, order="user",
                            item_sort_chunks=1, device="cuda"),
           N_USERS, N_ITEMS)
    yield ("config3_skewed", cfg3, skewed_pack(N_USERS, N_ITEMS, bs, seed),
           N_USERS, N_ITEMS)
    yield ("headline_linear",
           sgd_cfg("linear", HEAD["n_factors"], HEAD["lr"], HEAD["batch_size"],
                   reg=HEAD["reg"]),
           sgd.pack_ratings(*headline_ratings(seed), HEAD["batch_size"],
                            order="auto", device="cuda"),
           HEAD["n_users"], HEAD["n_items"])
    sw = sweep_inputs(seed)
    yield ("config1_sweep_linear", sw["cfg"], sw["data"], sw["n_users"],
           sw["n_items"])


def longest_run(ids):
    """Length of the longest run of equal values in a sorted id tensor."""
    _, counts = ids.unique_consecutive(return_counts=True)
    return int(counts.max())


def sgd_cfg(kernel, n_factors, lr, batch_size, **kw):
    from matrix_factorization_tpu_torch.core.config import SGDConfig

    return SGDConfig(kernel=kernel, n_factors=n_factors, lr=lr,
                     reg=kw.pop("reg", 0.005), gamma=1.0 / n_factors,
                     min_rating=0.5, max_rating=5.0, batch_size=batch_size,
                     **kw)


def random_params(torch, rng, cfg, n_users, n_items):
    from matrix_factorization_tpu_torch import params_from_numpy

    return params_from_numpy(ext_tables(rng, n_users, cfg, "user"),
                             ext_tables(rng, n_items, cfg, "item"), 3.5,
                             device="cuda", cfg=cfg)


def clone_params(p):
    return p._replace(user_features=p.user_features.clone(),
                      item_features=p.item_features.clone())


def step_args(params, b, cfg, primary):
    """The step's arguments for a pack's batch (sorted by ``primary``,
    with its argsort) as ``segment_sgd.minibatch_update`` maps them:
    (positional args, keyword args, the secondary table)."""
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    prim, sec = ("user", "item") if primary == "user" else ("item", "user")
    tables = {"user": params.user_features, "item": params.item_features}
    ids = {"user": b["u"], "item": b["i"]}
    upd = {"user": cfg.update_user_params, "item": cfg.update_item_params}
    dev = params.user_features.device
    args = (cfg, params.global_mean, tables[prim], tables[sec], ids[prim],
            ids[sec], b["r"], b["w"], sgd.mask_tensor(cfg, prim, dev),
            sgd.mask_tensor(cfg, sec, dev), cfg.lr, cfg.reg)
    return args, {"update_prim": upd[prim], "write_dq": upd[sec]}, tables[sec]


def run_step(params, b, cfg, primary, plain):
    """One step on the card, in place: the step and apply kernels, or
    (``plain``) their plain versions. Returns the secondary deltas."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd

    step, apply = ((cuda_sgd.plain_sgd_step, cuda_sgd.plain_segment_apply)
                   if plain else
                   (cuda_sgd.cuda_sgd_step, cuda_sgd.cuda_segment_apply))
    args, kw, sec_tbl = step_args(params, b, cfg, primary)
    dq = step(*args, **kw)
    if kw["write_dq"]:
        apply(sec_tbl, dq, b["sp"], b["ss"])
    return dq


def phase_compare_sgd(torch, rng, cases):
    """Step kernel + apply kernel against the plain step on the card, from
    the same tables and batch; both tables and the step's ``dq`` at
    atol = rtol = 1e-5: both sum in f32, in different orders. The apply is
    also held alone, both versions applying the plain step's ``dq``, and
    bitwise against its plain order model ``segmented_segment_sum``
    (chunks of ``APPLY_CHUNK``) and a second run of itself. Returns the
    largest error of the step (primary table, dq) and of the apply
    (secondary table). Two runs of the kernels from the same tables must
    agree bitwise."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    worst = {"sgd_step": 0.0, "segment_apply": 0.0}
    for name, cfg, pack, k, n_users, n_items in cases:
        t0 = time.perf_counter()
        b = sgd.batch_at(pack, k)
        p0 = random_params(torch, rng, cfg, n_users, n_items)
        pk, pp = clone_params(p0), clone_params(p0)
        dq = run_step(pk, b, cfg, pack.primary, plain=False)
        again = clone_params(p0)
        dq_again = run_step(again, b, cfg, pack.primary, plain=False)
        check(torch.equal(pk.user_features, again.user_features)
              and torch.equal(pk.item_features, again.item_features)
              and (dq is None or torch.equal(dq, dq_again)),
              f"compare_sgd {name}: two runs of the kernels differ")
        del again, dq_again
        dq_plain = run_step(pp, b, cfg, pack.primary, plain=True)
        prim, sec = (("user_features", "item_features")
                     if pack.primary == "user"
                     else ("item_features", "user_features"))
        upd_sec = dq is not None
        out = {"phase": "compare_sgd", "case": name, "kernel": cfg.kernel,
               "bs": pack.batch_size, "Kp": cfg.padded_factors,
               "primary": pack.primary,
               "longest_prim_run": longest_run(
                   b["u"] if pack.primary == "user" else b["i"]),
               "update_prim": (cfg.update_user_params if prim == "user_features"
                               else cfg.update_item_params),
               "update_sec": upd_sec}
        errs = {}
        for tname in ("user_features", "item_features"):
            got, want = getattr(pk, tname), getattr(pp, tname)
            errs[tname] = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, atol=1e-5, rtol=1e-5)
            check(ok, f"compare_sgd {name}: {tname} differs by {errs[tname]}")
        step_err = errs[prim]
        if not out["update_prim"]:
            check(torch.equal(getattr(pk, prim), getattr(p0, prim)),
                  f"compare_sgd {name}: the frozen primary side moved")
        if upd_sec:
            step_err = max(step_err, float((dq - dq_plain).abs().max()))
            check(torch.allclose(dq, dq_plain, atol=1e-5, rtol=1e-5),
                  f"compare_sgd {name}: dq differs")
            got, again, model, want = (getattr(p0, sec).clone()
                                       for _ in range(4))
            cuda_sgd.cuda_segment_apply(got, dq_plain, b["sp"], b["ss"])
            cuda_sgd.cuda_segment_apply(again, dq_plain, b["sp"], b["ss"])
            ss.segmented_segment_sum(model, dq_plain, b["sp"], b["ss"],
                                     chunk=cuda_sgd.APPLY_CHUNK,
                                     layout="columns")
            cuda_sgd.plain_segment_apply(want, dq_plain, b["sp"], b["ss"])
            apply_err = float((got - want).abs().max())
            check(torch.equal(got, again),
                  f"compare_sgd {name}: two runs of the apply differ")
            check(torch.equal(got, model),
                  f"compare_sgd {name}: the apply is not its plain model")
            check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
                  f"compare_sgd {name}: the apply differs by {apply_err}")
            del again, model
            worst["segment_apply"] = max(worst["segment_apply"], apply_err)
            out["apply_max_abs_err"] = apply_err
        else:
            check(torch.equal(getattr(pk, sec), getattr(p0, sec)),
                  f"compare_sgd {name}: the frozen side moved")
        worst["sgd_step"] = max(worst["sgd_step"], step_err)
        torch.cuda.synchronize()
        out.update({"user_max_abs_err": errs["user_features"],
                    "item_max_abs_err": errs["item_features"],
                    "step_max_abs_err": step_err,
                    "seconds": time.perf_counter() - t0, "ok": True})
        emit(out)
        del pk, pp, p0, dq, dq_plain
        torch.cuda.empty_cache()  # the plain step's (bs, Kp) temporaries
    return worst


def plain_epoch(params, data, cfg, order):
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    for k in order.tolist():
        run_step(params, sgd.batch_at(data, k), cfg, data.primary, plain=True)


def phase_train(torch, rng, kernel, data3, pack, pack_seconds, seed):
    """Config 3 through ``KernelMF.fit`` and ``update_users`` (the main
    path; the step and apply counts are zeroed just before it and read
    just after), then throughput on the pack made once, the plain epoch,
    bitwise repeatability, the profile, ``predict`` and ``recommend``."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF
    from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u, i, r, hu, hi = data3
    spec = CONFIG3[kernel]
    out = {"phase": "train", "kernel": kernel, "n_ratings": len(r),
           "batch_size": spec["batch_size"], "pack_seconds": pack_seconds,
           "n_batches": pack.n_batches, "primary": pack.primary}
    model = KernelMF(n_factors=N_FACTORS, kernel=kernel, lr=spec["lr"],
                     reg=0.005, gamma=1.0 / N_FACTORS, min_rating=0.5,
                     max_rating=5.0, batch_size=spec["batch_size"],
                     epoch_order="auto", seed=seed)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)

    # -- the main path: fit, then update_users -------------------------
    cuda_sgd.reset_launches()
    t0 = time.perf_counter()
    model.fit(X, y, n_epochs=3)
    out["fit_seconds"] = time.perf_counter() - t0
    hist = model.train_rmse
    out["train_rmse"] = hist
    check(len(hist) == 3 and all(np.isfinite(hist)), f"train RMSE {hist}")
    check(hist[2] < hist[1] < hist[0], f"train RMSE not falling: {hist}")
    check(model._params.item_features.device.type == "cuda", "tables left the card")
    fit_launches = (cuda_sgd.step_launches, cuda_sgd.apply_launches)

    known = rng.choice(np.unique(u), 500, replace=False)
    new = np.arange(500) + 10_000_000
    uu = np.repeat(np.concatenate([known, new]), 100)
    ii = rng.integers(0, N_ITEMS, len(uu))
    pairs = np.unique(uu.astype(np.int64) * N_ITEMS + ii)
    Xu = pd.DataFrame({"user_id": pairs // N_ITEMS, "item_id": pairs % N_ITEMS})
    yu = pd.Series(np.round(rng.uniform(0.5, 5, len(Xu)) * 2) / 2)
    items = model._params.item_features.clone()
    n_users0 = model.n_users
    t0 = time.perf_counter()
    model.update_users(Xu, yu)
    torch.cuda.synchronize()
    out["update_users_seconds"] = time.perf_counter() - t0
    launches = {"sgd_step": cuda_sgd.step_launches,
                "segment_apply": cuda_sgd.apply_launches}
    check(launches["sgd_step"] > fit_launches[0], "update_users did not step")
    check(torch.equal(model._params.item_features, items),
          "update_users moved the frozen item table")
    check(model.n_users == n_users0 + 500, "update_users did not add users")
    out.update({"fit_launches": dict(zip(launches, fit_launches)),
                "launches": launches, "update_users_ratings": len(Xu),
                "update_users_rmse_last": model.train_rmse[-1]})

    # -- predict held-out pairs, recommend -----------------------------
    preds = np.asarray(model.predict(pd.DataFrame({"user_id": hu,
                                                   "item_id": hi})))
    check(preds.shape == (N_HELD_OUT,) and np.isfinite(preds).all(),
          "held-out predict shape")
    check(preds.min() >= 0.5 and preds.max() <= 5.0,
          "held-out predict outside [0.5, 5]")
    out["heldout_predict_mean"] = float(preds.mean())
    n0 = cuda_scores.launches
    rec = model.recommend(int(u[0]), amount=10)
    check(cuda_scores.launches > n0 and len(rec) == 10,
          "recommend after training did not launch the scorer")
    del model, X
    torch.cuda.empty_cache()

    # -- throughput on the pack made once ------------------------------
    cfg = sgd_cfg(kernel, N_FACTORS, spec["lr"], spec["batch_size"],
                  compute_epoch_rmse=False)
    p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                         N_USERS, N_ITEMS, cfg, float(r.mean()))
    gen = torch.Generator().manual_seed(seed)
    sgd.sgd_train(p0, pack, gen, cfg, 1, cfg.lr)  # warm-up epoch
    windows, enqueue = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd.sgd_train(p0, pack, gen, cfg, 1, cfg.lr)
        enqueue.append(time.perf_counter() - t0)  # host time to enqueue
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
    out["epoch_seconds"] = windows
    out["epoch_enqueue_seconds"] = enqueue
    out["updates_per_sec"] = pack.n_real / statistics.median(windows)

    # -- one epoch against the plain step; the kernel epoch repeated -----
    order = torch.randperm(pack.n_batches, generator=gen)
    pk = clone_params(p0)
    sgd.epoch(pk, pack, cfg, cfg.lr, order=order)
    pk2 = clone_params(p0)
    sgd.epoch(pk2, pack, cfg, cfg.lr, order=order)
    pp = clone_params(p0)
    plain_epoch(pp, pack, cfg, order)
    torch.cuda.synchronize()
    err = max(float((pk.user_features - pp.user_features).abs().max()),
              float((pk.item_features - pp.item_features).abs().max()))
    out["epoch_vs_plain_max_abs_err"] = err
    check(err <= 1e-4, f"a kernel epoch differs from the plain epoch by {err}")
    check(torch.equal(pk.user_features, pk2.user_features)
          and torch.equal(pk.item_features, pk2.item_features),
          "the kernel epoch is not bitwise repeatable")
    del pk, pk2, pp
    torch.cuda.empty_cache()

    # -- where an epoch's time goes ------------------------------------
    out["epoch_profile"] = _device_share(
        torch, lambda _: sgd.sgd_train(p0, pack, gen, cfg, 1, cfg.lr), [0])
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def phase_golden(torch):
    """The golden mini fixture on the card: held-out RMSE within 1e-3 of
    the pinned sequential-oracle values (``tests/test_golden_mini.py``),
    replaying the JAX engine's batch orders recorded beside the fixture."""
    import numpy as np

    from matrix_factorization_tpu_torch import params_from_numpy
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    data_dir = Path(__file__).resolve().parent / "tests" / "data"
    exp = json.loads((data_dir / "golden_mini_expected.json").read_text())
    orders = json.loads((data_dir / "golden_mini_batch_orders.json").read_text())
    raw = np.genfromtxt(data_dir / "golden_mini.csv", delimiter=",",
                        skip_header=1)
    u, i = raw[:, 0].astype(np.int32), raw[:, 1].astype(np.int32)
    r, tr = raw[:, 2].astype(np.float64), raw[:, 3].astype(bool)
    init = np.random.default_rng(exp["init_seed"])
    nu, ni, K = exp["n_users"], exp["n_items"], exp["n_factors"]
    P0 = init.normal(0, 0.1, (nu, K))
    Q0 = init.normal(0, 0.1, (ni, K))
    mu = float(r[tr].mean())
    lo, hi = exp["min_rating"], exp["max_rating"]
    out = {"phase": "golden", "budget": 1e-3}
    for kernel in ("linear", "sigmoid", "rbf"):
        cfg = SGDConfig(kernel=kernel, n_factors=K, lr=exp["lrs"][kernel],
                        reg=exp["reg"], gamma=exp["gamma"], min_rating=lo,
                        max_rating=hi, batch_size=1024)
        kp = cfg.padded_factors
        uf = np.zeros((sgd.round_up(nu, 8), kp), np.float32)
        uf[:nu, :K] = P0
        itf = np.zeros((sgd.round_up(ni, 8), kp), np.float32)
        itf[:ni, :K] = Q0
        if kernel != "rbf":
            uf[:, sgd.const_col(cfg, "user")] = 1.0
            itf[:, sgd.const_col(cfg, "item")] = 1.0
        for order in ("shuffle", "item"):
            params = params_from_numpy(uf, itf, mu, device="cuda")
            data = sgd.pack_ratings(u[tr], i[tr], r[tr].astype(np.float32),
                                    1024, order=order, device="cuda")
            params, _ = sgd.sgd_train(params, data, None, cfg, exp["n_epochs"],
                                      cfg.lr, batch_orders=orders["orders"])
            P = params.user_features.cpu().numpy().astype(np.float64)
            Q = params.item_features.cpu().numpy().astype(np.float64)
            ut, it_, rt = u[~tr], i[~tr], r[~tr]
            Pu, Qi = P[ut, :K], Q[it_, :K]
            if kernel == "rbf":
                pred = lo + (hi - lo) * np.exp(
                    -exp["gamma"] * ((Pu - Qi) ** 2).sum(1))
            else:
                x = (mu + P[ut, sgd.bias_col(cfg, "user")]
                     + Q[it_, sgd.bias_col(cfg, "item")] + (Pu * Qi).sum(1))
                pred = x if kernel == "linear" else lo + (hi - lo) / (1 + np.exp(-x))
            e = float(np.sqrt(np.mean((np.clip(pred, lo, hi) - rt) ** 2)))
            gap = abs(e - exp["oracle_test_rmse"][kernel])
            out[f"{kernel}_{order}_test_rmse"] = e
            out[f"{kernel}_{order}_gap"] = gap
            check(gap <= 1e-3, f"golden {kernel}/{order}: held-out RMSE {e} "
                               f"vs pinned {exp['oracle_test_rmse'][kernel]}")
    return out


def phase_train_headline(torch, head_data, pack, pack_seconds, seed, smi):
    """bench.py's headline shape: updates/s over a 20-epoch window,
    median of 5."""
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u, i, r = head_data
    cfg = sgd_cfg("linear", HEAD["n_factors"], HEAD["lr"], HEAD["batch_size"],
                  reg=HEAD["reg"], compute_epoch_rmse=False, shuffle="batch")
    params = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                             HEAD["n_users"], HEAD["n_items"], cfg,
                             float(r.mean()))
    gen = torch.Generator().manual_seed(seed)
    sgd.sgd_train(params, pack, gen, cfg, HEAD["epochs"], cfg.lr)  # warm-up
    rates, enqueue = [], []
    for _ in range(HEAD["trials"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd.sgd_train(params, pack, gen, cfg, HEAD["epochs"], cfg.lr)
        enqueue.append(time.perf_counter() - t0)  # host time to enqueue
        torch.cuda.synchronize()
        rates.append(HEAD["epochs"] * pack.n_real / (time.perf_counter() - t0))
    prof = _device_share(
        torch, lambda _: sgd.sgd_train(params, pack, gen, cfg, 1, cfg.lr), [0])
    return {"phase": "train_headline", "nvidia_smi": smi,
            "kernelmf_sgd_rating_updates_per_sec": statistics.median(rates),
            "updates_per_sec_best": max(rates), "trials": rates,
            "window_enqueue_seconds": enqueue,
            "window_epochs": HEAD["epochs"], "n_ratings": pack.n_real,
            "batch_size": pack.batch_size, "n_batches": pack.n_batches,
            "primary": pack.primary, "pack_seconds": pack_seconds,
            "epoch_profile": prof}


def sgd_bounds(b, kp, primary):
    """(bound_ms, bound_by) of the step and of the apply on this batch:
    each input read once (ids, r, w; each distinct secondary row; each
    primary run's row), each output written once (the primary rows, dq;
    the apply's touched rows), at 3.35 TB/s; about 12 f32 operations per
    entry and column for the step, 1 for the apply, at 67 TFLOP/s."""
    prim = b["u"] if primary == "user" else b["i"]
    n = prim.numel()
    runs_prim = int(prim.unique_consecutive().numel())
    runs_sec = int(b["ss"].unique_consecutive().numel())
    row = kp * 4
    step_bytes = n * 16 + runs_sec * row + 2 * runs_prim * row + n * row
    apply_bytes = n * (row + 8) + 2 * runs_sec * row
    out = {}
    for name, nbytes, flops in (("sgd_step", step_bytes, 12 * n * kp),
                                ("segment_apply", apply_bytes, n * kp)):
        tb, to = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
        out[name] = (max(tb, to) * 1e3, "bytes" if tb >= to else "operations",
                     nbytes)
    return out, runs_prim, runs_sec


def phase_sgd_kernel_times(torch, rng, shapes, timer):
    """Kernel, plain and library times of the step and the apply on the
    first batch of each (name, cfg, pack, n_users, n_items) shape, and
    their bounds; returns {shape name: {kernel name: row}}."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    out = {}
    for shape, cfg, pack, n_users, n_items in shapes:
        b = sgd.batch_at(pack, 0)
        p = random_params(torch, rng, cfg, n_users, n_items)
        args, _, S = step_args(p, b, cfg, pack.primary)
        bounds, runs_prim, runs_sec = sgd_bounds(b, cfg.padded_factors,
                                                 pack.primary)
        dq = cuda_sgd.cuda_sgd_step(*args)
        ss_long, dq_perm = b["ss"].long(), dq[b["sp"].long()]
        rows = {
            "sgd_step": {
                "ms": timer.ms(lambda: cuda_sgd.cuda_sgd_step(*args)),
                "plain_ms": timer.ms(lambda: cuda_sgd.plain_sgd_step(*args)),
                "library_ms": None},
            "segment_apply": {
                "ms": timer.ms(lambda: cuda_sgd.cuda_segment_apply(
                    S, dq, b["sp"], b["ss"])),
                "plain_ms": timer.ms(lambda: cuda_sgd.plain_segment_apply(
                    S, dq, b["sp"], b["ss"])),
                # one PyTorch call of the same function on the pre-permuted
                # rows: a float-atomic scatter, a yardstick the port never
                # calls
                "library_ms": timer.ms(lambda: S.index_add_(0, ss_long, dq_perm))},
        }
        for name, row in rows.items():
            row.update({"shape": shape, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "bound_bytes": bounds[name][2], "bs": pack.batch_size,
                        "Kp": cfg.padded_factors, "kernel": cfg.kernel,
                        "primary": pack.primary, "runs_prim": runs_prim,
                        "runs_sec": runs_sec,
                        "longest_prim_run": longest_run(
                            b["u"] if pack.primary == "user" else b["i"]),
                        "launches_per_epoch": pack.n_batches})
            emit({"phase": "sgd_kernel_time", "name": name, **row})
        out[shape] = rows
        del dq, dq_perm, p, args, S
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Factor ALS (slice 3): the Gauss-Jordan SPD leaf
# ---------------------------------------------------------------------------

# (E, d) of the leaf comparisons: the two Schur halves of a config-3 user
# chunk at k=200 (15,625 users of 256 slots, d=201 split 104 + 97), an item
# chunk at k=100 (d=101), d=128 past the 48 KB shared-memory opt-in,
# ImplicitALS's default d=64, and two small shapes
SPD_SHAPES = ((15_625, 104), (15_625, 97), (7_812, 101), (1_000, 128),
              (4_096, 64), (3, 8), (5, 1))
SPD_TIMED = SPD_SHAPES[:5]
# KernelMF(method='als') at config 3's width (benchmarks/RESULTS.md,
# "Extension: factor ALS")
ALS = {"n_factors": 200, "reg": 0.1, "reg_scale": "per_obs", "sweeps": 3}
# the ALS warm start of a sigmoid fit, on the first 2.5M config-3 ratings
WARM = {"n_ratings": 2_500_000, "batch_size": 2_097_152, "lr": 0.01,
        "reg": 0.005, "als_warm_reg": 0.1}
# ImplicitALS at its default width on the MovieLens-1M shape
IMPLICIT = {"n_users": 6_040, "n_items": 3_706, "n": 1_000_000, "epochs": 3,
            "new_users": 100}


def jacobi_scaled(torch, A):
    """``A`` scaled to a unit diagonal, as ``spd_solve`` hands it down."""
    ds = torch.rsqrt(torch.diagonal(A, dim1=-2, dim2=-1))
    return (A * ds[:, :, None] * ds[:, None, :]).contiguous()


def ridged_grams(torch, gen, E, d, L=64, ridge=0.5):
    """Jacobi-scaled ``X^T X + ridge I`` of seeded N(0, 0.3^2) rows, as
    ``tests/test_spd.py::_ridged_gram`` makes them: (E, d, d) f32."""
    X = torch.randn((E, L, d), generator=gen, device="cuda") * 0.3
    A = X.transpose(1, 2) @ X
    A.diagonal(dim1=-2, dim2=-1).add_(ridge)
    return jacobi_scaled(torch, A)


def spd_bound(E, d):
    """(bound_ms, bound_by) of E GJ inverses: 2 d^3 f32 operations and
    8 d^2 bytes (read once, written once) a matrix."""
    t_ops = 2.0 * d ** 3 * E / PEAK_FLOPS["float32"]
    t_bytes = 8.0 * d * d * E / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def first_full_chunk(buckets):
    return max(buckets, key=lambda b: b.other_ids.shape[0])


def chunk_leaves(torch, A):
    """The two GJ leaf inputs of ``spd_solve`` on a d=201 batch: the
    Jacobi-scaled A11 (104) and its Schur complement S (97), formed as
    ``spd_inverse`` forms them."""
    from matrix_factorization_tpu_torch.ops import cuda_spd, spd

    As = jacobi_scaled(torch, A)
    d = As.shape[-1]
    m = ((d // 2 + 7) // 8) * 8
    A11 = As[:, :m, :m].contiguous()
    A12 = As[:, :m, m:]
    inv11 = cuda_spd.cuda_gj_inverse(A11)
    S = As[:, m:, m:] - spd._mm(A12.transpose(1, 2), spd._mm(inv11, A12))
    return A11, S.contiguous()


def phase_compare_spd(torch, gen, real):
    """The GJ kernel against its plain version on the card, both against
    the float64 inverse; returns the largest kernel-vs-plain error.
    ``real``: (name, batch) leaf inputs of the config-3 chunk."""
    from matrix_factorization_tpu_torch.ops import cuda_spd

    def cases():
        for E, d in SPD_SHAPES:
            yield f"ridged_{E}x{d}", ridged_grams(torch, gen, E, d)
        yield from real

    worst = 0.0
    for name, A in cases():
        E, d = A.shape[0], A.shape[-1]
        got = cuda_spd.cuda_gj_inverse(A)
        want = cuda_spd.plain_gj_inverse(A)
        A64 = A.double()
        exact = torch.linalg.inv(A64)
        eye = torch.eye(d, dtype=torch.float64, device="cuda")
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, atol=1e-4, rtol=1e-4)
        out = {"phase": "compare_spd", "case": name, "E": E, "d": d,
               "max_abs_err": err,
               "kernel_eye_err": float((A64 @ got.double() - eye).abs().max()),
               "plain_eye_err": float((A64 @ want.double() - eye).abs().max()),
               "kernel_vs_f64": float((got.double() - exact).abs().max()),
               "plain_vs_f64": float((want.double() - exact).abs().max()),
               "inv_max_abs": float(exact.abs().max()), "ok": ok}
        emit(out)
        check(ok, f"compare_spd {name}: kernel differs from plain by {err}")
        check(out["kernel_eye_err"] < 5e-3 and out["plain_eye_err"] < 5e-3,
              f"compare_spd {name}: |A X - I| too large")
        worst = max(worst, err)
        del A, A64, got, want, exact
        torch.cuda.empty_cache()
    return worst


def phase_train_als(torch, rng, data3, seed, tmpdir):
    """KernelMF(method='als') at config 3 through ``fit`` (3 sweeps, on the
    bucketed path) and ``update_users`` (1,000 users, half known; the item
    table bitwise unchanged), with the GJ count zeroed just before and
    read just after; then ``predict``, ``recommend`` and a checkpoint
    round trip."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF, load_model, save_model
    from matrix_factorization_tpu_torch.models import kernel_mf
    from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_spd

    u, i, r, hu, hi = data3
    model = KernelMF(method="als", kernel="linear", n_factors=ALS["n_factors"],
                     reg=ALS["reg"], reg_scale=ALS["reg_scale"], min_rating=0.5,
                     max_rating=5.0, seed=seed)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    out = {"phase": "train_als", "n_ratings": len(r), **ALS}

    cuda_spd.reset_launches()
    t0 = time.perf_counter()
    model.fit(X, pd.Series(r), n_epochs=ALS["sweeps"])
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    hist = model.train_rmse
    out["train_rmse"] = hist
    check(kernel_mf._als_needs_buckets(u, i, model.n_users, model.n_items),
          "config 3 should take the bucketed ALS path")
    check(len(hist) == ALS["sweeps"] and all(np.isfinite(hist)),
          f"ALS train RMSE {hist}")
    check(hist[-1] < hist[0], f"ALS train RMSE not falling: {hist}")
    fit_launches = cuda_spd.launches

    known = rng.choice(np.unique(u), 500, replace=False)
    new = np.arange(500) + 10_000_000
    uu = np.repeat(np.concatenate([known, new]), 100)
    ii = rng.integers(0, N_ITEMS, len(uu))
    pairs = np.unique(uu.astype(np.int64) * N_ITEMS + ii)
    Xu = pd.DataFrame({"user_id": pairs // N_ITEMS, "item_id": pairs % N_ITEMS})
    yu = pd.Series(np.round(rng.uniform(0.5, 5, len(Xu)) * 2) / 2)
    items = model._params.item_features.clone()
    n_users0 = model.n_users
    t0 = time.perf_counter()
    model.update_users(Xu, yu)
    torch.cuda.synchronize()
    out["update_users_seconds"] = time.perf_counter() - t0
    launches = cuda_spd.launches
    check(launches > fit_launches, "ALS update_users did not launch the GJ leaf")
    check(torch.equal(model._params.item_features, items),
          "ALS update_users moved the frozen item table")
    check(model.n_users == n_users0 + 500, "ALS update_users did not add users")
    out.update({"fit_launches": fit_launches, "launches": launches,
                "update_users_rmse": model.train_rmse})

    preds = np.asarray(model.predict(pd.DataFrame({"user_id": hu,
                                                   "item_id": hi})))
    check(preds.shape == (N_HELD_OUT,) and np.isfinite(preds).all()
          and preds.min() >= 0.5 and preds.max() <= 5.0,
          "ALS held-out predict")
    out["heldout_predict_mean"] = float(preds.mean())
    n0 = cuda_scores.launches
    rec = model.recommend(int(u[0]), amount=10)
    check(cuda_scores.launches > n0 and len(rec) == 10,
          "ALS recommend did not launch the scorer")
    save_model(model, f"{tmpdir}/als")
    back = load_model(f"{tmpdir}/als")
    again = back.recommend(int(u[0]), amount=10)
    check(list(again["item_id"]) == list(rec["item_id"]) and np.array_equal(
        again["rating_pred"].to_numpy(), rec["rating_pred"].to_numpy()),
        "the reloaded ALS model recommends otherwise")
    del model, back, X
    torch.cuda.empty_cache()
    return out


def phase_als_sweeps(torch, data3, buckets, seed):
    """One sweep's seconds at k=200 and k=100 on buckets made once
    (median of 3), the first full user chunk's normal equations solved
    with the Cholesky leaf against the GJ leaf, the sweep repeated
    (bitwise equal) and a profiled sweep."""
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import ials, spd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    bu, bi = buckets
    mean = float(data3[2].mean())
    out = {"phase": "als_sweeps", "user_chunks": len(bu), "item_chunks": len(bi)}
    for k in (ALS["n_factors"], 100):
        cfg = SGDConfig(kernel="linear", n_factors=k, reg=ALS["reg"],
                        min_rating=0.5, max_rating=5.0, compute_epoch_rmse=False)
        p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                             N_USERS, N_ITEMS, cfg, mean)

        def sweep(_=None):
            return ials.ials_train_bucketed(p0, bu, bi, None, cfg, 1,
                                            reg_scale=ALS["reg_scale"])[0]

        sweep()  # warm-up
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p1 = sweep()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[f"k{k}_sweep_seconds"] = secs
        out[f"k{k}_sweep_median_s"] = statistics.median(secs)
        if k != ALS["n_factors"]:
            continue
        p2 = sweep()
        check(torch.equal(p1.user_features, p2.user_features)
              and torch.equal(p1.item_features, p2.item_features),
              "the ALS sweep is not bitwise repeatable")
        ch = first_full_chunk(bu)
        A, b = ials.normal_equations(p0.item_features, ch.other_ids, ch.ratings,
                                     ch.mask, p0.global_mean, cfg, "user",
                                     reg_scale=ALS["reg_scale"])
        x_gj = spd.spd_solve(A, b)
        x_chol = spd.spd_solve(A, b, leaf="cholesky")
        err = float((x_gj - x_chol).abs().max())
        out.update({"cholesky_vs_gj_max_abs_err": err,
                    "solution_max_abs": float(x_gj.abs().max()),
                    "chunk_E": int(A.shape[0]), "chunk_L": int(ch.other_ids.shape[1])})
        check(torch.allclose(x_gj, x_chol, atol=1e-4, rtol=0),
              f"Cholesky-leaf solve differs from the GJ-leaf solve by {err}")
        del A, b, x_gj, x_chol, p2
        torch.cuda.empty_cache()
        out["sweep_profile"] = _device_share(torch, sweep, [0],
                                             match="gj_inverse_kernel")
        out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def phase_warm_start(torch, data3, seed):
    """A sigmoid fit with one ALS warm sweep then one SGD epoch, on the
    first 2.5M config-3 ratings, against a cold fit of the same epoch."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF
    from matrix_factorization_tpu_torch.ops import cuda_sgd, cuda_spd

    n = WARM["n_ratings"]
    X = pd.DataFrame({"user_id": data3[0][:n], "item_id": data3[1][:n]})
    y = pd.Series(data3[2][:n])
    kw = dict(kernel="sigmoid", n_factors=N_FACTORS, lr=WARM["lr"],
              reg=WARM["reg"], min_rating=0.5, max_rating=5.0,
              batch_size=WARM["batch_size"], seed=seed)
    out = {"phase": "warm_start", **WARM}
    cuda_spd.reset_launches()
    cuda_sgd.reset_launches()
    t0 = time.perf_counter()
    warm = KernelMF(als_warm_start=1, als_warm_reg=WARM["als_warm_reg"],
                    **kw).fit(X, y, n_epochs=1)
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    launches = {"spd_gj": cuda_spd.launches, "sgd_step": cuda_sgd.step_launches,
                "segment_apply": cuda_sgd.apply_launches}
    check(all(v > 0 for v in launches.values()),
          f"the warm-start fit missed a kernel: {launches}")
    cold = KernelMF(**kw).fit(X, y, n_epochs=1)
    out.update({"launches": launches, "warm_train_rmse": warm.train_rmse,
                "cold_train_rmse": cold.train_rmse})
    check(np.isfinite(warm.train_rmse).all()
          and warm.train_rmse[-1] < cold.train_rmse[-1],
          f"warm start {warm.train_rmse} not below cold {cold.train_rmse}")
    del warm, cold
    torch.cuda.empty_cache()
    return out


def phase_implicit(torch, seed):
    """ImplicitALS at its default width (k=64) on 1M seeded interactions of
    6,040 x 3,706 (the MovieLens-1M shape), strengths 1..10: ``fit`` (loss
    falling), ``update_users`` for new users, ``recommend``."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import ImplicitALS
    from matrix_factorization_tpu_torch.ops import cuda_spd

    nu, ni, n = IMPLICIT["n_users"], IMPLICIT["n_items"], IMPLICIT["n"]
    rng = np.random.default_rng(seed + 2)
    flat = np.unique(rng.integers(0, nu * ni, int(n * 1.05)))
    rng.shuffle(flat)
    flat = flat[:n]  # after the shuffle: the sorted head would drop users
    X = pd.DataFrame({"user_id": flat // ni, "item_id": flat % ni})
    s = pd.Series(rng.integers(1, 11, len(flat)).astype(np.float32))
    out = {"phase": "implicit", **IMPLICIT}
    cuda_spd.reset_launches()
    t0 = time.perf_counter()
    m = ImplicitALS(n_epochs=IMPLICIT["epochs"], seed=seed).fit(X, s)
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    loss = m.train_loss
    check(len(loss) == IMPLICIT["epochs"] and np.isfinite(loss).all()
          and loss[-1] < loss[0], f"implicit loss not falling: {loss}")
    k = IMPLICIT["new_users"]
    Xn = pd.DataFrame({"user_id": np.repeat(np.arange(k) + 10_000_000, 20),
                       "item_id": np.concatenate(
                           [rng.choice(ni, 20, replace=False) for _ in range(k)])})
    items = m._params.item_features.clone()
    m.update_users(Xn, pd.Series(rng.integers(1, 11, len(Xn)).astype(np.float32)))
    check(torch.equal(m._params.item_features, items),
          "implicit update_users moved the item table")
    rec = m.recommend(10_000_000, amount=10)
    check(len(rec) == 10 and m.n_users == nu + k, "implicit recommend")
    out.update({"train_loss": loss, "launches": cuda_spd.launches})
    check(cuda_spd.launches > 0, "ImplicitALS launched no GJ leaf")
    return out


def phase_spd_kernel_times(torch, gen, timer):
    """Kernel, plain and library (``torch.linalg.inv``) times of the leaf
    at the main path's shapes, and their bounds."""
    from matrix_factorization_tpu_torch.ops import cuda_spd

    rows = []
    for E, d in SPD_TIMED:
        A = ridged_grams(torch, gen, E, d)
        b_ms, b_by = spd_bound(E, d)
        row = {"E": E, "d": d,
               "ms": timer.ms(lambda: cuda_spd.cuda_gj_inverse(A)),
               "plain_ms": timer.ms(lambda: cuda_spd.plain_gj_inverse(A)),
               # the one PyTorch call of the same function (LU-based): a
               # yardstick the port never calls
               "library_ms": timer.ms(lambda: torch.linalg.inv(A)),
               "bound_ms": b_ms, "bound_by": b_by}
        row["tflops"] = 2.0 * d ** 3 * E / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
        emit({"phase": "spd_kernel_time", **row})
        del A
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The bias, neighbourhood and content models and the sweep: the segment-sum
# kernel
# ---------------------------------------------------------------------------

# BASELINE.json config 2 (benchmarks/run_configs.py:126-162): MovieLens-1M
# shape, the bias model by ALS and by SGD
ML1M = {"n_users": 6_040, "n_items": 3_706, "n_ratings": 1_000_000,
        "held_out": 10_000}
BASE = {"als": {"method": "als", "reg": 0.5, "n_epochs": 20,
                "batch_size": 4096},
        "sgd": {"method": "sgd", "lr": 0.02, "reg": 0.02, "n_epochs": 20,
                "batch_size": 4096}}
CF_NEIGHBOURS = 50
CF_PREDICT = 100_000  # pairs timed; the first CF_ORACLE held to float64
CF_ORACLE = 2_000
N_GENRES = 18  # MovieLens-1M's genre count
# BASELINE.json config 1 (benchmarks/run_configs.py:114-123): MovieLens-100K
# shape, linear KernelMF, k=100, bs 4,096; the default 3 x 3 grid
ML100K = {"n_users": 943, "n_items": 1_682, "n_ratings": 100_000,
          "held_out": 10_000, "n_factors": 100, "batch_size": 4096,
          "epochs": 20}


def ml1m_ratings(seed):
    """MovieLens-1M-shaped ratings, as ``run_configs._gen`` makes them:
    (u, i, r) of the 1M training pairs and of the 10,000 held out."""
    n = ML1M["n_ratings"]
    u, i, r = gen_ratings(ML1M["n_users"], ML1M["n_items"],
                          n + ML1M["held_out"], seed)
    return (u[:n], i[:n], r[:n]), (u[n:], i[n:], r[n:])


def segsum_cases(train, rng):
    """(name, ids, n_rows, d) of the segment sum at the slice's shapes:
    the 1M ratings by user and by item (the bias sums, one column), by user
    with the 18 genre columns (the content profiles), a 4,096-entry batch
    (bias SGD's step), a stream with one 200,000-entry segment, and 1M
    entries in runs of 1-19 that straddle the lanes' slices of 8."""
    import numpy as np

    u, i, _ = train
    nu, ni = ML1M["n_users"], ML1M["n_items"]
    long_ids = np.concatenate([np.full(200_000, nu // 2),
                               rng.integers(0, nu, 300_000)])
    straddle = np.repeat(np.arange(100_000), rng.integers(1, 20, 100_000))
    return (("ml1m_by_user", u, nu, 1), ("ml1m_by_item", i, ni, 1),
            ("ml1m_profiles_by_user", u, nu, N_GENRES),
            ("batch_4096", u[:4096], nu, 1),
            ("long_segment", long_ids, nu, 1),
            ("straddle_slices", straddle, 100_000, 1))


def phase_compare_segsum(torch, rng, train):
    """The segment-sum kernel against ``index_add_`` on the card (rtol
    1e-5, atol 1e-5 x the row's absolute sum: both sum in f32, in other
    orders), bitwise against its plain model ``segmented_segment_sum``
    in the layout ``segsum_plan`` picks (the same adds in the same order)
    and against a second run. Returns the largest error."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    worst = 0.0
    for name, ids, n_rows, d in segsum_cases(train, rng):
        t0 = time.perf_counter()
        ids_t = torch.from_numpy(np.asarray(ids, np.int32)).to("cuda")
        vals = torch.from_numpy(rng.standard_normal(
            (len(ids), d), dtype=np.float32)).to("cuda")
        order = ss.sorted_order(ids_t)
        got = torch.zeros((n_rows, d), device="cuda")
        ss.cuda_segment_sum(got, vals, *order)
        again = torch.zeros_like(got)
        ss.cuda_segment_sum(again, vals, *order)
        model = torch.zeros_like(got)
        ss.segmented_segment_sum(model, vals, *order)
        want = torch.zeros_like(got)
        ss.plain_segment_sum(want, vals, *order)
        scale = torch.zeros_like(got)
        ss.plain_segment_sum(scale, vals.abs(), *order)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, again), f"compare_segsum {name}: two runs differ")
        check(torch.equal(got, model),
              f"compare_segsum {name}: the kernel is not its plain model")
        check(bool(torch.all((got - want).abs()
                             <= 1e-5 * want.abs() + 1e-5 * scale)),
              f"compare_segsum {name}: off index_add_ by {err}")
        emit({"phase": "compare_segsum", "case": name, "n": len(ids),
              "d": d, "rows": n_rows,
              "layout": ss.segsum_plan(len(ids), d).layout,
              "longest_segment": longest_run(order[1]),
              "max_abs_err": err, "max_abs_sum": float(want.abs().max()),
              "seconds": time.perf_counter() - t0, "ok": True})
    return worst


def bias_oracle(model, u_raw, i_raw):
    """float64 numpy predictions of a fitted ``BaselineModel`` from its
    biases: mu + the known sides' biases, clipped to the rating range."""
    import numpy as np

    uu = model.user_vocab.encode(np.asarray(u_raw, dtype=object))
    ii = model.item_vocab.encode(np.asarray(i_raw, dtype=object))
    bu = model.user_biases.astype(np.float64)
    bi = model.item_biases.astype(np.float64)
    pred = (float(model._params.global_mean) + np.where(uu >= 0, bu[uu], 0.0)
            + np.where(ii >= 0, bi[ii], 0.0))
    return np.clip(pred, model.min_rating, model.max_rating)


def bias_als_oracle(model, train, kw):
    """float64 numpy of the closed-form bias ALS that ``BaselineModel.fit``
    ran, from the raw ``train`` (u, i, r) encoded through the model's
    vocabularies: from zero biases, ``n_epochs`` sweeps of the user half
    (``np.bincount`` by user), then the item half with the fresh user
    biases; an id without ratings keeps its bias. Returns (user, item)
    biases."""
    import numpy as np

    u, i, r = train
    uu = model.user_vocab.encode(np.asarray(u, dtype=object))
    ii = model.item_vocab.encode(np.asarray(i, dtype=object))
    rr = np.asarray(r, np.float64)
    mu, reg = rr.mean(), kw["reg"]
    nu, ni = model.n_users, model.n_items
    cu = np.bincount(uu, minlength=nu).astype(np.float64)
    ci = np.bincount(ii, minlength=ni).astype(np.float64)
    bu, bi = np.zeros(nu), np.zeros(ni)
    for _ in range(kw["n_epochs"]):
        bu = np.where(cu > 0, np.bincount(uu, rr - mu - bi[ii], nu)
                      / (reg + cu), bu)
        bi = np.where(ci > 0, np.bincount(ii, rr - mu - bu[uu], ni)
                      / (reg + ci), bi)
    return bu, bi


def bias_sgd_oracle(torch, model, X, y, kw, seed):
    """float64 numpy of the bias SGD that ``BaselineModel.fit`` ran: the
    same pack, the same per-epoch permutations (redrawn from the fit's
    seeded generator on the card), every entry reading the pre-step biases
    and each side's deltas summed by id. Returns (user, item) biases."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u = model.user_vocab.encode(X["user_id"].to_numpy())
    i = model.item_vocab.encode(X["item_id"].to_numpy())
    data = sgd.pack_ratings(u, i, np.asarray(y, np.float32), kw["batch_size"],
                            device="cpu")
    uf, if_ = (t.reshape(-1).long().numpy() for t in (data.user_ids,
                                                       data.item_ids))
    rf, wf = (t.reshape(-1).double().numpy() for t in (data.ratings,
                                                        data.weights))
    n_pad = len(uf)
    nb = max(1, n_pad // kw["batch_size"])
    mu = float(model._params.global_mean)
    lr, reg = kw["lr"], kw["reg"]
    bu = np.zeros(model.n_users)
    bi = np.zeros(model.n_items)
    gen = sgd.seeded_generator(model._device, seed, 0)
    for _ in range(kw["n_epochs"]):
        perm = torch.randperm(n_pad, generator=gen,
                              device=gen.device).cpu().numpy()
        for uu, ii, rr, ww in zip(*(a[perm].reshape(nb, -1)
                                    for a in (uf, if_, rf, wf))):
            pu, pi = bu[uu], bi[ii]
            err = (rr - (mu + pu + pi)) * ww
            bu += np.bincount(uu, lr * (err - reg * ww * pu), len(bu))
            bi += np.bincount(ii, lr * (err - reg * ww * pi), len(bi))
    return bu, bi


def update_cohort(rng, u, n_items, per_user=100):
    """1,000 users, half of them known, ``per_user`` unique seeded items
    each: the ``update_users`` frame and its ratings."""
    import numpy as np
    import pandas as pd

    known = rng.choice(np.unique(u), 500, replace=False)
    new = np.arange(500) + 10_000_000
    uu = np.repeat(np.concatenate([known, new]), per_user)
    ii = rng.integers(0, n_items, len(uu))
    pairs = np.unique(uu.astype(np.int64) * n_items + ii)
    X = pd.DataFrame({"user_id": pairs // n_items, "item_id": pairs % n_items})
    return X, pd.Series(np.round(rng.uniform(0.5, 5, len(X)) * 2) / 2)


def phase_baseline(torch, rng, train, held, tmpdir, seed):
    """``BaselineModel`` at config 2, by ALS and by SGD, through ``fit``
    (ALS: its train RMSE below the global mean's and not rising, the
    biases against ``bias_als_oracle``, atol 1e-5; SGD: the biases
    against ``bias_sgd_oracle``, atol 1e-5: on ratings without
    signal, as ``run_configs._gen`` makes them, SGD at lr 0.02 settles at
    its noise floor in the first epoch, so its RMSE need not fall further)
    and ``update_users`` (1,000 users, half known; item biases bitwise
    unchanged), ``predict`` (the held-out pairs against float64 numpy of
    the fitted biases, atol 1e-5), ``recommend`` and ``recommend_batch``
    (256 users), the segment-sum count zeroed just before and read just
    after; then the fit repeated (bitwise equal biases) and a checkpoint
    round trip."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import BaselineModel, load_model, save_model
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    Xh = pd.DataFrame({"user_id": held[0], "item_id": held[1]})
    Xu, yu = update_cohort(rng, u, ML1M["n_items"])
    cohort = [int(x) for x in np.unique(u)[:256]]
    rmse_mean = float(np.sqrt(np.mean((r.astype(np.float64)
                                       - np.mean(r.astype(np.float64))) ** 2)))
    out = {"phase": "baseline", "n_ratings": len(r), "config": BASE,
           "global_mean_rmse": rmse_mean, "launches": {}}
    for method, kw in BASE.items():
        res = {}
        ss.reset_launches()
        t0 = time.perf_counter()
        model = BaselineModel(min_rating=0.5, max_rating=5.0, seed=seed,
                              **kw).fit(X, y)
        torch.cuda.synchronize()
        res["fit_seconds"] = time.perf_counter() - t0
        res["fit_launches"] = ss.launches
        hist = model.train_rmse
        check(len(hist) == kw["n_epochs"] and np.isfinite(hist).all(),
              f"baseline {method} RMSE {hist}")
        fitted = (model._params.user_biases.clone(),
                  model._params.item_biases.clone())
        t0 = time.perf_counter()
        if method == "als":
            # exact from its first sweep on: below the mean, then it stalls
            check(hist[-1] <= hist[0] < rmse_mean,
                  f"baseline als RMSE {hist} against {rmse_mean}")
            bu, bi = bias_als_oracle(model, train, kw)
        else:
            bu, bi = bias_sgd_oracle(torch, model, X, y, kw, seed)
        res["oracle_seconds"] = time.perf_counter() - t0
        res["oracle_max_abs_err"] = max(
            float(np.abs(model.user_biases - bu).max()),
            float(np.abs(model.item_biases - bi).max()))
        check(res["oracle_max_abs_err"] <= 1e-5,
              f"baseline {method} off its float64 oracle by "
              f"{res['oracle_max_abs_err']}")
        items = fitted[1]
        t0 = time.perf_counter()
        model.update_users(Xu, yu)
        torch.cuda.synchronize()
        res["update_users_seconds"] = time.perf_counter() - t0
        check(torch.equal(model._params.item_biases, items),
              f"baseline {method} update_users moved the item biases")
        check(model.n_users == len(np.unique(u)) + 500,
              f"baseline {method} update_users did not add the new users")
        t0 = time.perf_counter()
        preds = np.asarray(model.predict(Xh))
        res["predict_seconds"] = time.perf_counter() - t0
        want = bias_oracle(model, held[0], held[1])
        res["predict_max_abs_err"] = float(np.abs(preds - want).max())
        check(res["predict_max_abs_err"] <= 1e-5,
              f"baseline {method} predict off float64 by "
              f"{res['predict_max_abs_err']}")
        rec = model.recommend(cohort[0], amount=10)
        batch = model.recommend_batch(cohort, amount=10)
        check(len(rec) == 10 and len(batch) == 2560
              and list(batch["item_id"][:10]) == list(rec["item_id"]),
              f"baseline {method} recommend")
        scores = bias_oracle(model, [cohort[0]] * ML1M["n_items"],
                             model.item_vocab.raw_ids)
        check(np.allclose(np.sort(scores)[::-1][:10], rec["rating_pred"],
                          atol=1e-5), f"baseline {method} recommend scores")
        res["launches"] = ss.launches
        out["launches"][method] = ss.launches
        check(ss.launches > 0, f"baseline {method} launched no segment sum")
        res["train_rmse_first_last"] = [hist[0], hist[-1]]
        again = BaselineModel(min_rating=0.5, max_rating=5.0, seed=seed,
                              **kw).fit(X, y)
        check(torch.equal(again._params.user_biases, fitted[0])
              and torch.equal(again._params.item_biases, fitted[1]),
              f"baseline {method}: two fits differ")
        save_model(model, f"{tmpdir}/baseline_{method}")
        back = load_model(f"{tmpdir}/baseline_{method}")
        check(torch.equal(back._params.user_biases, model._params.user_biases)
              and back.predict(Xh.iloc[:100]) == model.predict(Xh.iloc[:100]),
              f"baseline {method}: the reloaded model differs")
        out[method] = res
        del model, again, back
    out["rmse_gap_als_sgd"] = abs(out["als"]["train_rmse_first_last"][1]
                                  - out["sgd"]["train_rmse_first_last"][1])
    return out


def cf_oracle(torch, model, train, pu, pi, k):
    """float64 predictions of a fitted CF model for dense pairs (pu, pi),
    both known, by the reference's neighbourhood formula
    (``tests/test_cf.py``): the top-``k`` raters by similarity, ties to the
    lower index. The rating matrix is built here from the raw ``train``
    (u, i, r) through the vocabularies and must equal the model's; the
    means over the filled matrix and the float64 similarity come from it.
    Returns (predictions from the model's f32 similarity rows, predictions
    from float64 similarity rows, the largest difference between the two
    similarities). On ratings without signal many similarities lie within
    f32 rounding of the k-th one, so the two precisions may pick different
    neighbours: only the first prediction is held to the formula."""
    import numpy as np

    u, i, r = train
    Rh = np.zeros((model.n_users, model.n_items))
    Rh[model.user_vocab.encode(np.asarray(u, dtype=object)),
       model.item_vocab.encode(np.asarray(i, dtype=object))] = r
    R = torch.from_numpy(Rh).to("cuda")
    check(torch.equal(model._state.ratings, R.float()),
          f"{type(model).__name__}: the rating matrix is not the raw ratings")
    if model._mode == "item":
        R, Rh = R.T, Rh.T
        q, c = pi, pu
    else:
        q, c = pu, pi
    means = R.mean(dim=1)
    cen = R - means[:, None]
    normed = cen / cen.norm(dim=1, keepdim=True).clamp(min=1e-12)
    qt = torch.from_numpy(q).to(R.device)
    S64 = (normed[qt] @ normed.T).cpu().numpy()
    S32 = model._state.sim[qt].double().cpu().numpy()
    m = means.cpu().numpy()

    def predict(S):
        out = np.empty(len(q))
        for j, (a, b) in enumerate(zip(q, c)):
            rated = Rh[:, b] > 0
            rated[a] = False
            s, r, mm = S[j][rated], Rh[rated, b], m[rated]
            top = np.argsort(-s, kind="stable")[:k]
            s, r, mm = s[top], r[top], mm[top]
            den = np.abs(s).sum()
            out[j] = m[a] if not len(s) or den == 0 else (
                m[a] + (s * (r - mm)).sum() / den)
        return out

    return predict(S32), predict(S64), float(np.abs(S64 - S32).max())


def phase_cf(torch, rng, train):
    """``UserUserCF`` and ``ItemItemCF`` (50 neighbours) on the config-2
    ratings: ``fit`` seconds, a second fit bitwise equal, ``predict`` of
    100,000 seeded pairs (seconds), 2,000 of them against the float64
    oracle of ``cf_oracle`` (the rating matrix equal to the raw ratings,
    the similarity within 1e-4 of float64, the predictions atol 6e-3,
    ``tests/test_cf.py``'s bar), ``recommend`` for one user."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import ItemItemCF, UserUserCF

    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    # dense ids of users and items that have ratings (``_gen`` keeps the
    # first 1M of the sorted unique pairs: the highest user ids have none)
    pu = rng.integers(0, len(np.unique(u)), CF_PREDICT)
    pi = rng.integers(0, len(np.unique(i)), CF_PREDICT)
    out = {"phase": "cf", "n_neighbors": CF_NEIGHBOURS, "pairs": CF_PREDICT}
    for cls in (UserUserCF, ItemItemCF):
        res = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = cls(n_neighbors=CF_NEIGHBOURS, min_rating=0.5,
                    max_rating=5.0).fit(X, y)
        torch.cuda.synchronize()
        res["fit_seconds"] = time.perf_counter() - t0
        raw_u = np.asarray(model.user_vocab.raw_ids)[pu]
        raw_i = np.asarray(model.item_vocab.raw_ids)[pi]
        pairs = pd.DataFrame({"user_id": raw_u, "item_id": raw_i})
        t0 = time.perf_counter()
        preds = np.asarray(model.predict(pairs, bound_ratings=False))
        res["predict_seconds"] = time.perf_counter() - t0
        res["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
        check(np.isfinite(preds).all(), f"{cls.__name__} predict")
        want, want64, sim_err = cf_oracle(torch, model, train, pu[:CF_ORACLE],
                                          pi[:CF_ORACLE], CF_NEIGHBOURS)
        err = np.abs(preds[:CF_ORACLE] - want)
        err64 = np.abs(preds[:CF_ORACLE] - want64)
        res.update({"oracle_max_abs_err": float(err.max()),
                    "oracle_median_abs_err": float(np.median(err)),
                    "sim_max_abs_err": sim_err,
                    "f64_sim_max_abs_err": float(err64.max()),
                    "f64_sim_pairs_over_6e-3": int((err64 > 6e-3).sum())})
        check(sim_err <= 1e-4, f"{cls.__name__} similarity off float64 by "
                               f"{sim_err}")
        check(err.max() <= 6e-3, f"{cls.__name__} off the float64 oracle by "
                                 f"{err.max()}")
        rec = model.recommend(int(u[0]), amount=10)
        check(len(rec) == 10 and np.isfinite(rec["rating_pred"]).all(),
              f"{cls.__name__} recommend")
        state = model._state
        again = cls(n_neighbors=CF_NEIGHBOURS, min_rating=0.5,
                    max_rating=5.0).fit(X, y)
        check(torch.equal(again._state.sim, state.sim)
              and torch.equal(again._state.means, state.means),
              f"{cls.__name__}: two fits differ")
        res["sim_shape"] = list(state.sim.shape)
        out[cls.__name__] = res
        del model, again, state
        torch.cuda.empty_cache()
    return out


def phase_content(torch, rng, train, held, seed):
    """``ContentBasedRecommender`` on the config-2 ratings, without
    features (user means) and with 18 seeded binary genre columns: the
    profiles against float64 numpy (atol 1e-5), both ``predict_mode``s on
    the held-out pairs against float64 numpy of the fitted profiles (atol
    1e-5); the segment-sum count zeroed just before the fits and read
    just after."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import ContentBasedRecommender
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    nu, ni = ML1M["n_users"], ML1M["n_items"]
    genres = np.random.default_rng(seed + 4).integers(
        0, 2, (ni, N_GENRES)).astype(np.float32)
    feats = pd.DataFrame(genres, columns=[f"g{j}" for j in range(N_GENRES)])
    feats.insert(0, "item_id", np.arange(ni))
    out = {"phase": "content", "genres": N_GENRES}
    ss.reset_launches()
    t0 = time.perf_counter()
    plain = ContentBasedRecommender(min_rating=0.5, max_rating=5.0).fit(X, y)
    models = {mode: ContentBasedRecommender(
        min_rating=0.5, max_rating=5.0, predict_mode=mode).fit(
            X, y, item_features=feats)
        for mode in ("profile_mean", "similarity")}
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    out["launches"] = ss.launches
    check(ss.launches > 0, "the content fits launched no segment sum")

    m = models["profile_mean"]
    uu = m.user_vocab.encode(np.asarray(u, dtype=object))
    ii = m.item_vocab.encode(np.asarray(i, dtype=object))
    rr = r.astype(np.float64)
    n_u = np.bincount(uu, minlength=m.n_users)
    mean = np.bincount(uu, weights=rr, minlength=m.n_users) / np.maximum(n_u, 1)
    F = np.zeros((m.n_items, N_GENRES))
    enc = m.item_vocab.encode(np.arange(ni).astype(object))
    F[enc[enc >= 0]] = genres[enc >= 0]
    w = rr - 0.5
    num = np.stack([np.bincount(uu, weights=w * F[ii, g], minlength=m.n_users)
                    for g in range(N_GENRES)], axis=1)
    den = np.bincount(uu, weights=w, minlength=m.n_users)
    prof = np.where(den[:, None] > 0, num / np.maximum(den[:, None], 1e-12), 0)
    errs = {"user_mean": float(np.abs(plain._profiles.cpu().numpy()
                                      - mean).max()),
            "profiles": float(np.abs(m._profiles.cpu().numpy() - prof).max())}
    hu = m.user_vocab.encode(np.asarray(held[0], dtype=object))
    hi = m.item_vocab.encode(np.asarray(held[1], dtype=object))
    ok = (hu >= 0) & (hi >= 0)
    gm = float(np.mean(r))
    p = prof[np.maximum(hu, 0)]
    want = {"profile_mean": p.mean(axis=1)}
    f = F[np.maximum(hi, 0)]
    cos = (p * f).sum(1) / np.maximum(np.linalg.norm(p, axis=1)
                                      * np.linalg.norm(f, axis=1), 1e-12)
    want["similarity"] = 0.5 + cos * 4.5
    Xh = pd.DataFrame({"user_id": held[0], "item_id": held[1]})
    for mode, model in models.items():
        got = np.asarray(model.predict(Xh, bound_ratings=False))
        errs[mode] = float(np.abs(got - np.where(ok, want[mode], gm)).max())
    out["max_abs_err"] = errs
    check(max(errs.values()) <= 1e-5, f"content off float64 numpy: {errs}")
    check(len(m.recommend(int(u[0]), amount=10)) == 10, "content recommend")
    del plain, models, m
    torch.cuda.empty_cache()
    return out


def sweep_inputs(seed):
    """Config 1's ratings and what its sweep trains on: the 90,000
    training and 10,000 held-out ratings as frames, the ``KernelMF``
    keywords, the encoded training (u, i, r), the pack (on the card, as
    ``grid_search_kernel_mf`` packs it), the id counts and the model's
    config."""
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    c = ML100K
    u, i, r = gen_ratings(c["n_users"], c["n_items"], c["n_ratings"], seed + 3)
    n = c["n_ratings"] - c["held_out"]
    kw = dict(n_factors=c["n_factors"], batch_size=c["batch_size"],
              kernel="linear", min_rating=0.5, max_rating=5.0)
    model = KernelMF(seed=seed, **kw)
    X = pd.DataFrame({"user_id": u[:n], "item_id": i[:n]})
    y = pd.Series(r[:n])
    uu, ii, rr = model._preprocess_fit(X, y)
    return {"X": X, "y": y,
            "Xv": pd.DataFrame({"user_id": u[n:], "item_id": i[n:]}),
            "yv": pd.Series(r[n:]), "kw": kw, "raw_u0": int(u[0]),
            "rr": rr, "data": sgd.pack_ratings(uu, ii, rr, c["batch_size"],
                                               order=model.epoch_order),
            "n_users": model.n_users, "n_items": model.n_items,
            "cfg": model._cfg()}


def phase_sweep(torch, sw, seed):
    """``grid_search_kernel_mf`` at config 1 (linear, k=100, bs 4,096, 20
    epochs, the default 3 x 3 grid) on 90,000 ratings with 10,000 held
    out (``sweep_inputs``): seconds and aggregate updates/s, the step and
    apply counts zeroed just before and read just after (9 x batches x 20
    each), ``recommend`` on the winner (scorer count > 0). Then the sweep
    again through ``sweep.grid_train`` (its best candidate bitwise the
    winner's tables), its best and worst candidates against ``sgd_train``
    run alone from the same tables and batch orders (atol 1e-5), and the
    best candidate's first epoch through the kernels against the plain
    step from the same tables and order (atol 1e-5)."""
    import numpy as np

    from matrix_factorization_tpu_torch import grid_search_kernel_mf
    from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd, sweep
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    c = ML100K
    n = len(sw["X"])
    out = {"phase": "sweep", "n_train": n, "held_out": c["held_out"],
           "epochs": c["epochs"], **sw["kw"]}
    cuda_sgd.reset_launches()
    cuda_scores.reset_launches()
    t0 = time.perf_counter()
    model, results = grid_search_kernel_mf(sw["X"], sw["y"], sw["Xv"],
                                           sw["yv"], n_epochs=c["epochs"],
                                           seed=seed, **sw["kw"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rec = model.recommend(sw["raw_u0"], amount=10)
    launches = {"sgd_step": cuda_sgd.step_launches,
                "segment_apply": cuda_sgd.apply_launches,
                "score_catalog": cuda_scores.launches}
    nb = -(-n // c["batch_size"])
    k = len(results)
    out.update({"seconds": secs, "candidates": k,
                "updates_per_s": k * c["epochs"] * n / secs,
                "launches": launches, "batches": nb,
                "best": results[0], "worst": results[-1]})
    check(k == 9 and all(np.isfinite(d["val_rmse"]) for d in results),
          f"sweep results {results}")
    check(launches["sgd_step"] == launches["segment_apply"]
          == k * nb * c["epochs"], f"sweep launches {launches}")
    check(launches["score_catalog"] > 0 and len(rec) == 10,
          "the winner's recommend did not launch the scorer")

    # the same sweep through grid_train: the winner's tables, bitwise
    cfg, data, rr = model._cfg(), sw["data"], sw["rr"]
    check(cfg == dataclasses.replace(sw["cfg"], lr=model.lr, reg=model.reg)
          and (model.n_users, model.n_items) == (sw["n_users"], sw["n_items"]),
          "the sweep's model is not configured as its inputs")
    lrs = [d["lr"] for d in results]
    regs = [d["reg"] for d in results]
    t0 = time.perf_counter()
    params_k, _ = sweep.grid_train(data, model.n_users, model.n_items, cfg,
                                   c["epochs"], lrs, regs, float(rr.mean()),
                                   seed=seed)
    torch.cuda.synchronize()
    out["grid_train_seconds"] = time.perf_counter() - t0
    check(torch.equal(params_k.user_features[0], model._params.user_features)
          and torch.equal(params_k.item_features[0],
                          model._params.item_features),
          "two sweeps differ: the winner's tables are not bitwise equal")
    init = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           model.n_users, model.n_items, cfg, float(rr.mean()))
    gen = sgd.seeded_generator("cpu", seed, 1)
    orders = [torch.randperm(nb, generator=gen) for _ in range(c["epochs"])]
    errs = {}
    for name, j in (("best", 0), ("worst", k - 1)):
        alone, _ = sgd.sgd_train(init, data, None, cfg, c["epochs"], lrs[j],
                                 batch_orders=orders, reg=regs[j])
        errs[name] = max(float((alone.user_features
                                - params_k.user_features[j]).abs().max()),
                         float((alone.item_features
                                - params_k.item_features[j]).abs().max()))
    out["alone_max_abs_err"] = errs
    check(max(errs.values()) <= 1e-5, f"sweep candidates off sgd_train: {errs}")

    # the best candidate's first epoch: the kernels against the plain step
    pk = clone_params(init)
    sgd.epoch(pk, data, cfg, lrs[0], order=orders[0], reg=regs[0])
    pp = clone_params(init)
    plain_epoch(pp, data, dataclasses.replace(cfg, lr=lrs[0], reg=regs[0]),
                orders[0])
    torch.cuda.synchronize()
    err = max(float((pk.user_features - pp.user_features).abs().max()),
              float((pk.item_features - pp.item_features).abs().max()))
    out["epoch_vs_plain_max_abs_err"] = err
    check(torch.allclose(pk.user_features, pp.user_features, atol=1e-5,
                         rtol=1e-5)
          and torch.allclose(pk.item_features, pp.item_features, atol=1e-5,
                             rtol=1e-5),
          f"a sweep epoch through the kernels differs from the plain epoch "
          f"by {err}")
    return out


def segsum_bound(ids_sorted, n, d):
    """(bound_ms, bound_by): ids and perm read once (8 B an entry), vals
    once (4 d B an entry), each touched row of out read and written once;
    one f32 add an entry and column at 67 TFLOP/s."""
    rows = int(ids_sorted.unique_consecutive().numel())
    nbytes = n * (8 + 4 * d) + 2 * rows * 4 * d
    tb, to = nbytes / HBM_BYTES_PER_S, n * d / PEAK_FLOPS["float32"]
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def phase_segsum_kernel_times(torch, rng, train, timer):
    """Kernel, plain (``index_add_`` of the permuted rows) and library (one
    ``index_add_`` of the unsorted stream, a float-atomic scatter the port
    never calls) times of the segment sum at the slice's shapes, by CUDA
    events around the call with the L2 flushed (``Timer.ms``, as every
    other kernel row), and their bounds."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    rows = []
    for name, ids, n_rows, d in segsum_cases(train, rng):
        ids_t = torch.from_numpy(np.asarray(ids, np.int32)).to("cuda")
        ids_l = ids_t.long()
        vals = torch.from_numpy(rng.standard_normal(
            (len(ids), d), dtype=np.float32)).to("cuda")
        order = ss.sorted_order(ids_t)
        out = torch.zeros((n_rows, d), device="cuda")
        b_ms, b_by = segsum_bound(order[1], len(ids), d)
        calls = {"": lambda: ss.cuda_segment_sum(out, vals, *order),
                 "plain_": lambda: ss.plain_segment_sum(out, vals, *order),
                 "library_": lambda: out.index_add_(0, ids_l, vals)}
        row = {"shape": name, "n": len(ids), "d": d, "rows": n_rows,
               "bound_ms": b_ms, "bound_by": b_by}
        for key, fn in calls.items():
            row[f"{key}ms"] = timer.ms(fn)
        rows.append(row)
        emit({"phase": "segsum_kernel_time", **row})
    return rows


# ---------------------------------------------------------------------------
# The native host library, the sparse-gram top-k CF (config 4) and EASE
# ---------------------------------------------------------------------------

# BASELINE.json config 4 (benchmarks/run_configs.py:221-286): item-item and
# user-user centered-cosine top-k CF on the config-3 ratings
CF4 = {"n_neighbors": 50, "block": 4096, "predict_pairs": 1_000_000,
       "oracle_columns": 64, "oracle_pairs": 4096}
# EASE at MovieLens-1M shape (the config-2 ratings as implicit feedback,
# the JAX model's default lam) and at the item budget, as
# benchmarks/ease_bench.py::run_combo makes it
EASE_ML1M = {"reg": 250.0, "users": 256, "k": 10}
EASE_BUDGET = {"n_users": 100_000, "n_items": 16_384, "per_user": 100,
               "reg": 100.0, "oracle_columns": 256}


def timed(torch, fn):
    """(result, wall seconds) of ``fn()`` ending in a device synchronise."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_host_native(torch, data3, tmpdir, seed):
    """The host library's build; ``load_ratings_csv`` on a 1M-row CSV of the
    config-2 ratings, native against pandas; the config-3 SGD pack
    (``order='auto'``, bs 2,097,152) and the config-3 ALS bucket packs,
    native against numpy: every array equal, seconds for each."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch.data import loader
    from matrix_factorization_tpu_torch.ops import _build, ials
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    out = {"phase": "host_native", "threads": loader.native_threads()}
    out["build_seconds"] = _build.build(["host_loader"])
    loader.host_lib()

    (u, i, r), _ = ml1m_ratings(seed)
    path = Path(tmpdir) / "ratings.csv"
    pd.DataFrame({"userId": u, "movieId": i, "rating": r}).to_csv(path, index=False)
    loads = {}
    for backend in ("native", "pandas"):
        t0 = time.perf_counter()
        loads[backend] = loader.load_ratings_csv(path, force_backend=backend)
        out[f"csv_{backend}_seconds"] = time.perf_counter() - t0
    nat, pdl = loads["native"], loads["pandas"]
    check(nat.backend == "native" and pdl.backend == "pandas", "csv backends")
    check(all(np.array_equal(getattr(nat, f), getattr(pdl, f))
              for f in ("user_ids", "item_ids", "ratings", "user_uniques",
                        "item_uniques")), "native and pandas CSV loads differ")
    check(np.array_equal(nat.user_uniques[nat.user_ids], u)
          and np.array_equal(nat.ratings, r), "the CSV load lost ratings")
    out["csv_rows"] = len(r)

    u3, i3, r3 = data3[:3]
    bs = CONFIG3["sigmoid"]["batch_size"]
    packs = {}
    for native in (True, False):
        packs[native], out[f"pack_{'native' if native else 'numpy'}_seconds"] = timed(
            torch, lambda: sgd.pack_ratings(u3, i3, r3, bs, order="auto",
                                            device="cuda", native=native))
    fields = ("user_ids", "item_ids", "ratings", "weights", "sec_perm",
              "sec_ids_sorted")
    check(all(torch.equal(getattr(packs[True], f), getattr(packs[False], f))
              for f in fields) and packs[True].primary == packs[False].primary,
          "the native config-3 pack differs from numpy's")
    out["pack_primary"] = packs[True].primary
    packs.clear()
    torch.cuda.empty_cache()

    buckets = {}
    for native in (True, False):
        buckets[native], out[f"als_pack_{'native' if native else 'numpy'}_seconds"] = timed(
            torch, lambda: ials.group_both_sides_bucketed(
                u3, i3, r3, N_USERS, N_ITEMS, device="cuda", native=native))
    same = all(
        len(a) == len(b) and all(torch.equal(s, t) for x, y in zip(a, b)
                                 for s, t in zip(x, y))
        for a, b in zip(buckets[True], buckets[False]))
    check(same, "the native config-3 ALS packs differ from numpy's")
    out["als_chunks"] = [len(side) for side in buckets[True]]
    buckets.clear()
    torch.cuda.empty_cache()
    return out


def cosine_columns_f64(u, i, r, n_rows, n_cols, cols):
    """float64 centered cosine of columns ``cols`` against every column of
    the (n_rows, n_cols) sparse ratings (scipy.sparse), self pairs -inf:
    (len(cols), n_cols)."""
    import numpy as np
    import scipy.sparse as sp

    R = sp.csc_matrix((r.astype(np.float64), (u, i)), shape=(n_rows, n_cols))
    m = np.asarray(R.sum(axis=0)).ravel() / n_rows
    sq = np.asarray(R.multiply(R).sum(axis=0)).ravel()
    norms = np.sqrt(np.maximum(sq - n_rows * m * m, 0.0))
    G = (R.T @ R[:, cols]).toarray().T  # (len(cols), n_cols)
    C = G - n_rows * m[cols][:, None] * m[None, :]
    S = C / np.maximum(np.outer(norms[cols], norms), 1e-12)
    S[np.arange(len(cols)), cols] = -np.inf
    return S


def hold_topk(sims, ids, S, tol):
    """(max |value error|, ids checked, ids wrong) of top-k lists against
    the float64 rows ``S``: values sorted as the oracle's; an id counts
    where its oracle value is more than ``tol`` from its neighbours'."""
    import numpy as np

    k = sims.shape[1]
    order = np.argsort(-S, axis=1, kind="stable")[:, :k + 1]
    want = np.take_along_axis(S, order, axis=1)
    err = float(np.abs(sims - want[:, :k]).max())
    gaps = np.abs(np.diff(want, axis=1)) > tol  # gap after position t
    sep = gaps[:, :k].copy()
    sep[:, 1:] &= gaps[:, :k - 1]
    checked = int(sep.sum())
    wrong = int((ids[sep] != order[:, :k][sep]).sum())
    return err, checked, wrong


def strip_split(torch, rows, cols, r, n_rows, n_cols, k, block):
    """One strip of ``similarity_topk`` timed by its parts: the host sort
    and the device windows, the accumulation (tile builds + exact f32
    GEMMs), the centered cosine with its top-k, and ``stable_topk``
    alone, with the strip count and the GEMMs' operations."""
    from matrix_factorization_tpu_torch.ops import sparse_gram as sg
    from matrix_factorization_tpu_torch.ops.scoring import stable_topk
    from matrix_factorization_tpu_torch.ops.segment_sgd import round_up

    pad = round_up(n_cols, block)
    (ub, ib, rb, counts), t_bucket = timed(
        torch, lambda: sg._bucket_by_block(rows, cols, r, n_rows, block, "cuda"))
    acc, t_acc = timed(torch, lambda: sg._strip_accumulate(
        ub, ib, rb, counts, 0, block, block, pad))
    ones = torch.ones(pad, device="cuda")
    _, t_topk = timed(torch, lambda: sg._strip_topk(
        acc, torch.arange(block, device="cuda"), ones, n_rows, ones, k, n_cols))
    del acc
    x = torch.rand((block, pad), device="cuda")
    _, t_sort = timed(torch, lambda: stable_topk(x, k))
    del x, ub, ib, rb
    torch.cuda.empty_cache()
    n_strips = -(-n_cols // block)
    flops = 2.0 * block * block * pad * int((counts > 0).sum())
    return {"strips": n_strips, "bucket_seconds": t_bucket,
            "accumulate_seconds_per_strip": t_acc,
            "topk_seconds_per_strip": t_topk, "sort_seconds_per_strip": t_sort,
            "accumulate_tflops": flops / t_acc / 1e12,
            "accumulate_seconds": t_acc * n_strips,
            "topk_seconds": t_topk * n_strips}


def phase_cf_topk(torch, rng, data3):
    """``TopKItemItemCF`` at BASELINE config 4 (162,000 x 59,392, the 25M
    config-3 ratings, 50 neighbours): ``fit`` seconds and peak memory, one
    strip split into its parts, a bulk ``predict`` of 1M seeded pairs, 64
    sampled columns against a float64 scipy.sparse centered cosine (values
    within 1e-5, ids where separated by more than 1e-5), 4,096 predictions
    against a float64 replay of the formula on the fitted lists (1e-4);
    then user-user ``similarity_topk(i, u, r, ...)`` once, timed, and its
    strip split."""
    import numpy as np
    import pandas as pd
    import scipy.sparse as sp

    from matrix_factorization_tpu_torch import TopKItemItemCF
    from matrix_factorization_tpu_torch.ops import sparse_gram as sg

    u, i, r = data3[:3]
    k = CF4["n_neighbors"]
    out = {"phase": "cf_topk", "n_users": N_USERS, "n_items": N_ITEMS,
           "n_ratings": len(r), "n_neighbors": k}
    X = pd.DataFrame({"user_id": u, "item_id": i})
    torch.cuda.reset_peak_memory_stats()
    model, out["item_fit_seconds"] = timed(torch, lambda: TopKItemItemCF(
        n_neighbors=k, min_rating=0.5, max_rating=5.0).fit(X, pd.Series(r)))
    out["item_fit_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    del X
    # dense ids; users without ratings (the top of config 3's id range, as
    # ``_gen`` keeps the lowest of the sorted unique pairs) are not in them
    n_u, n_i = model.n_users, model.n_items
    out["users_rated"] = n_u
    ud = model.user_vocab.encode(u)
    idd = model.item_vocab.encode(i)
    out["item_split"] = strip_split(torch, ud, idd, r, n_u, n_i, k, CF4["block"])

    n = CF4["predict_pairs"]
    qu = rng.integers(0, n_u, n).astype(np.int32)
    qi = rng.integers(0, n_i, n).astype(np.int32)
    model._predict_arrays(qu[:1024], qi[:1024], True)
    (preds, possible), dt = timed(torch, lambda: model._predict_arrays(qu, qi, True))
    check(np.isfinite(preds).all() and possible.all(), "config-4 bulk predict")
    out.update({"predict_pairs": n, "predict_seconds": dt,
                "predict_pairs_per_s": n / dt})

    sims = model._neighbor_sims.cpu().numpy()
    ids = model._neighbor_ids.cpu().numpy()
    cols = np.sort(rng.choice(n_i, CF4["oracle_columns"], replace=False))
    S = cosine_columns_f64(ud, idd, r, n_u, n_i, cols)
    err, checked, wrong = hold_topk(sims[cols], ids[cols], S, 1e-5)
    out.update({"columns_max_abs_err": err, "columns_ids_checked": checked,
                "columns_ids_wrong": wrong})
    check(err <= 1e-5, f"config-4 top-k values off float64 by {err}")
    check(wrong == 0 and checked > 0, f"config-4 top-k ids: {wrong} of "
                                      f"{checked} separated ids differ")

    m = CF4["oracle_pairs"]
    R = sp.csr_matrix((r.astype(np.float64), (ud, idd)), shape=(n_u, n_i))
    means = model._means.cpu().numpy().astype(np.float64)
    nb = ids[qi[:m]]
    s = sims[qi[:m]].astype(np.float64)
    rated = np.asarray(R[np.repeat(qu[:m], k), nb.ravel()]).reshape(m, k)
    found = rated > 0
    num = np.where(found, s * (rated - means[nb]), 0.0).sum(1)
    den = np.where(found, np.abs(s), 0.0).sum(1)
    base = means[qi[:m]]
    want = np.clip(np.where(den > 0, base + num / np.maximum(den, 1e-12), base),
                   0.5, 5.0)
    perr = float(np.abs(preds[:m] - want).max())
    out.update({"predict_max_abs_err": perr, "predict_neighbours_found": int(found.sum())})
    check(perr <= 1e-4, f"config-4 predictions off the float64 replay by {perr}")
    del model, R, S
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    (usims, uids, _, _), out["user_seconds"] = timed(
        torch, lambda: sg.similarity_topk(i, u, r, N_ITEMS, N_USERS, k=k,
                                          device="cuda"))
    out["user_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    check(usims.shape == (N_USERS, k) and np.isfinite(usims).all()
          and (uids >= 0).all() and (uids < N_USERS).all(), "user-user top-k")
    ucols = np.sort(rng.choice(N_USERS, 16, replace=False))
    uerr, uchecked, uwrong = hold_topk(
        usims[ucols], uids[ucols], cosine_columns_f64(i, u, r, N_ITEMS, N_USERS, ucols),
        1e-5)
    out.update({"user_columns_max_abs_err": uerr, "user_columns_ids_checked": uchecked,
                "user_columns_ids_wrong": uwrong})
    check(uerr <= 1e-5 and uwrong == 0, f"user-user top-k off float64: {uerr}, "
                                        f"{uwrong} ids")
    out["user_split"] = strip_split(torch, i, u, r, N_ITEMS, N_USERS, k, CF4["block"])
    return out


class LeafRecorder:
    """Wraps ``cuda_spd.gj_inverse`` (the leaf the Schur recursion calls)
    to keep every input it is handed, by leaf width, for holding the
    kernel to its plain version and timing it at the path's own inputs;
    the launches are counted by the wrapper."""

    def __init__(self):
        from matrix_factorization_tpu_torch.ops import cuda_spd

        self.cuda_spd = cuda_spd
        self.inputs = {}

    def __enter__(self):
        self.orig = self.cuda_spd.gj_inverse

        def record(A):
            self.inputs.setdefault(A.shape[-1], []).append(A.clone())
            return self.orig(A)

        self.cuda_spd.gj_inverse = record
        return self

    def __exit__(self, *exc):
        self.cuda_spd.gj_inverse = self.orig


def ease_f64(u, i, n_users, n_items, lam):
    """float64 dense EASE: (X, B) with B = -P / diag(P), zero diagonal."""
    import numpy as np

    X = np.zeros((n_users, n_items))
    X[u, i] = 1.0
    P = np.linalg.inv(X.T @ X + lam * np.eye(n_items))
    B = -P / np.diag(P)[None, :]
    np.fill_diagonal(B, 0.0)
    return X, B


def phase_ease(torch, rng, train, tmpdir, seed):
    """EASE at MovieLens-1M shape (the config-2 ratings as implicit
    feedback, lam 250): ``fit`` with the GJ count zeroed just before and
    read just after, ``B`` against float64 numpy EASE (atol 1e-4), the
    top-10 of 256 users against the float64 top-10 where separated by
    more than 1e-5, a checkpoint round trip; then at the item budget
    (16,384 items, 100,000 users x 100 interactions) ``item_gram`` and
    ``ease_weights`` timed apart with peak memory, held by the closed
    form's identity ``(G + lam I)(I - B) = diag(1 / diag P)`` on 256
    columns. Returns (out, GJ launches, the recorded leaf inputs)."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import EASE, load_model, save_model
    from matrix_factorization_tpu_torch.ops import cuda_spd
    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from matrix_factorization_tpu_torch.ops.spd import exact_f32

    u, i, r = train
    lam = EASE_ML1M["reg"]
    out = {"phase": "ease", "ml1m": {"n_users": ML1M["n_users"],
                                     "n_items": ML1M["n_items"], "reg": lam}}
    res = out["ml1m"]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    torch.cuda.reset_peak_memory_stats()
    cuda_spd.reset_launches()
    with LeafRecorder() as rec_ml1m:
        model, res["fit_seconds"] = timed(
            torch, lambda: EASE(reg=lam).fit(X, pd.Series(r)))
    launches = {"ml1m": cuda_spd.launches}
    check(launches["ml1m"] > 0, "EASE fit did not launch the GJ leaf")
    res["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    res["leaf_d"] = sorted(rec_ml1m.inputs)
    ud = model.user_vocab.encode(u)
    idd = model.item_vocab.encode(i)
    Xd, B_ref = ease_f64(ud, idd, model.n_users, model.n_items, lam)
    n_i = model.n_items
    B = model._params.item_weights.cpu().numpy()
    res["B_max_abs_err"] = float(np.abs(B[:n_i, :n_i] - B_ref).max())
    check(res["B_max_abs_err"] <= 1e-4, f"EASE B off float64 by {res['B_max_abs_err']}")
    users = np.sort(rng.choice(model.n_users, EASE_ML1M["users"], replace=False))
    vals, idx = model._catalog_topk(users, EASE_ML1M["k"])
    S = Xd[users] @ B_ref
    err, checked, wrong = hold_topk(vals, idx, S, 1e-5)
    res.update({"top10_max_abs_err": err, "top10_ids_checked": checked,
                "top10_ids_wrong": wrong})
    check(err <= 1e-4 and wrong == 0 and checked > 0,
          f"EASE top-10 off float64: {err}, {wrong} of {checked} ids")
    save_model(model, f"{tmpdir}/ease")
    back = load_model(f"{tmpdir}/ease")
    raw = list(model.user_vocab.raw_ids[:8])
    check(torch.equal(back._params.item_weights, model._params.item_weights)
          and back.recommend_batch(raw, amount=10).equals(
              model.recommend_batch(raw, amount=10)),
          "the reloaded EASE model differs")
    del model, back, Xd, B_ref
    torch.cuda.empty_cache()

    cfg = EASE_BUDGET
    res = out["budget"] = dict(cfg)
    gen = np.random.default_rng(seed)
    n = cfg["n_users"] * cfg["per_user"]
    bu = np.repeat(np.arange(cfg["n_users"], dtype=np.int64), cfg["per_user"])
    bi = gen.integers(0, cfg["n_items"], n).astype(np.int64)
    w = np.ones(n, np.float32)
    torch.cuda.reset_peak_memory_stats()
    G, res["gram_seconds"] = timed(torch, lambda: ease_ops.item_gram(
        bu, bi, w, cfg["n_users"], cfg["n_items"], device="cuda"))
    res["gram_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    cuda_spd.reset_launches()
    with LeafRecorder() as rec_budget:
        Bt, res["inverse_seconds"] = timed(
            torch, lambda: ease_ops.ease_weights(G, cfg["reg"]))
    launches["budget"] = cuda_spd.launches
    check(launches["budget"] > 0, "EASE at the budget did not launch the GJ leaf")
    res["inverse_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    res["leaf_d"] = sorted(rec_budget.inputs)
    check(bool(torch.isfinite(Bt).all()) and not Bt.diagonal().any(), "EASE B at 16k")
    cols = torch.from_numpy(np.sort(gen.choice(cfg["n_items"], cfg["oracle_columns"],
                                               replace=False))).to("cuda")
    A = G.clone()
    A.diagonal().add_(cfg["reg"])
    IB = -Bt[:, cols]
    IB[cols, torch.arange(len(cols), device="cuda")] += 1.0
    with exact_f32():
        M = A @ IB  # = diag(1 / diag P) on the sampled columns
    diag = M[cols, torch.arange(len(cols), device="cuda")].clone()
    M[cols, torch.arange(len(cols), device="cuda")] = 0.0
    res["identity_rel_err"] = float(M.abs().max() / diag.abs().min())
    check(res["identity_rel_err"] <= 1e-3 and bool((diag > 0).all()),
          f"EASE at 16k: (G + lam I)(I - B) off diagonal by {res['identity_rel_err']}")
    del G, Bt, A, IB, M
    torch.cuda.empty_cache()
    out["launches"] = launches
    leaves = {"ease_ml1m": rec_ml1m.inputs, "ease_budget": rec_budget.inputs}
    return out, launches, leaves


def phase_ease_leaf_times(torch, leaves, timer):
    """The GJ leaf at every input EASE's Schur recursion handed it: the
    kernel against its plain version (atol = rtol = 1e-4, as compare_spd)
    and both against the float64 inverse; then the kernel, plain and
    library (``torch.linalg.inv``) times and bounds on the first input
    of each width. Returns (rows, the largest kernel-vs-plain error)."""
    from matrix_factorization_tpu_torch.ops import cuda_spd

    rows, worst = [], 0.0
    for path, inputs in leaves.items():
        for d, batch in sorted(inputs.items()):
            err = eye_err = plain_eye_err = vs_f64 = 0.0
            for n, A in enumerate(batch):
                got = cuda_spd.cuda_gj_inverse(A)
                want = cuda_spd.plain_gj_inverse(A)
                A64 = A.double()
                eye = torch.eye(d, dtype=torch.float64, device="cuda")
                e = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got, want, atol=1e-4, rtol=1e-4)
                check(ok, f"EASE leaf {path} d={d} #{n}: kernel differs from "
                          f"plain by {e}")
                err = max(err, e)
                eye_err = max(eye_err, float((A64 @ got.double() - eye).abs().max()))
                plain_eye_err = max(plain_eye_err,
                                    float((A64 @ want.double() - eye).abs().max()))
                vs_f64 = max(vs_f64, float(
                    (got.double() - torch.linalg.inv(A64)).abs().max()))
            check(eye_err < 5e-3 and plain_eye_err < 5e-3,
                  f"EASE leaf {path} d={d}: |A X - I| too large "
                  f"({eye_err}, plain {plain_eye_err})")
            A = batch[0]
            E = A.shape[0]
            b_ms, b_by = spd_bound(E, d)
            row = {"path": path, "E": E, "d": d, "leaves": len(batch),
                   "max_abs_err": err, "kernel_eye_err": eye_err,
                   "plain_eye_err": plain_eye_err, "kernel_vs_f64": vs_f64,
                   "ms": timer.ms(lambda: cuda_spd.cuda_gj_inverse(A)),
                   "plain_ms": timer.ms(lambda: cuda_spd.plain_gj_inverse(A)),
                   "library_ms": timer.ms(lambda: torch.linalg.inv(A)),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            emit({"phase": "spd_kernel_time", **row})
            worst = max(worst, err)
    return rows, worst


# ---------------------------------------------------------------------------
# The remaining model families: BPR, SVD++, NMF (every training scatter on
# the segment-sum kernels, serving on the scorer) and Popularity
# ---------------------------------------------------------------------------

# The MovieLens-25M shape the JAX package benches these families at
# (benchmarks/bpr_bench.py:146-151, nmf_bench.py:81-86,
# svdpp_bench.py:171-176): k = 64 (Kp 128), bs 1,048,576; 3 epochs here, on
# the config-3 ratings; each family's lr and reg as its bench sets them
# (BPR: its model's defaults, as bpr_bench)
FAM = {"n_factors": 64, "batch_size": 1_048_576, "epochs": 3}
FAM_KW = {"BPR": {},
          "SVDpp": {"lr": 0.005, "reg": 0.02, "min_rating": 0.5,
                    "max_rating": 5.0},
          "NMF": {"reg": 0.05, "min_rating": 0.5, "max_rating": 5.0}}
FAM_TOL = {"BPR": 1e-4, "SVDpp": 2e-4, "NMF": 1e-4}  # one epoch, kernel vs plain


def plain_scatters(fn):
    """``fn()`` with ``cuda_sgd.segment_apply`` and ``segment_sum.segment_sum``
    routed to their plain versions (``index_add_``) for the call."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    saved = cuda_sgd.segment_apply, ss.segment_sum
    cuda_sgd.segment_apply = cuda_sgd.plain_segment_apply
    ss.segment_sum = lambda out, *a: (ss.plain_segment_sum(out, *a), out)[1]
    try:
        return fn()
    finally:
        cuda_sgd.segment_apply, ss.segment_sum = saved


def family_epoch_fn(torch, family, pack, seed, n_users, n_items, ids):
    """(run, tables): ``run(n_epochs, draws)`` trains ``family`` on ``pack``
    from seeded tables and returns its output tables; ``draws`` True hands
    in one batch order and negatives made once from ``seed`` (the same
    every call), False draws them from a seeded generator. ``ids`` is the
    (users, items) of the ratings, for the counts and weights."""
    import numpy as np

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import bpr, nmf, svdpp
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    kw = FAM_KW[family]
    cfg = SGDConfig(kernel="linear", n_factors=FAM["n_factors"],
                    lr=kw.get("lr", 0.05), reg=kw.get("reg", 0.002),
                    min_rating=0.5, max_rating=5.0,
                    compute_epoch_rmse=False)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    order = [rng.permutation(pack.n_batches)]
    if family == "NMF":
        p0 = nmf.init_nmf_params(gen, n_users, n_items, cfg)
        cnt = [torch.from_numpy(np.bincount(ids_, minlength=t.shape[0]).astype(
            np.float32)).cuda() for ids_, t in ((ids[0], p0.user_features),
                                                (ids[1], p0.item_features))]

        def run(n_epochs, draws):
            out, _ = nmf.nmf_train(p0, pack, *cnt, cfg, n_epochs, cfg.reg,
                                   cfg.reg)
            return out.user_features, out.item_features
        return run, cfg
    if family == "BPR":
        p0 = sgd.init_params(gen, n_users, n_items, cfg, 0.0)
        negs = [torch.randint(0, n_items, (pack.n_batches, pack.batch_size),
                              generator=gen, device="cuda", dtype=torch.int32)]

        def run(n_epochs, draws):
            out, hist = bpr.bpr_train_tiled(
                p0, pack, sgd.seeded_generator("cuda", seed, 9), cfg, n_epochs,
                0.05, n_items, batch_orders=order if draws else None,
                negatives=negs if draws else None)
            return out.user_features, out.item_features
        return run, cfg
    p0 = svdpp.init_params(gen, n_users, n_items, cfg, 2.75)
    Y = torch.zeros_like(p0.implicit_features)
    Y[:, :cfg.n_factors] = 0.05 * torch.randn(
        (Y.shape[0], cfg.n_factors), generator=gen, device="cuda")
    p0 = p0._replace(implicit_features=Y)
    wvec = torch.from_numpy(svdpp._neighbor_weights(
        ids[0], n_users, p0.user_features.shape[0])).cuda()
    deg = torch.from_numpy(np.bincount(ids[1], minlength=Y.shape[0]).astype(
        np.float32)).cuda()

    def run(n_epochs, draws):
        out, _ = svdpp.svdpp_train_batched(
            p0, pack, wvec, deg, sgd.seeded_generator("cuda", seed, 9), cfg,
            n_epochs, cfg.lr, cfg.reg, batch_orders=order if draws else None)
        return (out.user_features, out.item_features, out.implicit_features,
                out.user_implicit_sums)
    return run, cfg


def family_serving_check(torch, model, family, held, rng, users_pool):
    """``predict`` on the held-out pairs against a float64 numpy replay of
    the served formula; ``recommend`` and a 256-user ``recommend_batch``
    launch the scorer, top-10 sets equal to the plain scorer's (rows
    without a near-tie at the cut)."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch.ops import cuda_scores
    from matrix_factorization_tpu_torch.ops.scoring import stable_topk

    out = {}
    hu, hi = held
    preds = np.asarray(model.predict(pd.DataFrame({"user_id": hu,
                                                   "item_id": hi})))
    possible = np.asarray(model.predictions_possible)
    serve = (model._cached_serving_params(model._mf_view) if family == "SVDpp"
             else model._cached_serving_params())
    ud = model.user_vocab.encode(hu)[possible]
    idd = model.item_vocab.encode(hi)[possible]
    P = serve.user_features.cpu().numpy().astype(np.float64)
    Q = serve.item_features.cpu().numpy().astype(np.float64)
    ref = float(serve.global_mean) + (P[ud] * Q[idd]).sum(1)
    if family != "BPR":
        ref = np.clip(ref, model.min_rating, model.max_rating)
    err = float(np.abs(preds[possible] - ref).max())
    check(np.isfinite(preds).all() and possible.sum() > len(hu) // 2,
          f"{family} held-out predict")
    check(err <= 1e-4, f"{family} predict differs from the float64 replay by {err}")
    if family == "NMF":
        fb = float(np.clip(model.global_mean, model.min_rating,
                           model.max_rating))
        check(bool((preds[~possible] == np.float32(fb)).all()),
              "NMF cold pairs do not predict the global mean")
    out.update(predict_max_abs_err=err, predict_possible=int(possible.sum()))
    users = [int(x) for x in rng.choice(users_pool, 256, replace=False)]
    n0 = cuda_scores.launches
    rec = model.recommend(users[0], amount=10)
    check(cuda_scores.launches > n0 and len(rec) == 10,
          f"{family} recommend did not launch the scorer")
    n0 = cuda_scores.launches
    batch = model.recommend_batch(users, amount=10)
    check(cuda_scores.launches > n0 and len(batch) == 2560,
          f"{family} recommend_batch did not launch the scorer")
    out["score_launches"] = cuda_scores.launches
    dense = torch.as_tensor(model.user_vocab.encode(np.asarray(users)),
                            device="cuda")
    plain = cuda_scores.plain_score_catalog(
        model._cfg(), serve.global_mean, serve.user_features[dense],
        serve.item_features[:model.n_items])
    pv, pi = (t.cpu().numpy() for t in stable_topk(plain, 11))
    raw = np.asarray(model.item_vocab.raw_ids)
    compared = 0
    for row, usr in enumerate(users):
        if pv[row, 9] - pv[row, 10] >= 1e-4:
            compared += 1
            got = set(batch.item_id.iloc[10 * row:10 * row + 10])
            check(got == set(raw[pi[row, :10]]),
                  f"{family} top-10 of user {usr} differs from plain")
    check(compared >= 64, f"{family}: too few rows without a near-tie")
    out["topk_rows_compared"] = compared
    return out


def phase_family(torch, rng, family, data3, pack, pack_seconds, tmpdir, seed):
    """One family at the MovieLens-25M shape: one epoch through the kernels
    against the same epoch through the plain versions on the card (the
    kernel epoch twice, bitwise); a device epoch's updates/s on the pack
    made once; then the main path, with the apply, segment-sum and scorer
    counts zeroed just before and read just after: ``fit``,
    ``update_users`` (1,000 users, half known), ``predict``, ``recommend``
    and ``recommend_batch``; then a checkpoint round trip."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as mf
    from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    u, i, r, hu, hi = data3
    out = {"phase": family.lower(), "n_ratings": len(r), **FAM,
           "pack_seconds": pack_seconds, "n_batches": pack.n_batches}
    kernel_name = "segment_sum" if family == "NMF" else "segment_apply"

    def count():
        return ss.launches if family == "NMF" else cuda_sgd.apply_launches

    # -- one epoch, kernels against plain, from the same tables and draws --
    run, cfg = family_epoch_fn(torch, family, pack, seed, N_USERS, N_ITEMS,
                               (u, i))
    n0 = count()
    got = run(1, True)
    again = run(1, True)
    check(count() > n0, f"{family}'s epoch launched no {kernel_name}")
    plain = plain_scatters(lambda: run(1, True))
    torch.cuda.synchronize()
    err = max(float((a - c).abs().max()) for a, c in zip(got, plain))
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{family}'s kernel epoch is not bitwise repeatable")
    check(err <= FAM_TOL[family],
          f"{family}'s kernel epoch differs from plain by {err}")
    out["epoch_vs_plain_max_abs_err"] = err
    del got, again, plain

    # -- throughput: one-epoch windows on the pack made once -------------
    run(1, False)  # warm-up
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(1, False)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
    out["epoch_seconds"] = windows
    out["updates_per_sec"] = pack.n_real / statistics.median(windows)
    del run
    torch.cuda.empty_cache()

    # -- the main path: fit, then update_users ---------------------------
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = None if family == "BPR" else pd.Series(r)
    model = getattr(mf, family)(n_factors=FAM["n_factors"],
                                n_epochs=FAM["epochs"],
                                batch_size=FAM["batch_size"], seed=seed,
                                **FAM_KW[family])
    cuda_sgd.reset_launches()
    ss.reset_launches()
    cuda_scores.reset_launches()
    t0 = time.perf_counter()
    model.fit(X, y)
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    fit_launches = count()
    hist = model.train_loss if family == "BPR" else model.train_rmse
    out["train_loss" if family == "BPR" else "train_rmse"] = hist
    check(len(hist) == FAM["epochs"] and np.isfinite(hist).all(),
          f"{family} history {hist}")
    if family == "NMF":
        check(all(b <= a for a, b in zip(hist, hist[1:])),
              f"NMF train RMSE rose: {hist}")
        check(float(model._params.user_features.min()) >= 0
              and float(model._params.item_features.min()) >= 0,
              "NMF factors went negative")
    else:
        check(hist[-1] < hist[0], f"{family} history not falling: {hist}")
    Xu, yu = update_cohort(rng, u, N_ITEMS)
    frozen = [model._params.item_features.clone()]
    if family == "SVDpp":
        frozen.append(model._params.implicit_features.clone())
    t0 = time.perf_counter()
    model.update_users(Xu, None if family == "BPR" else yu, n_epochs=3)
    torch.cuda.synchronize()
    out["update_users_seconds"] = time.perf_counter() - t0
    out["launches"] = count()
    out["fit_launches"] = fit_launches
    check(fit_launches > 0 and out["launches"] > fit_launches,
          f"{family}'s fit or update_users launched no {kernel_name}")
    check(torch.equal(model._params.item_features, frozen[0])
          and (family != "SVDpp"
               or torch.equal(model._params.implicit_features, frozen[1])),
          f"{family}'s update_users moved a frozen table")

    # -- serving, AUC, checkpoint ----------------------------------------
    out.update(family_serving_check(torch, model, family, (hu, hi), rng,
                                    np.unique(u)))
    if family == "BPR":
        # the config-3 ratings are uniform: a held-out pair is a random
        # item, so its AUC is at chance by construction; the trained pairs
        # are what the tables must rank above random items
        t0 = time.perf_counter()
        out["auc_held_out"] = model.auc(pd.DataFrame({"user_id": hu,
                                                      "item_id": hi}))
        out["auc_seconds"] = time.perf_counter() - t0
        k = rng.choice(len(u), N_HELD_OUT, replace=False)
        out["auc_trained_pairs"] = model.auc(pd.DataFrame(
            {"user_id": u[k], "item_id": i[k]}))
        check(0.0 <= out["auc_held_out"] <= 1.0, "BPR held-out AUC")
        check(out["auc_trained_pairs"] > 0.5,
              f"BPR AUC on trained pairs {out['auc_trained_pairs']}")
    t0 = time.perf_counter()
    mf.save_model(model, f"{tmpdir}/{family}")
    back = mf.load_model(f"{tmpdir}/{family}")
    out["checkpoint_seconds"] = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(model._params, back._params)),
          f"{family}'s checkpoint round trip is not bitwise")
    if family == "BPR":
        check(all(np.array_equal(a, b) for a, b in zip(model._train_pairs,
                                                       back._train_pairs)),
              "BPR's training pairs did not round-trip")
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    del model, back, X
    torch.cuda.empty_cache()
    return out


def phase_popularity(rng, data3, tmpdir):
    """``Popularity`` (host numpy) in 'mean' mode on the config-3 ratings:
    its statistics against ``bincount``, its scores against the damped-mean
    formula in float64, ``recommend_batch`` (user-independent lists),
    ``update_users`` and a checkpoint round trip."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as mf

    u, i, r, _, _ = data3
    out = {"phase": "popularity"}
    X = pd.DataFrame({"user_id": u, "item_id": i})
    t0 = time.perf_counter()
    m = mf.Popularity(score="mean", damping=10.0, min_rating=0.5,
                      max_rating=5.0).fit(X, pd.Series(r))
    out["fit_seconds"] = time.perf_counter() - t0
    idx = m.item_vocab.encode(np.arange(N_ITEMS))
    cnt = np.bincount(i, minlength=N_ITEMS).astype(np.float64)
    sums = np.bincount(i, weights=r.astype(np.float64), minlength=N_ITEMS)
    ref = (sums + 10.0 * r.astype(np.float64).mean()) / (cnt + 10.0)
    check(np.array_equal(m._item_counts[idx], cnt), "Popularity counts")
    err = float(np.abs(m.item_scores_[idx] - ref).max())
    check(err <= 1e-4, f"Popularity scores differ from float64 by {err}")
    users = [int(x) for x in rng.choice(np.unique(u), 256, replace=False)]
    t0 = time.perf_counter()
    batch = m.recommend_batch(users, amount=10)
    out["recommend_batch_seconds"] = time.perf_counter() - t0
    top = list(np.asarray(m.item_vocab.raw_ids)[
        np.argsort(-m.item_scores_, kind="stable")[:10]])
    check(len(batch) == 2560 and all(
        list(batch.item_id.iloc[10 * k:10 * k + 10]) == top
        for k in range(256)), "Popularity lists are not the catalog top-10")
    Xu, yu = update_cohort(rng, u, N_ITEMS)
    m.update_users(Xu, yu)
    check(m._item_counts.sum() == len(r) + len(Xu), "Popularity update_users")
    mf.save_model(m, f"{tmpdir}/pop")
    back = mf.load_model(f"{tmpdir}/pop")
    check(np.array_equal(back.item_scores_, m.item_scores_),
          "Popularity checkpoint round trip")
    out.update(score_max_abs_err=err, n_users=m.n_users)
    return out


def phase_family_kernel_times(torch, rng, pack, timer):
    """Kernel, plain and library (one ``index_add_`` of the rows at their
    unsorted ids, a float-atomic scatter the port never calls) times of
    the apply and the segment sum at the families' shapes, on the first
    batch of the families' user-primary pack (n = 1,048,576, Kp 128; NMF's
    accumulator 2k = 128): over the batch's user order (BPR's P, SVD++'s
    P, A and S; NMF's user side), over its secondary order (BPR's Q[i],
    SVD++'s Q and gY; NMF's item side), and over sorted uniform negatives
    (BPR's Q[j]); with their bounds."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    b = {"u": pack.user_ids[0], "i": pack.item_ids[0], "sp": pack.sec_perm[0],
         "ss": pack.sec_ids_sorted[0]}
    n = b["u"].numel()
    j = torch.from_numpy(rng.integers(0, N_ITEMS, n, dtype=np.int32)).cuda()
    kp = 128
    vals = torch.from_numpy(rng.standard_normal((n, kp), dtype=np.float32)).cuda()
    orders = {"user_order": (ss.identity_order(b["u"]), b["u"], N_USERS),
              "secondary_order": ((b["sp"], b["ss"]), b["i"], N_ITEMS),
              "negatives": (ss.sorted_order(j), j, N_ITEMS)}
    rows = []
    for kernel, cases in (("segment_apply", orders),
                          ("segment_sum", {k: orders[k] for k in
                                           ("user_order", "secondary_order")})):
        for name, (order, raw, n_rows) in cases.items():
            out = torch.zeros((n_rows, kp), device="cuda")
            raw_l = raw.long()
            if kernel == "segment_apply":
                fns = {"": lambda: cuda_sgd.cuda_segment_apply(out, vals, *order),
                       "plain_": lambda: cuda_sgd.plain_segment_apply(out, vals, *order)}
            else:
                fns = {"": lambda: ss.cuda_segment_sum(out, vals, *order),
                       "plain_": lambda: ss.plain_segment_sum(out, vals, *order)}
            # vals[t] belongs to the batch's entry t, whose id is raw[t]
            fns["library_"] = lambda: out.index_add_(0, raw_l, vals)
            b_ms, b_by = segsum_bound(order[1], n, kp)
            row = {"name": kernel, "shape": f"families_{name}", "n": n, "d": kp,
                   "rows": n_rows, "bound_ms": b_ms, "bound_by": b_by}
            for key, fn in fns.items():
                row[f"{key}ms"] = timer.ms(fn)
            rows.append(row)
            emit({"phase": "family_kernel_time", **row})
    return rows



# ---------------------------------------------------------------------------
# The recipe recommender's serving path at RecipeNLG's catalog
# ---------------------------------------------------------------------------

# RecipeNLG's full_dataset.csv (2,231,142 recipes; the reference's
# prepare_recipes_full_dataset.py), the hash_embed width (512), the TF-IDF
# index's max_features (50,000, build_tfidf_index); the model is config 3's
# KernelMF width (linear, k = 200) on the config-2 ratings, whose 3,706
# items are the first 3,706 recipes
RECIPE = {"n_items": 2_231_142, "dim": 512, "n_known": 3_706,
          "vocab": 50_000, "terms": 32, "queries": 64, "batch": 256,
          "k": 10, "candidate_k": 500, "alpha": 0.5, "vocab_block": 1_024,
          "reranker_seeds": 200, "n_factors": 200, "epochs": 3,
          "batch_size": 131_072, "lr": 0.01, "reg": 0.02}
RECIPE_WORDS = (
    "chicken breast", "rice", "tofu", "salmon", "beef", "egg", "milk",
    "peanut butter", "walnut", "lettuce", "potato", "carrot", "noodle",
    "curry paste", "cheese", "butter", "lentils", "black beans", "spinach",
    "greek yogurt", "shrimp", "flour", "soy sauce", "olive oil", "garlic",
    "onion", "tomato", "mushroom", "pork loin", "turkey", "chickpeas",
    "broccoli", "honey", "oats", "cod", "quinoa")
RECIPE_STYLE = ("smoky", "spicy", "creamy", "crispy", "light", "hearty",
                "zesty", "golden", "rustic", "quick")
RECIPE_DISH = ("bowl", "stew", "salad", "bake", "stir fry", "soup", "wrap",
               "skillet", "casserole", "curry")
RECIPE_VERB = ("grill", "bake", "boil", "steam", "fry", "simmer", "roast")


def recipe_texts(rng, n_known, n_items):
    """Seeded recipe texts in the JAX pipeline's "title / ingredients /
    directions" form: full ones for the first ``n_known``, short ones for
    the rest. Returns (texts, titles of the known recipes)."""
    import numpy as np

    W, S, D, V = RECIPE_WORDS, RECIPE_STYLE, RECIPE_DISH, RECIPE_VERB
    texts, titles = [], []
    for i in range(n_known):
        ings = rng.choice(len(W), size=int(rng.integers(3, 7)), replace=False)
        title = f"{S[rng.integers(len(S))]} {W[ings[0]]} {D[rng.integers(len(D))]} {i}"
        verb = V[rng.integers(len(V))]
        texts.append(f"title: {title}\ningredients: "
                     f"{'; '.join(W[j] for j in ings)}\ndirections: {verb} "
                     f"{int(rng.integers(5, 120))} minutes")
        titles.append(title)
    rest = n_items - n_known
    a, b = rng.integers(0, len(W), rest), rng.integers(0, len(W), rest)
    v, m = rng.integers(0, len(V), rest), rng.integers(5, 120, rest)
    texts += [f"title: recipe {i}\ningredients: {W[x]}; {W[y]}\ndirections: "
              f"{V[z]} {t} minutes" for i, x, y, z, t in
              zip(range(n_known, n_items), a.tolist(), b.tolist(), v.tolist(),
                  m.tolist())]
    return texts, titles


class HashVectorizer:
    """A TF-IDF vectorizer stand-in (this script needs no sklearn): tokens
    hashed (crc32) into ``vocab`` columns, term counts, l2-normalized CSR
    rows, as ``TfidfVectorizer.transform`` gives them."""

    def __init__(self, vocab):
        self.vocab = vocab

    def transform(self, queries):
        import re
        import zlib

        import numpy as np
        import scipy.sparse as sp

        rows, cols = [], []
        for r, q in enumerate(queries):
            for tok in re.findall(r"[a-z0-9]+", q.lower()):
                rows.append(r)
                cols.append(zlib.crc32(tok.encode()) % self.vocab)
        m = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(len(queries), self.vocab))
        m.sum_duplicates()
        norms = np.sqrt(np.asarray(m.multiply(m).sum(1)).ravel())
        return sp.csr_matrix(sp.diags(1.0 / np.maximum(norms, 1e-12)) @ m)


def tfidf_catalog(rng, n_items, vocab, terms):
    """A seeded l2-normalized CSR of ``n_items`` x ``vocab``, ``terms``
    distinct columns a row (an arithmetic progression from a random start:
    unique by construction, as a CSR's (row, col) pairs are)."""
    import numpy as np
    import scipy.sparse as sp

    start = rng.integers(0, vocab, n_items)
    step = rng.integers(1, vocab // terms, n_items)
    cols = (start[:, None] + step[:, None] * np.arange(terms)) % vocab
    vals = rng.uniform(0.1, 1.0, (n_items, terms)).astype(np.float32)
    vals /= np.linalg.norm(vals, axis=1, keepdims=True)
    return sp.csr_matrix(
        (vals.ravel(), cols.ravel().astype(np.int32),
         np.arange(0, n_items * terms + 1, terms, dtype=np.int64)),
        shape=(n_items, vocab))


def f64_topk_positions(s, k):
    """The top-``k`` positions of one float64 score row, by score
    descending then position ascending: ``np.partition`` finds the k-th
    score, ``np.lexsort`` orders every score at or above it (the same
    order as ``np.lexsort((np.arange(n), -s))[:k]``, without sorting the
    whole row)."""
    import numpy as np

    n = s.shape[0]
    k = min(k, n)
    t = np.partition(s, n - k)[n - k]
    cand = np.flatnonzero(s >= t)
    return cand[np.lexsort((cand, -s[cand]))][:k]


def host_f64_topk(emb, Q, k, chunk=131_072):
    """float64 scores of every item against every query, on the host, and
    each query's top-k positions (``f64_topk_positions``). Returns (scores
    (B, n), positions (B, k), seconds)."""
    import numpy as np

    t0 = time.perf_counter()
    Q64 = Q.astype(np.float64)
    S = np.empty((Q.shape[0], emb.shape[0]), np.float64)
    for lo in range(0, emb.shape[0], chunk):
        S[:, lo:lo + chunk] = Q64 @ emb[lo:lo + chunk].astype(np.float64).T
    pos = np.stack([f64_topk_positions(s, k) for s in S])
    return S, pos, time.perf_counter() - t0


def hold_search(vals, pos, S, want, tol=1e-5, tie=1e-6):
    """Device top-k against the host float64 one (``S`` (B, n)): values
    within ``tol`` of the float64 scores at both position lists; positions equal except where
    the float64 scores tie within ``tie`` (``want`` holds k + 1 positions).
    Returns the largest value error."""
    import numpy as np

    err = 0.0
    k = pos.shape[1]
    for j in range(pos.shape[0]):
        s = S[j]
        err = max(err, float(np.abs(vals[j] - s[pos[j]]).max()),
                  float(np.abs(vals[j] - s[want[j, :k]]).max()))
        gap = np.abs(np.diff(s[want[j]])) > tie
        sep = np.concatenate([[True], gap[:-1]]) & gap
        bad = np.flatnonzero((pos[j] != want[j, :k]) & sep)
        check(bad.size == 0, f"query {j}: positions {pos[j][bad]} differ from "
                             f"the float64 top-k {want[j, :k][bad]}")
    check(err < tol, f"search values off the float64 scores by {err}")
    return err


def reranker_rows(index, texts, meta, rng_seed, n_seeds):
    """Weak-supervision rows as the JAX pipeline's ``train_reranker`` makes
    them: queries from seed recipes, the seed's hit positive, three hard
    negatives from the same top-30."""
    import random

    import numpy as np

    from matrix_factorization_tpu_torch.rank.reranker import featurize, generate_queries
    from matrix_factorization_tpu_torch.retrieval import search

    rng = random.Random(rng_seed)
    X, y = [], []
    for seed_id in range(n_seeds):
        for q in generate_queries(texts[seed_id], rng):
            cand = search.search_topk_pos(
                index, search.encode_query_for_index(index, q), 30)
            hit = next((c for c in cand if c[1] == seed_id), None)
            if hit is None:
                continue
            X.append(featurize(q, texts[hit[0]], hit[2], meta.loc[str(seed_id)]))
            y.append(1)
            negs = [c for c in cand if c[1] != seed_id]
            rng.shuffle(negs)
            for p, nid, s in negs[:3]:
                X.append(featurize(q, texts[p], s, meta.loc[str(nid)]))
                y.append(0)
    return np.vstack(X), np.asarray(y, np.int32)


def http_statuses(svc, user, query):
    """One pass over the HTTP routes on 127.0.0.1:0: the statuses of
    ``tests/test_serve_checkpoint.py::test_http_api`` (and the batch and
    plan routes)."""
    import urllib.error
    import urllib.request

    from matrix_factorization_tpu_torch.serve.api import serve

    httpd = serve(svc, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def status(path, body=None):
        req = urllib.request.Request(base + path, data=None if body is None
                                     else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        got = {
            "health": status("/health"),
            "recommend": status("/recommend", {"query": query, "user_id": user,
                                               "k": 5}),
            "missing_query": status("/recommend", {}),
            "k_out_of_bounds": status("/recommend", {"query": "x", "k": 999}),
            "unknown_path": status("/nope"),
            "batch": status("/recommend_batch", {"queries": [query, "rice"],
                                                 "k": 3}),
            "plan": status("/plan", {"meals": ["午餐"], "per_meal_k": 2,
                                     "avoid": ["peanut"], "use_reranker": False}),
            "bad_plan": status("/plan", {"nope": 1}),
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    check(not th.is_alive(), "the HTTP server thread did not stop")
    want = {"health": 200, "recommend": 200, "missing_query": 422,
            "k_out_of_bounds": 422, "unknown_path": 404, "batch": 200,
            "plan": 200, "bad_plan": 422}
    codes = {k: v[0] for k, v in got.items()}
    check(codes == want, f"HTTP statuses {codes}, want {want}")
    check(got["health"][1]["n_items"] == len(svc.index.item_ids)
          and len(got["recommend"][1]["results"]) == 5
          and len(got["batch"][1]["results"]) == 2
          and got["plan"][1]["plan"], "HTTP bodies")
    return codes


def phase_recipe_serve(torch, rng, train, tmpdir, seed, timer):
    """The recipe recommender's serving path at RecipeNLG's catalog: a
    2,231,142 x 512 dense index on the card, a KernelMF fitted there by SGD
    (the step and apply counts zeroed just before the fit and read just
    after), a reranker trained there, the service loaded from its artifacts
    (``item_index.pkl``, ``model.pkl``, ``reranker.pkl``), 64 hybrid
    ``recommend`` calls, 4 ``plan_meals``, the HTTP routes, and the batched
    TF-IDF path on a 2,231,142 x 50,000 CSR."""
    import pickle

    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF
    from matrix_factorization_tpu_torch.core.artifacts import load_pickle
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.rank import hybrid
    from matrix_factorization_tpu_torch.rank.recipe_features import (
        contains_any, expand_avoid_terms, featurize_item_text)
    from matrix_factorization_tpu_torch.rank.reranker import (
        FEATURE_NAMES, TorchLogisticRegression, rerank_scores)
    from matrix_factorization_tpu_torch.retrieval import index as rindex
    from matrix_factorization_tpu_torch.retrieval import search, sparse_scoring
    from matrix_factorization_tpu_torch.retrieval.encode import hash_embed
    from matrix_factorization_tpu_torch.serve.planner import PlanRequest, plan_meals
    from matrix_factorization_tpu_torch.serve.service import RecommendService

    R = RECIPE
    n, dim, n_known = R["n_items"], R["dim"], R["n_known"]
    out = {"phase": "recipe_serve", "n_items": n, "dim": dim, "n_known": n_known}
    tmp = Path(tmpdir)

    # -- catalog: texts, embeddings (unit rows, hash_embed of the known) ---
    t0 = time.perf_counter()
    texts, titles = recipe_texts(rng, n_known, n)
    g = torch.Generator(device="cuda").manual_seed(seed)
    E = torch.randn((n, dim), generator=g, device="cuda")
    E /= E.norm(dim=1, keepdim=True)
    E[:n_known] = torch.from_numpy(hash_embed(texts[:n_known], dim=dim)).cuda()
    emb = E.cpu().numpy()
    del E
    meta = pd.DataFrame([featurize_item_text(t) for t in texts[:n_known]])
    rest = n - n_known
    meta = pd.concat([meta[["time_min", "protein_score", "low_calorie_score",
                            "ingredients_count"]], pd.DataFrame({
        "time_min": rng.integers(5, 120, rest).astype(float),
        "protein_score": rng.integers(0, 4, rest).astype(float),
        "low_calorie_score": rng.uniform(0, 5, rest),
        "ingredients_count": rng.integers(2, 12, rest)})], ignore_index=True)
    meta.index = [str(i) for i in range(n)]
    out["data_seconds"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = rindex.build_dense_index(list(range(n)), texts, emb, normalize=False)
    dev_emb = search.device_embeddings(index)
    torch.cuda.synchronize()
    out["index_build_seconds"] = time.perf_counter() - t0
    out["index_device_bytes"] = torch.cuda.memory_allocated() - mem0
    out["memory_allocated_bytes"] = torch.cuda.memory_allocated()
    check(out["index_device_bytes"] >= n * dim * 4, "the index is not on the card")

    # -- the model: KernelMF by SGD on the card, the counts zeroed ---------
    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    model = KernelMF(n_factors=R["n_factors"], kernel="linear", lr=R["lr"],
                     reg=R["reg"], batch_size=R["batch_size"], min_rating=0.5,
                     max_rating=5.0, seed=seed)
    cuda_sgd.reset_launches()
    t0 = time.perf_counter()
    model.fit(X, pd.Series(r), n_epochs=R["epochs"])
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    out["launches"] = {"sgd_step": cuda_sgd.step_launches,
                       "segment_apply": cuda_sgd.apply_launches}
    check(all(v > 0 for v in out["launches"].values()),
          f"the fit missed a kernel: {out['launches']}")
    hist = model.train_rmse
    out["train_rmse"] = hist
    check(len(hist) == R["epochs"] and hist[-1] < hist[0], f"train RMSE {hist}")
    out["Kp"] = int(model._params.item_features.shape[1])
    # the step and the apply against the plain step at this fit's own
    # shape (linear, Kp 256, bs 131,072), on the pack fit made: its first
    # batch and its last (which holds pads)
    cfg = model._cfg()
    pack = sgd.pack_ratings(model.user_vocab.encode(u), model.item_vocab.encode(i),
                            np.asarray(r, np.float32), cfg.batch_size,
                            order=model.epoch_order, device="cuda")
    out["compare_sgd"] = phase_compare_sgd(torch, rng, [
        (f"recipe_linear_k200_batch{b}", cfg, pack, b, model.n_users,
         model.n_items) for b in (0, pack.n_batches - 1)])
    del pack

    # -- the reranker, trained on the card ---------------------------------
    t0 = time.perf_counter()
    Xr, yr = reranker_rows(index, texts, meta, seed, R["reranker_seeds"])
    clf = TorchLogisticRegression().fit(Xr, yr)
    out["reranker_seconds"] = time.perf_counter() - t0
    out["reranker_rows"] = int(len(yr))
    out["reranker_accuracy"] = float((clf.predict(Xr) == yr).mean())
    check(np.isfinite(clf.coef_).all() and out["reranker_accuracy"] > 0.5,
          f"reranker accuracy {out['reranker_accuracy']}")

    # -- artifacts and the service ------------------------------------------
    t0 = time.perf_counter()
    rindex.save_item_index(index, tmp / "item_index.pkl")
    with (tmp / "model.pkl").open("wb") as f:
        pickle.dump(model, f)
    with (tmp / "reranker.pkl").open("wb") as f:
        pickle.dump({"model_type": "logreg", "index_type": "dense",
                     "feature_names": FEATURE_NAMES, "model": clf}, f)
    out["artifact_save_seconds"] = time.perf_counter() - t0
    out["item_index_pkl_bytes"] = (tmp / "item_index.pkl").stat().st_size
    t0 = time.perf_counter()
    svc = RecommendService.from_artifacts(tmp)
    out["service_load_seconds"] = time.perf_counter() - t0
    (tmp / "item_index.pkl").unlink()
    del index, emb, dev_emb
    index = svc.index
    svc.meta = meta
    check(svc.health() == {"status": "ok", "index_type": "dense", "n_items": n,
                           "has_model": True, "has_reranker": True},
          f"health {svc.health()}")
    check(svc.model._params.item_features.device.type == "cuda",
          "the loaded model is not on the card")
    check(isinstance(svc.reranker["model"], TorchLogisticRegression),
          "reranker type")
    cpu_model = load_pickle(tmp / "model.pkl", device="cpu")
    t0 = time.perf_counter()
    emb_dev = search.device_embeddings(index)
    torch.cuda.synchronize()
    out["index_device_copy_seconds"] = time.perf_counter() - t0

    # -- search against the host float64 top-k -------------------------------
    k = R["k"]
    Q = np.stack([search.encode_query_for_index(index, t)
                  for t in titles[:R["batch"]]])
    S, want, host_s = host_f64_topk(index.embeddings, Q, k + 1)
    out["host_f64_seconds"] = host_s
    out["host_f64_ms_per_query"] = host_s / len(Q) * 1e3
    vals = np.zeros((R["queries"], k), np.float32)
    pos = np.zeros((R["queries"], k), np.int64)
    for j in range(R["queries"]):
        rows = search.search_topk_pos(index, Q[j], k)
        pos[j] = [p for p, _, _ in rows]
        vals[j] = [s for _, _, s in rows]
    out["search_max_abs_err"] = hold_search(vals, pos, S[:R["queries"]],
                                            want[:R["queries"]])
    # the service's own depth: candidate_k rows of every query
    ck = R["candidate_k"]
    cvals = np.zeros((R["queries"], ck), np.float32)
    cpos = np.zeros((R["queries"], ck), np.int64)
    for j in range(R["queries"]):
        rows = search.search_topk_pos(index, Q[j], ck)
        cpos[j] = [p for p, _, _ in rows]
        cvals[j] = [s for _, _, s in rows]
    cwant = np.stack([f64_topk_positions(S[j], ck + 1)
                      for j in range(R["queries"])])
    out["search_candidate_k_max_abs_err"] = hold_search(
        cvals, cpos, S[:R["queries"]], cwant)
    out["search_self_hit"] = float(np.mean(pos[:, 0] == np.arange(R["queries"])))
    bvals, bpos = search.search_topk_batch(index, Q, k)
    out["batch_max_abs_err"] = hold_search(bvals, bpos, S, want)
    del S

    q1 = torch.from_numpy(Q[:1]).cuda()
    qb = torch.from_numpy(Q).cuda()
    b_bytes = n * dim * 4 / HBM_BYTES_PER_S * 1e3
    out["search_ms"] = timer.ms(lambda: search.dense_topk(emb_dev, q1, k))
    out["search_bound_ms"] = max(b_bytes, 2 * n * dim / PEAK_FLOPS["float32"] * 1e3)
    out["search_batch_ms"] = timer.ms(lambda: search.dense_topk(emb_dev, qb, k),
                                      reps=10)
    out["search_batch_bound_ms"] = max(
        b_bytes, 2 * len(Q) * n * dim / PEAK_FLOPS["float32"] * 1e3)
    host = []
    for j in range(R["queries"]):
        t0 = time.perf_counter()
        search.search_topk(index, Q[j], k)
        host.append((time.perf_counter() - t0) * 1e3)
    out["search_host_p50_ms"] = float(np.percentile(host, 50))

    # -- 64 hybrid recommend calls -------------------------------------------
    users = rng.choice(np.unique(u), R["queries"], replace=False).tolist()
    lat, err = [], 0.0
    for j, user in enumerate(users):
        t0 = time.perf_counter()
        res = svc.recommend(titles[j], user_id=user, k=k,
                            candidate_k=R["candidate_k"], alpha=R["alpha"])
        lat.append((time.perf_counter() - t0) * 1e3)
        check(len(res) == k and all(x["reason"].startswith("hybrid") for x in res),
              f"recommend {j}: {res[:1]}")
        cands = search.search_topk(index, search.encode_query_for_index(
            index, titles[j]), R["candidate_k"])
        ids = [c[0] for c in cands]
        ms = hybrid.model_scores(svc.model, user, ids)
        ms_cpu = hybrid.model_scores(cpu_model, user, ids)
        check(np.any(ms != 0), f"recommend {j}: model scores are the zeros fallback")
        err = max(err, float(np.abs(ms - ms_cpu).max()))
        blended = hybrid.blend(ms, np.asarray([c[1] for c in cands], np.float32),
                               R["alpha"])
        check(np.allclose(np.sort(blended)[::-1][:k], [x["score"] for x in res],
                          atol=1e-6), f"recommend {j}: scores are not the blend")
    check(err < 1e-5, f"model scores on the card off the CPU model's by {err}")
    out["model_scores_vs_cpu"] = err
    out["recommend_p50_ms"] = float(np.percentile(lat, 50))
    out["recommend_p99_ms"] = float(np.percentile(lat, 99))

    # -- 4 meal plans with the reranker and avoid terms ----------------------
    # at the planner's default diversity penalty; the greedy never picks a
    # candidate twice in a meal, while across meals only the carried-over
    # penalty holds a repeat back (JAX's semantics), so those are counted
    plans, cross = [], 0
    t0 = time.perf_counter()
    for goal, avoid in (("增肌/高蛋白", ["milk"]), ("减脂/低卡", ["peanut"]),
                        ("控糖/低碳", ["egg"]), ("", ["beef", "pork"])):
        req = PlanRequest(goal=goal, avoid=avoid, per_meal_k=3, candidate_k=100,
                          alpha=0.3, user_id=users[0], use_reranker=True)
        rows = plan_meals(svc, req)
        terms = expand_avoid_terms(avoid, enable=True)
        check(len(rows) == 3 * len(req.meals), f"plan {goal} {avoid}: {len(rows)} rows")
        check(not any(contains_any(index.texts[x["item_id"]], terms) for x in rows),
              f"plan {goal} {avoid}: an avoided ingredient")
        for meal in req.meals:
            ids = [x["item_id"] for x in rows if x["meal"] == meal]
            check(len(ids) == len(set(ids)), f"plan {goal} {avoid}: a repeat in {meal}")
        ids = [x["item_id"] for x in rows]
        cross += len(ids) - len(set(ids))
        plans.append(len(rows))
    out["plan_seconds"] = time.perf_counter() - t0
    out["plan_rows"] = plans
    out["plan_cross_meal_repeats"] = cross
    cand = search.search_topk_pos(index, Q[0], 20)
    rr = rerank_scores(svc.reranker, titles[0],
                       [(index.texts[p], s) for p, _, s in cand],
                       {str(c[1]): meta.loc[str(c[1])] for c in cand},
                       [c[1] for c in cand])
    check(rr.shape == (20,) and np.isfinite(rr).all(), "rerank_scores")

    out["http"] = http_statuses(svc, users[0], titles[0])

    # -- the batched TF-IDF path at the catalog's size ------------------------
    t0 = time.perf_counter()
    M = tfidf_catalog(rng, n, R["vocab"], R["terms"])
    tix = rindex.TfidfItemIndex(item_ids=index.item_ids, texts=index.texts,
                                vectorizer=HashVectorizer(R["vocab"]), matrix=M)
    out["tfidf_data_seconds"] = time.perf_counter() - t0
    qs = titles[:R["queries"]]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = sparse_scoring.tfidf_scores_device(tix, qs, vocab_block=R["vocab_block"])
    torch.cuda.synchronize()
    out["tfidf_scores_seconds"] = time.perf_counter() - t0
    got = scores.cpu().numpy()
    del scores
    ref = np.ascontiguousarray((M @ tix.vectorizer.transform(qs).T).toarray().T)
    out["tfidf_max_abs_err"] = float(np.abs(got - ref).max())
    check(out["tfidf_max_abs_err"] < 1e-5,
          f"TF-IDF scores off scipy's by {out['tfidf_max_abs_err']}")
    tvals, tpos = sparse_scoring.tfidf_batch_topk(tix, qs, k,
                                                  vocab_block=R["vocab_block"])
    twant = np.stack([f64_topk_positions(ref[j].astype(np.float64), k + 1)
                      for j in range(len(qs))])
    hold_search(tvals, tpos, ref, twant)
    out["tfidf_peak_bytes"] = torch.cuda.max_memory_allocated()
    del got, ref, M, tix
    svc.model = svc.reranker = None
    torch.cuda.empty_cache()
    return out


# the batch pipeline at MovieLens-25M (config 3's ratings) over a recipe
# catalog of the same width: the stages' argv as the JAX e2e test gives
# them, no --platform (the default device), in run_all's order with the
# dense index in the TF-IDF index's place
PIPE = {"dim": 512, "max_users": 2_000, "k": 10, "held": 200, "profiles": 64,
        "tie": 1e-5, "candidate_k": 100, "reranker_seeds": 200,
        "query": "chicken rice dinner"}
PIPE_TRAIN = ["--model", "kernel_mf", "--kernel", "sigmoid", "--factors", "200",
              "--lr", "0.01", "--reg", "0.005", "--batch-size", "2097152",
              "--epochs", "3"]
# hits for the metric check: low-rank seeded ratings (few reach the 4.0
# positive threshold, so a user's held-out items are their two highest
# rated, which a fitted model ranks near the top; chance would be 0.2% a
# slot) and a narrow sigmoid KernelMF
PIPE_SIGNAL_DATA = {"n_users": 2_000, "n_items": 1_000, "n_factors": 8,
                    "density": 0.05}
PIPE_SIGNAL = ["--model", "kernel_mf", "--kernel", "sigmoid", "--factors", "32",
               "--lr", "0.01", "--batch-size", "8192", "--epochs", "10"]
PIPE_BASELINE_KW = {"reg": 0.005, "n_epochs": 5}
SCORER_KERNELS = ("score_stream_kernel", "score_tile_kernel")


def run_cli(module, argv):
    """``module.main()`` with ``argv``, as the JAX pipeline tests drive a
    stage; returns what it printed."""
    import contextlib
    import io

    old = sys.argv
    sys.argv = [module.__name__] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = old
    return buf.getvalue()


class Recorded:
    """Within the block, ``module.name`` is wrapped: each call's
    arguments, result and seconds are kept in ``calls`` (``keep`` of them
    at most), and ``on_result`` may replace the result."""

    def __init__(self, module, name, keep=None, on_result=None):
        self.module, self.name, self.keep = module, name, keep
        self.on_result = on_result
        self.calls, self.seconds = [], 0.0

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            self.seconds += time.perf_counter() - t0
            if self.on_result is not None:
                out = self.on_result(out)
            if self.keep is None or len(self.calls) < self.keep:
                self.calls.append((args, kwargs, out))
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)
        return False


def record_recommend(model, calls):
    """``model`` with its ``recommend`` calls kept in ``calls``: (user,
    known items, recommended ids, their scores)."""
    import numpy as np

    inner = model.recommend

    def recommend(user, amount=10, items_known=None, **kw):
        out = inner(user=user, amount=amount, items_known=items_known, **kw)
        calls.append((user, list(items_known or ()), list(out["item_id"]),
                      out["rating_pred"].to_numpy(np.float64)))
        return out

    model.recommend = recommend
    return model


def f64_scores(cfg, mu, p, Q):
    """float64 scores of one user row ``p`` against the item rows ``Q``
    under the model's kernel (``ops/cuda_scores.py::plain_score_catalog``'s
    formula)."""
    import numpy as np

    dots = Q @ p
    if cfg.kernel == "linear":
        return mu + dots
    if cfg.kernel == "sigmoid":
        return cfg.a + cfg.c / (1.0 + np.exp(-(mu + dots)))
    sq = np.maximum(p @ p + (Q * Q).sum(1) - 2.0 * dots, 0.0)
    return cfg.a + cfg.c * np.exp(-cfg.gamma * sq)


def topk_metrics(ratings, calls, k):
    """precision, recall and ndcg@k of the recorded ``recommend`` calls, as
    ``eval/topk_eval.py`` defines them: a user's relevant items are the
    ones of their ``ratings`` rows that were not passed as known."""
    import numpy as np

    hist = (ratings[ratings["user_id"].isin([c[0] for c in calls])]
            .groupby("user_id")["item_id"].agg(set))
    ps, rs, ns = [], [], []
    for user, known, rec, _ in calls:
        rel = hist[user] - set(known)
        hits = np.asarray([it in rel for it in rec], np.float64)
        ps.append(hits.mean() if hits.size else 0.0)
        rs.append(hits.sum() / max(1, len(rel)))
        dcg = float(np.sum(hits / np.log2(np.arange(2, hits.size + 2))))
        n_ideal = min(k, int(hits.sum()))
        ns.append(dcg / float(np.sum(1.0 / np.log2(np.arange(2, n_ideal + 2))))
                  if n_ideal else 0.0)
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(ns))


def hold_recommended(model, calls, n_held, tie):
    """The first ``n_held`` recorded lists against a float64 numpy top-k of
    the model's own tables with the same known items excluded (score
    descending, then item position ascending): where the 10th and 11th
    float64 scores are more than ``tie`` apart, positions equal except
    among ties within the list and scores within 1e-5 (``hold_search``).
    Returns (users held, users skipped at a tied cut, largest error)."""
    import numpy as np

    cfg, p = model._cfg(), model._params
    n_items = model.n_items
    Q = p.item_features[:n_items].double().cpu().numpy()
    mu = float(p.global_mean)
    k = len(calls[0][2])
    S, want, got_pos, got_val, skipped = [], [], [], [], 0
    for user, known, rec, vals in calls[:n_held]:
        u = int(model.user_vocab.encode(np.asarray([user], dtype=object))[0])
        s = f64_scores(cfg, mu, p.user_features[u].double().cpu().numpy(), Q)
        s[model.item_vocab.encode(np.asarray(known, dtype=object))] = -np.inf
        w = f64_topk_positions(s, k + 1)
        if s[w[k - 1]] - s[w[k]] <= tie:
            skipped += 1
            continue
        S.append(s)
        want.append(w)
        got_pos.append(model.item_vocab.encode(np.asarray(rec, dtype=object)))
        got_val.append(vals)
    check(S, "every held user's top-k cut ties")
    err = hold_search(np.stack(got_val), np.stack(got_pos), np.stack(S),
                      np.stack(want), tol=1e-5, tie=tie)
    return len(S), skipped, err


def trace_summary(trace_dir, names):
    """The Chrome trace in ``trace_dir``: its kernel events whose name holds
    one of ``names`` (count, device milliseconds), the device's busy
    milliseconds (``device_time``) and the trace's window in milliseconds
    (its first event's start to its last event's end, host or device)."""
    files = sorted(Path(trace_dir).glob("trace_*.json"))
    check(len(files) == 1, f"{len(files)} trace files in {trace_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    ev, by_name, busy_us = device_time(events)
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X"]
    window_us = max(t for _, t in spans) - min(s for s, _ in spans)
    n = sum(1 for e in events if e.get("cat") == "kernel"
            and any(x in e.get("name", "") for x in names))
    ms = sum(t for x, t in by_name.items() if any(y in x for y in names))
    return {"kernels": n, "kernel_ms": ms, "device_busy_ms": busy_us / 1e3,
            "window_ms": window_us / 1e3}


def host_rss_mib():
    """(current, peak) resident set of this process, MiB: ``VmRSS`` of
    ``/proc/self/status`` and ``getrusage``'s ``ru_maxrss``."""
    import resource

    rss = None
    for line in Path("/proc/self/status").read_text().splitlines():
        key, _, val = line.partition(":")
        if key == "VmRSS":
            rss = int(val.split()[0]) / 1024
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def pipeline_launches():
    from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd, segment_sum

    return {"score_catalog": cuda_scores.launches,
            "sgd_step": cuda_sgd.step_launches,
            "segment_apply": cuda_sgd.apply_launches,
            "segment_sum": segment_sum.launches}


def phase_pipeline(torch, rng, data3, tmpdir, seed):
    """The batch pipeline end to end on the card, every stage through its
    ``main()`` with no ``--platform``: config 3's 25M ratings (item ids
    written as strings) and 59,392 seeded recipe texts in, the recipe
    metadata, structured features, 512-wide embeddings and dense index, a
    config-3 sigmoid KernelMF, ``evaluate`` (traced), ``evaluate_hybrid``,
    both rerankers, ``evaluate_llm``, the app's plan, then
    ``BaselineModel`` by ALS (held to ``bias_als_oracle``) and ``evaluate``
    again; between them ``train`` and ``evaluate`` on low-rank ratings
    (from ``seed``), whose lists hit. The launch counts are zeroed
    just before the first stage and read after each."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch.core.artifacts import load_pickle
    from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings
    from matrix_factorization_tpu_torch.eval import hybrid_eval
    from matrix_factorization_tpu_torch.ops import cuda_scores, cuda_sgd, segment_sum
    from matrix_factorization_tpu_torch.pipeline import (
        build_item_embeddings, build_recipe_metadata, build_structured_features,
        evaluate, evaluate_hybrid, evaluate_llm, export_artifacts, train,
        train_reranker)
    from matrix_factorization_tpu_torch.rank.reranker import (
        TorchLogisticRegression, TorchMLPReranker)
    from matrix_factorization_tpu_torch.retrieval.index import load_item_index
    from matrix_factorization_tpu_torch.serve import app
    from matrix_factorization_tpu_torch.utils.profiling import trace

    P = PIPE
    root = Path(tmpdir) / "pipeline"
    data, feats, art = root / "data", root / "features", root / "artifacts"
    data.mkdir(parents=True)
    out = {"phase": "pipeline", "n_ratings": int(len(data3[0])),
           "n_items": N_ITEMS, "dim": P["dim"]}

    # -- inputs: ratings.parquet (str item ids) and items.parquet ----------
    t0 = time.perf_counter()
    names = np.asarray([str(j) for j in range(N_ITEMS)], dtype=object)
    ratings = pd.DataFrame({"user_id": data3[0].astype(np.int64),
                            "item_id": names[data3[1]], "rating": data3[2]})
    ratings.to_parquet(data / "ratings.parquet", index=False)
    texts, _ = recipe_texts(rng, N_ITEMS, N_ITEMS)
    pd.DataFrame({"item_id": names, "text": texts}).to_parquet(
        data / "items.parquet", index=False)
    out["input_seconds"] = time.perf_counter() - t0
    n_users = int(ratings["user_id"].nunique())

    torch.cuda.reset_peak_memory_stats()
    for reset in (cuda_scores.reset_launches, cuda_sgd.reset_launches,
                  segment_sum.reset_launches):
        reset()
    seconds, launches, printed = {}, {}, {}

    def stage(name, module, argv, at=root):
        before = pipeline_launches()
        t0 = time.perf_counter()
        printed[name] = run_cli(module, ([] if at is None else ["--root", str(at)])
                                + argv)
        seconds[name] = time.perf_counter() - t0
        after = pipeline_launches()
        launches[name] = {k: after[k] - before[k] for k in after}

    def last_json(name):
        return json.loads([x for x in printed[name].splitlines()
                           if x.startswith(("{", "["))][-1])

    def evaluate_recorded(name, at, frame):
        """``evaluate`` on ``at``'s model, its ``recommend`` lists kept; the
        metrics recomputed from them (``frame``: the ratings it read) must
        equal the stage's JSON. Returns (the model, the lists, the JSON,
        ``evaluate_topk``'s seconds)."""
        recs = []
        with Recorded(evaluate, "load_pickle",
                      on_result=lambda m: record_recommend(m, recs)) as ld, \
                Recorded(evaluate, "evaluate_topk") as ev:
            stage(name, evaluate, ["--k", str(P["k"]),
                                   "--max-users", str(P["max_users"])], at=at)
        res = last_json(name)
        check(res["n_users"] == len(recs) > 0, f"{name} {res}, {len(recs)} lists")
        got = topk_metrics(frame, recs, P["k"])
        want = (res["precision"], res["recall"], res["ndcg"])
        check(np.allclose(got, want, rtol=0, atol=1e-12),
              f"{name}: metrics from the lists {got} != the stage's {want}")
        return ld.calls[0][2], recs, res, ev.seconds

    stage("build_recipe_metadata", build_recipe_metadata, [])
    meta = pd.read_parquet(feats / "recipe_meta.parquet")
    check(len(meta) == N_ITEMS and meta["item_id"].tolist() == names.tolist(),
          f"recipe_meta: {len(meta)} rows")
    stage("build_structured_features", build_structured_features, [])
    uf = pd.read_parquet(feats / "user_features.parquet")
    itf = pd.read_parquet(feats / "item_features.parquet")
    check(len(uf) == n_users and len(itf) == N_ITEMS
          and int(uf["rating_count"].sum()) == len(ratings),
          f"structured features: {len(uf)} users, {len(itf)} items")
    stage("build_item_embeddings", build_item_embeddings, ["--dim", str(P["dim"])])
    emb_df = pd.read_parquet(feats / "items_emb.parquet")
    check(emb_df.shape == (N_ITEMS, P["dim"] + 1), f"items_emb {emb_df.shape}")
    del emb_df
    stage("export_artifacts", export_artifacts, [])
    index = load_item_index(art / "item_index.pkl")
    check(len(index.item_ids) == N_ITEMS
          and index.embeddings.shape == (N_ITEMS, P["dim"]),
          f"item_index: {len(index.item_ids)} x {index.embeddings.shape}")

    # -- the config-3 KernelMF, then evaluate inside the trace ----------------
    with Recorded(train, "train_model") as fit:
        stage("train_kernel_mf", train, PIPE_TRAIN)
    out["fit_seconds"] = fit.seconds
    trace_dir = root / "trace"
    with trace(str(trace_dir)):
        before = cuda_scores.launches
        model, recs, res, eval_seconds = evaluate_recorded("evaluate", root,
                                                           ratings)
        eval_launches = cuda_scores.launches - before
    check(model._params.item_features.device.type == "cuda"
          and model._params.user_features.device.type == "cuda",
          "the loaded model is not on the card")
    hist = model.train_rmse
    check(len(hist) == 3 and hist[-1] < hist[0], f"train RMSE {hist}")
    out["train_rmse"] = hist
    out["evaluate"] = res
    out["evaluate_users_per_s"] = res["n_users"] / eval_seconds
    out["evaluate_topk_seconds"] = eval_seconds
    held, skipped, err = hold_recommended(model, recs, P["held"], P["tie"])
    out["evaluate_held_users"], out["evaluate_skipped_tied_cut"] = held, skipped
    out["evaluate_max_abs_err"] = err
    tr = trace_summary(trace_dir, SCORER_KERNELS)
    out["evaluate_trace"] = dict(tr, scorer_launches=eval_launches,
                                 device_busy_share=tr["device_busy_ms"] / tr["window_ms"])
    check(tr["kernels"] == eval_launches >= res["n_users"],
          f"the trace holds {tr['kernels']} scorer kernels, the counter {eval_launches}")
    del recs, model
    shutil.rmtree(trace_dir)

    # -- hits the metric check can see: config 3's draws are uniform, so its
    # top-10 lists hit nothing; low-rank ratings go through the same two
    # stages -----------------------------------------------------------------
    sig = root / "signal"
    (sig / "data").mkdir(parents=True)
    Xs, ys = lowrank_ratings(seed=seed, **PIPE_SIGNAL_DATA)
    sig_ratings = Xs.assign(item_id=Xs["item_id"].astype(str), rating=ys)
    sig_ratings.to_parquet(sig / "data" / "ratings.parquet", index=False)
    stage("train_signal", train, PIPE_SIGNAL, at=sig)
    model, recs, res, _ = evaluate_recorded("evaluate_signal", sig, sig_ratings)
    out["evaluate_signal"] = res
    check(min(res["precision"], res["recall"], res["ndcg"]) > 0,
          f"the signal run's lists hit nothing: {res}")
    out["evaluate_signal_held_users"], _, out["evaluate_signal_max_abs_err"] = (
        hold_recommended(model, recs, P["held"], P["tie"]))
    del recs, model

    # -- hybrid, rerankers, judge, app ----------------------------------------
    with Recorded(hybrid_eval, "_profile_topk", keep=1) as prof:
        stage("evaluate_hybrid", evaluate_hybrid, [
            "--alpha", "0.5", "--candidate-k", str(P["candidate_k"]),
            "--max-users", str(P["max_users"])])
    rep = last_json("evaluate_hybrid")
    out["evaluate_hybrid"] = rep
    check(len(rep) == 2 and all(v["n_users"] > 0 for v in rep.values()),
          f"evaluate_hybrid {rep}")
    args, kw, (sims, pos) = prof.calls[0]
    prof64 = np.stack(args[1][:P["profiles"]]).astype(np.float64)
    S = prof64 @ index.embeddings.astype(np.float64).T
    kk = kw["k"]
    want = np.stack([f64_topk_positions(s, kk + 1) for s in S])
    out["hybrid_profile_k"] = int(kk)
    out["hybrid_max_abs_err"] = hold_search(sims[:P["profiles"]], pos[:P["profiles"]],
                                            S, want, tol=1e-5, tie=P["tie"])
    del S, prof
    for kind, cls, extra in (("logreg", TorchLogisticRegression, []),
                             ("mlp", TorchMLPReranker, ["--model-type", "mlp"])):
        stage(f"train_reranker_{kind}", train_reranker, [
            "--n-seed-items", str(P["reranker_seeds"]), "--log-every", "0"] + extra)
        payload = load_pickle(art / "reranker.pkl")
        check(payload["model_type"] == kind and isinstance(payload["model"], cls)
              and payload["train_stats"]["n_samples"] > 0,
              f"reranker payload {kind}: {payload['train_stats']}")
        out[f"reranker_{kind}_samples"] = payload["train_stats"]["n_samples"]
    stage("evaluate_llm", evaluate_llm, [
        "--query", P["query"], "--must-include", "chicken", "--avoid", "peanut"])
    report = json.loads((art / "llm_eval_report.json").read_text())
    check(report["n_cases"] == 1, f"llm report {report['n_cases']} cases")
    out["llm"] = {k: report[k] for k in ("avg_relevance", "violation_rate",
                                         "diversity")}
    stage("app", app, ["--artifacts", str(art), "--features", str(feats),
                       "--query", P["query"], "--json"], at=None)
    rows = last_json("app")
    check(rows, "the app planned nothing")
    for meal in {r["meal"] for r in rows}:
        ids = [r["item_id"] for r in rows if r["meal"] == meal]
        check(len(ids) == len(set(ids)), f"the plan repeats an item in {meal}")
    out["app_rows"] = len(rows)

    # -- run_all's default model, then evaluate again -------------------------
    with Recorded(train, "train_model") as fit:
        stage("train_baseline", train, ["--model", "baseline", "--method", "als",
                                        "--epochs", str(PIPE_BASELINE_KW["n_epochs"]),
                                        "--reg", str(PIPE_BASELINE_KW["reg"])])
    out["baseline_fit_seconds"] = fit.seconds
    base_model = load_pickle(art / "model.pkl")
    check(base_model.train_rmse[-1] < base_model.train_rmse[0],
          f"baseline train RMSE {base_model.train_rmse}")
    # the fit's segment sums at 25M entries, held through the biases they
    # made: float64 numpy of the same closed-form sweeps, atol 1e-5
    t0 = time.perf_counter()
    bu, bi = bias_als_oracle(base_model, (ratings["user_id"], ratings["item_id"],
                                          ratings["rating"]), PIPE_BASELINE_KW)
    out["baseline_oracle_seconds"] = time.perf_counter() - t0
    err = max(float(np.abs(base_model.user_biases - bu).max()),
              float(np.abs(base_model.item_biases - bi).max()))
    out["baseline_oracle_max_abs_err"] = err
    check(err <= 1e-5, f"baseline ALS at 25M off its float64 oracle by {err}")
    del base_model, bu, bi
    with Recorded(evaluate, "evaluate_topk") as ev:
        stage("evaluate_baseline", evaluate, ["--k", str(P["k"]),
                                              "--max-users", str(P["max_users"])])
    out["evaluate_baseline"] = last_json("evaluate_baseline")
    out["evaluate_baseline_users_per_s"] = (out["evaluate_baseline"]["n_users"]
                                            / ev.seconds)

    out["seconds"] = seconds
    out["launches_by_stage"] = {k: v for k, v in launches.items() if any(v.values())}
    total = {k: sum(v[k] for v in launches.values()) for k in pipeline_launches()}
    out["launches"] = total
    check(all(v > 0 for v in total.values()), f"the pipeline missed a kernel: {total}")
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["host_rss_mib"], out["host_peak_rss_mib"] = host_rss_mib()
    shutil.rmtree(root)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import _build, cuda_scores, cuda_sgd, ials
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    secs = _build.build(sources)
    ptxas = ptxas_summary(_build.build_logs.values())
    emit({"phase": "build", "sources": sources, "seconds": secs,
          "ptxas": ptxas})
    spilled = [k for k in ptxas if k[2] and any(
        n in k[0] for n in ("score_stream", "score_tile", "gj_inverse",
                            "sgd_step_kernel", "step_finish", "segsum",
                            "apply_"))]
    check(not spilled, f"the scorer, the GJ leaf, the SGD step, the segment "
                       f"sum or the apply spills: {spilled}")

    # -- serving (slice 1) -------------------------------------------------
    rng = np.random.default_rng(args.seed)
    worst = phase_compare(torch, rng, SGDConfig, cuda_scores)

    cuda_scores.reset_launches()
    launches = lambda: cuda_scores.launches  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    models = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        for kernel in ("sigmoid", "rbf"):
            models[kernel], out = phase_serve(torch, rng, kernel, tmpdir, launches)
            emit(out)
    main_path_launches = launches()
    check(main_path_launches > 0, "the serving path launched no kernel")
    latency = {k: phase_latency(torch, rng, m) for k, m in models.items()}
    latency["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    emit({"phase": "latency", **latency})
    models.clear()

    timer = Timer(torch)
    rows = phase_kernel_times(torch, rng, SGDConfig, cuda_scores, timer)
    head = next(r for r in rows if r["B"] == 256 and r["kernel"] == "sigmoid"
                and r["dtype"] == "float32")

    # -- training (slice 2): data and packs, made once ---------------------
    t0 = time.perf_counter()
    u3, i3, r3 = gen_ratings(N_USERS, N_ITEMS, N_RATINGS + N_HELD_OUT,
                             args.seed)
    data3 = (u3[:N_RATINGS], i3[:N_RATINGS], r3[:N_RATINGS],
             u3[N_RATINGS:], i3[N_RATINGS:])
    t_config3 = time.perf_counter() - t0
    head_data = headline_ratings(args.seed)
    small = gen_ratings(5000, 3000, 200_000, args.seed + 1)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "config3_seconds": t_config3,
          "config3_ratings": N_RATINGS, "held_out": N_HELD_OUT,
          "config3_users_rated": int(np.unique(data3[0]).size)})
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        emit(phase_host_native(torch, data3, tmpdir, args.seed))
    packs, pack_seconds = {}, {}
    for name, (u, i, r), bs in (
            ("sigmoid", data3[:3], CONFIG3["sigmoid"]["batch_size"]),
            ("rbf", data3[:3], CONFIG3["rbf"]["batch_size"]),
            ("headline", head_data, HEAD["batch_size"]),
            ("small", small, 16_384)):
        t0 = time.perf_counter()
        packs[name] = sgd.pack_ratings(u, i, r, bs, order="auto", device="cuda")
        torch.cuda.synchronize()
        pack_seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packs["skewed"] = skewed_pack(N_USERS, N_ITEMS,
                                  CONFIG3["sigmoid"]["batch_size"], args.seed)
    pack_seconds["skewed"] = time.perf_counter() - t0
    emit({"phase": "pack", "seconds": pack_seconds,
          "primary": {k: v.primary for k, v in packs.items()},
          "n_batches": {k: v.n_batches for k, v in packs.items()}})

    cases = [
        ("config3_sigmoid", sgd_cfg("sigmoid", N_FACTORS, 0.01, 2_097_152),
         packs["sigmoid"], 0, N_USERS, N_ITEMS),
        ("config3_rbf", sgd_cfg("rbf", N_FACTORS, 0.05, 1_048_576),
         packs["rbf"], 0, N_USERS, N_ITEMS),
        ("config3_skewed", sgd_cfg("sigmoid", N_FACTORS, 0.01, 2_097_152),
         packs["skewed"], 0, N_USERS, N_ITEMS),
        ("headline_linear", sgd_cfg("linear", HEAD["n_factors"], HEAD["lr"],
                                    HEAD["batch_size"], reg=HEAD["reg"]),
         packs["headline"], 0, HEAD["n_users"], HEAD["n_items"]),
        ("ragged_k126_sigmoid", sgd_cfg("sigmoid", 126, 0.05, 16_384),
         packs["small"], 1, 5000, 3000),
        ("frozen_items_sigmoid", sgd_cfg("sigmoid", HEAD["n_factors"], 0.05,
                                         HEAD["batch_size"],
                                         update_item_params=False),
         packs["headline"], 1, HEAD["n_users"], HEAD["n_items"]),
    ]
    # the sweep's own pack and launch plan (config 1: linear, k=100, bs
    # 4,096), at the grid's largest lr and reg; the last batch holds pads
    sweep_in = sweep_inputs(args.seed)
    sweep_cfg = dataclasses.replace(sweep_in["cfg"], lr=0.05, reg=0.5)
    cases += [(f"config1_sweep_linear_batch{k}", sweep_cfg, sweep_in["data"],
               k, sweep_in["n_users"], sweep_in["n_items"])
              for k in (0, sweep_in["data"].n_batches - 1)]
    check(packs["headline"].primary == "item", "the headline pack is item-primary")
    sgd_worst = phase_compare_sgd(torch, rng, cases)

    train_launches = {"sgd_step": 0, "segment_apply": 0}
    for kernel in ("sigmoid", "rbf"):
        out = phase_train(torch, rng, kernel, data3, packs[kernel],
                          pack_seconds[kernel], args.seed)
        for k in train_launches:
            train_launches[k] += out["launches"][k]
        emit(out)
    check(all(v > 0 for v in train_launches.values()),
          f"the training path missed a kernel: {train_launches}")

    t0 = time.perf_counter()
    golden = phase_golden(torch)
    golden["seconds"] = time.perf_counter() - t0
    emit(golden)
    emit(phase_train_headline(torch, head_data, packs["headline"],
                              pack_seconds["headline"], args.seed, smi))
    sgd_rows = phase_sgd_kernel_times(torch, rng, [
        (name, cases[k][1], packs[pk], *cases[k][4:])
        for name, k, pk in (("config3_sigmoid", 0, "sigmoid"),
                            ("config3_rbf", 1, "rbf"),
                            ("config3_skewed", 2, "skewed"),
                            ("headline_linear", 3, "headline"))] + [
        ("config1_sweep_linear", sweep_cfg, sweep_in["data"],
         sweep_in["n_users"], sweep_in["n_items"])], timer)

    # -- factor ALS (slice 3) ------------------------------------------------
    packs.clear()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    buckets = ials.group_both_sides_bucketed(*data3[:3], N_USERS, N_ITEMS)
    torch.cuda.synchronize()
    emit({"phase": "als_pack", "seconds": time.perf_counter() - t0,
          "chunks": [[(int(b.other_ids.shape[0]), int(b.other_ids.shape[1]))
                      for b in side] for side in buckets]})
    # the leaves of the first full user chunk's solve against the seeded
    # initial item table (the first sweep of a fit)
    cfg_als = SGDConfig(kernel="linear", n_factors=ALS["n_factors"],
                        reg=ALS["reg"], min_rating=0.5, max_rating=5.0)
    p_init = sgd.init_params(torch.Generator(device="cuda").manual_seed(args.seed),
                             N_USERS, N_ITEMS, cfg_als, float(data3[2].mean()))
    ch = first_full_chunk(buckets[0])
    A, _ = ials.normal_equations(p_init.item_features, ch.other_ids, ch.ratings,
                                 ch.mask, p_init.global_mean, cfg_als, "user",
                                 reg_scale=ALS["reg_scale"])
    real = list(zip(("config3_chunk_A11", "config3_chunk_schur"),
                    chunk_leaves(torch, A)))
    del A, p_init
    spd_worst = phase_compare_spd(torch, gen, real)
    del real
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        train_als = phase_train_als(torch, rng, data3, args.seed, tmpdir)
    emit(train_als)
    emit(phase_als_sweeps(torch, data3, buckets, args.seed))
    del buckets
    torch.cuda.empty_cache()
    warm = phase_warm_start(torch, data3, args.seed)
    emit(warm)
    implicit = phase_implicit(torch, args.seed)
    emit(implicit)
    spd_rows = phase_spd_kernel_times(torch, gen, timer)
    spd_launches = {"train_als": train_als["launches"],
                    "warm_start": warm["launches"]["spd_gj"],
                    "implicit": implicit["launches"]}
    # -- BPR, SVD++, NMF and Popularity at the MovieLens-25M shape -----------
    t0 = time.perf_counter()
    fam_pack = sgd.pack_ratings(*data3[:3], FAM["batch_size"],
                                shuffle_seed=args.seed, order="user",
                                device="cuda")
    torch.cuda.synchronize()
    fam_pack_seconds = time.perf_counter() - t0
    fam = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        for family in ("BPR", "SVDpp", "NMF"):
            fam[family] = phase_family(torch, rng, family, data3, fam_pack,
                                       fam_pack_seconds, tmpdir, args.seed)
            emit(fam[family])
        emit(phase_popularity(rng, data3, tmpdir))
    fam_rows = phase_family_kernel_times(torch, rng, fam_pack, timer)
    del fam_pack
    torch.cuda.empty_cache()
    # -- sparse-gram top-k CF at config 4 ------------------------------------
    emit(phase_cf_topk(torch, rng, data3))
    torch.cuda.empty_cache()

    # -- bias, neighbourhood and content models, the sweep -----------------
    t0 = time.perf_counter()
    train1m, held1m = ml1m_ratings(args.seed)
    emit({"phase": "ml1m_data", "seconds": time.perf_counter() - t0, **ML1M})
    segsum_worst = phase_compare_segsum(torch, rng, train1m)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        baseline = phase_baseline(torch, rng, train1m, held1m, tmpdir,
                                  args.seed)
    emit(baseline)
    emit(phase_cf(torch, rng, train1m))
    content = phase_content(torch, rng, train1m, held1m, args.seed)
    emit(content)
    sweep_out = phase_sweep(torch, sweep_in, args.seed)
    emit(sweep_out)
    segsum_rows = phase_segsum_kernel_times(torch, rng, train1m, timer)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        ease_out, ease_launches, leaves = phase_ease(torch, rng, train1m, tmpdir,
                                                     args.seed)
    emit(ease_out)
    spd_launches["ease"] = sum(ease_launches.values())
    ease_rows, ease_worst = phase_ease_leaf_times(torch, leaves, timer)
    spd_rows += ease_rows
    spd_worst = max(spd_worst, ease_worst)
    del leaves
    # -- the recipe recommender's serving path at RecipeNLG's catalog --------
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        recipe = phase_recipe_serve(torch, rng, train1m, tmpdir, args.seed, timer)
    emit(recipe)
    # -- the batch pipeline at MovieLens-25M -----------------------------------
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        pipeline = phase_pipeline(torch, rng, data3, tmpdir, args.seed)
    emit(pipeline)
    del data3
    pipe_launches = pipeline["launches"]
    for name in sgd_worst:
        sgd_worst[name] = max(sgd_worst[name], recipe["compare_sgd"][name])
    segsum_launches = {"baseline_als": baseline["launches"]["als"],
                       "baseline_sgd": baseline["launches"]["sgd"],
                       "content": content["launches"]}
    check(all(v > 0 for v in segsum_launches.values()),
          f"a path of the slice missed the segment sum: {segsum_launches}")
    segsum_launches["nmf"] = fam["NMF"]["launches"]
    segsum_launches["pipeline"] = pipe_launches["segment_sum"]

    kernels = [{
        "name": "score_catalog", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/score_catalog.cu",
        "replaces": "matrix_factorization_tpu/ops/pallas_scores.py:34",
        "launches": (main_path_launches + sweep_out["launches"]["score_catalog"]
                     + sum(f["score_launches"] for f in fam.values())
                     + pipe_launches["score_catalog"]),
        "launches_by_path": {"serve": main_path_launches,
                             "sweep": sweep_out["launches"]["score_catalog"],
                             **{k.lower(): f["score_launches"]
                                for k, f in fam.items()},
                             "pipeline": pipe_launches["score_catalog"]},
        "max_abs_err": worst,
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("B", "I", "Kp", "kernel", "dtype")},
        "shapes": rows, "serving": latency,
    }]
    for name, source, replaces, note in (
            ("sgd_step", "sgd_step.cu",
             "matrix_factorization_tpu/ops/pallas_sgd.py:65",
             "the fused mini-batch step (_step_kernel)"),
            ("segment_apply", "segment_sum.cu",
             "matrix_factorization_tpu/ops/segment_sgd.py:923",
             "the secondary apply (tile_sec_scatter), an XLA scatter on the "
             "TPU and not a Pallas kernel; the port needs it deterministic")):
        row = sgd_rows["config3_sigmoid"][name]
        by_path = {"train": train_launches[name],
                   "sweep": sweep_out["launches"][name],
                   "recipe_serve": recipe["launches"][name],
                   "pipeline": pipe_launches[name]}
        if name == "segment_apply":
            by_path.update(bpr=fam["BPR"]["launches"],
                           svdpp=fam["SVDpp"]["launches"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"matrix_factorization_tpu_torch/csrc/{source}",
            "replaces": replaces, "note": note,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": sgd_worst[name], "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in ("bs", "Kp", "kernel", "primary",
                                          "runs_prim", "runs_sec")},
            "shapes": [rows_[name] for rows_ in sgd_rows.values()],
            "family_shapes": [r for r in fam_rows if r["name"] == name]})
    row = spd_rows[0]
    kernels.append({
        "name": "spd_gj", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/spd_gj.cu",
        "replaces": "matrix_factorization_tpu/ops/pallas_spd.py:56",
        "note": "the Gauss-Jordan SPD leaf (_gj_kernel) of every ALS solve",
        "launches": sum(spd_launches.values()),
        "launches_by_path": spd_launches, "max_abs_err": spd_worst,
        "ms": row["ms"], "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": {"E": row["E"], "d": row["d"]}, "shapes": spd_rows})
    row = next(r for r in segsum_rows if r["shape"] == "ml1m_by_user")
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/segment_sum.cu",
        "replaces": "matrix_factorization_tpu/ops/als.py:75",
        "note": "jax.ops.segment_sum and .at[].add of the bias, count and "
                "profile sums (XLA scatters, not a Pallas kernel); the port "
                "needs them deterministic",
        "launches": sum(segsum_launches.values()),
        "launches_by_path": segsum_launches, "max_abs_err": segsum_worst,
        "ms": row["ms"], "kernel_ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": {k: row[k] for k in ("n", "d", "rows")}, "shapes": segsum_rows,
        "family_shapes": [r for r in fam_rows if r["name"] == "segment_sum"]})
    emit({"kernels": kernels, "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
