#!/usr/bin/env python3
"""Probe the catalog scorer's two paths and the designs of the SGD step,
the segment sum and the apply, and hold each against another build of
its source, on one CUDA GPU.

    python3 tools/probe_kernels.py [--phases paths,scorer,spd,sgd,segsum]
        [--old-src DIR] [--variants L:STAGES[:FLAG...],...]
        [--segsum-variants NAME=VALUE[:NAME=VALUE...],...] [--out FILE]
        [--seed N]

1. build: the port's sources, with the ptxas lines (registers, spills).
2. paths: at config 3's serving width (I = 59,392, Kp = 256), sigmoid,
   f32 and bf16 tables, the streaming plans (2, 3 and 4 stages) and the
   tiled plan timed against each other for B from 1 to 256 (CUDA events,
   median, L2 flushed), to place the boundary B_s
   (``ops/cuda_scores.py::STREAM_MAX_B``) and the stage count; and B=1
   f32 timed with the L2 flushed by a 256 MB write (``chip_smoke.Timer``),
   by a 256 MB read, and not flushed.
3. With ``--old-src DIR``: ``DIR/score_catalog.cu`` and ``DIR/spd_gj.cu``,
   sources of the same functions with the earlier C interface (no launch
   plan arguments), are built under other library names and called on
   the same inputs as the current kernels, at every shape of
   ``chip_smoke.py``'s compare and compare_spd phases: ``torch.equal``
   of the two outputs, their largest difference, and both kernels' times
   at the timed shapes.
4. sgd: one batch of each of ``chip_smoke.sgd_kernel_shapes`` (config 3
   sigmoid with uniform and with skewed ids, the headline linear batch),
   built directly from the seed, no 25M ratings. The step is held
   against ``plain_sgd_step`` (atol = rtol = 1e-5, primary table and dq)
   and against a second run of itself (``torch.equal``), with the
   primary side frozen (table untouched) and without dq; timed as
   called, without dq, with the secondary ids folded into a window of
   16,384 rows that stays in L2, and with both (what the dq stream and
   the gathers' misses cost), beside a fill of dq and a gather of the
   secondary rows into dq by PyTorch's own kernels (what the card takes
   to move the same bytes). With ``--old-src DIR`` holding an earlier
   ``sgd_step.cu`` (the 20-argument interface, no plan), that build runs
   on the same inputs: rows of runs inside one segment (summed in entry
   order by both) ``torch.equal``, every row within 1e-5, dq
   ``torch.equal``, and the same four timings.
   ``--variants 32:6,128:6,64:4:MF_GATHER_KEEP=1.0`` builds the current
   source with other segment lengths, stage counts and ``-D`` flags and
   times each at the same shapes.
5. segsum: the segment sum at every shape of ``chip_smoke.py``'s
   compare_segsum phase (MovieLens-1M shaped, from the seed) and the
   apply at the first batch of each shape of 4 (rows seeded normals),
   for the current build, for builds of ``csrc/segment_sum.cu`` with
   other ``MF_`` constants (``--segsum-variants
   ENTRIES_MAX_D=32,APPLY_CHUNK=64,APPLY_ROWS=8``) and, with ``--old-src
   DIR``, for an earlier ``DIR/segment_sum.cu`` (no layout argument) and
   the apply of an earlier ``DIR/sgd_step.cu`` (a warp a run): each
   bitwise against its plain order model and a second run, and timed in
   turns beside the plain version and ``index_add_``.

Each result is one JSON line on stdout and in ``--out``. Needs a GPU and
``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_out = None


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if _out is not None:
        _out.write(line + "\n")
        _out.flush()


def build_others(jobs):
    """Build ``{tag: (source file, extra nvcc flags)}`` under other library
    names, all at once; returns ``{tag: (library, nvcc log)}``."""
    from matrix_factorization_tpu_torch.ops import _build

    dst = _build.BUILD_DIR / "old"
    dst.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, flags) in jobs.items():
        lib = dst / f"lib{tag}.so"
        procs[tag] = (lib, src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for tag, (lib, src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({tag}):\n{log}")
        out[tag] = (ctypes.CDLL(str(lib)), log)
    return out


def phase_paths(torch, rng, timer):
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import cuda_scores as sc

    cfg = cs.score_cfg(SGDConfig, "sigmoid", 256)
    Q32 = torch.from_numpy(cs.ext_tables(rng, cs.N_ITEMS, cfg, "item")).to("cuda")
    P32 = torch.from_numpy(cs.ext_tables(rng, 256, cfg, "user")).to("cuda")
    mu = torch.tensor(3.5, device="cuda")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        Q, P = Q32.to(dtype), P32.to(dtype)
        size = Q.element_size()
        for B in (1, 4, 16, 17, 32, 64, 128, 256):
            pu = P[:B].contiguous()
            row = {"phase": "paths", "B": B, "dtype": str(dtype).split(".")[-1],
                   "plan": sc.score_plan(B, cs.N_ITEMS, 256, size, n_sms).path}
            want = sc.score_with_plan(cfg, mu, pu, Q, None)
            plans = {}
            users = next((u for u in sc.STREAM_USERS if u >= B), None)
            if users is not None:
                for stages in (2, 3, 4):
                    smem = sc.stream_smem(users, 256, stages)
                    if smem <= sc.SMEM_LIMIT:
                        plans[f"stream{stages}"] = sc.ScorePlan(
                            "stream", users, sc.STREAM_ITEMS, 128 // size, stages,
                            (min(-(-cs.N_ITEMS // sc.STREAM_ITEMS), n_sms), 1), smem)
            plans["tile"] = sc.ScorePlan(
                "tile", sc.TILE_M, sc.TILE_N, 128 // size, sc.TILE_STAGES,
                (-(-cs.N_ITEMS // sc.TILE_N), -(-B // sc.TILE_M)),
                sc.tile_smem(sc.TILE_STAGES))
            for name, plan in plans.items():
                got = sc.score_with_plan(cfg, mu, pu, Q, plan)
                row[f"{name}_equal"] = bool(torch.equal(got, want))
                row[f"{name}_ms"] = timer.ms(
                    lambda plan=plan: sc.score_with_plan(cfg, mu, pu, Q, plan))
            row["bound_ms"], row["bound_by"] = cs.bound(
                B, cs.N_ITEMS, 256, "sigmoid", str(dtype).split(".")[-1])
            emit(row)
    # what the flush costs the timed call: a written flush leaves the L2
    # full of dirty lines that the kernel's reads then evict to memory
    pu = P32[:1].contiguous()
    call = lambda: sc.cuda_score_catalog(cfg, mu, pu, Q32)  # noqa: E731
    emit({"phase": "flush", "B": 1, "dtype": "float32",
          "write_flush_ms": timer.ms(call),
          "read_flush_ms": timer.ms(call, before=timer.flush.sum),
          "no_flush_ms": timer.ms(call, before=lambda: None),
          "write_flush_ms_again": timer.ms(call)})


def phase_old_scores(torch, rng, timer, old):
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import cuda_scores as sc

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old.mf_score_catalog.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                     cf, cf, cf, vp]
    old.mf_score_catalog.restype = ci

    def run_old(cfg, mu, pu, Q):
        out = torch.empty((pu.shape[0], Q.shape[0]), device="cuda")
        rc = old.mf_score_catalog(
            mu.data_ptr(), pu.data_ptr(), Q.data_ptr(), out.data_ptr(),
            pu.shape[0], Q.shape[0], pu.shape[1],
            {"linear": 0, "sigmoid": 1, "rbf": 2}[cfg.kernel],
            0 if pu.dtype == torch.float32 else 1, float(cfg.gamma),
            float(cfg.a), float(cfg.c),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old scorer failed: {rc}")
        return out

    shapes = list(cs.compare_shapes(sc.STREAM_MAX_B))
    shapes += [(B, cs.N_ITEMS, 256) for B in cs.SCORE_TIMED_B
               if (B, cs.N_ITEMS, 256) not in shapes]
    for B, I, kp in shapes:
        for kernel in ("linear", "sigmoid", "rbf"):
            cfg = cs.score_cfg(SGDConfig, kernel, kp)
            pu32 = torch.from_numpy(cs.ext_tables(rng, B, cfg, "user")).to("cuda")
            Q32 = torch.from_numpy(cs.ext_tables(rng, I, cfg, "item")).to("cuda")
            mu = torch.tensor(3.5, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                pu, Q = pu32.to(dtype), Q32.to(dtype)
                new = sc.cuda_score_catalog(cfg, mu, pu, Q)
                was = run_old(cfg, mu, pu, Q)
                diff = (new - was).abs()
                row = {"phase": "old_scores", "B": B, "I": I, "Kp": kp,
                       "kernel": kernel, "dtype": str(dtype).split(".")[-1],
                       "path": sc.score_plan(B, I, kp, pu.element_size()).path,
                       "equal": bool(torch.equal(new, was)),
                       "max_abs_diff": float(diff.max()),
                       "n_differ": int((diff > 0).sum())}
                if I == cs.N_ITEMS and B in cs.SCORE_TIMED_B:
                    row["new_ms"] = timer.ms(lambda: sc.cuda_score_catalog(cfg, mu, pu, Q))
                    row["old_ms"] = timer.ms(lambda: run_old(cfg, mu, pu, Q))
                    row["new_ms_again"] = timer.ms(
                        lambda: sc.cuda_score_catalog(cfg, mu, pu, Q))
                emit(row)


def phase_old_spd(torch, gen, timer, old):
    from matrix_factorization_tpu_torch.ops import cuda_spd

    vp, ci = ctypes.c_void_p, ctypes.c_int
    old.mf_gj_inverse.argtypes = [vp, vp, ctypes.c_longlong, ci, vp]
    old.mf_gj_inverse.restype = ci

    def run_old(A):
        out = torch.empty_like(A)
        rc = old.mf_gj_inverse(A.data_ptr(), out.data_ptr(), A.shape[0],
                               A.shape[-1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old GJ leaf failed: {rc}")
        return out

    for E, d in cs.SPD_SHAPES:
        A = cs.ridged_grams(torch, gen, E, d)
        new = cuda_spd.cuda_gj_inverse(A)
        was = run_old(A)
        diff = (new - was).abs()
        row = {"phase": "old_spd", "E": E, "d": d,
               "equal": bool(torch.equal(new, was)),
               "max_abs_diff": float(diff.max()), "n_differ": int((diff > 0).sum())}
        if (E, d) in cs.SPD_TIMED:
            row["new_ms"] = timer.ms(lambda: cuda_spd.cuda_gj_inverse(A))
            row["old_ms"] = timer.ms(lambda: run_old(A))
            row["new_ms_again"] = timer.ms(lambda: cuda_spd.cuda_gj_inverse(A))
            row["bound_ms"], row["bound_by"] = cs.spd_bound(E, d)
        emit(row)
        del A, new, was
        torch.cuda.empty_cache()


def step_caller(torch, lib, plan_of=None):
    """``fn(args, update_prim, write_dq) -> dq`` calling ``mf_sgd_step`` of
    ``lib`` on ``chip_smoke.step_args``' arguments: the earlier 20-argument
    interface, or (``plan_of(n, kp)`` given) the planned one."""
    vp, ci, cf, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
    base = [vp] * 10 + [cll, ci, ci, cf, cf, cf, cf, cf, ci]
    lib.mf_sgd_step.argtypes = base + (
        [vp] if plan_of is None else [vp, ci, cll, ci, ci, ci, vp])
    lib.mf_sgd_step.restype = ci

    def call(args, update_prim=True, write_dq=True):
        cfg, mu, P, S, pid, sid, r, w, pm, sm, lr, reg = args
        n, kp = pid.numel(), P.shape[1]
        dq = torch.empty((n, kp), device="cuda") if write_dq else None
        tail = [torch.cuda.current_stream().cuda_stream]
        scratch = None
        if plan_of is not None:
            plan = plan_of(n, kp)
            if update_prim:
                scratch = torch.empty(plan.scratch_shape, device="cuda")
            tail = [scratch.data_ptr() if update_prim else None, plan.seg_len,
                    plan.n_segments, plan.grid, plan.smem_bytes, plan.stages,
                    *tail]
        rc = lib.mf_sgd_step(
            mu.data_ptr(), P.data_ptr(), S.data_ptr(), pid.data_ptr(),
            sid.data_ptr(), r.data_ptr(), w.data_ptr(), pm.data_ptr(),
            sm.data_ptr(), dq.data_ptr() if write_dq else None, n, kp,
            {"linear": 0, "sigmoid": 1, "rbf": 2}[cfg.kernel],
            float(cfg.gamma), float(cfg.a), float(cfg.c), float(lr),
            float(reg), int(update_prim), *tail)
        if rc:
            raise RuntimeError(f"mf_sgd_step failed: {rc}")
        return dq

    return call


L2_WINDOW_ROWS = 16_384  # 16 MB of secondary rows at Kp 256: stays in L2


def step_timings(timer, call, args):
    """The step as called, without dq, with the secondary ids folded into
    ``L2_WINDOW_ROWS`` rows, and with both."""
    folded = list(args)
    folded[5] = args[5] % L2_WINDOW_ROWS
    return {
        "ms": timer.ms(lambda: call(args)),
        "no_dq_ms": timer.ms(lambda: call(args, write_dq=False)),
        "l2_window_ms": timer.ms(lambda: call(folded)),
        "l2_window_no_dq_ms": timer.ms(lambda: call(folded, write_dq=False)),
    }


def phase_sgd(torch, seed, timer, old_src, variants):
    import numpy as np

    from matrix_factorization_tpu_torch.ops import _build, cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    jobs = {}
    if old_src is not None and (old_src / "sgd_step.cu").exists():
        jobs["sgd_step_old"] = (old_src / "sgd_step.cu", [])
    for spec in variants:
        seg_len, stages, *flags = spec.split(":")
        jobs[f"sgd_step_{spec.replace(':', '_')}"] = (
            _build.CSRC / "sgd_step.cu",
            [f"-DMF_SEG_LEN={seg_len}", f"-DMF_STAGES={stages}",
             *(f"-D{f}" for f in flags)])
    built = build_others(jobs)
    callers = {"current": lambda args, update_prim=True, write_dq=True:
               cuda_sgd.cuda_sgd_step(*args, update_prim, write_dq)}
    for tag, (lib, log) in built.items():
        ptxas = [k for k in cs.ptxas_summary((log,)) if "step" in k[0]]
        emit({"phase": "sgd_build", "tag": tag,
              "registers": [min(k[1] for k in ptxas), max(k[1] for k in ptxas)],
              "spill_bytes": max(k[2] for k in ptxas)})
        if tag == "sgd_step_old":
            callers["old"] = step_caller(torch, lib)
        else:
            seg_len, stages = (int(x) for x in tag.split("_")[2:4])
            callers[tag[9:]] = step_caller(
                torch, lib, lambda n, kp, seg_len=seg_len, stages=stages:
                cuda_sgd.step_plan(n, kp, n_sms, seg_len, stages))

    rng = np.random.default_rng(seed)
    for shape, cfg, pack, n_users, n_items in cs.sgd_kernel_shapes(seed):
        b = sgd.batch_at(pack, 0)
        p0 = cs.random_params(torch, rng, cfg, n_users, n_items)
        prim = "user_features" if pack.primary == "user" else "item_features"
        ids = (b["u"] if pack.primary == "user" else b["i"]).long()
        bounds, runs_prim, runs_sec = cs.sgd_bounds(b, cfg.padded_factors,
                                                    pack.primary)
        n = ids.numel()
        new_run = torch.ones(n, dtype=torch.bool, device="cuda")
        new_run[1:] = ids[1:] != ids[:-1]
        starts = new_run.nonzero().squeeze(1)
        ends = torch.cat([starts[1:], starts.new_tensor([n])]) - 1
        row = {"phase": "sgd", "shape": shape, "kernel": cfg.kernel, "bs": n,
               "Kp": cfg.padded_factors, "primary": pack.primary,
               "runs_prim": runs_prim, "runs_sec": runs_sec,
               "longest_prim_run": int((ends - starts).max()) + 1,
               "bound_ms": bounds["sgd_step"][0],
               "bound_by": bounds["sgd_step"][1]}

        def run(call, **kw):
            p = cs.clone_params(p0)
            args, _, _ = cs.step_args(p, b, cfg, pack.primary)
            dq = call(args, **kw)
            torch.cuda.synchronize()
            return getattr(p, prim), dq

        P_plain, dq_plain = run(lambda args: cuda_sgd.plain_sgd_step(*args))
        results = {}
        for tag, call in callers.items():
            P_k, dq_k = run(call)
            P_again, dq_again = run(call)
            P_frozen, dq_frozen = run(call, update_prim=False)
            P_nodq, nodq = run(call, write_dq=False)
            res = {
                "P_max_abs_err": float((P_k - P_plain).abs().max()),
                "dq_max_abs_err": float((dq_k - dq_plain).abs().max()),
                "close": bool(
                    torch.allclose(P_k, P_plain, atol=1e-5, rtol=1e-5)
                    and torch.allclose(dq_k, dq_plain, atol=1e-5, rtol=1e-5)),
                "deterministic": bool(torch.equal(P_k, P_again)
                                      and torch.equal(dq_k, dq_again)),
                "frozen_ok": bool(torch.equal(P_frozen, getattr(p0, prim))
                                  and torch.equal(dq_frozen, dq_k)),
                "no_dq_ok": nodq is None and bool(torch.equal(P_nodq, P_k)),
            }
            results[tag] = (P_k, dq_k)
            del P_again, dq_again, P_frozen, dq_frozen, P_nodq
            row[tag] = res
        if "old" in results:
            for tag, (P_k, dq_k) in results.items():
                if tag == "old":
                    continue
                seg_len = (cuda_sgd.SEG_LEN if tag == "current"
                           else int(tag.split("_")[0]))
                # a run inside one segment is summed in entry order, as the
                # earlier kernel summed every run
                whole = ids[starts[starts // seg_len == ends // seg_len]]
                P_old, dq_old = results["old"]
                row[tag].update({
                    "runs_summed_whole": int(whole.numel()),
                    "whole_rows_equal_old": bool(
                        torch.equal(P_k[whole], P_old[whole])),
                    "all_rows_max_abs_diff_old": float(
                        (P_k - P_old).abs().max()),
                    "dq_equal_old": bool(torch.equal(dq_k, dq_old))})
        del results, P_plain, dq_plain
        torch.cuda.empty_cache()
        p = cs.clone_params(p0)
        args, _, _ = cs.step_args(p, b, cfg, pack.primary)
        # what the card takes to move the step's bytes with PyTorch's own
        # kernels: a fill of dq, and a gather of the secondary rows into dq
        buf = torch.empty((n, cfg.padded_factors), device="cuda")
        sid_long = args[5].long()
        row["fill_dq_ms"] = timer.ms(buf.zero_)
        row["gather_copy_ms"] = timer.ms(
            lambda: torch.index_select(args[3], 0, sid_long, out=buf))
        sid_long %= L2_WINDOW_ROWS
        row["gather_copy_l2_window_ms"] = timer.ms(
            lambda: torch.index_select(args[3], 0, sid_long, out=buf))
        del buf, sid_long
        order = list(callers) + list(reversed(callers))  # each twice, in turns
        for k, tag in enumerate(order):
            times = step_timings(timer, callers[tag], args)
            for name, ms in times.items():
                row[tag].setdefault(name, []).append(ms)
        emit(row)
        del p, p0, args
        torch.cuda.empty_cache()


def segsum_caller(torch, lib, entries_max_d=None):
    """``fn(out, vals, perm, ids)`` calling ``mf_segment_sum`` of ``lib``:
    the planned interface of a build with ``MF_ENTRIES_MAX_D =
    entries_max_d``, or (None) the earlier one without a layout."""
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mf_segment_sum.argtypes = [vp, vp, vp, vp, cll, ci, vp] + (
        [ci] if entries_max_d is not None else []) + [ci, cll, cll, cll, vp]
    lib.mf_segment_sum.restype = ci

    def call(out, vals, perm, ids):
        out2, vals2 = ss._as_2d(out, vals)
        n, d = vals2.shape
        plan = ss.segsum_plan(n, d, entries_max_d or 0)
        scratch = torch.empty(plan.scratch_shape, device="cuda")
        layout = ([] if entries_max_d is None
                  else [ss.LAYOUTS.index(plan.layout)])
        rc = lib.mf_segment_sum(
            out2.data_ptr(), vals2.data_ptr(), perm.data_ptr(),
            ids.data_ptr(), n, d, scratch.data_ptr(), *layout, plan.chunk,
            plan.n_chunks, plan.grid, plan.finish_grid,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"mf_segment_sum failed: {rc}")

    return call


def apply_caller(torch, lib, chunk=None):
    """``fn(table, rows, perm, ids)`` calling ``mf_segment_apply`` of
    ``lib``: the planned interface of a build with ``MF_APPLY_CHUNK =
    chunk``, or (None) the earlier one of ``sgd_step.cu`` (a warp a
    run)."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd

    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mf_segment_apply.argtypes = [vp, vp, vp, vp, cll, ci] + (
        [] if chunk is None else [vp, ci, cll, cll, cll]) + [vp]
    lib.mf_segment_apply.restype = ci

    def call(table, rows, perm, ids):
        n, kp = rows.shape
        tail = []
        if chunk is not None:
            plan = cuda_sgd.apply_plan(n, kp, chunk)
            scratch = torch.empty(plan.scratch_shape, device="cuda")
            tail = [scratch.data_ptr(), plan.chunk, plan.n_chunks, plan.grid,
                    plan.finish_grid]
        rc = lib.mf_segment_apply(
            table.data_ptr(), rows.data_ptr(), perm.data_ptr(),
            ids.data_ptr(), n, kp, *tail,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"mf_segment_apply failed: {rc}")

    return call


def phase_segsum(torch, seed, timer, old_src, variants):
    """The segment sum at ``chip_smoke.segsum_cases`` and the apply at
    the first batch of each ``chip_smoke.sgd_kernel_shapes`` (its rows
    seeded normals of the batch's shape), for the current build, builds
    of the current source with other ``-DMF_...`` constants
    (``variants``) and, from ``old_src``, the earlier ``segment_sum.cu``
    and ``sgd_step.cu``: each held bitwise to its plain order model
    ``segmented_segment_sum`` (the earlier apply: one piece a run) and to
    a second run, and timed in turns (each build twice, in the order
    A B .. B A), beside the plain version and ``index_add_``."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import _build
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    jobs = {}
    for name in ("segment_sum", "sgd_step"):
        if old_src is not None and (old_src / f"{name}.cu").exists():
            jobs[f"{name}_old"] = (old_src / f"{name}.cu", [])
    consts_of = {}  # tag -> {MF_ constant: value} of a variant build
    for spec in variants:
        consts = dict(kv.split("=") for kv in spec.split(":"))
        tag = "v_" + "_".join(f"{k.lower()}{v}" for k, v in consts.items())
        consts_of[tag] = consts
        jobs[tag] = (_build.CSRC / "segment_sum.cu",
                     [f"-DMF_{k}={v}" for k, v in consts.items()])
    built = build_others(jobs)
    # tag -> (caller, chunk and layout of its order model, or None)
    sums = {"current": (ss.cuda_segment_sum, ss.ENTRIES_MAX_D)}
    applies = {"current": (cuda_sgd.cuda_segment_apply, cuda_sgd.APPLY_CHUNK)}
    for tag, (lib, log) in built.items():
        emit({"phase": "segsum_build", "tag": tag,
              "ptxas": cs.ptxas_summary((log,))})
        if tag == "segment_sum_old":
            sums["old"] = (segsum_caller(torch, lib), 0)
        elif tag == "sgd_step_old":
            applies["old"] = (apply_caller(torch, lib), None)
        else:
            consts = consts_of[tag]
            max_d = int(consts.get("ENTRIES_MAX_D", ss.ENTRIES_MAX_D))
            chunk = int(consts.get("APPLY_CHUNK", cuda_sgd.APPLY_CHUNK))
            sums[tag[2:]] = (segsum_caller(torch, lib, max_d), max_d)
            applies[tag[2:]] = (apply_caller(torch, lib, chunk), chunk)

    def in_turns(calls):
        order = list(calls) + list(reversed(calls))
        out = {}
        for tag in order:
            out.setdefault(tag, []).append(timer.ms(calls[tag]))
        return out

    rng = np.random.default_rng(seed)
    train, _ = cs.ml1m_ratings(seed)
    for name, ids, n_rows, d in cs.segsum_cases(train, rng):
        ids_t = torch.from_numpy(np.asarray(ids, np.int32)).to("cuda")
        vals = torch.from_numpy(rng.standard_normal(
            (len(ids), d), dtype=np.float32)).to("cuda")
        order = ss.sorted_order(ids_t)
        row = {"phase": "segsum", "shape": name, "n": len(ids), "d": d,
               "rows": n_rows}
        row["bound_ms"], row["bound_by"] = cs.segsum_bound(order[1],
                                                           len(ids), d)
        for tag, (call, max_d) in sums.items():
            got, again, model = (torch.zeros((n_rows, d), device="cuda")
                                 for _ in range(3))
            call(got, vals, *order)
            call(again, vals, *order)
            layout = ss.segsum_plan(len(ids), d, max_d).layout
            ss.segmented_segment_sum(model, vals, *order, layout=layout)
            row[tag] = {"layout": layout,
                        "model_equal": bool(torch.equal(got, model)),
                        "deterministic": bool(torch.equal(got, again))}
        out = torch.zeros((n_rows, d), device="cuda")
        ids_l = ids_t.long()
        calls = {tag: (lambda c=c: c(out, vals, *order))
                 for tag, (c, _) in sums.items()}
        for tag, times in in_turns(calls).items():
            row[tag]["ms"] = times
        row["plain_ms"] = timer.ms(lambda: ss.plain_segment_sum(
            out, vals, *order))
        row["library_ms"] = timer.ms(lambda: out.index_add_(0, ids_l, vals))
        emit(row)
        del out, vals, got, again, model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for shape, cfg, pack, n_users, n_items in cs.sgd_kernel_shapes(seed):
        b = sgd.batch_at(pack, 0)
        kp = cfg.padded_factors
        n_sec = n_items if pack.primary == "user" else n_users
        n = b["sp"].numel()
        rows = 1e-3 * torch.randn((n, kp), device="cuda", generator=gen)
        table = torch.randn((n_sec, kp), device="cuda", generator=gen)
        bounds, _, runs_sec = cs.sgd_bounds(b, kp, pack.primary)
        row = {"phase": "apply", "shape": shape, "bs": n, "Kp": kp,
               "runs_sec": runs_sec, "longest_sec_run": cs.longest_run(b["ss"]),
               "bound_ms": bounds["segment_apply"][0],
               "bound_by": bounds["segment_apply"][1]}
        for tag, (call, chunk) in applies.items():
            got, again, model = (table.clone() for _ in range(3))
            call(got, rows, b["sp"], b["ss"])
            call(again, rows, b["sp"], b["ss"])
            ss.segmented_segment_sum(model, rows, b["sp"], b["ss"],
                                     chunk=chunk or n, layout="columns")
            row[tag] = {"chunk": chunk,
                        "model_equal": bool(torch.equal(got, model)),
                        "deterministic": bool(torch.equal(got, again))}
            del got, again, model
            torch.cuda.empty_cache()
        calls = {tag: (lambda c=c: c(table, rows, b["sp"], b["ss"]))
                 for tag, (c, _) in applies.items()}
        for tag, times in in_turns(calls).items():
            row[tag]["ms"] = times
        row["plain_ms"] = timer.ms(lambda: cuda_sgd.plain_segment_apply(
            table, rows, b["sp"], b["ss"]))
        rows_perm, ss_long = rows[b["sp"].long()], b["ss"].long()
        row["library_ms"] = timer.ms(
            lambda: table.index_add_(0, ss_long, rows_perm))
        emit(row)
        del rows, table, rows_perm, pack, b
        torch.cuda.empty_cache()


def main() -> int:
    global _out
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="paths,scorer,spd,sgd,segsum",
                    help="comma-separated: paths, scorer, spd, sgd, segsum")
    ap.add_argument("--old-src", type=Path, default=None)
    ap.add_argument("--variants", default="",
                    help="builds of the SGD step to time beside the current "
                         "one: L:STAGES[:FLAG...], comma-separated")
    ap.add_argument("--segsum-variants", default="",
                    help="builds of csrc/segment_sum.cu to time beside the "
                         "current one: NAME=VALUE[:NAME=VALUE...] of its "
                         "MF_ constants, comma-separated")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    from matrix_factorization_tpu_torch.ops import _build

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        _out = args.out.open("w")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__})
    sources = [name for name, used_by in (
        ("score_catalog", {"paths", "scorer"}), ("spd_gj", {"spd"}),
        ("sgd_step", {"sgd"}), ("segment_sum", {"segsum"}))
        if phases & used_by]
    secs = _build.build(sources)
    emit({"phase": "build", "seconds": secs,
          "ptxas": cs.ptxas_summary(_build.build_logs.values())})
    timer = cs.Timer(torch)
    rng = np.random.default_rng(args.seed)
    if "paths" in phases:
        phase_paths(torch, rng, timer)
    old = {} if args.old_src is None else build_others({
        f"{name}_old": (args.old_src / f"{name}.cu", [])
        for name, phase in (("score_catalog", "scorer"), ("spd_gj", "spd"))
        if phase in phases})
    if old:
        emit({"phase": "build_old",
              "ptxas": cs.ptxas_summary(log for _, log in old.values())})
    if "score_catalog_old" in old:
        phase_old_scores(torch, rng, timer, old["score_catalog_old"][0])
    if "spd_gj_old" in old:
        phase_old_spd(torch, torch.Generator(device="cuda").manual_seed(args.seed),
                      timer, old["spd_gj_old"][0])
    if "sgd" in phases:
        phase_sgd(torch, args.seed, timer, args.old_src,
                  [v for v in args.variants.split(",") if v])
    if "segsum" in phases:
        phase_segsum(torch, args.seed, timer, args.old_src,
                     [v for v in args.segsum_variants.split(",") if v])
    emit({"phase": "done", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
