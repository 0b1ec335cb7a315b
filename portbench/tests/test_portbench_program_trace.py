"""``portbench/program_trace.py`` on hand-built Chrome traces: device time
by correlation to the innermost program span, idle time by gap middle
with no cap, the accounting closing, the spans' readings, and the readers
that existed before the spans reading the same with and without them."""

from __future__ import annotations

import pytest

from portbench import common
from portbench.program_trace import (
    harness_window,
    reduce_program,
    span_readings,
    total,
)
from portbench.tests.test_portbench_metrics import reader
from portbench.trace import reduce_trace


def X(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def search_call():
    """One search call in a window of [0, 1000] us: the product, the
    selection with its sync and tie branch, the fetch; a kernel launched
    outside every span, one with no launch in the trace, and one before
    the window."""
    return [
        X("pb:unit", "user_annotation", 0, 1000),
        X("mf:search.gemm", "cpu_op", 10, 10),
        X("mf:topk.select", "cpu_op", 20, 180),
        X("mf:topk.sync", "cpu_op", 50, 100),
        X("mf:topk.ties", "cpu_op", 160, 30),
        X("mf:search.fetch", "cpu_op", 200, 700),
        X("aten::mm", "cpu_op", 11, 5),
        X("aten::nonzero", "cpu_op", 52, 96),
        X("aten::index_put_", "cpu_op", 185, 2),
        X("aten::index_put_", "cpu_op", 187, 2),
        X("cudaLaunchKernel", "cuda_runtime", 12, 1, corr=1),
        X("cudaLaunchKernel", "cuda_runtime", 25, 1, corr=2),
        X("cudaLaunchKernel", "cuda_runtime", 165, 1, corr=3),
        X("cudaMemcpyAsync", "cuda_runtime", 210, 100, corr=4),
        X("cuLaunchKernel", "cuda_driver", 950, 1, corr=5),
        X("cudaLaunchKernel", "cuda_runtime", -60, 1, corr=6),
        X("sm90_xmma_gemm_f32f32", "kernel", 30, 50, corr=1),
        X("radixSortKernel", "kernel", 80, 20, corr=2),
        X("gatherTopK", "kernel", 170, 10, corr=3),
        X("Memcpy DtoH", "gpu_memcpy", 300, 10, corr=4),
        X("tail_kernel", "kernel", 960, 10, corr=5),
        X("orphan_kernel", "kernel", 980, 5, corr=99),
        X("warm_kernel", "kernel", -50, 10, corr=6),
    ]


def training_epoch():
    """An SGD batch and an ALS bucket's normal equations and Schur level
    above a leaf, in a window of [0, 100] us."""
    return [
        X("pb:unit", "user_annotation", 0, 100),
        X("mf:sgd.step", "cpu_op", 0, 10), X("mf:sgd.apply", "cpu_op", 10, 10),
        X("mf:als.normal_eq", "cpu_op", 20, 10), X("mf:spd.schur", "cpu_op", 30, 30),
        X("mf:spd.leaf", "cpu_op", 40, 10),
        *(X("cudaLaunchKernel", "cuda_runtime", t, 1, corr=c)
          for t, c in ((5, 11), (15, 12), (25, 13), (35, 14), (45, 15))),
        X("sgd_step_kernel", "kernel", 10, 20, corr=11),
        X("apply_chunk_kernel", "kernel", 30, 10, corr=12),
        X("gemm", "kernel", 40, 10, corr=13),
        X("elementwise", "kernel", 50, 6, corr=14),
        X("gj_inverse_kernel", "kernel", 56, 4, corr=15),
    ]


def test_device_time_goes_to_the_innermost_span_by_correlation():
    p = reduce_program(search_call(), *harness_window(search_call()))
    sp = p["spans"]
    us = 1e-6
    assert sp["search.gemm"]["device_s"] == pytest.approx(50 * us)
    # launched inside topk.select, not inside its sync
    assert sp["topk.select"]["kernel_s"] == pytest.approx(20 * us)
    assert sp["topk.sync"]["device_s"] == 0
    assert sp["topk.ties"]["kernel_s"] == pytest.approx(10 * us)
    # a copy is device time, not kernel time
    assert sp["search.fetch"]["device_s"] == pytest.approx(10 * us)
    assert sp["search.fetch"]["kernel_s"] == 0
    # launched under no span, and with no launch; the warm-up kernel lies
    # before the window
    assert p["outside"]["device_s"] == pytest.approx(15 * us)
    assert p["outside"]["kernel_s"] == pytest.approx(15 * us)
    assert sp["topk.select"]["count"] == 1
    assert sp["topk.select"]["host_s"] == pytest.approx(180 * us)


def test_idle_goes_to_the_span_at_each_gap_middle():
    p = reduce_program(search_call(), 0, 1000)
    sp, us = p["spans"], 1e-6
    # [0, 30] at 15: the product's span; [100, 170] at 135: the sync;
    # [180, 300] and [310, 960]: the fetch; [970, 980], [985, 1000]: none
    assert sp["search.gemm"]["idle_s"] == pytest.approx(30 * us)
    assert sp["topk.sync"]["idle_s"] == pytest.approx(70 * us)
    assert sp["topk.select"]["idle_s"] == 0
    assert sp["search.fetch"]["idle_s"] == pytest.approx(770 * us)
    assert p["outside"]["idle_s"] == pytest.approx(25 * us)


@pytest.mark.parametrize("events", [search_call, training_epoch])
def test_the_accounting_closes(events):
    ev = events()
    lo, hi = harness_window(ev)
    p = reduce_program(ev, lo, hi)
    t = reduce_trace(ev)
    assert p["busy_s"] == pytest.approx(t.busy_s)
    assert p["idle_s"] == pytest.approx(t.window_s - t.busy_s)
    for key, whole in (("device_s", t.busy_s), ("idle_s", t.window_s - t.busy_s)):
        assert total(p, key) + p["outside"][key] == pytest.approx(whole)


def test_every_gap_counts_past_512():
    """600 gaps of 1 us between 1 us kernels, all launched in one span:
    ``reduce_trace`` names the 512 longest and sums the rest, the
    program's reduction attributes every one."""
    ev = [X("pb:unit", "user_annotation", 0, 1200), X("mf:search.gemm", "cpu_op", 0, 1200)]
    for j in range(600):
        ev += [X("cudaLaunchKernel", "cuda_runtime", j, 0.5, corr=j),
               X("k", "kernel", 2 * j + 1, 1, corr=j)]
    p = reduce_program(ev, *harness_window(ev))
    assert p["spans"]["search.gemm"]["idle_s"] == pytest.approx(600e-6)
    assert p["spans"]["search.gemm"]["kernel_s"] == pytest.approx(600e-6)
    assert dict(reduce_trace(ev).idle_gaps)["other gaps"] > 0


def test_innermost_among_siblings_and_nesting():
    """A launch after a closed sibling goes to the parent, not to the
    sibling; nested three deep goes to the deepest."""
    ev = [X("pb:unit", "user_annotation", 0, 100),
          X("mf:a", "cpu_op", 0, 100), X("mf:b", "cpu_op", 10, 10),
          X("mf:c", "cpu_op", 30, 40), X("mf:d", "cpu_op", 40, 10),
          X("cudaLaunchKernel", "cuda_runtime", 25, 1, corr=1),
          X("cudaLaunchKernel", "cuda_runtime", 45, 1, corr=2),
          X("cudaLaunchKernel", "cuda_runtime", 60, 1, corr=3),
          X("k1", "kernel", 70, 1, corr=1), X("k2", "kernel", 75, 2, corr=2),
          X("k3", "kernel", 80, 4, corr=3)]
    sp = reduce_program(ev, 0, 100)["spans"]
    assert {n: sp[n]["kernel_s"] * 1e6 for n in "abcd"} == pytest.approx(
        {"a": 1, "b": 0, "c": 4, "d": 2})


def test_span_readings_by_hand():
    ev = search_call()
    t = reduce_trace(ev, work={"calls": 1, "gemm_work": (0.0, 3.35e12 * 25e-6),
                               "topk_work": (0.0, 3.35e12 * 15e-6)})
    r = span_readings(t, reduce_program(ev, *harness_window(ev)))
    assert r["search_gemm_roofline.span"] == pytest.approx(50.0)  # 25 of 50 us
    assert r["topk_roofline.span"] == pytest.approx(50.0)  # 15 of 20 + 10 us
    assert r["topk_tie_blocks.span"] == 1.0
    assert r["search_idle_program_ms"] == pytest.approx(0.87)  # 30 + 70 + 770 us
    assert r["topk_idle_ms"] == pytest.approx(0.07)
    assert r["als_normal_eq_ms"] is None and r["sgd_step_roofline.span"] is None

    ev = training_epoch()
    t = reduce_trace(ev, work={"epochs": 2, "sgd_step_bound_s": 10e-6,
                               "sgd_apply_bound_s": 5e-6, "gj_bound_s": 1e-6})
    r = span_readings(t, reduce_program(ev, *harness_window(ev)))
    assert r["sgd_step_roofline.span"] == pytest.approx(50.0)
    assert r["sgd_apply_roofline.span"] == pytest.approx(50.0)
    assert r["gj_roofline.span"] == pytest.approx(25.0)
    assert r["als_normal_eq_ms"] == pytest.approx(0.005)
    # Schur's own 6 us, the leaf's 4 us excluded, over two epochs
    assert r["als_schur_ms"] == pytest.approx(0.003)
    assert r["search_gemm_roofline.span"] is None and r["topk_tie_blocks.span"] is None


def test_the_span_twins_match_the_name_matching_readers():
    ev = training_epoch()
    t = reduce_trace(ev, work={"epochs": 2, "sgd_step_bound_s": 10e-6,
                               "sgd_apply_bound_s": 5e-6, "gj_bound_s": 1e-6})
    r = span_readings(t, reduce_program(ev, *harness_window(ev)))
    for name in ("sgd_step_roofline", "sgd_apply_roofline", "gj_roofline"):
        assert r[name + ".span"] == pytest.approx(reader(name)(t))


@pytest.mark.parametrize("events", [search_call, training_epoch])
def test_existing_readers_read_the_same_without_the_spans(manifest, events):
    work = {"calls": 2, "epochs": 2, "epoch_flops": 1e6, "epoch_bytes": 1e6,
            "call_work": (1e6, 1e6), "gemm_work": (1e6, 1e6), "topk_work": (1e6, 1e6),
            "sgd_step_bound_s": 1e-6, "sgd_apply_bound_s": 1e-6, "gj_bound_s": 1e-6}
    ev = events()
    bare = [e for e in ev if not e["name"].startswith("mf:")]
    with_spans, without = reduce_trace(ev, work), reduce_trace(bare, work)
    read = 0
    for m in manifest["per_layer"]:
        if m["name"].endswith(".span"):
            continue
        fn = common.load_module(common.metric_path(m["name"]), "m_" + m["name"]).read
        a, b = fn(with_spans, None), fn(without, None)
        assert a == b, m["name"]
        read += a is not None
    assert read >= 5


@pytest.mark.parametrize("tie", ["none", "straddling", "wide"])
def test_tie_span_count_equals_the_operator_count(tie, monkeypatch):
    """The program's selection body, traced on the CPU: the span twin of
    ``topk_tie_blocks`` reads what the original reads."""
    import torch

    from matrix_factorization_tpu_torch.ops import scoring
    from matrix_factorization_tpu_torch.ops.scoring import SELECT_MAX_TIED, stable_topk
    from portbench.trace import Profiled

    monkeypatch.setattr(scoring, "SORT_MAX_SCORES", 1024)  # the selection body
    s = torch.randn(6, 2 * SELECT_MAX_TIED, generator=torch.Generator().manual_seed(0))
    if tie == "straddling":
        s[2, :50] = torch.topk(s[2], 10).values[-1]
    elif tie == "wide":
        s[1] = 0.5
    with Profiled(torch, "cpu") as prof:
        for _ in range(2):  # two calls of one selection block each
            with torch.autograd.profiler.record_function("pb:unit"):
                stable_topk(s, 10)
    t = reduce_trace(prof.events, work={"calls": 2})
    assert reader("topk_tie_blocks.span")(t) == reader("topk_tie_blocks")(t)
    assert reader("topk_tie_blocks.span")(t) == (0.0 if tie == "none" else 1.0)
    p = reduce_program(prof.events, *harness_window(prof.events))
    assert p["spans"]["topk.select"]["count"] == 2
    no_select = reduce_trace([e for e in prof.events
                              if not e.get("name", "").startswith("mf:")],
                             work={"calls": 2})
    assert reader("topk_tie_blocks.span")(no_select) is None
