"""The yardstick's arithmetic and the per-layer readers on hand-worked
values."""

from __future__ import annotations

import pytest

from portbench import common, roofline
from portbench.trace import TraceView, reduce_trace


def view(**kw):
    base = dict(window_s=1.0, busy_s=0.5, device_ops={}, kernel_ops={},
                kernel_launches={}, host_calls={}, spans=[], busy_in_spans={},
                idle_gaps=[], work={})
    base.update(kw)
    return TraceView(**base)


def reader(name):
    read = common.load_module(common.metric_path(name), "m_" + name).read
    return lambda t: read(t, None)


def test_least_seconds_names_the_binding_side():
    assert roofline.least_seconds(67e12, 1.0) == (1.0, "operations")
    assert roofline.least_seconds(1.0, 3.35e12) == (1.0, "bytes")


def test_sgd_bounds_by_hand():
    # n 4, Kp 128 (512 B a row), 2 primary runs, 3 secondary runs
    b = roofline.sgd_bounds(4, 128, 2, 3)
    step_bytes = 4 * 16 + 3 * 512 + 2 * 2 * 512 + 4 * 512
    apply_bytes = 4 * (512 + 8) + 2 * 3 * 512
    assert b["sgd_step"][2] == step_bytes == 5696
    assert b["segment_apply"][2] == apply_bytes == 5152
    assert b["sgd_step"][0] == pytest.approx(step_bytes / 3.35e12 * 1e3)
    assert b["sgd_step"][1] == "bytes"


def test_spd_bound_by_hand():
    ms, by = roofline.spd_bound(1000, 100)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * 100**3 * 1000 / 67e12 * 1e3)


def test_work_counts_by_hand():
    # one batch of 10 entries, 3 users, 2 items, k 4: rows of 5 floats
    flops, nbytes = roofline.sgd_epoch_work([(10, 3, 2)], 4)
    assert nbytes == 2 * 5 * 20 + 160 and flops == 8 * 4 * 10
    flops, nbytes = roofline.als_epoch_work(10, 3, 2, 1)  # d = 2
    assert flops == 2 * (2 * 4 * 10) + 5 * (8 / 3 + 8)
    assert nbytes == 2 * 12 * 10 + 2 * 5 * 2 * 4
    assert roofline.search_work(2, 1000, 4, 3) == (16000, 16000 + 32 + 72)
    assert roofline.gemm_work(2, 1000, 4) == (16000, 16000 + 32 + 8000)
    assert roofline.topk_work(2, 1000, 3) == (2000, 8000 + 72)


def test_train_mfu_by_hand():
    # an epoch needs 10 ms at the f32 peak; two epochs in 0.1 s: 20%
    t = view(window_s=0.1, work={"epochs": 2, "epoch_flops": 67e12 * 0.01,
                                 "epoch_bytes": 1.0})
    assert reader("train_mfu")(t) == pytest.approx(20.0)
    assert reader("train_mfu")(view()) is None


def test_search_mfu_by_hand():
    # bytes-bound: 16,104 bytes at 3.35 TB/s per call, 4 calls in 1 ms
    t = view(window_s=1e-3, work={"calls": 4, "call_work": roofline.search_work(2, 1000, 4, 3)})
    assert reader("search_mfu")(t) == pytest.approx(100 * 4 * 16104 / 3.35e12 / 1e-3)


def test_kernel_rooflines_by_hand():
    t = view(kernel_ops={"void (anonymous namespace)::sgd_step_kernel<1, 2>(float)": 0.002,
                         "void step_finish_kernel<2>(float*)": 0.0005,
                         "void apply_chunk_kernel<2>(float*)": 0.001,
                         "void gj_inverse_kernel<16, 7, 1>(float const*)": 0.004,
                         "sm80_xmma_gemm_f32f32_f32f32": 0.003,
                         "void gemv2T_kernel_val<int>": 0.001,
                         "void cub::DeviceRadixSortOnesweepKernel": 0.002},
             work={"sgd_step_bound_s": 0.001, "sgd_apply_bound_s": 0.0005,
                   "gj_bound_s": 0.001, "calls": 2,
                   "gemm_work": (0.0, 3.35e12 * 0.001), "topk_work": (0.0, 3.35e12 * 0.0005)})
    assert reader("sgd_step_roofline")(t) == pytest.approx(40.0)
    assert reader("sgd_apply_roofline")(t) == pytest.approx(50.0)
    assert reader("gj_roofline")(t) == pytest.approx(25.0)
    # 2 calls of 1 ms over 4 ms of GEMM and GEMV
    assert reader("search_gemm_roofline")(t) == pytest.approx(50.0)
    # everything but the products: 2 + 0.5 + 1 + 4 + 2 ms; 2 calls of 0.5 ms
    assert reader("topk_roofline")(t) == pytest.approx(100 * 0.001 / 0.0095)
    assert reader("sgd_step_roofline")(view(work={"sgd_step_bound_s": 1.0})) is None


def test_idle_and_host_readers_by_hand():
    t = view(window_s=2.0, busy_s=1.5, work={"epochs": 1, "calls": 2},
             spans=[("unit", 0.0, 0.004), ("unit", 0.01, 0.012)],
             busy_in_spans={"unit": 0.003})
    assert reader("device_idle_share.train")(t) == pytest.approx(25.0)
    assert reader("device_idle_share.search")(t) == pytest.approx(25.0)
    assert reader("search_host_ms")(t) == pytest.approx(1e3 * (0.006 - 0.003) / 2)


def test_reduce_trace_by_hand():
    X = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat,  # noqa: E731
                                     "ts": ts, "dur": dur}
    # the profiler's own start ([-50, -40]) and the block's closing
    # synchronize (up to 130) lie outside the window of the spans
    events = [X("pb:unit", "user_annotation", 0, 100),
              X("k0", "kernel", -50, 10),
              X("k1", "kernel", 10, 10), X("k2", "kernel", 15, 15),
              X("Memcpy DtoH", "gpu_memcpy", 60, 10), X("k1", "kernel", 95, 35),
              X("aten::nonzero", "cpu_op", 35, 20), X("host_wait", "cpu_op", 30, 40)]
    t = reduce_trace(events, work={"calls": 1})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)  # [10, 30], [60, 70] and [95, 100]
    assert t.kernel_launches == {"k0": 1, "k1": 2, "k2": 1}
    assert t.launches(r"k[12]") == 3 and t.launches(r"k", exclude="0") == 3
    assert t.host_calls == {"aten::nonzero": 1, "host_wait": 1}
    assert t.kernel_ops["k2"] == pytest.approx(15e-6)
    assert t.busy_in_spans["unit"] == pytest.approx(35e-6)
    gaps = dict(t.idle_gaps)
    # [30, 60] at 45: aten::nonzero is the innermost; [0, 10] at 5 and
    # [70, 95] at 82.5 lie only inside the harness's span
    assert gaps["aten::nonzero"] == pytest.approx(30e-6)
    assert gaps["pb:unit"] == pytest.approx(35e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("tie", ["none", "straddling", "wide"])
def test_topk_tie_blocks_counts_the_program_s_tie_branch(tie):
    """The program's selection body, traced on the CPU: a row whose tie
    straddles the k-th score sends its block through a second top-k (or,
    past ``SELECT_MAX_TIED`` tied scores, a whole-row sort)."""
    import torch

    from matrix_factorization_tpu_torch.ops.scoring import SELECT_MAX_TIED, _select_topk
    from portbench.trace import Profiled

    s = torch.randn(6, 2 * SELECT_MAX_TIED, generator=torch.Generator().manual_seed(0))
    if tie == "straddling":
        s[2, :50] = torch.topk(s[2], 10).values[-1]
    elif tie == "wide":
        s[1] = 0.5
    with Profiled(torch, "cpu") as prof:
        for _ in range(2):  # two calls of one block each
            _select_topk(s, 10)
    t = reduce_trace(prof.events, work={"calls": 2})
    assert reader("topk_tie_blocks")(t) == (0.0 if tie == "none" else 1.0)
    assert reader("topk_tie_blocks")(view(work={"calls": 2})) is None
