"""The traced stretch of a run: a ``torch.profiler`` trace of CPU and CUDA
activity, reduced to what the per-layer metrics read.

``device_time`` is a copy of ``chip_smoke.py::device_time``: the device's
kernel, copy and memset intervals from the exported Chrome trace, the
seconds of each name and the union of the intervals (busy time). The rest
of the window is idle, waiting on the host; each idle gap is named by the
innermost host event that spans its middle. The window is the trace's own:
from the start of the harness's first span to the end of its last, so
that busy time and window are read on one clock.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the harness's spans: ``record_function`` ranges named ``pb:<name>``
SPAN_PREFIX = "pb:"


def device_time(events):
    """The device's work in a Chrome trace's ``events``: its kernel, copy
    and memset intervals ((start, end, name), microseconds, by start), the
    milliseconds of each name, and the busy microseconds (the union of the
    intervals)."""
    ev = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                for e in events if e.get("ph") == "X"
                and e.get("cat") in DEVICE_CATS)
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


def _union(ev) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e, _ in ev:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceView:
    """What a per-layer metric reads: the traced window's seconds (the
    trace's timeline, from the first span's start to the last span's end),
    the device's busy seconds inside it and seconds by operation name, the
    launches of each kernel name, the calls of each host operator, the
    harness's spans, and ``work``, the driver's count of what the traced
    stretch did (units, shapes, necessary operations and bytes)."""

    window_s: float
    busy_s: float
    device_ops: Dict[str, float]  # name -> seconds
    kernel_ops: Dict[str, float]  # kernels only, name -> seconds
    kernel_launches: Dict[str, int]  # kernel name -> launches
    host_calls: Dict[str, int]  # host operator (``aten::mm``) -> calls
    spans: List[Tuple[str, float, float]]  # (name, start s, end s)
    busy_in_spans: Dict[str, float]  # span name -> device busy s inside
    idle_gaps: List[Tuple[str, float]]  # (host activity, seconds), summed
    work: dict = field(default_factory=dict)

    def kernel_seconds(self, pattern: str, exclude: Optional[str] = None) -> float:
        """Seconds of the kernels whose name matches ``pattern`` (a regular
        expression, searched) and not ``exclude``."""
        rx = re.compile(pattern)
        ex = re.compile(exclude) if exclude else None
        return sum(s for n, s in self.kernel_ops.items()
                   if rx.search(n) and not (ex and ex.search(n)))

    def launches(self, pattern: str, exclude: Optional[str] = None) -> int:
        """Launches of the kernels whose name matches ``pattern`` and not
        ``exclude``."""
        rx = re.compile(pattern)
        ex = re.compile(exclude) if exclude else None
        return sum(c for n, c in self.kernel_launches.items()
                   if rx.search(n) and not (ex and ex.search(n)))

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in self.idle_gaps[:10]]}


def reduce_trace(events: list, work: Optional[dict] = None) -> TraceView:
    """Reduce a Chrome trace's events to a ``TraceView``. The window runs
    from the first of the harness's spans to the end of the last (without
    spans, from the device's first interval to its last)."""
    ev, by_name_ms, _ = device_time(events)
    kernels: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    calls: Dict[str, int] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"] / 1e6
            launches[e["name"]] = launches.get(e["name"], 0) + 1
        elif e.get("cat") == "cpu_op":
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    spans = sorted((e["name"][len(SPAN_PREFIX):], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(SPAN_PREFIX))
    busy = _union(ev)
    bs = np.array([s for s, _ in busy]) if busy else np.zeros(0)
    be = np.array([e for _, e in busy]) if busy else np.zeros(0)

    def busy_between(a: float, b: float) -> float:
        if not len(bs):
            return 0.0
        return float(np.clip(np.minimum(be, b) - np.maximum(bs, a), 0, None).sum())

    lo = spans[0][1] if spans else (busy[0][0] if busy else 0.0)
    hi = max(b for _, _, b in spans) if spans else (busy[-1][1] if busy else 0.0)
    in_spans: Dict[str, float] = {}
    for name, a, b in spans:
        in_spans[name] = in_spans.get(name, 0.0) + busy_between(a, b) / 1e6

    # idle gaps inside the traced stretch, named by the innermost host
    # event at each gap's middle; the 512 longest are named, the rest
    # summed under their own name
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    hs = np.array([h[0] for h in host]) if host else np.zeros(0)
    he = np.array([h[1] for h in host]) if host else np.zeros(0)
    edges = [lo] + [min(max(x, lo), hi) for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = {}
    for n, (a, b) in enumerate(gaps):
        name = "other gaps"
        if n < 512 and len(hs):
            mid = (a + b) / 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = ("host (no traced event)" if not len(cover) else
                    host[int(cover[np.argmin(he[cover] - hs[cover])])][2])
        named[name] = named.get(name, 0.0) + (b - a) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])
    return TraceView(
        window_s=(hi - lo) / 1e6, busy_s=busy_between(lo, hi) / 1e6,
        device_ops={n: ms / 1e3 for n, ms in by_name_ms.items()},
        kernel_ops=kernels, kernel_launches=launches, host_calls=calls,
        spans=[(n, a / 1e6, b / 1e6) for n, a, b in spans],
        busy_in_spans=in_spans, idle_gaps=idle, work=dict(work or {}))


class Profiled:
    """``with Profiled(torch) as p: ...`` traces CPU and CUDA activity;
    afterwards ``p.events`` holds the Chrome trace's events (the block
    ends in a device synchronize, so that every kernel it launched is in
    the trace). The trace file goes to the temporary directory and is
    removed."""

    def __init__(self, torch, device: str = "cuda"):
        self.torch = torch
        self.device = device
        self.events: list = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device == "cuda":
            self.torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = json.load(f)["traceEvents"]
            finally:
                os.unlink(path)
        return False
