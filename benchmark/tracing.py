"""The device trace of a run's traced requests: torch.profiler over them,
its Chrome trace written under TMPDIR, read back, and deleted.

From the trace: the union of the device's activity intervals (busy
seconds), the host-side kernel and graph launch calls, device time by
operation, and the idle gaps between device intervals named by what the
host was doing when the gap ended: the outermost ATen operation that
issued the launch that ended it, or, for a launch from outside ATen (the
port's ctypes kernels), the kernel's name.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # host clock over the traced requests, synchronized at both ends
    busy_s: float  # union of device activity intervals
    device_events: int
    launches: int  # host-side launch calls (LAUNCH_CALLS)
    requests: int  # requests inside the traced window
    device_ops: list  # [[name, seconds]], most time first
    idle_gaps: list  # [[host activity, seconds]], most time first


class Tracer:
    def __init__(self, device):
        self.device = torch.device(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.activities = acts
        self.prof = None
        self.t0 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        """Start and stop the profiler once, so that its own set-up (CUPTI)
        falls in the run's set-up and not in the traced window."""
        with torch.profiler.profile(activities=self.activities):
            torch.ones(8, device=self.device).sum().item()

    def start(self):
        self._sync()
        self.prof = torch.profiler.profile(activities=self.activities)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, requests: int) -> TraceSummary:
        self._sync()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return summarize(events, window, requests)


def _top(acc: dict) -> list:
    return [[name, sec] for name, sec in sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]]


def _outermost(ops: list) -> list:
    """The ops not inside another op of their thread, sorted by start."""
    out, end = [], -1.0
    for ts, te, name in sorted(ops):
        if ts >= end:
            out.append((ts, te, name))
            end = te
    return out


def summarize(events: list, window_s: float, requests: int) -> TraceSummary:
    dev, launches, n_launch, ops = [], {}, 0, collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name, (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver") and name in LAUNCH_CALLS:
            n_launch += 1
            launches[(e.get("args") or {}).get("correlation")] = (ts, e.get("tid"))
        elif cat == "cpu_op":
            ops[e.get("tid")].append((ts, ts + dur, name))
    top_ops = {tid: _outermost(v) for tid, v in ops.items()}
    starts = {tid: [o[0] for o in v] for tid, v in top_ops.items()}

    by_op = collections.defaultdict(float)
    for ts, te, name, _ in dev:
        by_op[name[:NAME_CHARS]] += (te - ts) * 1e-6

    dev.sort()
    busy, gaps = 0.0, collections.defaultdict(float)
    cur_s = cur_e = None
    for ts, te, name, corr in dev:
        if cur_e is None:
            cur_s, cur_e = ts, te
            continue
        if ts > cur_e:
            busy += cur_e - cur_s
            gaps[_host_activity(ts, name, corr, launches, top_ops, starts)] += (ts - cur_e) * 1e-6
            cur_s, cur_e = ts, te
        else:
            cur_e = max(cur_e, te)
    if cur_e is not None:
        busy += cur_e - cur_s
    return TraceSummary(window_s, busy * 1e-6, len(dev), n_launch, requests, _top(by_op), _top(gaps))


def _host_activity(ts, kernel, corr, launches, top_ops, starts) -> str:
    launch = launches.get(corr)
    if launch is not None:
        t, tid = launch
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        if i >= 0:
            s, e, name = top_ops[tid][i]
            if s <= t < e:
                return name[:NAME_CHARS]
    return ("launch outside ATen: " + kernel)[:NAME_CHARS]
