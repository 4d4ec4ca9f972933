"""Hierarchical wall-clock profiler + optional device tracing (the port of
admm_optim_tpu/utils/profiling.py).

Counterpart of the reference's ``ProfileLUA(true)`` / ``PrintStats()``
(2d_admm.lua:14, 746; ``-bActivateProfiler`` flag 2d:85): phase timers
accumulate into a tree keyed by the with-block nesting, and a report table
prints totals / counts / mean.  ``device_trace`` wraps ``torch.profiler``
for a Chrome trace when deeper kernel timing is needed.

A phase synchronizes the device it is given before it stops the clock, so
asynchronous launches are not charged to the next phase.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.last = 0.0  # seconds of the last phase that ended
        self._stack: list[str] = []

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; nests as parent/child keys.  sync: the device to
        synchronize (CUDA only) before stopping the clock."""
        if not self.enabled:
            yield
            return
        self._stack.append(name)
        key = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            self.last = time.perf_counter() - t0
            self.totals[key] += self.last
            self.counts[key] += 1
            self._stack.pop()

    def report(self) -> str:
        if not self.totals:
            return "(no phases recorded)"
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        w = max(len(k) for k, _ in rows)
        lines = [f"{'phase':<{w}}  {'total[s]':>10}  {'count':>7}  {'mean[ms]':>10}"]
        for k, t in rows:
            n = self.counts[k]
            lines.append(f"{k:<{w}}  {t:>10.3f}  {n:>7}  {t / n * 1e3:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """torch.profiler trace of the block, exported as a Chrome trace
    (log_dir/trace.json): CPU activity, and CUDA activity when the device
    (default: the card if there is one) is CUDA."""
    device = torch.device(device if device is not None else ("cuda" if torch.cuda.is_available() else "cpu"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        _sync(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


NULL = Profiler(enabled=False)
