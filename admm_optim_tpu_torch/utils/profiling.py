"""Hierarchical wall-clock profiler + optional device tracing (the port of
admm_optim_tpu/utils/profiling.py).

Counterpart of the reference's ``ProfileLUA(true)`` / ``PrintStats()``
(2d_admm.lua:14, 746; ``-bActivateProfiler`` flag 2d:85): phase timers
accumulate into a tree keyed by the with-block nesting, and a report table
prints totals / counts / mean.  ``device_trace`` wraps ``torch.profiler``
for a Chrome trace when deeper kernel timing is needed.

A phase synchronizes the device it is given before it stops the clock, so
asynchronous launches are not charged to the next phase.

``span(name, **attrs)`` marks a region of the solve path.  It records only
while a ``torch.profiler`` profile records (``device_trace``, a benchmark's
traced run): then it opens ``record_function(name)``, a ``user_annotation``
event on the trace's clock, and appends a record to an in-process list that
``spans()`` returns and ``reset_spans()`` clears.  Otherwise it reads the
profiler's flag and nothing else: no clock, no ``record_function``.  A span
never synchronizes, allocates on the device or launches anything.

A record is a dict: ``name``; ``start_ns`` and ``end_ns`` on
``time.time_ns()``, the clock the exported Chrome trace stamps as
``ts * 1000 + baseTimeNanoseconds``; ``parent``, the index of the enclosing
record (None for a root); ``request``, the sequence number of the root the
record descends from; ``attrs``.  ``host_read`` is the one blocking
device-to-host read of the solve path, a ``host.sync`` span each.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler


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
            with span(name):
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


_records: list[dict] = []
_open: list[int] = []  # indices of the records still open, innermost last
_roots = 0  # root records since the last reset_spans()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "rec", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _roots
        self.rf = _autograd_profiler.record_function(self.name)
        parent = _open[-1] if _open else None
        if parent is None:
            request = _roots
            _roots += 1
        else:
            request = _records[parent]["request"]
        self.rec = dict(name=self.name, start_ns=None, end_ns=None, parent=parent, request=request, attrs=self.attrs)
        _open.append(len(_records))
        _records.append(self.rec)
        # both ends are stamped just before the call into record_function,
        # so its own cost (tens of us under a recording profiler) shifts the
        # record against the annotation and leaves the duration
        self.rec["start_ns"] = time.time_ns()
        self.rf.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self.rec["end_ns"] = time.time_ns()
        self.rf.__exit__(*exc)
        if _open:
            _open.pop()
        return False


def span(name: str, **attrs):
    """A context manager marking a region: a record and a user_annotation
    while a torch.profiler profile records, a shared null context
    otherwise.  ``with span(...) as rec`` gives the record, whose attrs
    the region may add to, or None when nothing records."""
    if not recording():
        return _OFF
    return _Span(name, attrs)


def recording() -> bool:
    """Whether a torch.profiler profile records (and so spans do)."""
    return _autograd_profiler._is_profiler_enabled


def spans() -> list[dict]:
    """The records since the last reset_spans(), in the order they opened."""
    return list(_records)


def reset_spans() -> None:
    global _roots
    _records.clear()
    _open.clear()
    _roots = 0


def host_read(value: torch.Tensor, cast=bool):
    """cast(value) for a device tensor: the host blocks until the device has
    computed it.  A host.sync span, so the traced blocking reads of the solve
    path are counted and timed in one place."""
    with span("host.sync"):
        return cast(value)
