"""The benchmark's general harness: finds a cell's configuration, traffic
mix, request driver and metric readers by name, runs set-up, the measured
window and the correctness check, and builds the result line.

    BENCHMARK.json  cell -> config file, traffic name, metrics
    traffic/<traffic>.json        parameters of the mix; "request" names
    drivers/<request>.py          the driver that makes and serves requests
    limits/<cell>.json            the limit of each number the check compares
    metrics/<metric>.py           read(run) -> number or None; a metric
                                  <base>.<cells> without a file of its own
                                  is read by metrics/<base>.py

Adding a configuration, a mix, a cell or a metric adds files and entries;
no file here changes.

Over the window the harness logs what the host did besides (HostWatch).  The harness never imports the program itself: the
driver does, inside its set-up.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import random
import resource
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "admm_optim_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def process_start() -> float:
    """time.monotonic() at which this process started (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------

def load_manifest(path: pathlib.Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(manifest: dict, workload: str):
    """(cell, config, traffic, limits) of the named cell."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(REPO / configs[cell["config"]]["file"])
    traffic = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(ROOT / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader_path(name: str) -> pathlib.Path:
    """metrics/<name>.py, or for a name <base>.<cells> without a file of
    its own, metrics/<base>.py."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = ROOT / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def load_reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(request: str):
    return importlib.import_module(f"benchmark.drivers.{request}")


def load_peaks() -> dict:
    return load_json(ROOT / "peaks.json")


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    config: dict
    traffic: dict
    cell: dict
    seed: int
    setup_s: float = 0.0
    setup_parts: dict = dataclasses.field(default_factory=dict)
    requests: list = dataclasses.field(default_factory=list)  # one record a request in the window
    window_s: float = 0.0
    trace: object = None  # tracing.TraceSummary of the traced requests
    traced_requests: list = dataclasses.field(default_factory=list)
    device_kind: str = ""
    peaks: dict | None = None  # the device's row of peaks.json


def device_info(device, chips: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": peak}


def card_state() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class HostWatch:
    """What the host did over the window: its CPU and clock, this process's
    CPU time, the garbage collector's passes.  Runs of a host-bound cell
    spread with the host; steal time and context switches read 0 on the
    card's machine, so they are not logged."""

    def __init__(self):
        self.gc_s = 0.0
        self.gc_passes = [0, 0, 0]
        self._t = 0.0
        self.start = {}

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_passes[info["generation"]] += 1

    @staticmethod
    def _read() -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"t": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime}

    @staticmethod
    def cpu() -> str:
        """The first core's model and clock, as the kernel reports them."""
        try:
            with open("/proc/cpuinfo") as f:
                block = f.read().split("\n\n")[0]
        except OSError:
            return "unknown"
        info = {k.strip(): v.strip() for k, v in (ln.split(":", 1) for ln in block.splitlines() if ":" in ln)}
        return f"{info.get('model name', 'unknown')} at {info.get('cpu MHz', '?')} MHz"

    def begin(self):
        self.start = self._read()
        gc.callbacks.append(self._gc)

    def end(self) -> str:
        gc.callbacks.remove(self._gc)
        a, b = self.start, self._read()
        d = {k: b[k] - a[k] for k in a}
        return (f"host over the window: {self.cpu()}; this process's CPU {d['cpu_s']:.3f} s of {d['t']:.3f} s; "
                f"gc passes {self.gc_passes} in {self.gc_s:.4f} s")


def execute(cell: dict, config: dict, traffic: dict, limits: dict, metric_specs: list, seed: int, seconds: float,
            trace: bool, device, t_start: float, driver_hook=None, parts: dict | None = None) -> dict:
    """Set-up, the measured window, the check and the metrics of one run;
    returns the result line's object.  driver_hook(driver), if given, is
    called after set-up (the controls and the tests use it); parts: set-up
    seconds the caller spent before it (interpreter start, torch, the
    card's context)."""
    from . import tracing

    run = Run(config, traffic, cell, seed)
    driver = load_driver(traffic["request"]).Driver(config, traffic, limits, seed, device, log)
    run.setup_parts = dict(parts or {})
    run.setup_parts.update(driver.setup())
    if driver_hook is not None:
        driver_hook(driver)
    tracer = None
    if trace:
        tracer = tracing.Tracer(device)
        t0 = time.perf_counter()
        tracer.warm()
        run.setup_parts["profiler_s"] = time.perf_counter() - t0
    host = HostWatch()
    run.setup_s = time.monotonic() - t_start
    log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items())
        + f"; setup_s {run.setup_s:.3f}")

    n_trace = int(traffic["trace_requests"]) if trace else 0
    k = int(traffic["check_samples"])
    rng = random.Random(f"check:{seed}")
    kept = []
    host.begin()
    t_w = time.perf_counter()
    i = 0
    while True:
        if i == 0 and n_trace:
            tracer.start()
        rec, answer = driver.request(i)
        run.requests.append(rec)
        if len(kept) < k:
            kept.append((rec, answer))
        else:
            j = rng.randrange(i + 1)
            if j < k:
                kept[j] = (rec, answer)
        i += 1
        if n_trace and i == n_trace:
            run.trace = tracer.stop(i)
            run.traced_requests = run.requests[:i]
        if time.perf_counter() - t_w >= seconds:
            break
    if n_trace and run.trace is None:
        run.trace = tracer.stop(i)
        run.traced_requests = list(run.requests)
    run.window_s = time.perf_counter() - t_w
    log(host.end())

    dev_info = device_info(device, int(cell.get("chips", 1)))
    run.device_kind = dev_info["kind"]
    run.peaks = load_peaks().get(run.device_kind)
    log(f"window: {len(run.requests)} requests in {run.window_s:.3f} s; card: {card_state()}")
    driver.log_window(run.requests)

    driver.release(kept)
    t0 = time.perf_counter()
    checks = driver.check(kept)
    log(f"check took {time.perf_counter() - t0:.2f} s over {len(kept)} sampled requests")

    failed = sum(1 for r in run.requests if not r["ok"])
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for spec in metric_specs:
        value = load_reader(spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    if trace:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
        log(f"trace: {run.trace.requests} requests, {run.trace.launches} launch calls, "
            f"{run.trace.device_events} device events, busy {run.trace.busy_s:.6f} s "
            f"of {run.trace.window_s:.6f} s")
    result = {"correct": correct, "attempted": len(run.requests), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    return result
