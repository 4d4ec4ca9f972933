#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (there is no CPU path) and nvcc.  Phases:
  1. device: the card's name and power limit;
  2. build: compiles the stencil kernels from admm_optim_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch twin at the refs=4
     fine shape (17^3 x 224), at the NS V-cycle's refs=2 fine shape
     (9^3 x 224) and at a small shape with boundary pencils (3^3 x 5),
     random W with a Dirichlet mask, the lane forms (K1 on a lane axis,
     K3) with B = 5 lanes; errors, median times and each kernel's bound
     (bytes over 3.35 TB/s or flops over the published peak, whichever is
     larger), for K3 the time of five K2 launches on the same lanes, for
     K5 and K5^T the adjointness <A x, y> = <x, A^T y> on the card;
  4. slice: xupdate_solve.build(4) + solve on the GPU (2,843,910 DoF), its
     convergence to a true relative residual <= 1e-8 (evaluated once in
     f64 with the plain apply), the kernel launch counts of that run;
  5. admm: admm_run.run on the same refs=4 context (bench.py's
     admm_throughput: 5 ADMM iterations at most, 1+m = 5 lanes per
     x-update solve), its counters, time split and launch counts;
  6. ns: ns_run at refs=2 (383,400 NS unknowns), float32, visc 0.16 from
     the cold start: Newton (final |R| rechecked in float64 with the plain
     residual), drag, the adjoint with the vjp-transposed preconditioner
     (K5^T) and the masked shape gradient J'; seconds per Newton, GMRES
     and adjoint iteration, assembly seconds per Newton iterate, peak
     memory, and a profiled window of the Krylov operators for K5's share
     of device time;
  7. small: refs=1 solve, ADMM run and NS slice held against the port's
     float64 CPU runs.
Each path (solve, ADMM, NS) is driven with the launch counts set to 0 just
before it (ns_run resets them before each of its phases) and read just
after; each of its kernels must have launched.
The last three lines are the kernel table as one JSON object, the
nvidia-smi name/power-limit line, and {"ok": true, "device": {...}}.  Any failure
raises, and the run exits nonzero without that last line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from admm_optim_tpu_torch import _build, admm_run, ns_run, xupdate_solve
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import navier_stokes as nsops
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers.ns_solver import NewtonConfig, transpose_M

SOURCE = "admm_optim_tpu_torch/csrc/stencil.cu"
PALLAS = "admm_optim_tpu/ops/pallas_stencil.py"
FINE_SHAPE = ((17, 17, 17), 224)  # refs=4 fine lattice, P
NS_SHAPE = ((9, 9, 9), 224)  # refs=2 fine lattice of the NS velocity V-cycle
SMALL_SHAPE = ((3, 3, 3), 5)
REPS = 20
LANES = 5  # 1 + m lanes of the 3D x-update
# published H100 SXM rates (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 and float64 rates outside the tensor cores, for the bounds
H100_SXM_GBPS = 3350.0
F32_FLOPS = 67e12
F64_FLOPS = 34e12
NS_VISC = 0.16  # the first rung of the JAX package's cold-start ladder
# the kernels each path must launch, and the TPU kernel each replaces
PATHS = {
    "solve": ("apply_w_sym", "apply_w_pencil", "apply_w_df_sym"),
    "admm": ("apply_w_sym", "apply_w_pencil_batched"),
    "ns": ("apply_w_full", "apply_w_full_t"),
}
REPLACES = {
    "apply_w_sym": f"{PALLAS}:213",
    "apply_w_pencil": f"{PALLAS}:370",
    "apply_w_pencil_batched": f"{PALLAS}:337",
    "apply_w_df_sym": f"{PALLAS}:588",
    "apply_w_full": f"{PALLAS}:97",
    # the JAX package transposes K5 with jax.vjp inside transpose_M
    "apply_w_full_t": f"{PALLAS}:97 (its jax.vjp, admm_optim_tpu/solvers/ns_solver.py:907)",
}
# the shape each kernel's JSON entry is timed at: the main path's fine level
JSON_SHAPE = {name: "17^3x224" for name in REPLACES}
JSON_SHAPE.update(apply_w_full="9^3x224", apply_w_full_t="9^3x224")


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def median_ms(fn, reps=REPS):
    """Median device time of fn() over reps runs after two warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stencil_patchset():
    """A small 3D channel patchset: the kernels need only its 15-slot
    Kuhn stencil, which every channel_3d hierarchy shares."""
    lv = [geomgen.channel_3d(n_side=(2, 1, 1))]
    lv.append(refine(lv[0]))
    return build_patchset(Hierarchy(lv))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, flops, flops_per_s):
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or the flops over
    the peak rate of their type, whichever is larger."""
    t_bytes = moved / (H100_SXM_GBPS * 1e9) * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(ps, shape, seed, timed, device="cuda"):
    """Each kernel against its twin on random data of one shape; returns
    {name: (max_abs_err, rel_err, ms, plain_ms, extra_ms, bound_ms,
    bound_by)}.  Flops count 2 per multiply-add of the full 15-slot
    stencil, per lane."""
    lat, P = shape
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    H = len(st.half_slots(ps))
    free = (torch.rand(lat + (P,), generator=g, device=dev) > 0.2).float()
    W = torch.randn((H, 3, 3) + lat + (P,), generator=g, device=dev)
    W = st.bake_dirichlet_w(ps, ps.k, W, free=free).contiguous()
    x64 = torch.randn((3,) + lat + (P,), generator=g, device=dev, dtype=torch.float64)
    x64 = x64 * free[None].double()
    xh = x64.float()
    xl = (x64 - xh.double()).float()
    xb = torch.randn((LANES, 3) + lat + (P,), generator=g, device=dev) * free
    W_pc = sk.to_pencil_major(ps, W, torch.bfloat16)
    # a nonsymmetric full slot-major W, as the NS conv-diff V-cycle has
    Wf = torch.randn((len(ps.stencil), 3, 3) + lat + (P,), generator=g, device=dev)
    Wf = st.bake_dirichlet_w(ps, ps.k, Wf, free=free).contiguous()
    yt = torch.randn((3,) + lat + (P,), generator=g, device=dev) * free
    flops = 2.0 * len(ps.stencil) * 9 * free.numel()  # one field
    out = {}

    def record(name, got, ref, fn, plain, moved, fl, extra=None, rate=F32_FLOPS):
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = median_ms(fn) if timed else float("nan")
        plain_ms = median_ms(plain) if timed else float("nan")
        extra_ms = median_ms(extra) if timed and extra else float("nan")
        out[name] = (err, rel, ms, plain_ms, extra_ms) + bound(moved, fl, rate)

    y = sk.apply_w_sym(ps, W, xh)
    record(
        "apply_w_sym", y, sk._apply_w_sym(ps, W, xh),
        lambda: sk.apply_w_sym(ps, W, xh), lambda: sk._apply_w_sym(ps, W, xh),
        nbytes(W, xh, y), flops,
    )
    y = sk.apply_w_pencil(ps, W_pc, xh)
    record(
        "apply_w_pencil", y, sk._apply_w_pencil(ps, W_pc, xh),
        lambda: sk.apply_w_pencil(ps, W_pc, xh), lambda: sk._apply_w_pencil(ps, W_pc, xh),
        nbytes(W_pc, xh, y), flops,
    )
    y = sk.apply_w_sym(ps, W, xb)
    record(
        "apply_w_sym/lanes", y, sk._lanes(sk._apply_w_sym, ps, W, xb),
        lambda: sk.apply_w_sym(ps, W, xb), lambda: sk._lanes(sk._apply_w_sym, ps, W, xb),
        nbytes(W, xb, y), LANES * flops,
    )
    # K3 against its twin, and against LANES launches of K2 (extra_ms)
    y = sk.apply_w_pencil_batched(ps, W_pc, xb)
    record(
        "apply_w_pencil_batched", y, sk._apply_w_pencil_batched(ps, W_pc, xb),
        lambda: sk.apply_w_pencil_batched(ps, W_pc, xb),
        lambda: sk._apply_w_pencil_batched(ps, W_pc, xb),
        nbytes(W_pc, xb, y), LANES * flops,
        extra=lambda: [sk.apply_w_pencil(ps, W_pc, x) for x in xb],
    )
    yh, yl = sk.apply_w_df_sym(ps, W, xh, xl)
    ref64 = sk._apply_w_sym(ps, W.double(), xh.double() + xl.double())
    record(
        "apply_w_df_sym", yh.double() + yl.double(), ref64,
        lambda: sk.apply_w_df_sym(ps, W, xh, xl),
        lambda: sk._apply_w_df_full(ps, st.expand_sym_w(ps, W), xh, xl),
        nbytes(W, xh, xl, yh, yl), flops, rate=F64_FLOPS,  # f64 accumulation
    )
    # K5 and K5^T (the NS path's full-W applies) and their adjointness
    y = sk.apply_w_full(ps, Wf, xh)
    record(
        "apply_w_full", y, sk._apply_w_full(ps, Wf, xh),
        lambda: sk.apply_w_full(ps, Wf, xh), lambda: sk._apply_w_full(ps, Wf, xh),
        nbytes(Wf, xh, y), flops,
    )
    z = sk.apply_w_full_t(ps, Wf, yt)
    record(
        "apply_w_full_t", z, sk._apply_w_full_t(ps, Wf, yt),
        lambda: sk.apply_w_full_t(ps, Wf, yt), lambda: sk._apply_w_full_t(ps, Wf, yt),
        nbytes(Wf, yt, z), flops,
    )
    a = float(torch.sum(y.double() * yt.double()))
    b = float(torch.sum(xh.double() * z.double()))
    out["adjointness"] = abs(a - b) / max(abs(a), abs(b))
    return out


def read_launches(path):
    """Launch counts of one path's run (counts were reset just before it);
    each kernel the path runs must have launched."""
    torch.cuda.synchronize()
    counts = {name: sk.launches[name] for name in PATHS[path]}
    for name, n in counts.items():
        check(n > 0, f"{name} launched by the {path} path")
    return counts


def true_rel_residual(ctx, b, res):
    """||b - A x|| / ||b|| in f64 with the plain apply and exchange (a
    check of the result, not part of the solve)."""
    ps, data = ctx.ps, ctx.data
    tab = data.tabs[ps.k]
    W64 = data.W[ps.k].double()
    x64 = res.x_hi.double() + res.x_lo.double()
    y = st.exchange_sum(None, sk._apply_w_sym(ps, W64, x64), tab)
    free = tab.free.double()[None]
    b64 = b.double()
    r = (b64 - y) * free
    return float(torch.sqrt(st.owner_dot(None, r, r, tab)) / torch.sqrt(st.owner_dot(None, b64, b64, tab)))


def device_ms(prof):
    """(device ms of all kernels, of K5/K5^T's apply_w_slots_kernel, the
    five kernels with the most device time as (name, ms, count)) in a
    torch.profiler run, or None when the trace holds no device time."""
    from torch.autograd import DeviceType

    total = k5 = 0.0
    by_name = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        total += t
        by_name.append((e.key[:60], t / 1e3, e.count))
        if "apply_w_slots_kernel" in e.key:
            k5 += t
    top = sorted(by_name, key=lambda r: -r[1])[:5]
    return (total / 1e3, k5 / 1e3, top) if total > 0 else None


def ns_profile(ctx, s, reps=10):
    """The Krylov operators of the NS path at the state s: wall and device
    time of reps x (M, then J) and of reps x (M^T, then J^T), untraced and
    under torch.profiler, and K5's share of the device time."""
    m_args = ctx.pre_full(ctx.coords, s, ctx.visc)
    W = m_args[-1]
    MT = transpose_M(lambda r: ctx.M_fn(r, *m_args), ctx.n_state, s.dtype, s.device)
    v = torch.randn(ctx.n_state, generator=torch.Generator(device=s.device).manual_seed(5), device=s.device)
    ops = {
        "M then J": lambda: [ctx.jv(ctx.M_fn(v, *m_args), W) for _ in range(reps)],
        "M^T then J^T": lambda: [ctx.jtv(MT(v), W) for _ in range(reps)],
    }
    for label, fn in ops.items():
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            traced = (time.perf_counter() - t0) * 1e3
        dev = device_ms(prof)
        if dev is None:
            log(f"[ns] {reps} x ({label}): {wall / reps:.3f} ms each untraced; device time not measured "
                "(the trace holds no device events)")
            continue
        total, k5, top = dev
        log(
            f"[ns] {reps} x ({label}): {wall / reps:.3f} ms each untraced, {traced / reps:.3f} ms traced; "
            f"device busy {total / reps:.3f} ms each ({100 * total / wall:.1f}% of the untraced wall); "
            f"K5/K5^T {k5 / reps:.3f} ms each ({100 * k5 / total:.1f}% of device time); top kernels "
            + "; ".join(f"{n} {100 * t / total:.1f}% ({c})" for n, t, c in top)
        )


def ns_phase(launches):
    """The NS path at refs=2, float32, from the cold start; the launch
    counts are reset before each of its phases (ns_run.run) and read after."""
    torch.cuda.reset_peak_memory_stats()
    ctx = ns_run.build(2, "cuda", torch.float32, visc=NS_VISC)
    log(
        f"[ns] refs=2 n_state={ctx.n_state} velocity lattice {ctx.pre_ps.fine.lat_shape} x "
        f"{ctx.pre_ps.P}, host set-up {ctx.host_seconds:.2f} s, visc {ctx.visc}, "
        f"accept_tol {ctx.cfg.accept_tol:g}"
    )
    out = ns_run.run(ctx)
    for phase, n in out.launches.items():
        log(f"[ns] launches in the {phase} phase: {n}")
    check(out.launches["newton"]["apply_w_full"] > 0, "K5 launched in the Newton phase")
    check(out.launches["adjoint"]["apply_w_full_t"] > 0, "K5^T launched in the adjoint phase")
    launches["ns"] = {name: sum(n[name] for n in out.launches.values()) for name in PATHS["ns"]}
    for name in PATHS["ns"]:
        check(launches["ns"][name] > 0, f"{name} launched by the ns path")
    nw, adj = out.newton, out.adjoint
    lin = sum(nw.lin_iters)
    r64 = float(torch.linalg.vector_norm(
        nsops.ns_residual(ctx.space, ctx.coords.double(), nw.s.double(), ctx.visc, ctx.stab)))
    log(
        f"[ns] newton: {nw.iters} iterations, converged {nw.converged}, |R| history "
        f"{[f'{v:.3e}' for v in nw.res_history]}, linear iterations {nw.lin_iters} ({lin}), "
        f"final |R| {nw.res_norm:.3e} (float64 recheck {r64:.3e})"
    )
    log(
        f"[ns] newton: {out.seconds['newton']:.3f} s, per Newton iteration "
        f"{[round(v, 3) for v in nw.seconds]} s, assembly per iterate "
        f"{[round(v, 3) for v in out.assembly_seconds]} s, "
        f"{1e3 * (out.seconds['newton'] - sum(out.assembly_seconds)) / max(lin, 1):.2f} ms per linear "
        f"iteration outside assembly; K5 launches per linear iteration "
        f"{out.launches['newton']['apply_w_full'] / max(lin, 1):.2f}"
    )
    log(
        f"[ns] adjoint: exit {adj.exit}, {adj.iters} iterations in {adj.cycles} cycles, "
        f"|r| {adj.res_norm:.3e}, target {adj.target:.3e}, {out.seconds['adjoint']:.3f} s "
        f"({1e3 * out.seconds['adjoint'] / max(adj.iters, 1):.2f} ms per iteration), K5^T launches "
        f"per iteration {out.launches['adjoint']['apply_w_full_t'] / max(adj.iters, 1):.2f}"
    )
    log(
        f"[ns] drag {out.drag:.10g} ({out.seconds['drag']:.4f} s), |J'| {out.jprime_norm:.6e} "
        f"({out.seconds['jprime']:.3f} s), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    check(nw.converged and nw.res_norm <= ctx.cfg.accept_tol, "refs=2 Newton converged")
    check(r64 <= ctx.cfg.accept_tol, f"refs=2 float64 |R| {r64:.3e} <= accept_tol")
    check(adj.exit in ("target", "stagnation"), f"refs=2 adjoint exit {adj.exit}")
    check(bool(torch.isfinite(adj.lam).all()), "refs=2 finite adjoint")
    check(np.isfinite(out.drag) and out.drag > 0, "refs=2 finite positive drag")
    jp = out.jprime
    off = (ctx.obstacle_vmask == 0)[None].expand_as(jp)
    check(jp.shape == (3, ctx.space.n_vertices) and bool(torch.isfinite(jp).all()), "refs=2 finite J'")
    check(float(jp[off].abs().max()) == 0.0 and out.jprime_norm > 0, "J' nonzero only on the obstacle")
    ns_profile(ctx, nw.s)


def ns_small():
    """refs=1 NS slice, card float32 against the port's CPU float64, both
    with the float32 presets.  The Newton |R| history amplifies rounding
    from the third iteration on (tests/test_torch_ns_slice_newton.py), and
    |R| after it lands near accept_tol, so which iteration first accepts
    differs with the last bits (on the CPU at 3D refs=1: the 4th in
    float64, the 3rd in float32).  Held: both converge, and the linear
    counts of the first three iterations are equal.  On the CPU the port's
    float32 run lies 2.0e-5 (drag) and 2.6e-5 of max|J'| (J') from its
    float64 run at 3D refs=1, both stopped near |R| ~ 1e-5 (PERF.md); the
    bounds are ten times that."""
    cfg = ns_run.f32_presets(NewtonConfig())
    g = ns_run.run(ns_run.build(1, "cuda", torch.float32, visc=NS_VISC, cfg=cfg))
    c = ns_run.run(ns_run.build(1, "cpu", torch.float64, visc=NS_VISC, cfg=cfg))
    ddrag = abs(g.drag - c.drag) / abs(c.drag)
    djp = float((g.jprime.double().cpu() - c.jprime).abs().max() / c.jprime.abs().max())
    log(
        f"[small] refs=1 NS GPU f32 vs CPU f64: Newton iterations {g.newton.iters} vs {c.newton.iters}, "
        f"|R| {g.newton.res_norm:.3e} vs {c.newton.res_norm:.3e}, linear {g.newton.lin_iters} vs "
        f"{c.newton.lin_iters}, adjoint {g.adjoint.iters} ({g.adjoint.exit}) vs {c.adjoint.iters} "
        f"({c.adjoint.exit}), drag rel diff {ddrag:.3e}, J' rel max diff {djp:.3e}"
    )
    check(g.newton.converged and c.newton.converged, "refs=1 NS Newton converged on both")
    check(g.newton.lin_iters[:3] == c.newton.lin_iters[:3], "refs=1 NS first three linear counts equal")
    check(ddrag <= 2e-4 and djp <= 3e-4, "refs=1 GPU drag and J' agree with the f64 CPU run")


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    nvcc_s, nvcc_log = _build.build()
    _build.lib()
    log(f"[build] {SOURCE} -> {_build.LIBRARY.name}: nvcc {nvcc_s:.2f} s, total {time.perf_counter() - t0:.2f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 3. kernels vs twins
    ps_k = stencil_patchset()
    limits = {
        "apply_w_sym": 1e-5, "apply_w_sym/lanes": 1e-5, "apply_w_pencil": 1e-5,
        "apply_w_pencil_batched": 1e-5, "apply_w_df_sym": 1e-13,
        "apply_w_full": 1e-5, "apply_w_full_t": 1e-5, "adjointness": 1e-5,
    }
    phases = {
        "17^3x224": kernel_phase(ps_k, FINE_SHAPE, seed=1, timed=True),
        "9^3x224": kernel_phase(ps_k, NS_SHAPE, seed=3, timed=True),
        "3^3x5": kernel_phase(ps_k, SMALL_SHAPE, seed=2, timed=False),
    }
    for label, res in phases.items():
        adj = res.pop("adjointness")
        log(f"[kernel] K5/K5^T adjointness {label:9s} |<Ax,y> - <x,A^T y>| / max {adj:.3e} (limit 1e-5)")
        check(adj <= limits["adjointness"], f"K5/K5^T adjointness at {label}: {adj:.3e}")
        for name, (err, rel, ms, plain_ms, extra_ms, bms, bby) in res.items():
            log(
                f"[kernel] {name:22s} {label:9s} max_abs_err {err:.3e} rel {rel:.3e} "
                f"(limit {limits[name]:.0e}) kernel {ms:.4f} ms twin {plain_ms:.4f} ms "
                f"bound {bms:.4f} ms ({bby})"
                + (f" {LANES} x K2 {extra_ms:.4f} ms" if name == "apply_w_pencil_batched" else "")
            )
            check(rel <= limits[name], f"{name} at {label}: rel err {rel:.3e} > {limits[name]:.0e}")

    # 4. the solve path: build + solve at refs=4; counts from 0
    launches = {}
    sk.reset_launches()
    ctx = xupdate_solve.build(4, "cuda", torch.float32)
    b = xupdate_solve.random_rhs(ctx, seed=0)
    res = xupdate_solve.solve(ctx, b)
    launches["solve"] = read_launches("solve")
    log(
        f"[slice] refs=4 dofs={ctx.n_dofs} P={ctx.ps.P} lat={ctx.ps.fine.lat_shape}: "
        f"host setup {ctx.host_seconds:.2f} s, assembly {ctx.assembly_seconds:.2f} s, "
        f"inner CG iterations {res.inner_iters}, IR rounds {res.rounds}, "
        f"res_norm {float(res.res_norm):.3e}, converged {res.converged}, launches {launches['solve']}"
    )
    check(res.converged, "refs=4 cg_ir_p converged")
    data = ctx.data
    tensors = data.W + data.inv_diag + data.lmax + [data.base_inv] + [
        w.a for w in (data.W_sm or []) if w is not None
    ]
    check(all(t.is_cuda for t in tensors), "every PatchMGData tensor on cuda")
    check(data.W_sm is not None, "bf16 pencil smoother stream built")
    x = res.x_hi + res.x_lo
    check(x.shape == b.shape and bool(torch.isfinite(x).all()), "finite solution of the right shape")
    true_rel = true_rel_residual(ctx, b, res)
    log(f"[slice] true relative residual (f64 check) {true_rel:.3e}")
    check(true_rel <= 1e-8, f"true relative residual {true_rel:.3e} <= 1e-8")

    times, iters = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = xupdate_solve.solve(ctx, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        iters.append(r.inner_iters)
        check(r.converged, "warm solve converged")
    ms = statistics.median(times) * 1e3
    log(
        f"[slice] {ms:.2f} ms/solve (median of {len(times)} warm solves: "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)}; inner iterations {iters}), "
        f"{ctx.n_dofs / (ms / 1e3):.4e} DoF/s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    log(f"[slice] V-cycle cost table at the H100 SXM's published {H100_SXM_GBPS:.0f} GB/s:")
    log(xupdate_solve.patch_mg.vcycle_cost_table(ctx.struct, data, H100_SXM_GBPS))
    del tensors, res, r, x, b

    # 5. the ADMM path on the resident refs=4 stencils; counts from 0.  A
    # second run from the same inputs is timed warm.
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    run = admm_run.run(ctx)
    launches["admm"] = read_launches("admm")
    st = run.state
    check(bool(torch.isfinite(st.u).all()) and bool(torch.isfinite(st.Lambda).all()),
          "refs=4 ADMM: finite u and Lambda")
    check(st.admm_it >= 1 and float(st.u.abs().max()) > 0.0, "refs=4 ADMM: the iterate moved")
    warm = admm_run.run(ctx)
    for label, r_ in (("first", run), ("warm", warm)):
        s_ = r_.state
        log(
            f"[admm] refs=4 {label}: admm_it {s_.admm_it} total_newton {s_.total_newton} "
            f"total_lin_iters {s_.total_lin_iters} solver_iters {s_.solver_iters} "
            f"converged {s_.converged} failed {s_.failed}; {r_.seconds:.3f} s, "
            f"{s_.admm_it / r_.seconds:.4f} ADMM it/s, W_h assembly {s_.wh_seconds:.3f} s, "
            f"Krylov {s_.krylov_seconds:.3f} s, Lambda {[round(float(v), 6) for v in s_.Lambda]}"
        )
    log(
        f"[admm] launches {launches['admm']}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    del ctx, data, run, warm, st
    torch.cuda.empty_cache()

    # 6. the NS path at refs=2: Newton, drag, adjoint, J'
    ns_phase(launches)
    torch.cuda.empty_cache()

    # 7. small-input agreement: GPU float32 vs the port's float64 CPU runs
    # at refs=1.  The solves converge to 1e-8 of their own operator (the
    # float32 rounding of the operator moves x by ~eps * cond).  The bench
    # ADMM stops its Newton after two iterations, short of ns_tol, so u
    # keeps the float32 rounding of the constraint defects (sums of ~5e4
    # cell terms): on the CPU the port's float32 u lies 3.9e-3 of max|u|
    # from its float64 u, and the JAX package's float32 u 3.3e-2 from its
    # own float64 u.  Hence 1e-2; the counts must be equal
    small = xupdate_solve.build(1, "cuda", torch.float32)
    ref = xupdate_solve.build(1, "cpu", torch.float64)
    xs = xupdate_solve.solve(small, xupdate_solve.random_rhs(small, seed=0))
    xr = xupdate_solve.solve(ref, xupdate_solve.random_rhs(ref, seed=0))
    xg = (xs.x_hi.double() + xs.x_lo.double()).cpu()
    xc = xr.x_hi + xr.x_lo
    dx = float((xg - xc).abs().max() / xc.abs().max())
    log(f"[small] refs=1 solve GPU f32 vs CPU f64: rel max diff {dx:.3e}, iterations {xs.inner_iters} vs {xr.inner_iters}")
    check(xs.converged and xr.converged and dx <= 1e-5, "refs=1 GPU solve agrees with the f64 CPU solve")
    ag, ac = admm_run.run(small).state, admm_run.run(ref).state
    du = float((ag.u.double().cpu() - ac.u).abs().max() / ac.u.abs().max())
    log(
        f"[small] refs=1 ADMM GPU f32 vs CPU f64: admm_it {ag.admm_it} vs {ac.admm_it}, "
        f"total_newton {ag.total_newton} vs {ac.total_newton}, total_lin_iters "
        f"{ag.total_lin_iters} vs {ac.total_lin_iters}, u rel max diff {du:.3e}"
    )
    check((ag.admm_it, ag.total_newton) == (ac.admm_it, ac.total_newton) and du <= 1e-2,
          "refs=1 GPU ADMM agrees with the f64 CPU ADMM")
    ns_small()

    # library_ms is null for every kernel: no single PyTorch call computes a
    # per-site variable stencil
    kernels = []
    for name, replaces in REPLACES.items():
        shape = JSON_SHAPE[name]
        err, rel, kms, pms, xms, bms, bby = phases[shape][name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sum(n.get(name, 0) for n in launches.values()),
            "launches_by_path": {path: n[name] for path, n in launches.items() if name in n},
            "max_abs_err": err, "rel_err": rel, "ms": kms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": bby, "library_ms": None, "shape": shape,
        }
        if name == "apply_w_sym":
            lerr, lrel, lms, lpms, _, lbms, _ = phases[shape]["apply_w_sym/lanes"]
            entry.update(lanes=LANES, lanes_max_abs_err=lerr, lanes_ms=lms, lanes_plain_ms=lpms,
                         lanes_bound_ms=lbms)
        if name == "apply_w_pencil_batched":
            entry.update(lanes=LANES, k2_x_lanes_ms=xms)
        if shape != "17^3x224":
            ferr, _, fms, fpms, _, fbms, _ = phases["17^3x224"][name]
            entry.update(ms_17=fms, plain_ms_17=fpms, bound_ms_17=fbms, max_abs_err_17=ferr)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
