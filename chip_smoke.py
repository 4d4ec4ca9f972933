#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (there is no CPU path) and nvcc.  Phases:
  1. device: the card's name and power limit;
  2. build: compiles the stencil kernels from admm_optim_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch twin at the refs=4
     fine shape (17^3 x 224) and at a small shape with boundary pencils
     (3^3 x 5), random W with a Dirichlet mask, the lane forms (K1 on a
     lane axis, K3) with B = 5 lanes; errors and median times, and for K3
     the time of five K2 launches on the same lanes;
  4. slice: xupdate_solve.build(4) + solve on the GPU (2,843,910 DoF), its
     convergence to a true relative residual <= 1e-8 (evaluated once in
     f64 with the plain apply), the kernel launch counts of that run;
  5. admm: admm_run.run on the same refs=4 context (bench.py's
     admm_throughput: 5 ADMM iterations at most, 1+m = 5 lanes per
     x-update solve), its counters, time split and launch counts;
  6. small: refs=1 solve and ADMM run held against the port's float64 CPU
     runs.
Each path (solve, ADMM) is driven with the launch counts set to 0 just
before it and read just after; each of its kernels must have launched.
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

from admm_optim_tpu_torch import _build, admm_run, xupdate_solve
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk

SOURCE = "admm_optim_tpu_torch/csrc/stencil.cu"
PALLAS = "admm_optim_tpu/ops/pallas_stencil.py"
FINE_SHAPE = ((17, 17, 17), 224)  # refs=4 fine lattice, P
SMALL_SHAPE = ((3, 3, 3), 5)
REPS = 20
LANES = 5  # 1 + m lanes of the 3D x-update
H100_SXM_GBPS = 3350.0  # published HBM3 bandwidth, for the V-cycle roofline
# the kernels each path must launch, and the TPU kernel each replaces
PATHS = {
    "solve": ("apply_w_sym", "apply_w_pencil", "apply_w_df_sym"),
    "admm": ("apply_w_sym", "apply_w_pencil_batched"),
}
REPLACES = {
    "apply_w_sym": f"{PALLAS}:213",
    "apply_w_pencil": f"{PALLAS}:370",
    "apply_w_pencil_batched": f"{PALLAS}:337",
    "apply_w_df_sym": f"{PALLAS}:588",
}


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


def kernel_phase(ps, shape, seed, timed):
    """Each kernel against its twin on random data of one shape; returns
    {name: (max_abs_err, rel_err, ms, plain_ms)}."""
    lat, P = shape
    dev = torch.device("cuda")
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
    out = {}

    def record(name, got, ref, fn, plain, extra=None):
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = median_ms(fn) if timed else float("nan")
        plain_ms = median_ms(plain) if timed else float("nan")
        extra_ms = median_ms(extra) if timed and extra else float("nan")
        out[name] = (err, rel, ms, plain_ms, extra_ms)

    record(
        "apply_w_sym", sk.apply_w_sym(ps, W, xh), sk._apply_w_sym(ps, W, xh),
        lambda: sk.apply_w_sym(ps, W, xh), lambda: sk._apply_w_sym(ps, W, xh),
    )
    record(
        "apply_w_pencil", sk.apply_w_pencil(ps, W_pc, xh), sk._apply_w_pencil(ps, W_pc, xh),
        lambda: sk.apply_w_pencil(ps, W_pc, xh), lambda: sk._apply_w_pencil(ps, W_pc, xh),
    )
    record(
        "apply_w_sym/lanes", sk.apply_w_sym(ps, W, xb), sk._lanes(sk._apply_w_sym, ps, W, xb),
        lambda: sk.apply_w_sym(ps, W, xb), lambda: sk._lanes(sk._apply_w_sym, ps, W, xb),
    )
    # K3 against its twin, and against LANES launches of K2 (extra_ms)
    record(
        "apply_w_pencil_batched", sk.apply_w_pencil_batched(ps, W_pc, xb),
        sk._apply_w_pencil_batched(ps, W_pc, xb),
        lambda: sk.apply_w_pencil_batched(ps, W_pc, xb),
        lambda: sk._apply_w_pencil_batched(ps, W_pc, xb),
        extra=lambda: [sk.apply_w_pencil(ps, W_pc, x) for x in xb],
    )
    yh, yl = sk.apply_w_df_sym(ps, W, xh, xl)
    ref64 = sk._apply_w_sym(ps, W.double(), xh.double() + xl.double())
    record(
        "apply_w_df_sym", yh.double() + yl.double(), ref64,
        lambda: sk.apply_w_df_sym(ps, W, xh, xl),
        lambda: sk._apply_w_df_full(ps, st.expand_sym_w(ps, W), xh, xl),
    )
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
    }
    fine = kernel_phase(ps_k, FINE_SHAPE, seed=1, timed=True)
    small = kernel_phase(ps_k, SMALL_SHAPE, seed=2, timed=False)
    for label, res in (("17^3x224", fine), ("3^3x5", small)):
        for name, (err, rel, ms, plain_ms, extra_ms) in res.items():
            log(
                f"[kernel] {name:22s} {label:9s} max_abs_err {err:.3e} rel {rel:.3e} "
                f"(limit {limits[name]:.0e}) kernel {ms:.4f} ms twin {plain_ms:.4f} ms"
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

    # 6. small-input agreement: GPU float32 vs the port's float64 CPU runs
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

    kernels = []
    for name, replaces in REPLACES.items():
        err, rel, kms, pms, xms = fine[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sum(n.get(name, 0) for n in launches.values()),
            "launches_by_path": {path: n[name] for path, n in launches.items() if name in n},
            "max_abs_err": err, "rel_err": rel, "ms": kms, "plain_ms": pms,
        }
        if name == "apply_w_sym":
            lerr, lrel, lms, lpms, _ = fine["apply_w_sym/lanes"]
            entry.update(lanes=LANES, lanes_max_abs_err=lerr, lanes_ms=lms, lanes_plain_ms=lpms)
        if name == "apply_w_pencil_batched":
            entry.update(lanes=LANES, k2_x_lanes_ms=xms)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
