"""Flag-compatible command line (the port of admm_optim_tpu/cli.py).

Mirrors the reference's ``ugshell -ex 2d_admm.lua -numRefs 3 -visc 0.02 ...``
interface (flag names from 2d_admm.lua:43-87 / 3d_admm.lua:46-86), e.g.::

    python -m admm_optim_tpu_torch.cli -dim 3 -numRefs 1 -numSteps 10 \
        -visc 0.16 -tau 2 -outDir ./out              (the card, float32)
    python -m admm_optim_tpu_torch.cli -dim 2 -numRefs 1 -numSteps 2 \
        -admmSteps 8 -x64 -outDir ./out              (the CPU, float64)
    python -m admm_optim_tpu_torch.cli -dim 2 -numRefs 1 -numSteps 1 \
        -backend global -x64 -outDir ./out           (the block-ELL backend)
    python -m admm_optim_tpu_torch.cli -grid box.ugx -numRefs 1 ...

Extra flags beyond the reference: ``-dim`` (one entry point for both 2D/3D),
``-outDir``, ``-x64`` (CPU double precision), ``-vorder``.  Without
``-x64`` the run takes the card in float32 with f32_presets, and raises
when there is none.  A ``-grid`` file, and ``-backend global``, run on the
global (block-ELL) backend.  ``-b2ndOrder 1`` (the J'' term; it puts the
x-update on the global backend), ``-vorder 1`` (P1/P1 with ``-stab``,
matrix-free NS operators) and ``-pressurePrecond pcd`` on either backend
run as in the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

# the bandwidth the -bActivateProfiler V-cycle table is priced at: the
# published HBM3 rate of an NVIDIA H100 SXM (80 GB)
H100_SXM_GBPS = 3350.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="admm_optim_tpu_torch", description=__doc__, allow_abbrev=False,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    a = p.add_argument
    a("-dim", type=int, default=2, choices=(2, 3))
    a("-numRefs", type=int, default=3)
    a("-numSteps", type=int, default=400)
    a("-admmSteps", type=int, default=1000)
    a("-visc", type=float, default=0.02)
    a("-stab", type=float, default=0.0)
    a("-stabType", type=float, default=0.0,
      help="parsed for reference-CLI parity (2d:48); the stabilized P1/P1 "
           "discretization here is always Brezzi-Pitkaranta")
    a("-control", type=float, default=1.0,
      help="reference's p-term control (2d:55) - vestigial there (constant "
           "p=2, 2d:908) and here; parsed for CLI parity")
    a("-sigma_threshold", type=float, default=0.3)
    a("-scaling", type=float, default=1.0)
    a("-admm_tolerance", type=float, default=1e-2)
    a("-admm_gradient_tolerance", type=float, default=0.05)
    a("-step_length", type=float, default=1.0)
    a("-line_search", type=float, default=1e-5)
    a("-tau", type=float, default=1.0)
    a("-normName", type=str, default="frobenius", choices=("frobenius", "spectral"))
    a("-relaxAlpha", type=float, default=1.0,
      help="ADMM over-relaxation (1.0 = reference behavior; 1.4-1.8 "
           "accelerates, same fixed point)")
    a("-nsMaxIts", type=int, default=10)
    a("-nsTol", type=float, default=1e-9)
    a("-nsAbsLuTol", type=float, default=1e-12)
    a("-nsAbsLlambdaTol", type=float, default=1e-12)
    a("-nsRelLuTol", type=float, default=1e-12)
    a("-nsRelLlambdaTol", type=float, default=1e-12)
    a("-lambda_vol", type=float, default=0.0)
    a("-lambda_x", type=float, default=0.0)
    a("-lambda_y", type=float, default=0.0)
    a("-lambda_z", type=float, default=0.0)
    a("-grid", type=str, default=None, help=".ugx grid file (default: generated)")
    a("-bDoNothing", type=int, default=1)
    a("-b2ndOrder", type=int, default=0)
    a("-hscaling", type=float, default=1.0)
    a("-vorder", type=int, default=2, choices=(1, 2))
    a("-backend", type=str, default="auto", choices=("auto", "patch", "global"),
      help="ADMM linear-algebra backend (patch = brick-lattice stencils)")
    a("-pressurePrecond", type=str, default="mass", choices=("mass", "pcd"),
      help="NS pressure-block preconditioner (mass = default; pcd = "
           "pressure convection-diffusion)")
    a("-velInner", type=int, default=1,
      help="velocity-block Richardson steps per NS preconditioner apply")
    a("-outDir", type=str, default="./admm_out")
    a("-x64", action="store_true", help="run in float64 on CPU")
    a("-restart", type=str, default=None, help="checkpoint file to resume from")
    a("-autoResume", type=int, default=0,
      help="retry-from-checkpoint up to N times on a device fault "
           "(model + device buffers rebuilt; telemetry stays contiguous)")
    a("-bOutputMesh", type=int, default=1)
    a("-bOutputFlows", type=int, default=0,
      help="write flow velocity into the per-step VTU (2d:77)")
    a("-bOutputPressure", type=int, default=0)
    a("-bOutputAdjoints", type=int, default=0)
    a("-bDebugOutput", type=int, default=0,
      help="per-step mesh .ugx dump + Lu/RHS/delta_u debug VTUs "
           "(2d:80, 788, 962-1076)")
    a("-bDebugNodalPositions", type=int, default=0,
      help="per-step VTU of the deformed nodal positions (2d:81)")
    a("-bDebugSensitivity", type=int, default=0,
      help="write the shape gradient J' into the per-step VTU (2d:82)")
    a("-bOutputIntermediateUp", type=int, default=0,
      help="write a VTU of every ADMM iterate's u (2d:84)")
    a("-bNewtonOutput", type=int, default=0,
      help="print per-step NS/x-update iteration detail (2d:75) and write "
           "__NewtonStats_step_N_/__NewtonIterations_step_N_ (2d:1256-1259)")
    a("-debugNans", type=int, default=0,
      help="finite checks at every outer-loop phase boundary (raises "
           "naming the phase) + autograd anomaly detection")
    a("-bSaveFailures", type=int, default=1,
      help="catalogue non-descent steps to __Failure_Data.txt (2d:87)")
    a("-bActivateProfiler", type=int, default=0)
    a("-traceDir", type=str, default=None,
      help="write a torch.profiler trace (Chrome trace.json) of the whole run")
    a("-verbose", type=int, default=1)
    return p


def problem_config(args):
    """The ProblemConfig of parsed args (the JAX CLI's, field by field),
    with f32_presets unless -x64."""
    from .models.obstacle import ProblemConfig, f32_presets
    from .optim.admm import ADMMConfig
    from .solvers.ns_solver import NewtonConfig

    cfg = ProblemConfig(
        dim=args.dim,
        num_refs=args.numRefs,
        num_steps=args.numSteps,
        visc=args.visc,
        stab=args.stab,
        sigma_threshold=args.sigma_threshold,
        scaling=args.scaling,
        line_search_param=args.line_search,
        do_nothing=bool(args.bDoNothing),
        vorder=args.vorder,
        b2nd_order=bool(args.b2ndOrder),
        high_order_scaling=args.hscaling,
        grid_path=args.grid,
        backend=args.backend,
        pressure_precond=args.pressurePrecond,
        vel_inner=args.velInner,
        newton_output=bool(args.bNewtonOutput),
        debug_output=bool(args.bDebugOutput),
        debug_nodal_positions=bool(args.bDebugNodalPositions),
        debug_nans=bool(args.debugNans),
        admm=ADMMConfig(
            admm_steps=args.admmSteps,
            admm_tolerance=args.admm_tolerance,
            admm_gradient_tolerance=args.admm_gradient_tolerance,
            tau=args.tau,
            sigma_threshold=args.sigma_threshold,
            scaling=args.scaling,
            step_length=args.step_length,
            norm_name=args.normName,
            relax_alpha=args.relaxAlpha,
            ns_max_its=args.nsMaxIts,
            ns_tol=args.nsTol,
            ns_abs_tol=args.nsAbsLuTol,
            ns_abs_llambda_tol=args.nsAbsLlambdaTol,
            ns_rel_tol=args.nsRelLuTol,
            ns_rel_llambda_tol=args.nsRelLlambdaTol,
            lambda_init=(
                (args.lambda_vol, args.lambda_x, args.lambda_y)
                + ((args.lambda_z,) if args.dim == 3 else ())
                if (args.lambda_vol or args.lambda_x or args.lambda_y or args.lambda_z)
                else ()
            ),
        ),
        ns=NewtonConfig(),
    )
    return cfg if args.x64 else f32_presets(cfg)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from . import resolve_device, xupdate_solve
    from .io.telemetry import TelemetryWriter
    from .models.obstacle import ObstacleShapeOpt

    # -x64: the plain forms on the CPU in float64; else the card, or an error
    device, dtype = (torch.device("cpu"), torch.float64) if args.x64 else (resolve_device(), torch.float32)
    if args.debugNans:
        from .utils.debug import enable_nan_debug

        enable_nan_debug()
    cfg = problem_config(args)
    print("THE PARAMETERS USED FOR EXECUTION ARE:")
    for k, v in vars(args).items():
        print(f"  {k}: {v}")

    def build():
        return ObstacleShapeOpt(cfg, device=device, dtype=dtype)

    prob = build()
    print(prob.hier.describe())
    tele = TelemetryWriter(args.outDir)

    def host(t):
        return t.detach().cpu().numpy()

    start_state = None
    if args.restart:
        from .io.checkpoint import load_checkpoint

        start_state = load_checkpoint(args.restart)
        print(f"resuming from {args.restart} at step {start_state['step']}")

    want_vtu = (
        args.bOutputMesh or args.bOutputFlows or args.bOutputPressure
        or args.bOutputAdjoints or args.bDebugSensitivity
    )
    if want_vtu:
        from .io.vtk import write_vtu

        def callback(step, X, s, rec):
            V = prob.hier.fine.num_vertices
            pd = {"u": host(X - prob.X0)}
            if args.bOutputFlows or args.bOutputPressure:
                v, p = prob.ns.space.unpack(s)
                if args.bOutputFlows:  # P2 nodes are vertex-first
                    pd["v"] = host(v[:, :V].T)
                if args.bOutputPressure:
                    pd["p"] = host(p)
            if args.bOutputAdjoints and prob._cur_lam_adj is not None:
                q, h = prob.ns.space.unpack(prob._cur_lam_adj)
                pd["q_adj"] = host(q[:, :V].T)
                pd["h_adj"] = host(h)
            if args.bDebugSensitivity and prob._cur_Jp is not None:
                pd["jprime"] = host(prob._cur_Jp.T)
            if args.bNewtonOutput:
                print(
                    f"  [newton] step {step}: x-update newton={rec.newton_iters} "
                    f"krylov={rec.lin_iters} admm={rec.admm_iters} "
                    f"attempts={rec.attempts}"
                )
            write_vtu(f"{args.outDir}/mesh_step_{step:04d}.vtu", host(X), host(prob.elems), point_data=pd)
    else:
        callback = None

    admm_iter_cb = None
    if args.bOutputIntermediateUp:
        from .io.vtk import write_vtu as _write_vtu

        def admm_iter_cb(step, attempt, k, u):
            _write_vtu(
                f"{args.outDir}/u_intermediate_step_{step:04d}_a{attempt:02d}_{k:04d}.vtu",
                host(prob._cur_X), host(prob.elems), point_data={"u": host(u.T)},
            )

    profiler = None
    if args.bActivateProfiler:
        from .utils.profiling import Profiler

        profiler = Profiler()
        if prob.use_patch:
            # the reference's ProfileLUA cost accounting analogue: per-level
            # device-memory bytes and flops with a bandwidth roofline per
            # V-cycle (the patch backend's, as in the JAX CLI)
            print(f"V-cycle cost table at the NVIDIA H100 SXM's published {H100_SXM_GBPS:.0f} GB/s:")
            print(xupdate_solve.patch_mg.vcycle_cost_table(
                prob.xu.struct, xupdate_solve.assemble(prob.xu, prob.X0), H100_SXM_GBPS))

    trace_ctx = contextlib.nullcontext()
    if args.traceDir:
        from .utils.profiling import device_trace

        trace_ctx = device_trace(args.traceDir, device)

    run_kwargs = dict(
        telemetry=tele,
        callback=callback,
        verbose=bool(args.verbose),
        profiler=profiler,
        catalog_failures=bool(args.bSaveFailures),
        admm_iter_cb=admm_iter_cb,
    )
    ckpt = f"{args.outDir}/checkpoint.npz"
    with trace_ctx:
        if args.autoResume > 0:
            from .io.resume import resumable_run

            # on restart the callbacks pick up the rebuilt prob through the
            # nonlocal; the mesh topology is the same
            first = [True]

            def build_model():
                nonlocal prob
                if first[0]:
                    first[0] = False
                else:
                    prob = build()
                return prob

            hist = resumable_run(build_model, ckpt, max_restarts=args.autoResume, resume=start_state, **run_kwargs)
        else:
            hist = prob.run(resume=start_state, checkpoint_path=ckpt, **run_kwargs)
    tele.close()
    if profiler is not None:
        print(profiler.report())
    if hist:
        print(f"DONE: {len(hist)} accepted steps, drag {hist[0].drag:.6f} -> {hist[-1].drag:.6f}")
    else:
        print("DONE: no accepted steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
