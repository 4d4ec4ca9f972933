"""Make the goldens of the port's optimization step, from the JAX package
on the CPU in float64:

  * tests/goldens/e2e_steps.npz, held by tests/test_torch_obstacle.py: two
    optimization steps of ObstacleShapeOpt.run at 2D refs=1 and at 3D
    refs=0 with the settings of tests/test_e2e_2d.py and
    tests/test_e2e_3d.py (both marked slow, hence goldens).  The JAX side
    runs its host-stepped drivers (``_ns_stepped`` and ``_admm_stepped_on``
    set after construction; they are read at call time), whose chunk-unit
    counts the port reproduces.  Kept per step: the StepRecord, the
    adjoint's iteration count and the linear counts of every Newton
    iteration of the NS re-solves (parsed from the verbose lines); the
    final mesh, the constraint targets, the state the ladder reached (the
    "step -1" state a run resumes from to take step 0) and the post-step-0
    state (X, s, sigma, step, drag_old, drag_init) for a resumed step 1.
  * tests/goldens/adjoint_warm.npz, held by
    tests/test_torch_adjoint_warm.py: the stepped adjoint warm-started
    (obstacle.py _adjoint_stepped with lam0 and a recycle space U) at the
    JAX package's converged visc 0.16 states of tests/goldens/ns_slice.npz
    (2D and 3D refs=1), with a recycle space of k = 8.  A cold adjoint
    leaves lambda_1 and U; the warm one starts from lam0 = lambda_1 / 2
    with that U.
  * ckpt: tests/goldens/e2e_ckpt_2d.npz and e2e_ckpt_2d_sidecar.npz,
    held by tests/test_torch_resume.py: the 2D run of e2e_steps.npz again,
    with a checkpoint path and a TelemetryWriter; the checkpoint and its
    warm sidecar (lam_adj, adj_U, ns_U) as they stood after step 0, kept
    byte for byte (the sidecar under a name that .gitignore's *.warm.npz
    does not match), and, in e2e_ckpt_2d_telemetry.npz, the text of __Drag.txt and
    __Iterations_per_step.txt after both steps with the adjoint's
    iteration count per step.
  * cli: the JAX CLI (python -m admm_optim_tpu.cli) on the drive recipe
    -dim 2 -numRefs 1 -numSteps 2 -admmSteps 8 -x64, its __Drag.txt and
    __Iterations_per_step.txt kept in e2e_cli_2d.npz, held by
    tests/test_torch_cli.py.  The CLI's ObstacleShapeOpt is given the
    host-stepped loops as above (the port has only those).
  * global: the global (block-ELL) backend, in tests/goldens/e2e_global.npz
    (configurations in tests/torch_global_golden.py): two steps at 2D
    refs=1 on the channel with alternating diagonals and at 3D refs=0 with
    backend="global" (as run_e2e), one step on the .ugx file of that 2D
    channel (grid_path), admm_inner at the undeformed 2D and 3D meshes with
    a synthetic J', sigma_sweep, geometry_sweep and best_candidate at 2D,
    and the JAX CLI with -backend global and with -grid; held by
    tests/test_torch_admm_global.py, _obstacle_global*.py, _sweep.py and
    _cli_global.py.
  * variants: tests/goldens/e2e_variants.npz (configurations in
    tests/torch_variants_golden.py): one step each with b2nd_order, PCD on
    the global backend, ns_assembled_jac "off" and vorder 1, and the NS
    path alone matrix-free and P1/P1; held by
    tests/test_torch_obstacle_variants.py and test_torch_ns_matfree.py.
    The b2nd_order step runs the JAX package's monolithic ADMM loop, the
    one that passes its J'' term (its host-stepped ADMM driver has none).
  * shard: tests/goldens/e2e_shard.npz, held by
    tests/test_torch_patch_shard.py: the JAX package's single-device patch
    multigrid on the padded patch sets of that file's two fixtures
    (tests/torch_shard_ranks.py: the 2D refs=2 channel padded for 4 ranks,
    the 3D refs=1 channel for 2), from the same seeded inputs: each level's
    stencils, inverse diagonals and lambda_max and the base inverse
    (assemble_patch_mg_p, sym=True), one vcycle_p, cg_p, cg_ir_p, and
    admm_inner_ops on a PatchOps with pvalid masking the padding.
  * sweep: tests/goldens/e2e_sweep_patch.npz, held by
    tests/test_torch_sweep.py: geometry_sweep on tests/test_sweep.py's 2D
    refs=1 backend="auto" problem, whose x-update is on the patch backend
    (the sweep runs on the global def_space all the same), over the meshes
    of tests/torch_global_golden.py's perturbed_meshes.

The JAX stepped kernels compile for minutes on one CPU core.  Run from the
repository root:

    python tests/goldens/make_e2e_goldens.py [e2e] [adjoint] [ckpt] [cli] [global] [variants] [shard] [sweep]
"""
import contextlib
import io
import os
import pathlib
import re
import shutil
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parents[1]), str(HERE.parent)]

from admm_optim_tpu.models.obstacle import ObstacleShapeOpt, ProblemConfig  # noqa: E402
from admm_optim_tpu.optim import admm  # noqa: E402
from admm_optim_tpu.solvers import ns_solver  # noqa: E402

E2E_OUT = HERE / "e2e_steps.npz"
ADJ_OUT = HERE / "adjoint_warm.npz"
CKPT_OUT = HERE / "e2e_ckpt_2d.npz"
SIDECAR_OUT = HERE / "e2e_ckpt_2d_sidecar.npz"
TELEMETRY_OUT = HERE / "e2e_ckpt_2d_telemetry.npz"
CLI_OUT = HERE / "e2e_cli_2d.npz"
GLOBAL_OUT = HERE / "e2e_global.npz"
VARIANTS_OUT = HERE / "e2e_variants.npz"
SHARD_OUT = HERE / "e2e_shard.npz"
SWEEP_OUT = HERE / "e2e_sweep_patch.npz"
CLI_ARGV = ["-dim", "2", "-numRefs", "1", "-numSteps", "2", "-admmSteps", "8", "-x64"]
TELEMETRY_FILES = {"drag": "__Drag.txt", "iterations": "__Iterations_per_step.txt"}
NUM_STEPS = 2
# tests/test_e2e_2d.py:20-28 and tests/test_e2e_3d.py:22-33
CONFIGS = {
    "2d": dict(dim=2, num_refs=1, visc=0.05, sigma_threshold=0.3,
               admm=dict(admm_steps=40, ns_max_its=8, tau=2.0, lin_max_iters=120)),
    "3d": dict(dim=3, num_refs=0, visc=0.1, sigma_threshold=0.3,
               admm=dict(admm_steps=60, ns_max_its=10, tau=2.0, lin_max_iters=400),
               ns=dict(lin_max_iters=1200, lin_restart=100)),
}
RECORD = ("drag", "drag_diff", "shape_derivative", "sigma", "scaling", "admm_iters", "newton_iters",
          "lin_iters", "attempts", "solver_iters")
ADJ_CASES = {"2d_refs1": (2, 1), "3d_refs1": (3, 1)}
ADJ_VISC = 0.16
# U is k x n_state float64 (9.8 MB at 3D refs=1 with the default k = 24)
ADJ_RECYCLE_K = 8


def problem_config(kw):
    kw = dict(kw)
    admm_kw, ns_kw = kw.pop("admm", {}), kw.pop("ns", {})
    return ProblemConfig(**kw, admm=admm.ADMMConfig(**admm_kw), ns=ns_solver.NewtonConfig(**ns_kw))


class Tee(io.StringIO):
    def write(self, s):
        sys.__stdout__.write(s)
        return super().write(s)


def parse_verbose(text):
    """Per step: the adjoint's iterations and, per NS re-solve, the linear
    iterations of each Newton iteration (a re-solve starts at "newton 0")."""
    steps, cur = [], None
    for line in text.splitlines():
        m = re.search(r"adjoint: (\d+) its", line)
        if m:
            cur = dict(adjoint=int(m.group(1)), ns=[])
            steps.append(cur)
            continue
        m = re.search(r"newton (\d+): .*\((\d+) lin\)", line)
        if m and cur is not None:
            if int(m.group(1)) == 0:
                cur["ns"].append([])
            cur["ns"][-1].append(int(m.group(2)))
    return steps


def run_e2e(name, kw, num_steps=NUM_STEPS, admm_stepped=True, check=True):
    cfg = problem_config(kw)
    prob = ObstacleShapeOpt(cfg)
    glob = cfg.backend == "global" or cfg.grid_path is not None
    if check:
        assert prob.use_ns_jac and (not (prob.use_patch or prob.use_patch_ns) if glob
                                    else prob.use_patch and prob.use_patch_ns)
    prob._ns_stepped = True
    prob._admm_stepped_on = admm_stepped
    after0, ladder = {}, {}

    def callback(step, X, s, rec):
        if step == 0:
            after0.update(X=np.asarray(X), s=np.asarray(s), sigma=rec.sigma, step=0, drag_old=rec.drag)
            # the state the step started from: the ladder's at visc (run
            # sets _cur_s at the start of a step and leaves it)
            ladder["s"] = np.asarray(prob._cur_s)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        hist = prob.run(num_steps=num_steps, verbose=True, callback=callback)
    parsed = parse_verbose(buf.getvalue())
    assert len(hist) == num_steps and len(parsed) == num_steps, (len(hist), parsed)
    # the drag after the ladder: drag_init of the resumed run
    drag_init = hist[0].drag + hist[0].drag_diff
    out = {f"{name}_{f}": np.asarray([getattr(r, f) for r in hist]) for f in RECORD}
    out.update({
        f"{name}_adjoint_iters": np.asarray([p["adjoint"] for p in parsed]),
        f"{name}_ns_lin": np.concatenate([np.concatenate([np.asarray(n) for n in p["ns"]]) for p in parsed]),
        f"{name}_ns_lin_len": np.asarray([len(n) for p in parsed for n in p["ns"]]),
        f"{name}_ns_solves": np.asarray([len(p["ns"]) for p in parsed]),
        f"{name}_X_final": np.asarray(prob.X_final),
        f"{name}_ref_volume": np.asarray(prob.ref_volume),
        f"{name}_ref_barycenter": np.asarray(prob.ref_barycenter),
        f"{name}_drag_init": np.asarray(drag_init),
        f"{name}_ladder_s": ladder["s"],
    })
    out.update({f"{name}_after0_{k}": np.asarray(v) for k, v in after0.items()})
    print(f"{name}: drags {[r.drag for r in hist]} attempts {[r.attempts for r in hist]} "
          f"admm {[r.admm_iters for r in hist]} newton {[r.newton_iters for r in hist]} "
          f"parsed {parsed}", flush=True)
    return out


def run_adjoint(name, dim, refs, gold):
    ns = ns_solver.NewtonConfig(adj_recycle_k=ADJ_RECYCLE_K)
    prob = ObstacleShapeOpt(ProblemConfig(dim=dim, num_refs=refs, visc=ADJ_VISC, ns=ns))
    prob._ns_stepped = True
    X = prob.X0
    s = jnp.asarray(gold[f"{name}_s"])
    lam1, _, it1 = prob._adjoint_stepped_fn(X, s, jnp.zeros_like(s))
    U = prob._cur_adj_U
    assert U is not None and U.shape[0] == ADJ_RECYCLE_K
    lam0 = 0.5 * lam1
    lam2, rn2, it2 = prob._adjoint_stepped_fn(X, s, lam0)
    target = max(prob.cfg.ns.lin_abs_tol, prob.cfg.ns.adj_rel_tol * float(prob._adj_gj_norm(X, s)))
    print(f"{name}: cold {int(it1)} its, warm {int(it2)} its |r| {float(rn2):.3e} target {target:.3e}", flush=True)
    return {
        f"{name}_U": np.asarray(U), f"{name}_lam0": np.asarray(lam0), f"{name}_lam": np.asarray(lam2),
        f"{name}_iters": np.asarray(int(it2)), f"{name}_res": np.asarray(float(rn2)),
        f"{name}_target": np.asarray(target), f"{name}_recycle_k": np.asarray(ADJ_RECYCLE_K),
    }


def run_ckpt():
    """The 2D run of run_e2e with checkpoint_path and telemetry: the
    checkpoint and sidecar after step 0, the telemetry after step 1."""
    from admm_optim_tpu.io.telemetry import TelemetryWriter

    prob = ObstacleShapeOpt(problem_config(CONFIGS["2d"]))
    prob._ns_stepped = True
    prob._admm_stepped_on = True
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "checkpoint.npz")

        def callback(step, X, s, rec):
            # run saves the checkpoint and its sidecar before the callback
            if step == 0:
                shutil.copyfile(ckpt, CKPT_OUT)
                shutil.copyfile(ckpt + ".warm.npz", SIDECAR_OUT)

        tele = TelemetryWriter(tmp)
        buf = Tee()
        with contextlib.redirect_stdout(buf):
            hist = prob.run(num_steps=NUM_STEPS, verbose=True, callback=callback, telemetry=tele,
                            checkpoint_path=ckpt)
        tele.close()
        parsed = parse_verbose(buf.getvalue())
        assert len(hist) == NUM_STEPS
        out = {k: np.asarray(open(os.path.join(tmp, f)).read()) for k, f in TELEMETRY_FILES.items()}
    out["adjoint_iters"] = np.asarray([p["adjoint"] for p in parsed])
    with np.load(SIDECAR_OUT) as z:
        print(f"ckpt: drags {[r.drag for r in hist]}, adjoint {out['adjoint_iters'].tolist()}, sidecar "
              f"{ {k: z[k].shape for k in z.files} }", flush=True)
    return out


def run_cli(argv=CLI_ARGV):
    """The JAX CLI on argv with the host-stepped loops; its HOME (the
    compilation cache's root) is a temporary directory."""
    from admm_optim_tpu import cli
    from admm_optim_tpu.models import obstacle

    class Stepped(obstacle.ObstacleShapeOpt):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._ns_stepped = True
            self._admm_stepped_on = True

    orig, home = obstacle.ObstacleShapeOpt, os.environ.get("HOME")
    with tempfile.TemporaryDirectory() as tmp:
        obstacle.ObstacleShapeOpt = Stepped
        os.environ["HOME"] = tmp
        try:
            out_dir = os.path.join(tmp, "out")
            assert cli.main(argv + ["-outDir", out_dir]) == 0
        finally:
            obstacle.ObstacleShapeOpt = orig
            if home is not None:
                os.environ["HOME"] = home
        out = {k: np.asarray(open(os.path.join(out_dir, f)).read()) for k, f in TELEMETRY_FILES.items()}
    print(f"cli: {out}", flush=True)
    return out


def _state(prefix, st):
    """An ADMMState, batched or not, as numpy arrays under prefix_*."""
    return {f"{prefix}_{f}": np.asarray(getattr(st, f)) for f in (
        "u", "lam", "Lambda", "scaling", "admm_it", "total_newton", "total_lin_iters", "solver_iters",
        "converged", "failed", "stats")}


def run_global():
    """The global backend's goldens (tests/torch_global_golden.py)."""
    import torch_global_golden as G
    from admm_optim_tpu.core import geomgen, ugx
    from admm_optim_tpu.models import sweep
    from admm_optim_tpu.optim.spaces import GlobalOps

    out = {}
    for name, kw in G.CONFIGS.items():
        out.update(run_e2e(name, kw))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, G.GRID_NAME)
        G.write_channel_ugx(path, ugx, geomgen)
        out.update(run_e2e("grid2d", dict(G.GRID_CONFIG, grid_path=path), num_steps=1))
        cli_out = {"backend": run_cli(G.CLI_ARGVS["backend"]), "grid": run_cli(G.CLI_ARGVS["grid"] + ["-grid", path])}
    for case, files in cli_out.items():
        out.update({f"cli_{case}_{k}": v for k, v in files.items()})
    for name, kw in G.CONFIGS.items():
        prob = ObstacleShapeOpt(problem_config(kw))
        X = prob.X0
        Jp = jnp.asarray(G.jp_of(X, prob.obstacle_vmask))
        def global_ops(mgdata, coords, prob=prob):
            return GlobalOps(prob.struct, mgdata, coords, prob.elems, prob.free)

        st = admm.admm_inner_stepped(
            prob.cfg.admm, global_ops, (prob._assemble(X), X), Jp, G.ADMM_SIGMA, G.ADMM_SCALING,
            prob.ref_volume, prob.ref_barycenter, prob._admm_kernel_cache,
        )
        out.update(_state(f"admm_{name}", st))
        out[f"admm_{name}_Jp"] = np.asarray(Jp)
        print(f"admm {name}: admm_it {int(st.admm_it)} newton {int(st.total_newton)} lin {int(st.total_lin_iters)} "
              f"converged {bool(st.converged)} failed {bool(st.failed)}", flush=True)
        if name != "2dg":
            continue
        prob._ns_stepped = True
        states = sweep.sigma_sweep(prob, X, Jp, jnp.asarray(G.SWEEP_SIGMAS))
        out.update(_state("sigma_sweep", states))
        Xs = np.stack([np.asarray(X), np.asarray(X) + G.GEOMETRY_SHARE * np.asarray(states.u[0]).T])
        gstates = sweep.geometry_sweep(prob, Xs, np.broadcast_to(np.asarray(Jp), (2,) + Jp.shape),
                                       sigma=G.GEOMETRY_SIGMA)
        out.update(_state("geometry_sweep", gstates))
        s = jnp.asarray(out["2dg_ladder_s"])
        idx, drags = sweep.best_candidate(prob, X, s, states)
        out["best_index"], out["best_drags"] = np.asarray(idx), np.asarray(drags)
        print(f"sweeps: sigma counts {np.asarray(states.admm_it)} geometry {np.asarray(gstates.admm_it)} "
              f"best {idx} {drags}", flush=True)
    return out


def run_sweep():
    """geometry_sweep on the patch-backend problem of tests/test_sweep.py
    (tests/torch_global_golden.py's PATCH_SWEEP_*): the meshes, the shape
    gradient and the batched ADMMState."""
    import torch_global_golden as G
    from admm_optim_tpu.models import sweep

    prob = ObstacleShapeOpt(problem_config(G.PATCH_SWEEP_CONFIG))
    assert prob.use_patch
    Xs = G.perturbed_meshes(prob.X0, prob.free, G.PATCH_SWEEP_LANES)
    Jp = np.asarray(G.jp_of(prob.X0, prob.obstacle_vmask))
    states = sweep.geometry_sweep(prob, Xs, np.broadcast_to(Jp, (len(Xs),) + Jp.shape), sigma=G.PATCH_SWEEP_SIGMA)
    print(f"patch geometry_sweep: admm_it {np.asarray(states.admm_it)} newton {np.asarray(states.total_newton)} "
          f"lin {np.asarray(states.total_lin_iters)}", flush=True)
    return dict(_state("geometry_sweep_patch", states), Xs=Xs, Jp=Jp)


def run_ns_alone(name, kw):
    """The NS path alone at V.NS_VISC from the cold start, with the
    host-stepped drivers: Newton's linear counts per iteration, drag, the
    adjoint's count and J'."""
    import torch_variants_golden as V

    prob = ObstacleShapeOpt(problem_config(kw))
    assert not prob.use_ns_jac
    prob._ns_stepped = True
    X = prob.X0
    buf = Tee()
    with contextlib.redirect_stdout(buf):
        s, it, nrm, conv = prob._ns_solve(X, prob.initial_state(X), visc=V.NS_VISC, verbose=True)
    lin = [int(v) for v in re.findall(r"\((\d+) lin\)", buf.getvalue())]
    lam, adj_res, adj_it = prob._adjoint(X, s)
    out = dict(newton_iters=int(it), res_norm=float(nrm), converged=bool(conv), lin_iters=np.asarray(lin),
               drag=float(prob._drag(X, s)), adj_iters=int(adj_it), adj_res=float(adj_res),
               jprime=np.asarray(prob._jprime(X, s, lam)), s=np.asarray(s))
    print(f"{name}: newton {int(it)} lin {lin} |R| {float(nrm):.3e} drag {out['drag']!r} adjoint {int(adj_it)}",
          flush=True)
    return {f"{name}_{k}": np.asarray(v) for k, v in out.items()}


def run_variants():
    """The variants' goldens (tests/torch_variants_golden.py)."""
    import torch_variants_golden as V

    out = {}
    for name, kw in V.CONFIGS.items():
        out.update(run_e2e(name, kw, num_steps=1, admm_stepped=name != "b2nd", check=False))
    for name, kw in V.NS_CASES.items():
        out.update(run_ns_alone(name, kw))
    # the JAX package's monolithic newton_solve with its default
    # block-diagonal preconditioner and matrix-free jvp, on the P1/P1 space
    prob = ObstacleShapeOpt(problem_config(V.NS_CASES["ns_p1"]))
    X = prob.X0
    s, it, nrm, conv = ns_solver.newton_solve(prob.ns_space, X, prob.initial_state(X), V.NS_VISC, stab=V.P1_STAB)
    out.update(p1_mono_newton_iters=np.asarray(int(it)), p1_mono_res_norm=np.asarray(float(nrm)),
               p1_mono_converged=np.asarray(bool(conv)), p1_mono_drag=np.asarray(float(prob._drag(X, s))),
               p1_mono_s=np.asarray(s))
    print(f"p1_mono: newton {int(it)} |R| {float(nrm):.3e} converged {bool(conv)} drag {float(prob._drag(X, s))!r}",
          flush=True)
    return out


def run_shard():
    """The JAX single-device reference of tests/test_torch_patch_shard.py."""
    import torch_shard_ranks as R
    from admm_optim_tpu.core import geomgen
    from admm_optim_tpu.core.mesh import Hierarchy, refine
    from admm_optim_tpu.core.patches import build_patchset, pad_patchset
    from admm_optim_tpu.ops import patchstencil as st
    from admm_optim_tpu.ops import sparsity
    from admm_optim_tpu.ops.deformation import deformation_corner_block_fn, deformation_elem_mats
    from admm_optim_tpu.optim.spaces import PatchOps
    from admm_optim_tpu.solvers import patch_mg as pmg

    cfg = admm.ADMMConfig(**{f: getattr(R.ADMM_CFG, f) for f in R.ADMM_CFG.__dataclass_fields__})
    coeffs = (cfg.c_eps, cfg.tau, cfg.c_mass)
    out = {}
    for name, (dim, refs, ranks) in R.CASES.items():
        c = R.case(dim, refs, ranks)
        levels = [geomgen.channel_2d(n_side=(3, 2), diag="fixed") if dim == 2 else geomgen.channel_3d(n_side=(2, 1, 1))]
        for _ in range(refs):
            levels.append(refine(levels[-1]))
        hier = Hierarchy(levels)
        ps = pad_patchset(build_patchset(hier), ranks)
        lvl0 = hier.levels[0]
        pat0 = sparsity.build_pattern(lvl0.elems, lvl0.num_vertices, dim)
        fixed0 = jnp.asarray(np.repeat(lvl0.vertex_mask(R.DIRICHLET)[None], dim, axis=0))

        def base_dense_fn(coords0):
            em0 = deformation_elem_mats(coords0, jnp.asarray(lvl0.elems), *coeffs)
            v0 = sparsity.bake_dirichlet(pat0, sparsity.assemble_values(pat0, em0), fixed0)
            return jnp.linalg.inv(sparsity.to_dense(pat0, v0))

        struct = pmg.PatchMGStructure(ps)
        coords_p = st.to_patch(ps.fine, jnp.asarray(hier.fine.coords.T))
        data = pmg.assemble_patch_mg_p(ps, struct, coords_p, deformation_corner_block_fn(*coeffs), base_dense_fn,
                                       pmg.make_level_tables(ps, coords_p.dtype), sym=True)
        b = st.to_patch(ps.fine, jnp.asarray(c.b))
        res = pmg.cg_p(struct, data, b, **R.CG)
        ir = pmg.cg_ir_p(struct, data, b, **R.IR)
        pvalid = jnp.asarray((np.arange(ps.P) < c.ps.P).astype(np.float64))
        ops_ = PatchOps(struct, data, coords_p, pvalid=pvalid)
        sa = jax.jit(lambda Jp: admm.admm_inner_ops(cfg, ops_, Jp, R.SIGMA, 1.0, jnp.asarray(c.ref_vol),
                                                    jnp.asarray(c.ref_bary)))(st.to_patch(ps.fine, jnp.asarray(c.Jp)))
        g = dict(P=ps.P, b=c.b, Jp=c.Jp, lmax=data.lmax, base_inv=data.base_inv, vcycle=pmg.vcycle_p(struct, data, b),
                 cg_iters=res.iters, cg_converged=res.converged, cg_x=res.x, ir_rounds=ir.rounds,
                 ir_inner_iters=ir.inner_iters, ir_converged=ir.converged, ir_x=ir.x_hi + ir.x_lo)
        for l in range(len(ps.levels)):
            g[f"W{l}"], g[f"inv_diag{l}"] = data.W[l], data.inv_diag[l]
        g.update(_state("admm", sa))
        g.update({f: getattr(sa, f) for f in ("u_diff_norm", "lam_inc_norm", "max_grad_norm")})
        out.update({f"{name}_{k}": np.asarray(v) for k, v in g.items()})
        print(f"shard {name}: P {ps.P} cg {int(res.iters)} ir {int(ir.rounds)}/{int(ir.inner_iters)} admm_it "
              f"{int(sa.admm_it)} newton {int(sa.total_newton)} lin {int(sa.total_lin_iters)} "
              f"{np.asarray(sa.solver_iters)}", flush=True)
    return out


def main(which):
    if "e2e" in which:
        out = {}
        for name, kw in CONFIGS.items():
            out.update(run_e2e(name, kw))
        np.savez_compressed(E2E_OUT, **out)
        print(f"wrote {E2E_OUT} ({E2E_OUT.stat().st_size} bytes)", flush=True)
    if "adjoint" in which:
        gold = np.load(HERE / "ns_slice.npz")
        out = {}
        for name, (dim, refs) in ADJ_CASES.items():
            out.update(run_adjoint(name, dim, refs, gold))
        np.savez_compressed(ADJ_OUT, **out)
        print(f"wrote {ADJ_OUT} ({ADJ_OUT.stat().st_size} bytes)", flush=True)
    for name, run, path in (("ckpt", run_ckpt, TELEMETRY_OUT), ("cli", run_cli, CLI_OUT),
                            ("global", run_global, GLOBAL_OUT), ("variants", run_variants, VARIANTS_OUT),
                            ("shard", run_shard, SHARD_OUT), ("sweep", run_sweep, SWEEP_OUT)):
        if name in which:
            np.savez_compressed(path, **run())
            print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["e2e", "adjoint", "ckpt", "cli", "global", "variants", "shard", "sweep"])
