"""Make the JAX package's ADMM results that tests/test_torch_admm.py holds
the port to: tests/goldens/admm_3d_refs1.npz and admm_3d_refs1_relaxed.npz.

On the 3D refs=1 fixture of tests/torch_admm_problems.py, in float64 on
the CPU, it records the JAX package's admm_inner_ops
  * "bicgstab": with the fixture's ADMMConfig, admm_steps=2,
  * "cg": with bench.py's solver settings (BENCH_SOLVER),
and "next": one ADMM iteration (z-update, newton_xupdate_ops with zero
warm starts, dual ascent) from the final "bicgstab" state, into the first
file; into the second
  * "relaxed": relax_alpha = 1.5 and lin_accept_rel = 1e-4 (RELAXED),
and the counts and flags of the same run without the acceptance
(STRICT) as "strict_*".  The JAX side compiles for about three minutes on
one CPU core, too long for the test lane, hence the goldens.  Run from the
repository root, naming the files to make (all of them by default):

    python tests/goldens/make_admm_goldens.py [admm_3d_refs1.npz] [admm_3d_refs1_relaxed.npz]
"""
import dataclasses
import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]

from admm_optim_tpu.optim import admm as jadmm  # noqa: E402
from torch_admm_problems import GOLDEN_FILES, RUNS, SCALING, SIGMA, STRICT, jax_problem  # noqa: E402

STATE_FIELDS = (
    "u", "lam", "q_proj", "Lambda", "scaling", "admm_it", "total_newton", "total_lin_iters",
    "solver_iters", "converged", "failed", "u_diff_norm", "lam_inc_norm", "max_grad_norm", "stats",
)
COUNT_FIELDS = ("admm_it", "total_newton", "total_lin_iters", "solver_iters", "converged", "failed")


def next_iteration(cfg, p, st):
    """One ADMM iteration from st, as admm_inner_ops's body runs it, with
    zero Krylov warm starts."""
    ops = p.ops
    q_proj = ops.z_update(st.u, st.lam, cfg.tau, SIGMA, cfg.norm_name)
    max_norm = ops.max_grad_norm(st.u_old, cfg.norm_name)
    u, Lambda, nit, nlin, lin_each, failed, _, _, _ = jadmm.newton_xupdate_ops(
        cfg, ops, p.Jp, st.scaling, st.lam, q_proj, p.ref_vol, p.ref_bary, st.u, st.Lambda,
    )
    lam, lam_inc = ops.dual_update(u, st.lam, q_proj, cfg.tau)
    return dict(
        u=u, Lambda=Lambda, lam=lam, q_proj=q_proj, newton_iters=nit, lin_iters=nlin,
        lin_each=lin_each, failed=failed, max_grad_norm=max_norm,
        u_diff_norm=ops.norm_p1(u - st.u_old), lam_inc_norm=ops.norm_pc(lam_inc),
    )


def run(p, name, over):
    cfg = dataclasses.replace(p.cfg, **over)
    st = jadmm.admm_inner_ops(cfg, p.ops, p.Jp, SIGMA, SCALING, p.ref_vol, p.ref_bary)
    print(name, *(np.asarray(getattr(st, f)) for f in COUNT_FIELDS), flush=True)
    return cfg, st


def main(files):
    p = jax_problem(3, 1)
    for fname in files:
        out = {}
        for name in GOLDEN_FILES[fname]:
            cfg, st = run(p, name, RUNS[name])
            for f in STATE_FIELDS:
                out[f"{name}_{f}"] = np.asarray(getattr(st, f))
            if name == "bicgstab":
                for k, v in next_iteration(cfg, p, st).items():
                    out[f"next_{k}"] = np.asarray(v)
            if name == "relaxed":
                _, strict = run(p, "strict", STRICT)
                for f in COUNT_FIELDS:
                    out[f"strict_{f}"] = np.asarray(getattr(strict, f))
        path = HERE / fname
        np.savez_compressed(path, **out)
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    names = sys.argv[1:] or list(GOLDEN_FILES)
    unknown = set(names) - set(GOLDEN_FILES)
    if unknown:
        raise SystemExit(f"unknown golden files {sorted(unknown)}; known: {list(GOLDEN_FILES)}")
    main(names)
