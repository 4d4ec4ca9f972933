"""Make tests/goldens/pcd_ladder.npz, the JAX package's cold-start
viscosity ladder with the PCD pressure block that
tests/test_torch_ns_ladder.py holds the port to.

The case is the 2D refs=1 geomgen channel, float64 on the CPU, target
viscosity 0.02, ``pressure_precond="pcd"`` on the patch backend with the
assembled lattice Jacobian.  The script runs the cold-start loop of
``ObstacleShapeOpt.run`` (models/obstacle.py: the rungs of
``_continuation_ladder``, a failed rung retried at the geometric mean, one
GCRO-DR recycle dict for all rungs) through the host-stepped
``newton_solve_stepped``, recording per attempted rung its viscosity, the
Newton and linear iteration counts and |R| after every Newton iteration;
then the drag, the host-stepped adjoint with the vjp-transposed PCD
preconditioner and the masked shape gradient J' at 0.02.  The JAX side
compiles its stepped kernels for minutes on one CPU core, too long for the
test lane, hence the goldens.  Run from the repository root:

    python tests/goldens/make_pcd_goldens.py
"""
import contextlib
import io
import os
import pathlib
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parents[1]), str(HERE)]

from admm_optim_tpu.models.obstacle import (  # noqa: E402
    ObstacleShapeOpt, ProblemConfig, _continuation_ladder,
)
from make_ns_goldens import spy_line_search  # noqa: E402

OUT = HERE / "pcd_ladder.npz"
VISC = 0.02
DIM, REFS = 2, 1


def ladder(prob, X):
    """obstacle.py's cold-start continuation loop, one record per attempt."""
    s = prob.initial_state(X)
    nus = list(_continuation_ladder(VISC))
    planned = set(nus)
    rungs = []
    nu_ok, bisects, i = None, 0, 0
    conv = True
    record = []  # |R| of every solve in turn: the spy wraps the kernels jitted by the first
    stack = contextlib.ExitStack()
    stack.enter_context(spy_line_search(record))
    while i < len(nus):
        nu = nus[i]
        n0, buf = len(record), io.StringIO()
        with contextlib.redirect_stdout(buf):
            s_try, it, nrm, conv = prob._ns_solve(X, s, visc=nu, verbose=True)
        hist = record[n0:]
        lin = [int(v) for v in re.findall(r"\((\d+) lin\)", buf.getvalue())]
        assert len(lin) == int(it) and len(hist) == int(it) + 1, (lin, hist, int(it))
        rungs.append(dict(nu=nu, inserted=nu not in planned, iters=int(it), lin=lin, hist=hist,
                          converged=bool(conv)))
        print(f"rung nu={nu:.5f} newton {int(it)} lin {lin} |R| {hist} converged {bool(conv)}", flush=True)
        if bool(conv):
            s, nu_ok = s_try, nu
            i += 1
            continue
        if bisects >= 6:
            break
        prev = nu_ok if nu_ok is not None else nus[0] * 2.0
        nus.insert(i, float(np.sqrt(prev * nu)))
        bisects += 1
    stack.close()
    assert bool(conv), "the ladder failed"
    return s, rungs


def main():
    prob = ObstacleShapeOpt(ProblemConfig(dim=DIM, num_refs=REFS, visc=VISC, pressure_precond="pcd"))
    assert prob.use_patch_ns and prob.use_ns_jac
    prob._ns_stepped = True  # the host-stepped solvers, as at flagship sizes
    X = prob.X0
    s, rungs = ladder(prob, X)
    lam, adj_res, adj_it = prob._adjoint(X, s)
    target = max(prob.cfg.ns.lin_abs_tol, prob.cfg.ns.adj_rel_tol * float(prob._adj_gj_norm(X, s)))
    jp = np.asarray(prob._jprime(X, s, lam))
    n_max = max(len(r["hist"]) for r in rungs)
    out = dict(
        s=np.asarray(s), nus=np.asarray([r["nu"] for r in rungs]),
        inserted=np.asarray([r["inserted"] for r in rungs]),
        rung_converged=np.asarray([r["converged"] for r in rungs]),
        newton_iters=np.asarray([r["iters"] for r in rungs]),
        # ragged per-rung lists padded with -1 (counts) and nan (|R|)
        lin_iters=np.asarray([r["lin"] + [-1] * (n_max - 1 - len(r["lin"])) for r in rungs]),
        res_history=np.asarray([r["hist"] + [np.nan] * (n_max - len(r["hist"])) for r in rungs]),
        drag=float(prob._drag(X, s)), lam=np.asarray(lam), adj_res=float(adj_res),
        adj_iters=int(adj_it), adj_target=target, jprime=jp,
        recycle_k=int(prob.cfg.ns.lin_recycle_k),
    )
    print(f"drag {out['drag']!r} adjoint {int(adj_it)} its res {float(adj_res):.3e} target {target:.3e} "
          f"|J'| {float(jnp.linalg.norm(jp)):.6e}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
