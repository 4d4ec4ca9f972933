"""Make tests/goldens/ns_slice.npz, the JAX package's NS slice results that
tests/test_torch_ns_slice.py holds the port to.

For each case (2D refs=1, 3D refs=1; geomgen channel, visc 0.16, float64 on
the CPU) it builds the JAX package's ObstacleShapeOpt (patch backend,
assembled lattice Jacobian) and runs, from the cold start
(``initial_state``):
  * the host-stepped Newton solve (``newton_solve_stepped`` with GCRO-DR),
    recording |R| after every iteration and the linear iterations per
    Newton iteration;
  * the drag;
  * the host-stepped adjoint with the vjp-transposed preconditioner;
  * the masked shape gradient J'.
The JAX side compiles its stepped kernels for minutes on one CPU core, too
long for the test lane, hence the goldens.  Run from the repository root:

    python tests/goldens/make_ns_goldens.py
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
sys.path[:0] = [str(HERE.parents[1])]

from admm_optim_tpu.models.obstacle import ObstacleShapeOpt, ProblemConfig  # noqa: E402

OUT = HERE / "ns_slice.npz"
VISC = 0.16
CASES = {"2d_refs1": (2, 1), "3d_refs1": (3, 1)}


@contextlib.contextmanager
def spy_line_search(record):
    """Record |R| after each Newton iteration: wrap the jitted line search
    (and the initial residual norm) that newton_solve_stepped builds."""
    orig = jax.jit

    def jit(fn, *a, **k):
        g = orig(fn, *a, **k)
        name = getattr(fn, "__name__", "")
        if name == "ls_step":
            def ls(*args):
                out = g(*args)
                record.append(float(out[1]))
                return out
            return ls
        if name == "resnorm":
            def rn(*args):
                out = g(*args)
                record.append(float(out))
                return out
            return rn
        return g

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = orig


def run_case(dim, refs):
    prob = ObstacleShapeOpt(ProblemConfig(dim=dim, num_refs=refs, visc=VISC))
    assert prob.use_patch_ns and prob.use_ns_jac
    prob._ns_stepped = True  # the host-stepped drivers, as at flagship sizes
    X = prob.X0
    hist = []
    buf = io.StringIO()
    with spy_line_search(hist), contextlib.redirect_stdout(buf):
        s, it, nrm, conv = prob._ns_solve(X, prob.initial_state(X), visc=VISC, verbose=True)
    lin = [int(v) for v in re.findall(r"\((\d+) lin\)", buf.getvalue())]
    assert len(lin) == int(it) and len(hist) == int(it) + 1, (lin, hist, int(it))
    lam, adj_res, adj_it = prob._adjoint(X, s)
    target = max(prob.cfg.ns.lin_abs_tol, prob.cfg.ns.adj_rel_tol * float(prob._adj_gj_norm(X, s)))
    out = dict(
        s=np.asarray(s), newton_iters=int(it), res_norm=float(nrm), converged=bool(conv),
        res_history=np.asarray(hist), lin_iters=np.asarray(lin),
        drag=float(prob._drag(X, s)), lam=np.asarray(lam), adj_res=float(adj_res),
        adj_iters=int(adj_it), adj_target=target, jprime=np.asarray(prob._jprime(X, s, lam)),
    )
    print(f"{dim}D refs={refs}: newton {int(it)} lin {lin} |R| {hist} drag {out['drag']!r} "
          f"adjoint {int(adj_it)} its res {float(adj_res):.3e} target {target:.3e} "
          f"|J'| {float(jnp.linalg.norm(out['jprime'])):.6e}", flush=True)
    return out


def main():
    out = {}
    for name, (dim, refs) in CASES.items():
        for k, v in run_case(dim, refs).items():
            out[f"{name}_{k}"] = np.asarray(v)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
