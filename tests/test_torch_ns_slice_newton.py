"""The port's cold-start Newton solve at 3D refs=1 against the JAX
package's (goldens of tests/goldens/make_ns_goldens.py), and the rounding
sensitivity of the Newton |R| history that bounds what the slice tests
can hold (see tests/test_torch_ns_slice.py)."""
import pathlib

import numpy as np
import torch

from admm_optim_tpu_torch import ns_run
from admm_optim_tpu_torch.ops import navier_stokes as nsops

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "ns_slice.npz")
VISC = 0.16


def test_newton_3d_refs1_matches_jax():
    """Equal Newton and linear iteration counts, |R|(s0) to 1e-12, the
    first iterate to 1e-3 (the first 3D Arnoldi cycle already amplifies
    rounding: the two packages' first corrections differ by ~3e-5 relative
    and |R| after it by ~2e-6), both converged below accept_tol; the drag
    of the two converged states to 1e-8."""
    case = "3d_refs1"
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=3)
    res, assembly = ns_run.newton(ctx)
    hist = GOLD[f"{case}_res_history"]
    assert res.iters == int(GOLD[f"{case}_newton_iters"]) and res.converged
    assert res.lin_iters == [int(v) for v in GOLD[f"{case}_lin_iters"]]
    assert len(res.res_history) == len(hist) and len(assembly) == res.iters
    assert abs(res.res_history[0] - hist[0]) <= 1e-12 * hist[0]
    assert abs(res.res_history[1] - hist[1]) <= 1e-3 * hist[1]
    assert res.res_norm <= ctx.cfg.accept_tol and hist[-1] <= ctx.cfg.accept_tol
    drag = float(nsops.drag(ctx.space, ctx.coords, res.s, ctx.visc))
    assert abs(drag - float(GOLD[f"{case}_drag"])) <= 1e-8 * float(GOLD[f"{case}_drag"])


def test_newton_history_amplifies_rounding():
    """Why the slice tests hold only a prefix of the |R| history: at 2D
    refs=1 a relative change of 1e-15 in the start state leaves the first
    two Newton iterates equal to ~1e-14 but moves |R| after the third
    (the second recycled GCRO-DR solve) by more than 1e-3 relative, with
    the same iteration counts and both runs converged."""
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2)
    s0 = ns_run.initial_state(ctx)
    a, _ = ns_run.newton(ctx, s0)
    eps = torch.from_numpy(np.random.default_rng(1).normal(size=s0.shape[0]))
    b, _ = ns_run.newton(ctx, s0 * (1 + 1e-15 * eps))
    ha, hb = np.asarray(a.res_history), np.asarray(b.res_history)
    assert a.lin_iters == b.lin_iters and a.iters == b.iters
    assert np.abs(ha[:3] - hb[:3]).max() <= 1e-12 * ha[0]
    assert abs(ha[3] - hb[3]) > 1e-3 * ha[3]
    assert a.converged and b.converged
