"""The NS slice of the port (ns_run: cold start, Newton, drag, adjoint, J')
against the JAX package's ObstacleShapeOpt on the patch backend (the
host-stepped newton_solve_stepped with GCRO-DR, the stepped adjoint with
the vjp-transposed preconditioner, the masked shape gradient), float64 on
the CPU.  The JAX results are goldens made by tests/goldens/make_ns_goldens.py.

What is held and why:
  * Newton and linear iteration counts (in lin_exec_chunk units) and the
    adjoint iteration count are equal;
  * the |R| history is equal to 1e-8 only over the iterations that do not
    amplify rounding: from the third Newton iteration (2D) or the first
    Arnoldi cycle (3D) on, a 1e-15 change of the start state moves |R| by
    O(1) relative in either package (test_torch_ns_slice_newton.py shows
    it), so later entries are held to convergence below accept_tol;
  * drag, adjoint lambda and J' are held at the JAX package's converged
    state to 1e-12 / 1e-8 / 1e-8; the port's own converged state differs
    from it by its Newton residual (~1e-10), so its drag to 1e-8."""
import pathlib

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch import convert, ns_run
from admm_optim_tpu_torch.ops import navier_stokes as nsops
from admm_optim_tpu_torch.ops import stencil_kernels as sk

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "ns_slice.npz")
VISC = 0.16


def _g(case, key):
    return GOLD[f"{case}_{key}"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_slice_2d_refs1_matches_jax():
    """ns_run.run end to end: counts, the |R| history's rounding-stable
    prefix, converged drag, adjoint count and target, J' masked to the
    obstacle surface; no kernel launches on CPU tensors."""
    case = "2d_refs1"
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2)
    out = ns_run.run(ctx)
    nw = out.newton
    assert nw.iters == int(_g(case, "newton_iters")) and nw.converged == bool(_g(case, "converged"))
    assert nw.lin_iters == [int(v) for v in _g(case, "lin_iters")]
    hist = _g(case, "res_history")
    assert len(nw.res_history) == len(hist)
    assert _rel(nw.res_history[:3], hist[:3]) < 1e-8
    assert nw.res_norm <= ctx.cfg.accept_tol and hist[-1] <= ctx.cfg.accept_tol
    assert abs(out.drag - float(_g(case, "drag"))) <= 1e-8 * abs(float(_g(case, "drag")))
    assert out.adjoint.iters == int(_g(case, "adj_iters")) and out.adjoint.exit == "target"
    assert out.adjoint.res_norm <= out.adjoint.target
    assert abs(out.adjoint.target - float(_g(case, "adj_target"))) <= 1e-8 * float(_g(case, "adj_target"))
    jp = out.jprime
    assert jp.shape == (2, ctx.space.n_vertices) and bool(torch.isfinite(jp).all())
    off = (ctx.obstacle_vmask == 0)[None].expand_as(jp)
    assert float(jp[off].abs().max()) == 0.0 and out.jprime_norm > 0
    assert all(sum(n.values()) == 0 for n in out.launches.values())
    assert set(out.seconds) == set(out.launches_by_lattice) == {"newton", "drag", "adjoint", "jprime"}
    assert not any(out.launches_by_lattice.values())


@pytest.mark.parametrize("case,dim", [("2d_refs1", 2), ("3d_refs1", 3)])
def test_drag_adjoint_and_jprime_at_the_jax_state(case, dim):
    """From the JAX package's converged state: drag, the stepped adjoint
    (iteration count, exit, lambda) and J' against the JAX package's."""
    ctx = ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=dim)
    s = convert.ns_state(_g(case, "s"), "cpu")
    drag = float(nsops.drag(ctx.space, ctx.coords, s, ctx.visc))
    assert abs(drag - float(_g(case, "drag"))) <= 1e-12 * abs(float(_g(case, "drag")))
    sk.reset_launches()
    adj = ns_run.adjoint(ctx, s)
    assert adj.iters == int(_g(case, "adj_iters")) and adj.exit == "target"
    assert adj.res_norm <= adj.target
    assert _rel(adj.lam, _g(case, "lam")) < 1e-8
    jp = ns_run.jprime(ctx, s, adj.lam)
    assert _rel(jp, _g(case, "jprime")) < 1e-8
    # J' is linear in lambda: at the JAX package's lambda it is its J'
    assert _rel(ns_run.jprime(ctx, s, convert.ns_state(_g(case, "lam"), "cpu")), _g(case, "jprime")) < 1e-12
    assert sum(sk.launches.values()) == 0
