"""The cold-start viscosity ladder 0.16 -> 0.08 -> 0.04 -> 0.02 with the
PCD pressure block (ns_run.solve_ladder, ns_run.run with a target) against
the JAX package's, 2D refs=1, float64 on the CPU.  The JAX results are
goldens made by tests/goldens/make_pcd_goldens.py (the cold-start loop of
ObstacleShapeOpt.run through the host-stepped Newton, one recycle dict for
all rungs).

What is held and why:
  * the rungs taken (none inserted, all converged) and, on the first rung,
    every Newton and linear count and the rounding-stable prefix of |R|
    (the start and the first iteration; the second to 1e-3);
  * on the later rungs the counts are not rounding-stable: a 1e-15 relative
    change of the start state moves the linear count of a recycled solve by
    one 50-step chunk in the port (0.08: [116, 66, ..] becomes [116, 116, ..],
    which is the JAX package's), and 1e-14 moves the first solve of that
    rung from 116 to 66.  Held there: convergence below accept_tol, and
    that every linear count is lin_recycle_k re-image applies plus whole
    chunks, so the recycle space was carried into the first solve of every
    later rung;
  * drag, the adjoint (count, exit, lambda) and J' at the JAX package's
    converged state at 0.02, to 1e-12 / 1e-8 / 1e-8; the port's own
    converged state differs by its Newton residual, so its drag to 1e-7."""
import pathlib

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch import convert, ns_run
from admm_optim_tpu_torch.ops import navier_stokes as nsops
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers import ns_solver

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "pcd_ladder.npz")
VISC = 0.02


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def ctx():
    return ns_run.build(1, "cpu", torch.float64, visc=VISC, dim=2, pressure_precond="pcd")


def test_pcd_ladder_2d_refs1_matches_jax(ctx):
    sk.reset_launches()
    lad = ns_run.solve_ladder(ctx)
    assert sum(sk.launches.values()) == 0  # CPU tensors take the twins
    rungs = lad.rungs
    assert [r.nu for r in rungs] == [float(v) for v in GOLD["nus"]] == ns_run.continuation_ladder(VISC)
    assert [r.inserted for r in rungs] == [bool(v) for v in GOLD["inserted"]] == [False] * 4
    assert all(r.newton.converged for r in rungs) and bool(GOLD["rung_converged"].all())
    # first rung: no recycled solve before its third iteration, counts equal
    n0 = int(GOLD["newton_iters"][0])
    first = rungs[0].newton
    assert first.iters == n0 and first.lin_iters == [int(v) for v in GOLD["lin_iters"][0][:n0]]
    # |R| after the second iteration, the first with a recycled solve, already
    # moves with the last bits: making one mask of the PCD tables contiguous
    # (other strides, so another order of the sums) moved it by 1.6e-5 of itself
    gold_hist = GOLD["res_history"][0]
    assert _rel(first.res_history[:2], gold_hist[:2]) < 1e-8
    assert abs(first.res_history[2] - gold_hist[2]) <= 1e-3 * gold_hist[2]
    # later rungs: recycle space carried in, solves converge
    k, ch = ctx.cfg.lin_recycle_k, ctx.cfg.lin_exec_chunk
    assert k == int(GOLD["recycle_k"]) == 16
    for i, r in enumerate(rungs[1:], start=1):
        gold_lin = [int(v) for v in GOLD["lin_iters"][i] if v >= 0]
        for counts in (r.newton.lin_iters, gold_lin):
            assert all(n >= k and (n - k) % ch == 0 for n in counts), counts
        assert abs(r.newton.iters - int(GOLD["newton_iters"][i])) <= 1
        assert r.newton.res_norm <= ctx.cfg.accept_tol
        assert len(r.assembly_seconds) == r.newton.iters
        assert set(r.assembly_seconds[0]) == {"velocity", "pcd", "jacobian"}
    assert lad.recycle["U"].shape == (k, ctx.n_state)
    drag = float(nsops.drag(ctx.space, ctx.coords, lad.s, VISC))
    assert abs(drag - float(GOLD["drag"])) <= 1e-7 * float(GOLD["drag"])


def test_recycle_dict_seeds_the_next_solve(ctx):
    """newton_solve_stepped reads recycle["U"] before its first iterate and
    leaves the last iterate's space in it: a second solve handed the dict
    of the first charges lin_recycle_k re-image applies to its first linear
    solve, a solve without it does not."""
    k, ch = ctx.cfg.lin_recycle_k, ctx.cfg.lin_exec_chunk
    rec = {}
    a, _ = ns_run.newton(ctx, visc=0.16, recycle=rec)
    assert a.converged and a.lin_iters[0] % ch == 0 and rec["U"].shape == (k, ctx.n_state)
    U0 = rec["U"].clone()
    cold, _ = ns_run.newton(ctx, a.s, visc=0.08)
    warm, _ = ns_run.newton(ctx, a.s, visc=0.08, recycle=rec)
    assert cold.lin_iters[0] % ch == 0
    assert (warm.lin_iters[0] - k) % ch == 0 and warm.lin_iters[0] >= k
    assert warm.converged and cold.converged
    assert not torch.equal(rec["U"], U0)  # replaced by the space the second solve left


def test_drag_adjoint_and_jprime_at_the_jax_state_visc_002(ctx):
    """From the JAX package's converged state at 0.02: drag, the stepped
    adjoint with the transposed PCD preconditioner (count, exit, lambda)
    and J'."""
    s = convert.ns_state(GOLD["s"], "cpu")
    drag = float(nsops.drag(ctx.space, ctx.coords, s, VISC))
    assert abs(drag - float(GOLD["drag"])) <= 1e-12 * float(GOLD["drag"])
    sk.reset_launches()
    adj = ns_run.adjoint(ctx, s)
    assert adj.iters == int(GOLD["adj_iters"]) and adj.exit == "target"
    assert adj.res_norm <= adj.target
    assert abs(adj.target - float(GOLD["adj_target"])) <= 1e-8 * float(GOLD["adj_target"])
    assert _rel(adj.lam, GOLD["lam"]) < 1e-8
    jp = ns_run.jprime(ctx, s, adj.lam)
    assert _rel(jp, GOLD["jprime"]) < 1e-8
    assert _rel(ns_run.jprime(ctx, s, convert.ns_state(GOLD["lam"], "cpu")), GOLD["jprime"]) < 1e-12
    off = (ctx.obstacle_vmask == 0)[None].expand_as(jp)
    assert float(jp[off].abs().max()) == 0.0
    assert sum(sk.launches.values()) == 0


def _fake_newton(ok):
    """A stand-in for ns_run.newton: converged iff ok(previous converged
    viscosity or None, this viscosity)."""
    state = {"nu_ok": None, "calls": []}

    def newton(ctx, s0=None, visc=None, recycle=None):
        conv = ok(state["nu_ok"], visc)
        state["calls"].append((visc, conv, recycle))
        if conv:
            state["nu_ok"] = visc
        s = torch.full((3,), float(ctx.visc if visc is None else visc), dtype=torch.float64)
        res = ns_solver.NewtonResult(s, 1, 0.0 if conv else 1.0, conv, [1.0], [50], [0.0])
        return res, [{}]

    return newton, state


def test_ladder_inserts_geometric_mean_rungs(ctx, monkeypatch):
    """A rung that fails is retried from the last converged state at the
    geometric mean of the two viscosities (obstacle.py's cold-start loop):
    with a Newton that only survives steps of at most a factor 1.5, every
    halving gets one inserted rung; the records keep the failed attempts
    and one recycle dict serves all of them."""
    newton, state = _fake_newton(lambda prev, nu: prev is None or prev / nu <= 1.5)
    monkeypatch.setattr(ns_run, "newton", newton)
    lad = ns_run.solve_ladder(ctx)
    g = lambda a, b: float(np.sqrt(a * b))  # noqa: E731
    expect = [0.16, 0.08, g(0.16, 0.08), 0.08, 0.04, g(0.08, 0.04), 0.04, 0.02, g(0.04, 0.02), 0.02]
    assert [r.nu for r in lad.rungs] == expect
    assert [r.newton.converged for r in lad.rungs] == [True, False, True, True, False, True, True, False, True, True]
    assert [r.inserted for r in lad.rungs] == [n not in (0.16, 0.08, 0.04, 0.02) for n in expect]
    assert float(lad.s[0]) == 0.02
    assert all(c[2] is lad.recycle for c in state["calls"])


def test_ladder_raises_after_six_insertions(ctx, monkeypatch):
    """At most 6 bisections: a Newton that never converges is tried 7
    times, then the ladder raises with the records of all seven.  With no converged rung yet the mean is
    taken with twice the list's current first rung, which is the rung just
    inserted (the JAX package's loop, kept): each retry is sqrt(2) higher."""
    newton, state = _fake_newton(lambda prev, nu: False)
    monkeypatch.setattr(ns_run, "newton", newton)
    with pytest.raises(RuntimeError, match="initial NS solve failed") as err:
        ns_run.solve_ladder(ctx)
    nus = [c[0] for c in state["calls"]]
    assert [r.nu for r in err.value.rungs] == nus and not any(r.newton.converged for r in err.value.rungs)
    assert len(nus) == 7 and nus[0] == 0.16
    for a, b in zip(nus, nus[1:]):
        assert abs(b - np.sqrt(2.0) * a) < 1e-14


def test_run_with_a_target_runs_the_ladder_first(ctx, monkeypatch):
    """run(ctx, target_visc): ladder, then drag, adjoint and J' at the
    target, on a context moved to that viscosity; without a target the
    single cold-start solve at ctx.visc."""
    newton, state = _fake_newton(lambda prev, nu: True)
    seen = {}
    monkeypatch.setattr(ns_run, "newton", newton)
    monkeypatch.setattr(nsops, "drag", lambda space, X, s, visc: torch.tensor(visc, dtype=torch.float64))
    monkeypatch.setattr(ns_run, "adjoint", lambda c, s: seen.setdefault("adj", (c.visc, float(s[0]))) and
                        ns_solver.AdjointResult(s, 0.0, 0, "target", 1.0, 0))
    monkeypatch.setattr(ns_run, "jprime", lambda c, s, lam: torch.ones(2, 3))
    out = ns_run.run(ctx.at_visc(0.16), target_visc=0.04)
    assert [r.nu for r in out.rungs] == [0.16, 0.08, 0.04] and out.drag == 0.04
    assert seen["adj"] == (0.04, 0.04) and out.newton is out.rungs[-1].newton
    assert set(out.seconds) == set(out.launches) == {"newton", "drag", "adjoint", "jprime"}
    state["calls"].clear()
    out = ns_run.run(ctx.at_visc(0.16))
    assert out.rungs is None and [c[0] for c in state["calls"]] == [None]


def test_run_from_a_state_takes_one_rung(ctx, monkeypatch):
    """run(ctx, target_visc, s0=s): one Newton solve at the target from s
    with a recycle space of its own (no ladder), then drag, adjoint and J'
    there; the one rung is the run's record."""
    calls = []

    def newton(c, s0=None, visc=None, recycle=None):
        calls.append((c.visc, s0, visc, recycle))
        res = ns_solver.NewtonResult(s0 + 1.0, 2, 0.0, True, [1.0], [50], [0.0])
        return res, [{"velocity": 0.0}]

    monkeypatch.setattr(ns_run, "newton", newton)
    monkeypatch.setattr(ns_run, "solve_ladder", lambda c: pytest.fail("the ladder ran"))
    monkeypatch.setattr(nsops, "drag", lambda space, X, s, visc: torch.tensor(visc, dtype=torch.float64))
    monkeypatch.setattr(ns_run, "adjoint", lambda c, s: ns_solver.AdjointResult(s, 0.0, 0, "target", 1.0, 0))
    monkeypatch.setattr(ns_run, "jprime", lambda c, s, lam: torch.ones(2, 3))
    s0 = torch.zeros(3, dtype=torch.float64)
    out = ns_run.run(ctx.at_visc(0.16), target_visc=0.02, s0=s0)
    assert len(calls) == 1 and calls[0][0] == 0.02 and calls[0][1] is s0 and calls[0][3] == {}
    assert [(r.nu, r.inserted) for r in out.rungs] == [(0.02, False)] and out.newton is out.rungs[-1].newton
    assert out.rungs[0].seconds == out.seconds["newton"] and out.assembly_seconds == [{"velocity": 0.0}]
    assert out.drag == 0.02 and bool((out.adjoint.lam == 1.0).all())
