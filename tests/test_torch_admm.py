"""The port's ADMM inner loop (optim.admm.admm_inner over
optim.spaces.PatchOps, with the batched multi-lane Krylov x-solves) against
the JAX package's admm_inner_ops on the 3D refs=1 fixture, float64, with
the fixture's config (BiCGStab) and with bench.py's solver settings (CG).

The JAX loop compiles for minutes on one CPU core, so its results are
goldens (tests/goldens/admm_3d_refs1.npz and admm_3d_refs1_relaxed.npz,
made by tests/goldens/make_admm_goldens.py from the JAX package); the port
builds its own operator from the same mesh.  The BiCGStab run is cut to
admm_steps=2 (torch_admm_problems.RUNS): over the fixture's full run the
per-lane Krylov counts move by a few iterations with a one-ulp change of
the operator, in the JAX package as in the port.  The "relaxed" run holds
relax_alpha != 1 and lin_accept_rel > 0, which f32_presets turns on."""
import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

from admm_optim_tpu.optim import admm as jadmm
from admm_optim_tpu_torch import admm_run, convert, xupdate_solve
from admm_optim_tpu_torch.optim import admm
from torch_admm_problems import FIXTURE_CFG, GOLDEN_FILES, RUNS, SCALING, SIGMA, STRICT, jax_targets, port_problem

torch.set_num_threads(1)

GOLD = {k: v for f in GOLDEN_FILES for k, v in np.load(pathlib.Path(__file__).parent / "goldens" / f).items()}
CFGS = {name: dataclasses.replace(jadmm.ADMMConfig(**FIXTURE_CFG), **over) for name, over in RUNS.items()}


@pytest.fixture(scope="module")
def problem():
    """The port's fixture problem with the JAX package's constraint targets
    (see torch_admm_problems.jax_targets)."""
    p = port_problem(3, 1)
    p.ref_vol, p.ref_bary = (torch.as_tensor(np.array(v)) for v in jax_targets(p.hier.fine))
    return p


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _admm_run(problem, cfg):
    """admm_inner on the fixture with every output hook: (state, callback
    iterations, stats rows, Newton history, debug fields)."""
    ks, rows, hist, dbg = [], [], [], {}
    st = admm.admm_inner(
        cfg, problem.ops, problem.Jp, SIGMA, SCALING, problem.ref_vol, problem.ref_bary,
        iter_cb=lambda k, u, Lambda: ks.append(k), newton_hist_out=hist, full_stats_out=rows,
        debug_out=dbg,
    )
    return st, ks, rows, hist, dbg


@pytest.fixture(scope="module")
def bicgstab_run(problem):
    """The lane-batched BiCGStab run, shared by the parity test and the
    xsolve_sequential test."""
    return _admm_run(problem, convert.admm_config(CFGS["bicgstab"]))


@pytest.mark.parametrize("name", ["bicgstab", "cg", "relaxed"])
def test_admm_inner_matches_jax(problem, name, request):
    cfg = convert.admm_config(CFGS[name])
    for f in ("x_solver", "relax_alpha", "lin_accept_rel", "lin_max_iters"):
        assert getattr(cfg, f) == getattr(CFGS[name], f), f
    g = {k[len(name) + 1:]: v for k, v in GOLD.items() if k.startswith(name + "_")}
    st, ks, rows, hist, dbg = request.getfixturevalue("bicgstab_run") if name == "bicgstab" else _admm_run(problem, cfg)
    # counts and flags exactly, per lane of the batched Krylov solves too
    assert st.admm_it == int(g["admm_it"])
    assert st.total_newton == int(g["total_newton"])
    assert st.total_lin_iters == int(g["total_lin_iters"])
    assert st.solver_iters == g["solver_iters"].tolist()
    assert (st.converged, st.failed) == (bool(g["converged"]), bool(g["failed"]))
    # the iterate, the multipliers and the per-iteration stats
    for f in ("u", "lam", "q_proj", "Lambda", "stats"):
        assert _rel(getattr(st, f), g[f]) <= 1e-9, f
    for f in ("u_diff_norm", "lam_inc_norm", "max_grad_norm", "scaling"):
        assert abs(getattr(st, f) - float(g[f])) <= 1e-9 * max(abs(float(g[f])), 1e-30), f
    # the outputs of the JAX package's stepped driver: one callback and one
    # stats row per iteration across restarts, the last row also in stats
    assert ks == list(range(len(rows))) and len(rows) >= st.admm_it
    assert any(_rel(rows[-1], r) <= 1e-12 for r in st.stats.numpy())
    assert 1 <= len(hist) <= cfg.ns_max_its and all(len(r) == 4 + 1 + 4 for r in hist)
    assert set(dbg) == {"Lu", "rhs_large", "du"} and dbg["du"].shape == st.u.shape


def test_relaxed_run_needs_its_acceptance(problem):
    """The "relaxed" run without lin_accept_rel (STRICT): the port fails at
    its first solve with the JAX package's counts, where the JAX record of
    the relaxed run went on, so the acceptance branch took effect there."""
    g = {k[len("strict_"):]: v for k, v in GOLD.items() if k.startswith("strict_")}
    assert bool(g["failed"]) and int(g["admm_it"]) < int(GOLD["relaxed_admm_it"])
    assert int(g["total_newton"]) < int(GOLD["relaxed_total_newton"])
    cfg = convert.admm_config(dataclasses.replace(jadmm.ADMMConfig(**FIXTURE_CFG), **STRICT))
    assert cfg.lin_accept_rel == 0.0 and cfg.relax_alpha == STRICT["relax_alpha"]
    st = admm.admm_inner(cfg, problem.ops, problem.Jp, SIGMA, SCALING, problem.ref_vol, problem.ref_bary)
    assert (st.admm_it, st.total_newton, st.total_lin_iters) == tuple(
        int(g[f]) for f in ("admm_it", "total_newton", "total_lin_iters")
    )
    assert st.solver_iters == g["solver_iters"].tolist()
    assert (st.converged, st.failed) == (bool(g["converged"]), bool(g["failed"]))


def test_next_iterate_from_converted_jax_state(problem):
    """convert.admm_state carries the JAX package's final BiCGStab state
    over; one port ADMM iteration from it (zero warm starts) gives the
    JAX package's next iterate."""
    jstate = types.SimpleNamespace(**{
        f: GOLD["bicgstab_" + f] for f in (
            "u", "lam", "q_proj", "Lambda", "scaling", "admm_it", "total_newton",
            "total_lin_iters", "solver_iters", "converged", "failed", "u_diff_norm",
            "lam_inc_norm", "max_grad_norm", "stats",
        )
    })
    jstate.u_old = jstate.u  # the loop leaves u_old = u
    st = convert.admm_state(jstate, "cpu")
    assert st.u.dtype == torch.float64 and st.solver_iters == GOLD["bicgstab_solver_iters"].tolist()
    cfg = convert.admm_config(CFGS["bicgstab"])
    new, xsols, nr, row = admm.admm_iteration(
        cfg, problem.ops, problem.Jp, SIGMA, problem.ref_vol, problem.ref_bary, st,
    )
    assert nr.iters == int(GOLD["next_newton_iters"])
    assert nr.lin_each == GOLD["next_lin_each"].tolist()
    assert nr.failed == bool(GOLD["next_failed"])
    assert xsols.shape == (5,) + st.u.shape
    for f in ("u", "Lambda", "lam", "q_proj"):
        assert _rel(getattr(new, f), GOLD["next_" + f]) <= 1e-9, f
    for f in ("u_diff_norm", "lam_inc_norm", "max_grad_norm"):
        assert abs(getattr(new, f) - float(GOLD["next_" + f])) <= 1e-9 * float(GOLD["next_" + f]), f
    assert new.total_newton == st.total_newton + nr.iters
    assert row[:2] == [st.scaling, SIGMA]


def test_admm_run_cpu_drive():
    """admm_run.run at bench.py's settings on the refs=1 channel, float64
    on the CPU: the x-update's Newton misses ns_tol = 1e-4 within its two
    iterations, which counts as failure and ends the loop after one ADMM
    iteration, as in the JAX package (admm.py:418-419, :553).  The
    per-lane Krylov counts are those of bench.py's admm_throughput on the
    same refs=1 context in float64."""
    ctx = xupdate_solve.build(1, "cpu", torch.float64)
    out = admm_run.run(ctx)
    s = out.state
    assert (s.admm_it, s.total_newton, s.converged, s.failed) == (1, 2, False, True)
    assert s.solver_iters == [12, 13, 12, 12, 13] and s.total_lin_iters == 62
    assert s.u.shape == (3,) + ctx.ps.fine.lat_shape + (ctx.ps.P,)
    assert bool(torch.isfinite(s.u).all()) and float(s.u.abs().max()) > 0.0
    assert out.seconds > 0.0


def test_xsolve_sequential_equals_the_lane_batched_run(problem, bicgstab_run):
    """xsolve_sequential runs the 1+m x-update solves one lane at a time
    (the JAX package's lax.map, admm.py:297-300); each lane takes the loop
    it takes in the lane-batched solve (the vmap): the same counts, per
    lane too, which are the JAX package's, and u and Lambda within 1e-12 of
    their max (the batched dots sum in another order)."""
    cfg = dataclasses.replace(convert.admm_config(CFGS["bicgstab"]), xsolve_sequential=True)
    batched = bicgstab_run[0]
    seq = admm.admm_inner(cfg, problem.ops, problem.Jp, SIGMA, SCALING, problem.ref_vol, problem.ref_bary)
    runs = (batched, seq)
    for st in runs:
        assert st.solver_iters == GOLD["bicgstab_solver_iters"].tolist()
        assert (st.admm_it, st.total_newton, st.total_lin_iters) == tuple(
            int(GOLD["bicgstab_" + f]) for f in ("admm_it", "total_newton", "total_lin_iters"))
        assert (st.converged, st.failed) == (bool(GOLD["bicgstab_converged"]), bool(GOLD["bicgstab_failed"]))
        for f in ("u", "Lambda"):
            assert _rel(getattr(st, f), GOLD["bicgstab_" + f]) <= 1e-9, f
    for f in ("u", "Lambda"):
        assert _rel(getattr(seq, f), getattr(batched, f)) <= 1e-12, f


@pytest.mark.parametrize("seq", [False, True])
def test_admm_config_carries_xsolve_sequential(seq):
    jcfg = jadmm.ADMMConfig(xsolve_sequential=seq, x_solver="cg")
    cfg = convert.admm_config(jcfg)
    assert cfg.xsolve_sequential is seq and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
