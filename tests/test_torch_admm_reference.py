"""The plain float64 reference of the ADMM inner loop (benchmark/admm_reference.py)
against the port's admm_inner on PatchOps, and the r4-admm cell's check
against its control and faults, on the 3D channel at refs=0 (360
vertices, 1,344 tets; the smallest fixture on which all four constraints,
volume and x/y/z barycenter, are active), in float64 on the CPU: a
float32 Newton stalls near ns_tol here.

The benchmark's r4-admm cell judges the program on the card by these
pieces; here they are held to the program and to their own definitions."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from admm_optim_tpu_torch import admm_run, xupdate_solve
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.optim import admm
from benchmark import admm_reference as ar
from benchmark import harness
from benchmark.drivers.admm_inner import CONTROL, FAULTS

torch.set_num_threads(1)

CONFIG = harness.load_json(harness.ROOT / "tests" / "data" / "channel3d-r0-admm.json")
TRAFFIC = dict(harness.load_json(harness.ROOT / "traffic" / "admm-inner.json"), warmup_requests=0)
LIMITS = harness.load_json(harness.ROOT / "limits" / "r4-admm.json")
CELL = {"name": "r0-admm", "config": CONFIG["name"], "traffic": "admm-inner", "chips": 1}
SEED = 2**31 + 4099
# the cell's loop with the x-update's Krylov solves run to 1e-12 of their
# right-hand sides, so that each Newton step is the exact one the
# reference takes, to rounding
TIGHT = dataclasses.replace(admm.ADMMConfig(**CONFIG["admm"]), lin_max_iters=200, lin_abs_tol=0.0,
                            lin_rel_tol=1e-12)


@pytest.fixture(scope="module")
def fixture():
    ctx = xupdate_solve.build(0, "cpu", torch.float64)
    fine, ps = ctx.hier.fine, ctx.ps
    tets = ar.Tets(fine.coords, ar.patch_elements(ps.fine.gid, ps.class_offsets),
                   ~fine.vertex_mask(xupdate_solve.DIRICHLET), "cpu")
    Jp = admm_run.shape_gradient(ctx, seed=7)
    return ctx, tets, Jp, st.from_patch(ps.fine, Jp, fine.num_vertices)


def test_patch_elements_are_the_mesh_tets(fixture):
    ctx, tets, _, _ = fixture
    mesh = torch.as_tensor(ctx.hier.fine.elems.astype(np.int64))
    assert ar.same_tets(tets.elems, mesh)
    assert not ar.same_tets(tets.elems, torch.cat([mesh[1:], mesh[:1, [0, 1, 2, 0]]]))


def test_port_loop_equals_the_reference_loop(fixture):
    """u_k and Lambda_k at every iterate, the Newton steps, and lambda_5 and
    q_5 element by element.  Both loops take the same Newton steps, the
    port's solved by CG to 1e-12 relative and the reference's directly, so
    they agree to ~1e-10 of the largest value (the CG residual times the
    condition of the x-update); 1e-8 leaves room for the Newton loop
    carrying it over 5 iterations."""
    ctx, tets, Jp, jp = fixture
    seen = []
    out = admm_run.run(ctx, TIGHT, Jp=Jp, iter_cb=lambda k, u, L: seen.append((k, u, L)))
    a = CONFIG["admm"]
    ref = ar.loop(tets, (1.0, a["tau"], 1.0), jp, a["tau"], a["sigma_threshold"], a["scaling"], a["admm_steps"],
                  a["ns_max_its"], a["ns_tol"])
    s = out.state
    assert (s.admm_it, s.newton_failed, ref["failed"]) == (5, False, False)
    assert [k for k, _, _ in seen] == list(range(5))
    assert s.total_newton == sum(ref["newton"]) and s.total_newton <= s.batch_iters <= s.total_lin_iters
    V = ctx.hier.fine.num_vertices
    for (_, u, L), u_r, L_r in zip(seen, ref["us"], ref["Lambdas"]):
        u_v = st.from_patch(ctx.ps.fine, u, V)
        assert ar.rel_err(u_v, u_r) <= 1e-8
        assert ar.rel_err(L, L_r) <= 1e-8
    assert float(ref["Lambdas"][-1].abs().min()) > 1e-3  # all four constraints active
    assert ar.rel_err(s.lam.reshape(3, 3, -1), ref["lam"]) <= 1e-8
    assert ar.rel_err(s.q_proj.reshape(3, 3, -1), ref["q"]) <= 1e-8
    assert float(ref["lam"].abs().max()) > 0.0


def test_constraint_grads_are_the_derivatives_of_g(fixture):
    """B_i against central differences of g_raw along random directions at
    a deformed state: the differences carry an O(h^2) error of ~1e-12 of
    |B.d| at h = 1e-5 and float64 rounding of ~1e-11, so 1e-8."""
    _, tets, _, _ = fixture
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.normal(size=(3, tets.n_vertices)) * 0.02)
    B = ar.constraint_grads(tets, u)
    h = 1e-5
    for _ in range(3):
        d = torch.as_tensor(rng.normal(size=u.shape))
        fd = (ar.constraints(tets, u + h * d) - ar.constraints(tets, u - h * d)) / (2 * h)
        an = (B * d).sum(dim=(1, 2))
        assert float((fd - an).abs().max() / an.abs().max()) <= 1e-8


def test_frobenius_projection():
    Q = torch.tensor([[[3.0, 0.1], [0.0, 0.0], [0.0, 0.0]], [[4.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                      [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]], dtype=torch.float64)  # (3, 3, 2): norms 5 and 0.1
    P = ar.project_frobenius(Q, 0.5)
    assert torch.allclose(P[..., 0], Q[..., 0] / 10.0) and torch.equal(P[..., 1], Q[..., 1])


def _run(variant):
    hook = None if variant == "program" else (lambda d: d.plant(variant))
    return harness.execute(CELL, CONFIG, TRAFFIC, LIMITS, [], SEED, 0.0, False, "cpu", time.monotonic(),
                           driver_hook=hook)


def _readings(r):
    return {k: c["value"] for k, c in r["checks"].items() if k != "failed"}


@pytest.fixture(scope="module")
def program_run():
    return _run("program")


def test_the_program_passes_the_check(program_run):
    """One loop through the cell's driver, harness and limits
    (limits/r4-admm.json, set on the card at refs=4)."""
    assert program_run["correct"] and program_run["failed"] == 0


@pytest.mark.parametrize("variant", (CONTROL,) + FAULTS)
def test_the_check_catches_the_control_and_each_fault(variant, program_run):
    """The bf16 control and each fault read at least 1000 times the
    program's reading, and at least 1e-6, in one of the check's numbers
    at this size and seed.  The control, state_unchanged and answer_altered
    also fail the card's limits here; dlambda_zero's constraint drift
    grows with the mesh (~2-4e-6 at refs=0, 1.05e-4 and more at refs=4, in
    limits/r4-admm.json), so here it is held to the program alone."""
    r = _run(variant)
    prog = _readings(program_run)
    assert any(v >= max(1e3 * prog[k], 1e-6) for k, v in _readings(r).items()), (_readings(r), prog)
    if variant != "dlambda_zero":
        assert not r["correct"]
