"""On the card: vcycle_p's CUDA graphs against the eager cycle, at 3D
refs=3 (9^3 x 224 fine lattice, the bf16 pencil smoother stream on it, K1
below) in float32.  A replay runs the eager cycle's kernels in its order,
so every answer is held to the eager one bit for bit: single fields and
lanes, after a stencil entry is replaced (the benchmark's bf16 control does
that) and after a write into the same storage, a whole cg_ir_p solve, and
the kernel launch counts.

The tests skip without a CUDA device.  The file imports neither JAX nor
the JAX package; on a machine without JAX run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vcycle_graph.py
"""
import dataclasses

import pytest
import torch

from admm_optim_tpu_torch import xupdate_solve
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers import patch_mg
from admm_optim_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def ctx():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    ctx = xupdate_solve.build(3, "cuda", torch.float32)
    assert ctx.data.W_sm is not None and ctx.data.W_sm[-1] is not None
    return ctx


def _fresh(ctx, **lists):
    """A PatchMGData over ctx's tensors with no graph, its lists copied
    (so that an entry can be replaced) where named."""
    return dataclasses.replace(ctx.data, **{k: list(getattr(ctx.data, k)) for k in lists})


def _rhs(ctx, lanes):
    if not lanes:
        return xupdate_solve.random_rhs(ctx, seed=11)
    return torch.stack([xupdate_solve.random_rhs(ctx, seed=s) for s in (12, 13, 14)])


def _cycles(ctx, data, bs):
    """vcycle_p on each b of bs in turn, with the mode of each."""
    out, modes = [], []
    for b in bs:
        before = dict(patch_mg.graph_counts)
        out.append(patch_mg.vcycle_p(ctx.struct, data, b))
        modes.append(next(k for k in before if patch_mg.graph_counts[k] != before[k]))
    return out, modes


@pytest.mark.card
@pytest.mark.parametrize("lanes", [False, True], ids=["field", "lanes"])
def test_replay_equals_eager(ctx, lanes):
    """Eager, capture, then replays: each bit for bit the eager cycle of
    its input, each a tensor of its own (an earlier output survives a
    later replay)."""
    data = _fresh(ctx)
    b = _rhs(ctx, lanes)
    bs = [b, 2 * b, b - 1, 0.5 * b]
    want = [patch_mg._vcycle(ctx.struct, data, v) for v in bs]
    got, modes = _cycles(ctx, data, bs)
    assert modes == ["eager", "capture", "replay", "replay"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len({g.data_ptr() for g in got}) == len(got)
    again = patch_mg.vcycle_p(ctx.struct, data, 3 * b)
    assert torch.equal(again, patch_mg._vcycle(ctx.struct, data, 3 * b))
    assert torch.equal(got[2], want[2])


@pytest.mark.card
def test_replaced_entry_recaptures(ctx):
    """Every W entry replaced by its bfloat16 rounding after capture (the
    benchmark's bf16 control): the next call runs eagerly, the one after
    captures anew, and each matches the eager cycle on the new operator;
    a write into the same storage is seen by the replay."""
    data = _fresh(ctx, W=True, inv_diag=True)
    b = _rhs(ctx, False)
    _, modes = _cycles(ctx, data, [b, b, b])
    assert modes == ["eager", "capture", "replay"]
    old = data.graphs["cycles"]
    data.W[:] = [w.to(torch.bfloat16).to(w.dtype) for w in data.W]
    want = patch_mg._vcycle(ctx.struct, data, b)
    got, modes = _cycles(ctx, data, [b, b, b])
    assert modes == ["eager", "capture", "replay"]
    assert data.graphs["cycles"] is not old
    assert all(torch.equal(g, want) for g in got)
    data.inv_diag[-1] = data.inv_diag[-1].clone()
    _cycles(ctx, data, [b, b])
    data.inv_diag[-1].mul_(1.25)
    got, modes = _cycles(ctx, data, [b])
    assert modes == ["replay"]
    assert torch.equal(got[0], patch_mg._vcycle(ctx.struct, data, b))


@pytest.mark.card
def test_cg_ir_p_as_eager(ctx, monkeypatch):
    """A whole solve with replayed cycles: the rounds, the CG iterations,
    the flag and the answer of the eager solve, bit for bit."""
    b = _rhs(ctx, False)
    data = _fresh(ctx)
    patch_mg.reset_graph_counts()
    graphed = [patch_mg.cg_ir_p(ctx.struct, data, b, **xupdate_solve.SOLVE_SETTINGS) for _ in range(2)]
    counts = dict(patch_mg.graph_counts)
    cycles = sum(r.inner_iters + r.rounds for r in graphed)
    assert counts == {"eager": 1, "capture": 1, "replay": cycles - 2}
    monkeypatch.setattr(patch_mg, "_graph_mode", lambda *a: ("eager", None))
    eager = patch_mg.cg_ir_p(ctx.struct, _fresh(ctx), b, **xupdate_solve.SOLVE_SETTINGS)
    for res in graphed:
        assert (res.rounds, res.inner_iters, res.converged) == (eager.rounds, eager.inner_iters, eager.converged)
        assert res.converged
        assert torch.equal(res.x_hi, eager.x_hi) and torch.equal(res.x_lo, eager.x_lo)
        assert torch.equal(res.res_norm, eager.res_norm)


@pytest.mark.card
def test_launch_counts_as_eager(ctx):
    """stencil_kernels' counts after N cycles through vcycle_p (eager,
    capture, replays) are those of N eager cycles."""
    b = _rhs(ctx, True)
    n = 6
    sk.reset_launches()
    for _ in range(n):
        patch_mg._vcycle(ctx.struct, ctx.data, b)
    want = (dict(sk.launches), dict(sk.launches_by_lattice))
    data = _fresh(ctx)
    sk.reset_launches()
    _, modes = _cycles(ctx, data, [b] * n)
    assert modes == ["eager", "capture"] + ["replay"] * (n - 2)
    assert (dict(sk.launches), dict(sk.launches_by_lattice)) == want
    assert sum(want[0].values()) > 0


@pytest.mark.card
def test_profiler_sees_one_span_a_replay(ctx):
    """While a profiler records, the second call stays eager (no capture
    under the profiler) and the next unprofiled call captures; a replay
    under the profiler records its mg.vcycle span, graph="replay", and no
    span inside it."""
    data = _fresh(ctx)
    b = _rhs(ctx, False)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _, modes = _cycles(ctx, data, [b])
    with torch.profiler.profile(activities=acts):
        _, m2 = _cycles(ctx, data, [b])
    _, m3 = _cycles(ctx, data, [b])
    profiling.reset_spans()
    with torch.profiler.profile(activities=acts):
        got, m4 = _cycles(ctx, data, [b])
        torch.cuda.synchronize()
    recs = profiling.spans()
    profiling.reset_spans()
    assert modes + m2 + m3 + m4 == ["eager", "eager", "capture", "replay"]
    assert [(r["name"], r["attrs"]) for r in recs] == [("mg.vcycle", {"graph": "replay"})]
    assert torch.equal(got[0], patch_mg._vcycle(ctx.struct, data, b))
