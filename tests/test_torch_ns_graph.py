"""The CUDA graphs of the NS Newton linear solves (ns_solver._Graphed,
taken by ns_run.newton where ctx.graphed): on the CPU, which contexts
take them and that CPU tensors run eagerly; on the card, at 3D refs=1 in
float32, a cold-start Newton solve whose Jacobian and preconditioner
applies replay graphs against the same solve run eagerly, bit for bit,
with the same kernel launch counts, untraced and under the profiler.

The card tests skip without a CUDA device.  The file imports neither JAX
nor the JAX package; on a machine without JAX run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ns_graph.py
"""
import dataclasses

import pytest
import torch

from admm_optim_tpu_torch import ns_run
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers import ns_solver
from admm_optim_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cpu_ctx():
    return ns_run.build(0, "cpu", torch.float64, visc=0.16)


def test_graphed_contexts(cpu_ctx):
    """The patch backend with the assembled Jacobian and the mass block
    takes the graphs; switched off, with PCD or matrix-free it does not."""
    assert cpu_ctx.assembled and cpu_ctx.graphed
    assert not dataclasses.replace(cpu_ctx, graphs=False).graphed
    assert not dataclasses.replace(cpu_ctx, pressure_precond="pcd").graphed
    assert not dataclasses.replace(cpu_ctx, assembled=False).graphed


def test_cpu_calls_run_eagerly():
    """On CPU tensors every call is fn's own result, and nothing is
    captured."""
    calls = []

    def fn(x):
        calls.append(x)
        return 2.0 * x

    op = ns_solver._Graphed(fn)
    before = dict(ns_solver.graph_counts)
    xs = [torch.arange(4.0) + k for k in range(4)]
    for x in xs:
        assert torch.equal(op(x), 2.0 * x)
    assert calls == xs and op.graph is None
    assert ns_solver.graph_counts["eager"] - before["eager"] == len(xs)
    assert ns_solver.graph_counts["capture"] == before["capture"]


@pytest.fixture(scope="module")
def card_ctx():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return ns_run.build(1, "cuda", torch.float32, visc=0.16)


def _solve(ctx):
    """A cold-start Newton solve with the launch counts and graph modes it
    made."""
    sk.reset_launches()
    before = dict(ns_solver.graph_counts)
    res, _ = ns_run.newton(ctx)
    torch.cuda.synchronize()
    modes = {k: ns_solver.graph_counts[k] - before[k] for k in before}
    return res, (dict(sk.launches), dict(sk.launches_by_lattice)), modes


def _captures(ctx, res):
    """The captures a solve makes: the Jacobian's every iterate, the
    preconditioner's where Arnoldi steps ran (an iterate that the re-imaged
    recycle space alone solves applies no M; the cold start's first
    iterate has no recycle space)."""
    k_r = ctx.cfg.lin_recycle_k
    return res.iters + sum(1 for i, n in enumerate(res.lin_iters) if n > (k_r if i else 0))


def _same(a, b):
    assert (a.iters, a.lin_iters, a.converged) == (b.iters, b.lin_iters, b.converged)
    assert a.converged
    assert a.res_history == b.res_history
    assert torch.equal(a.s, b.s)


@pytest.mark.card
def test_graphed_newton_as_eager(card_ctx):
    """A capture of the Jacobian's apply and of the preconditioner's an
    iterate, the other applies replays; the iterates, the linear counts
    and the state of the eager solve bit for bit, and its launch counts."""
    eager, eager_launches, modes = _solve(dataclasses.replace(card_ctx, graphs=False))
    assert modes == {"eager": 0, "capture": 0, "replay": 0}
    got, launches, modes = _solve(card_ctx)
    _same(got, eager)
    assert modes["capture"] == _captures(card_ctx, got)
    assert modes["replay"] > 10 * modes["capture"]
    assert launches == eager_launches and sum(launches[0].values()) > 0


@pytest.mark.card
def test_graphed_newton_under_the_profiler(card_ctx):
    """Captures and replays while a profiler records: the eager solve's
    bits, and the ns.* spans of the solve."""
    eager, _, _ = _solve(dataclasses.replace(card_ctx, graphs=False))
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        got, _, modes = _solve(card_ctx)
    _same(got, eager)
    assert modes["capture"] == _captures(card_ctx, got)
    names = {r["name"] for r in profiling.spans()}
    assert {"ns.newton", "ns.iterate", "ns.krylov", "ns.precond", "ns.line_search", "host.sync"} <= names
