"""graft_entry_torch (the torch twin of __graft_entry__.py): entry()'s
ADMM step, the dry run's (batch, space) phase on a 2 x 2 grid of gloo
ranks against the single-device port, and the whole dryrun_multichip(4)
(slow: its 3D refs=2 deep phase takes ~45 s of four CPU ranks in
float64; tests/test_torch_patch_shard.py holds the same agglomerated IR
solve and ADMM at 3D refs=1)."""
import numpy as np
import pytest
import torch

import graft_entry_torch as ge
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.optim import admm
from admm_optim_tpu_torch.optim.spaces import PatchOps
from admm_optim_tpu_torch.parallel import launch
from admm_optim_tpu_torch.solvers import patch_mg as pmg
from admm_optim_tpu_torch.xupdate_solve import assemble_deformation_p

torch.set_num_threads(1)


def test_entry_step_runs():
    """One step on the CPU: u moves off zero, finite, zero on Dirichlet
    vertices; the dual tensor moves."""
    fn, (u0, lam0, Jp, sigma) = ge.entry("cpu")
    assert u0.dtype == torch.float64
    u, lam, inc = fn(u0, lam0, Jp, sigma)
    assert u.shape == u0.shape and lam.shape == lam0.shape
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(lam).all())
    assert float(u.abs().max()) > 0.0 and float(inc) > 0.0


def test_entry_needs_a_device_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.entry()


def test_dryrun_batch_space_grid_matches_single_device():
    """The 2D phase on a (2, 2) grid: each batch row runs its two of the
    four sigma instances sharded over its space pair; each equals the
    single-device port's admm_inner on the same problem (counts, flags;
    u and the dual tensor within 1e-10 of their largest entry: the dots
    sum per rank)."""
    p = ge.problem_2d()
    outs = launch.spawn(ge.batch_space_rank, 4, "gloo", "cpu", 240.0, p)
    assert [(o["batch"], o["space"]) for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    states = [s for o in outs if o["space"] == 0 for s in o["states"]]
    assert len(states) == 4
    ps = p.ps
    cfg = ge.ADMM_2D
    struct = pmg.PatchMGStructure(ps)
    coords_p = st.to_patch(ps.fine, torch.from_numpy(p.coords.T.copy()))
    data = assemble_deformation_p(ps, struct, p.lvl0, coords_p, pmg.make_level_tables(ps, torch.float64), cfg)
    ops_ = PatchOps(struct, data, coords_p)
    Jp = st.to_patch(ps.fine, torch.from_numpy(p.Jp))
    for sigma, got in zip(np.linspace(0.25, 0.4, 4), states):
        want = admm.admm_inner(cfg, ops_, Jp, float(sigma), 1.0, torch.tensor(p.ref_vol),
                               torch.as_tensor(p.ref_bary))
        assert (got["admm_it"], got["total_newton"], got["total_lin_iters"]) == (
            want.admm_it, want.total_newton, want.total_lin_iters)
        assert (got["converged"], got["failed"]) == (want.converged, want.failed)
        assert want.total_newton > 0
        for name, w in (("u", want.u), ("lam", want.lam)):
            assert np.abs(got[name] - w.numpy()).max() <= 1e-10 * np.abs(w.numpy()).max(), name


@pytest.mark.slow
def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    ge.dryrun_multichip(4, "cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: grid batch=2 space=2" in out
    assert "3D-deep OK" in out and "3D-deep ADMM OK" in out
