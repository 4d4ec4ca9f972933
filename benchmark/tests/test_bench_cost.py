"""The frozen byte counts against the port's own vcycle_cost_table, and the
application counts against what cg_ir_p does."""
import copy

import pytest
import torch

from admm_optim_tpu_torch import xupdate_solve
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers import patch_mg
from benchmark import cost, harness

R4 = harness.load_json(harness.ROOT / "configs" / "channel3d-r4.json")


def _config(refs):
    c = copy.deepcopy(R4)
    c["mesh"]["refs"] = refs
    return c


@pytest.fixture(scope="module")
def refs3():
    """The port's refs=3 context on the CPU, with the bf16 pencil smoother
    stream attached where the card would attach it (lattice edge >= 9)."""
    ctx = xupdate_solve.build(3, "cpu", torch.float32)
    ps = ctx.ps
    ctx.data.W_sm = [st.PencilW(sk.to_pencil_major(ps, W, torch.bfloat16)) if min(ps.levels[l].lat_shape) >= 9
                     else None for l, W in enumerate(ctx.data.W)]
    return ctx


def _rows(table):
    rows = {}
    for line in table.splitlines()[1:-1]:
        f = line.split()
        rows[int(f[0])] = dict(store=f[5], w_mib=float(f[6]), gb=float(f[7]))
    return rows


def test_per_apply_bytes_match_the_ports_table(refs3):
    config = _config(3)
    rows = _rows(patch_mg.vcycle_cost_table(refs3.struct, refs3.data, 3350.0))
    n_table = refs3.struct.pre_smooth + refs3.struct.post_smooth + 1  # the table's applies a level
    for level, row in rows.items():
        stream = cost.smoother_stream(config, level)
        assert row["store"] == {"bf16_pencil": "bf16pc", "f32_sym": "sym"}[stream]
        g = cost.lattice(config, level)
        w = cost.apply_bytes(config, level, stream) - 2 * g["C"] * g["sites"] * g["P"] * cost.F32
        assert abs(w / 2**20 - row["w_mib"]) <= 0.005 + 1e-9
        assert abs(n_table * cost.apply_bytes(config, level, stream) / 1e9 - row["gb"]) <= 5e-5 + 1e-12


def test_vcycle_applies_match_vcycle_p(monkeypatch):
    """cost.vcycle_applies counts the stencil applications vcycle_p makes on
    each level >= 1 (pre-smoothing from zero skips one)."""
    ctx = xupdate_solve.build(2, "cpu", torch.float32)
    calls = []
    real = st.apply_w

    def counting(ps, W, x):
        calls.append(tuple(x.shape[-4:-1]))
        return real(ps, W, x)

    monkeypatch.setattr(st, "apply_w", counting)
    b = xupdate_solve.random_rhs(ctx, 0)
    patch_mg.vcycle_p(ctx.struct, ctx.data, b)
    config = _config(2)
    for level in (1, 2):
        edge = 2**level + 1
        assert calls.count((edge, edge, edge)) == cost.vcycle_applies(config)


def test_solve_applies_match_cg_ir_p(monkeypatch):
    """A cg_ir_p solve of R rounds and N CG iterations applies the fine
    operator N + R times, the V-cycle N + R times and the DF residual R
    times."""
    ctx = xupdate_solve.build(1, "cpu", torch.float32)
    n = {"fine": 0, "vcycle": 0, "df": 0}
    inside = []
    real_apply, real_vc, real_df = patch_mg._apply, patch_mg.vcycle_p, st.apply_w_df

    def apply(*a, **k):
        n["fine"] += not inside
        return real_apply(*a, **k)

    def vcycle(*a, **k):
        n["vcycle"] += 1
        inside.append(1)
        try:
            return real_vc(*a, **k)
        finally:
            inside.pop()

    def apply_df(*a, **k):
        n["df"] += 1
        return real_df(*a, **k)

    monkeypatch.setattr(patch_mg, "_apply", apply)
    monkeypatch.setattr(patch_mg, "vcycle_p", vcycle)
    monkeypatch.setattr(st, "apply_w_df", apply_df)
    res = xupdate_solve.solve(ctx, xupdate_solve.random_rhs(ctx, 0))
    assert n == {"fine": res.inner_iters + res.rounds, "vcycle": res.inner_iters + res.rounds, "df": res.rounds}
    config = _config(1)
    want = ((res.inner_iters + res.rounds) * (cost.apply_bytes(config, 1, "f32_sym") + cost.vcycle_bytes(config))
            + res.rounds * cost.df_apply_bytes(config))
    assert cost.ir_solve_bytes(config, res.rounds, res.inner_iters) == want


def test_bytes_at_the_cells_sizes():
    r4 = R4
    r5 = harness.load_json(harness.ROOT / "configs" / "channel3d-r5.json")
    # fine f32 half stencil: 8 x 3 x 3 x 17^3 x 224 x 4 bytes
    assert cost.apply_bytes(r4, 4, "f32_sym") == 8 * 9 * 17**3 * 224 * 4 + 2 * 3 * 17**3 * 224 * 4
    assert cost.smoother_stream(r4, 3) == "bf16_pencil" and cost.smoother_stream(r4, 2) == "f32_sym"
    assert cost.vcycle_bytes(r5) > 7 * cost.vcycle_bytes(r4)
