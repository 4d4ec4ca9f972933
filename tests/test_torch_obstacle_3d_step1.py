"""Step 1 of the port's optimization loop at 3D refs=0 (the settings of
tests/test_e2e_3d.py), resumed from the JAX package's state after step 0
through convert.resume_state, against the JAX package's step 1, float64 on
the CPU (tests/torch_obstacle_golden.py says what is held; a resume carries
no warm start, so the adjoint's count is not held).  The same run checks
that every tensor the 3D path hands to a kernel wrapper is contiguous: the
wrappers refuse strided tensors on the card, and their CPU forms, which
these tests run, take any layout.  The mesh X + u, J' and the assembly's
coordinates are among them."""
import pytest
import torch

from admm_optim_tpu_torch import convert
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.solvers import patch_mg
from torch_obstacle_golden import golden, mesh_invariants, obstacle_golden, port

torch.set_num_threads(1)

WRAPPERS = ("apply_w_sym", "apply_w_full", "apply_w_full_t", "apply_w_pencil", "apply_w_pencil_batched",
            "apply_w_df_sym")


@pytest.fixture
def strided(monkeypatch):
    """Records, per kernel wrapper and for the assembly's coordinates, the
    calls that got a strided tensor."""
    calls, bad = {}, []

    def spy(name, fn, tensors=lambda *args: args):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            if not all(a.is_contiguous() for a in tensors(*args) if isinstance(a, torch.Tensor)):
                bad.append(name)
            return fn(*args, **kw)
        return wrapped

    for name in WRAPPERS:
        monkeypatch.setattr(sk, name, spy(name, getattr(sk, name)))
    # assemble_patch_mg(ps, struct, coords, ...): the coordinates
    monkeypatch.setattr(patch_mg, "assemble_patch_mg",
                        spy("assemble", patch_mg.assemble_patch_mg, lambda ps, struct, X, *a: (X,)))
    return calls, bad


def test_resumed_step1_3d_matches_jax(strided):
    calls, bad = strided
    prob = port("3d")
    after0 = {k: golden("3d", f"after0_{k}") for k in ("X", "s", "sigma", "step", "drag_old")}
    resume = convert.resume_state(dict(after0, drag_init=golden("3d", "drag_init")), "cpu")
    hist = prob.run(num_steps=2, resume=resume)
    obstacle_golden("3d", prob, hist, [1])
    mesh_invariants(prob, prob.X_final)
    assert prob._cur_Jp.is_contiguous() and prob.X_final.is_contiguous()
    # K1 on lanes (the x-update), K5 (the re-solve) and K5^T (the adjoint)
    assert {"apply_w_sym", "apply_w_full", "apply_w_full_t", "assemble"} <= set(calls)
    assert bad == []
