"""Set-up shared by the drivers of the deformation configurations: the
kernel library, the benchmark's mesh handed to the port as a
``Hierarchy``, ``xupdate_solve.prepare`` and ``xupdate_solve.assemble``,
each timed, and the checks that the program runs as the configuration
states."""
from __future__ import annotations

import math
import time

import torch

from .. import cost, meshgen, pools

NOT_FINITE = 1e300  # what a check reports for a reading that is not finite


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def build_context(config: dict, device, log) -> tuple:
    """(ctx with its data assembled, the fine level's arrays, set-up parts)."""
    parts = {}
    t0 = time.perf_counter()
    from admm_optim_tpu_torch import _build, xupdate_solve
    from admm_optim_tpu_torch.core.mesh import Hierarchy, MeshLevel

    parts["import_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        t0 = time.perf_counter()
        compile_s, _ = _build.build()
        _build.lib()
        parts["kernels_s"] = time.perf_counter() - t0
        parts["nvcc_s"] = compile_s
    check_settings(config, xupdate_solve)

    levels, info = meshgen.load_levels(config["mesh"]["refs"], log=log)
    parts["mesh_s"] = info["seconds"]
    fine = levels[-1]
    check_sizes(config, levels)
    t0 = time.perf_counter()
    hier = Hierarchy([MeshLevel(dim=3, **lvl) for lvl in levels])
    vc, op = config["vcycle"], config["operator"]
    ctx = xupdate_solve.prepare(
        hier, device, torch.float32, c_eps=op["c_eps"], c_grad=op["c_grad"], c_mass=op["c_mass"],
        smoothing=dict(pre_smooth=vc["pre_smooth"], post_smooth=vc["post_smooth"], cheb_lower=vc["cheb_lower"]))
    parts["prepare_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx.data = xupdate_solve.assemble(ctx, ctx.coords)
    sync(device)
    parts["assembly_s"] = time.perf_counter() - t0
    check_stream(config, ctx, device)
    return ctx, fine, parts


def check_settings(config: dict, xupdate_solve):
    """The program runs as the configuration states, or not at all."""
    want = config["solve"]["settings"]
    if dict(xupdate_solve.SOLVE_SETTINGS) != want:
        raise RuntimeError(f"xupdate_solve.SOLVE_SETTINGS {xupdate_solve.SOLVE_SETTINGS} "
                           f"differ from the configuration's {want}")
    if list(xupdate_solve.DIRICHLET) != config["operator"]["dirichlet"]:
        raise RuntimeError(f"xupdate_solve.DIRICHLET {xupdate_solve.DIRICHLET} differs "
                           f"from the configuration's {config['operator']['dirichlet']}")


def check_sizes(config: dict, levels: list):
    exp, fine = config["expect"], levels[-1]
    got = dict(levels=len(levels), vertices=len(fine["coords"]), tets=len(fine["elems"]),
               dofs=3 * len(fine["coords"]), level0_vertices=len(levels[0]["coords"]))
    for key, val in got.items():
        if exp[key] != val:
            raise RuntimeError(f"mesh {key} {val} != the configuration's {exp[key]}")


def check_stream(config: dict, ctx, device):
    """On the card, the bf16 pencil smoother stream is on exactly where the
    configuration puts it."""
    if device.type != "cuda":
        return
    W_sm = ctx.data.W_sm or [None] * len(ctx.data.W)
    for level, w in enumerate(W_sm):
        want = cost.smoother_stream(config, level) == "bf16_pencil"
        if (w is not None) != want or (w is not None and w.dtype != torch.bfloat16):
            raise RuntimeError(f"level {level}: smoother stream {'on' if w is not None else 'off'}, "
                               f"the configuration says {'on' if want else 'off'}")


def pool_vertex(config: dict, traffic: dict, fine: dict, seed: int, device) -> torch.Tensor:
    """The traffic's pool in vertex layout, zero on the Dirichlet vertices."""
    keep = torch.as_tensor(~meshgen.dirichlet_mask(fine, config["operator"]["dirichlet"]), device=device)
    return pools.pool_from_traffic(seed, traffic, 3, keep)


def coeffs(config: dict) -> tuple:
    op = config["operator"]
    return op["c_eps"], op["c_grad"], op["c_mass"]


def reference_mesh(config: dict, fine: dict, device):
    from .. import reference

    free = ~meshgen.dirichlet_mask(fine, config["operator"]["dirichlet"])
    return reference.Mesh(fine["coords"], fine["elems"], free, device)
