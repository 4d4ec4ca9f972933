"""Bytes the NS re-solve's lattice operator applications need, counted from
the configuration's lattices and the program's counts, on the arithmetic
of ``benchmark.cost`` (each operator read once from memory in its storage,
its input read once and its output written once), whatever kernels
implement the work.

A linear iteration of the forward Newton solve (FGMRES, stepped) applies
the preconditioner once and the assembled Jacobian once; a solve cycle
adds one Jacobian apply for its start residual, and re-imaging the
recycle space adds lin_recycle_k Jacobian applies, which the program
charges to its linear count.  So a request of n Newton iterates and L
linear iterations in all makes at least L + n Jacobian applies and at
least L - k n preconditioner applies.

* The Jacobian (ops.ns_patchjac) stores, per cell of the pressure lattice
  and per element class, the dense (nloc x nloc) block of the element's
  local dofs, in float32; an apply reads it, the velocity field on the
  velocity lattice and the pressure field on the pressure lattice, and
  writes both.
* The preconditioner is one Jacobi V(2,2) cycle of the velocity's
  conv-diff operator on the velocity lattice (full 15-point stencil, C = 3,
  float32, ``cost.vcycle_applies`` applies a level above the base, a dense
  inverse at the base) and the pressure coupling B^T, which reads the
  velocity-pressure part of the Jacobian's blocks.

The line search's residual evaluations and the per-iterate assembly are
element work, not counted here.
"""
from __future__ import annotations

from . import cost

F32 = cost.F32


def _sites(config: dict, edge: int) -> int:
    return edge**3 * config["lattice"]["patches"]


def vel_apply_bytes(config: dict, level: int) -> int:
    """One conv-diff apply on level of the velocity lattice: the full
    stencil (stencil_points x C x C a site), x read, y written."""
    lat = config["lattice"]
    C, n = lat["velocity_components"], _sites(config, 2**level + 1)
    return lat["stencil_points"] * C * C * n * F32 + 2 * C * n * F32


def vcycle_bytes(config: dict) -> int:
    """One velocity V-cycle: the applies of every level above the base, the
    dense base inverse and its input and output."""
    lat = config["lattice"]
    top = lat["velocity_levels"] - 1
    total = sum(cost.vcycle_applies(config) * vel_apply_bytes(config, l) for l in range(1, top + 1))
    n0 = lat["velocity_components"] * config["expect"]["level0_vertices"]
    return total + n0 * n0 * F32 + 2 * n0 * F32


def _fields(config: dict) -> tuple[int, int]:
    """(velocity values, pressure values) of one state on the lattices."""
    exp, C = config["expect"], config["lattice"]["velocity_components"]
    return C * _sites(config, exp["velocity_lattice"]), _sites(config, exp["pressure_lattice"])


def _cells(config: dict) -> int:
    return (config["expect"]["pressure_lattice"] - 1) ** 3 * config["lattice"]["patches"]


def jac_apply_bytes(config: dict) -> int:
    """One assembled Jacobian apply: every class's (nloc x nloc) block a
    cell, the state read, the result written."""
    lat = config["lattice"]
    w = lat["cell_classes"] * lat["local_dofs"] ** 2 * _cells(config) * F32
    vel, p = _fields(config)
    return w + 2 * (vel + p) * F32


def bt_apply_bytes(config: dict) -> int:
    """B^T z_p: the velocity-pressure part of the blocks, z_p read, the
    velocity written."""
    lat = config["lattice"]
    n_vel = lat["local_dofs"] - lat["pressure_corners"]
    w = lat["cell_classes"] * n_vel * lat["pressure_corners"] * _cells(config) * F32
    vel, p = _fields(config)
    return w + (vel + p) * F32


def precond_bytes(config: dict) -> int:
    return vcycle_bytes(config) + bt_apply_bytes(config)


def request_bytes(config: dict, newton: int, lin_iters: int) -> int:
    """Least bytes of one re-solve of `newton` iterates and `lin_iters`
    linear iterations in all."""
    k = config["ns"]["newton"]["lin_recycle_k"]
    return ((lin_iters + newton) * jac_apply_bytes(config)
            + max(lin_iters - k * newton, 0) * precond_bytes(config))
