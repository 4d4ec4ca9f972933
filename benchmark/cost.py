"""Bytes the deformation solve's stencil applications need: a frozen copy
of the port's ``solvers/patch_mg.vcycle_cost_table`` arithmetic, with the
CG and IR applies added, computed from the configuration alone.

The stencil applications are bound by memory (270 flops a lattice site
against 290-310 bytes, where the card does 20 float32 flops a byte of its
bandwidth), so their least time is their bytes over the bandwidth.  Every
application reads its stencil W once, in the storage the configuration
fixes, reads x once and writes y once:

* the CG applies and the IR residual read the float32 symmetric half
  stencil (``sym_points`` slots) of the fine level; the IR residual is the
  double-float apply, which reads x as a (hi, lo) pair and writes y so;
* the V-cycle smooths with the bf16 pencil stream (all ``stencil_points``
  slots) on levels whose lattice edge is at least
  ``smoother_stream_min_lat``, elsewhere with the float32 half stencil;
  the restriction's residual uses the smoother's W as well;
* level 0 is a dense base solve: one float32 matvec with the inverse.

Counts per V-cycle and level >= 1: pre-smoothing from a zero iterate
skips its first apply (pre_smooth - 1), post-smoothing applies
post_smooth times, the restriction once.  A CG solve of n iterations
applies the operator and the V-cycle n + 1 times each (the start residual
and preconditioner, then one of each an iteration); IR adds one
double-float residual a round.
"""
from __future__ import annotations

F32 = 4
BF16 = 2


def lattice(config: dict, level: int) -> dict:
    lat = config["lattice"]
    edge = 2**level + 1
    return dict(edge=edge, sites=edge**3, P=lat["patches"], C=lat["components"])


def apply_bytes(config: dict, level: int, stream: str) -> int:
    """Least bytes of one stencil application on level: W in its storage
    (stream "f32_sym" or "bf16_pencil"), x read once, y written once."""
    lat = config["lattice"]
    g = lattice(config, level)
    n = g["C"] * g["sites"] * g["P"]
    if stream == "bf16_pencil":
        w = lat["stencil_points"] * g["C"] * g["C"] * g["sites"] * g["P"] * BF16
    elif stream == "f32_sym":
        w = lat["sym_points"] * g["C"] * g["C"] * g["sites"] * g["P"] * F32
    else:
        raise ValueError(f"unknown stencil storage {stream!r}")
    return w + 2 * n * F32


def smoother_stream(config: dict, level: int) -> str:
    vc = config["vcycle"]
    on = vc["smoother_stream"] == "bf16_pencil" and 2**level + 1 >= vc["smoother_stream_min_lat"]
    return "bf16_pencil" if on else "f32_sym"


def vcycle_applies(config: dict) -> int:
    """Stencil applications per level >= 1 in one V-cycle."""
    vc = config["vcycle"]
    return (vc["pre_smooth"] - 1) + vc["post_smooth"] + 1


def vcycle_bytes(config: dict) -> int:
    refs = config["mesh"]["refs"]
    total = sum(vcycle_applies(config) * apply_bytes(config, l, smoother_stream(config, l))
                for l in range(1, refs + 1))
    n0 = config["lattice"]["components"] * config["expect"]["level0_vertices"]
    return total + n0 * n0 * F32 + 2 * n0 * F32


def df_apply_bytes(config: dict) -> int:
    """The IR residual: the f32 half stencil, x as (hi, lo), y as (hi, lo)."""
    refs = config["mesh"]["refs"]
    g = lattice(config, refs)
    n = g["C"] * g["sites"] * g["P"]
    return apply_bytes(config, refs, "f32_sym") + 2 * n * F32


def ir_solve_bytes(config: dict, rounds: int, inner_iters: int) -> int:
    """Least stencil bytes of one cg_ir_p solve of `rounds` rounds and
    `inner_iters` CG iterations in all."""
    refs = config["mesh"]["refs"]
    n_cg = inner_iters + rounds
    return (n_cg * (apply_bytes(config, refs, "f32_sym") + vcycle_bytes(config))
            + rounds * df_apply_bytes(config))
