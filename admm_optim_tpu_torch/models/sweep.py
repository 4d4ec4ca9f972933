"""Design sweeps: the ADMM inner solver over a batch of sigma/scaling
candidates on one geometry, or over a batch of geometries (port of
admm_optim_tpu/models/sweep.py).

The JAX package runs the candidates as one ``jax.vmap`` of its jitted ADMM
loop, each lane frozen when it finishes; here each sweep is a host loop
over the candidates that calls the same ``admm_inner`` once per candidate,
so every candidate is exactly its single call.  The result is the JAX
package's batched ADMMState: every field stacked along a leading axis B,
the counters and flags as tensors, which ``best_candidate`` indexes as the
JAX one does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import ns_run, xupdate_solve
from ..optim import admm


def stack_states(states: list) -> admm.ADMMState:
    """One ADMMState per candidate -> the batched ADMMState (leading axis
    B; Python numbers and lists become tensors)."""
    out = {}
    for f in dataclasses.fields(admm.ADMMState):
        vals = [getattr(st, f.name) for st in states]
        if isinstance(vals[0], torch.Tensor):
            out[f.name] = torch.stack(vals)
        else:
            out[f.name] = torch.tensor(vals)
    return admm.ADMMState(**out)


def sigma_sweep(prob, X, Jp, sigmas, scalings=None) -> admm.ADMMState:
    """The ADMM inner solver for each (sigma, scaling) candidate on the
    geometry X (V, d) with the shape gradient Jp (C, V), on prob's backend
    (models.obstacle.ObstacleShapeOpt); scalings default to ones.  u is
    global (B, C, V) on either backend."""
    sigmas = [float(v) for v in sigmas]
    scalings = [1.0] * len(sigmas) if scalings is None else [float(v) for v in scalings]
    mgdata = xupdate_solve.assemble(prob.xu, X)
    return stack_states([prob._admm(mgdata, X, Jp, sg, sc) for sg, sc in zip(sigmas, scalings)])


def global_xupdate(prob) -> xupdate_solve.SolveContext:
    """The global (block-ELL) deformation context of prob's hierarchy with
    the x-update's coefficients (c_eps, tau, c_mass) and the default V(3,3)
    cycle: prob.xu itself on the global backend; on the patch backend one
    built at first use and kept on prob, the counterpart of the JAX
    package's def_space, which every problem builds
    (admm_optim_tpu/models/obstacle.py:219-220)."""
    if not prob.use_patch:
        return prob.xu
    xu = prob.__dict__.get("_xu_global")
    if xu is None:
        a = prob.cfg.admm
        xu = prob._xu_global = xupdate_solve.prepare(prob.hier, prob.device, prob.dtype, a.c_eps, a.tau, a.c_mass,
                                                     smoothing={}, backend="global")
    return xu


def geometry_sweep(prob, Xs, Jps, sigma, scaling=1.0) -> admm.ADMMState:
    """The ADMM inner solver for each geometry Xs[b] (V, d) with its shape
    gradient Jps[b] (C, V) on the global backend of prob's mesh
    (global_xupdate), whichever backend prob's x-update runs on, as the JAX
    package's runs on def_space; the multigrid data assembled per
    geometry."""
    xu = global_xupdate(prob)
    a = prob.cfg.admm
    states = []
    for X, Jp in zip(Xs, Jps):
        X = torch.as_tensor(X, dtype=prob.dtype, device=prob.device).contiguous()
        Jp = torch.as_tensor(Jp, dtype=prob.dtype, device=prob.device).contiguous()
        states.append(admm.admm_inner_global(
            a, xu.struct, xupdate_solve.assemble(xu, X), X, prob.elems, prob.ns.free_def, Jp, float(sigma),
            float(scaling), prob.ref_volume, prob.ref_barycenter, vplan=xu.vplan,
        ))
    return stack_states(states)


def best_candidate(prob, X, s, states: admm.ADMMState):
    """The drag of each candidate deformation of a batched ADMMState, by an
    NS re-solve on each deformed mesh from the state s (the forward recycle
    space of prob carried across them, as the JAX package's _ns_solve
    does); returns (index, drags), +inf for a failed candidate or
    re-solve."""
    drags = []
    for b in range(states.u.shape[0]):
        if bool(states.failed[b]) or not bool(states.converged[b]):
            drags.append(float("inf"))
            continue
        X_new = (X + states.u[b].T).contiguous()
        res, _ = ns_run.newton(prob.ns, s, recycle=prob._ns_recycle, X=X_new)
        drags.append(prob._drag(X_new, res.s) if res.converged else float("inf"))
    drags = np.asarray(drags)
    return int(np.argmin(drags)), drags
