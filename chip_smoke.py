#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase NAME[,NAME]   (build and kernels, then these phases)
    python3 chip_smoke.py --kernels-only        (= --phase kernels: phases 1-3, then stop)

NAME is one of kernels, slice, admm, shard, ns, step, global, pcd, variants, small, cli,
sizes (admm brings slice, whose refs=4 context it runs on); the default runs
them all, and only the full run prints the {"ok": true, ...} line.  Run
alone, step and global climb their own viscosity ladder, shard builds its
own refs=4 context, and sizes refines from scratch.

Needs one CUDA device (there is no CPU path) and nvcc.  Phases, in the order
they run:
  1. device: the card's name and power limit;
  2. build: compiles the stencil kernels from admm_optim_tpu_torch/csrc
     (one nvcc per part of the library, all at once), prints ptxas's
     registers, shared memory and spills per kernel and
     instantiation (K2/K3's with the blocks an SM holds; it must not
     spill);
  3. kernels: each kernel against its plain PyTorch twin at the refs=4
     fine shape (17^3 x 224), at the NS V-cycle's refs=2 fine shape
     (9^3 x 224) and at a small shape with boundary pencils (3^3 x 5),
     random W with a Dirichlet mask, K3 and K1 on a lane axis with B = 2, 5
     and 8 (each lane also bitwise equal to K2, or K1, on that field); K5
     and K5^T with C = 3 and with C = 1 (the scalar pressure operators of
     the PCD Schur block), K1 on one field and on 5 lanes (the step's
     x-update), K2 and K3 also at the coarse 3D levels of the NS velocity
     V-cycle, which are the refs=2 pressure lattices too (5^3 and 3^3 x
     224), and K5, K5^T, K2, K3 and K4 at a P that is no multiple of 4
     (5^3 x 222; K2, K3 and K4 timed at 3^3 x 5 too), and at one rank's
     block of the shard phase, 112 patches: K1, K2 and K4 at 17^3 and 9^3
     x 112, K1 on lanes at 5^3 x 112;
     errors, median device times (L2 emptied before each launch), the
     time of one call made on an idle card, each kernel's bound (bytes over 3.35 TB/s or flops over the
     published peak, whichever is larger) and the launch floor (the device
     time of an empty kernel), for K3 the time of five K2 launches on the
     same lanes, for K5 and K5^T the adjointness <A x, y> = <x, A^T y> on
     the card, for every kernel (K1 on a field and on lanes, K2, K3, K4, K5
     and K5^T at C = 3 and C = 1) the same result with 1e30 in every W
     entry whose neighbour lies outside the lattice, and at the shapes of
     the kernels line's entries (17^3, 9^3 and 5^3 x 224) each kernel's
     time also with the L2 emptied of clean lines (by reading, not zeroing,
     the 512 MB buffer: no write-back of the buffer's lines) and with the
     L2 left warm; the Hessian assembly of the ADMM x-update (group
     "hess") at 17^3 x 224, 9^3 x 224 and 3^3 x 5 on a jittered lattice,
     beside its byte and FP32 bounds, its twin timed once, twice bit for
     bit; KC, the constraint gradients (group "cgrads"), the same way at
     the same shapes, with and without pvalid, its twin timed thrice;
  4. slice: xupdate_solve.build(4) + solve on the GPU (2,843,910 DoF), its
     convergence to a true relative residual <= 1e-8 (evaluated once in
     f64 with the plain apply), the kernel launch counts of that run, its
     counts beside those recorded in PERF.md (SOLVE_COUNTS);
  5. admm: admm_run.run on the same refs=4 context (bench.py's
     admm_throughput: 5 ADMM iterations at most, 1+m = 5 lanes per
     x-update solve), its counters (beside ADMM_COUNTS), time split and
     launch counts;
  6. shard: the multi-device layer (parallel/) on two gloo ranks sharing
     the card, each the contiguous block of 112 of the 224 patches,
     against the single-device port on the same card: (a) at the refs=4
     fine lattice the sharded exchange and double-float exchange of a
     seeded field bit for bit; (b) the refs=4 IR solve from each rank's
     own assembly of its block, the slice phase's settings, converged to a
     true relative residual <= 1e-8 (rechecked in float64 against the
     single-device operator), x within SHARD_X_REL of the single-device
     solve, its rounds and inner iterations beside the single device's,
     each rank's launches by lattice (K1, K2, K4 on the 112-patch
     lattices); (c) graft_entry_torch's deep-phase ADMM at 3D refs=2 with
     level 0 agglomerated: the single-device admm_it, Newton and Krylov
     counts (per lane too), u and the dual tensor finite and within
     SHARD_U_REL, no early solver exit, K1 on lanes at 5^3 x 112; (d) the
     sharded solve twice, bit for bit; seconds per piece and the bytes
     handed to the collectives;
  7. ns: the NS path at refs=2 (383,400 NS unknowns), float32, with the
     lumped-mass pressure block: the cold-start viscosity ladder
     0.16 -> 0.02 (linear counts and seconds per linear iteration per
     rung; a rung the mass block fails is a finding, not a failed check),
     then at the first rung's state (visc 0.16) the drag, the adjoint with
     the vjp-transposed preconditioner (K5^T) under a cut iteration budget,
     and the masked shape gradient J', and the Jacobian assembly at that
     state timed at its JAC_CELL_CHUNK with its peak memory;
  8. step: two optimization steps of models.obstacle.ObstacleShapeOpt at
     3D refs=2, visc 0.02, float32 with f32_presets and the mass block.
     Step 0 starts from the 0.02 state the ns phase's ladder reached (the
     JAX package's "step -1" state; alone, the phase runs its own ladder)
     with telemetry, a checkpoint path and a profiler; then that model is
     deleted and a fresh one takes step 1 from load_checkpoint(checkpoint)
     and its warm sidecar.  Per step: seconds, launches and launches by
     lattice per phase (adjoint, J', assemble, ADMM, tangle test, NS
     re-solve, drag), the StepRecord, every attempt and what it halved;
     gates for each: accepted within max_attempts_per_step, drag fell, min
     det > 0, the re-solved |R| rechecked in float64 <= accept_tol, volume
     and barycenter of the new mesh (float64, on the host) within 10 x
     ns_abs_llambda_tol of the undeformed mesh's; for step 1 also: the
     sidecar restored, __Drag.txt with two rows equal to the two
     StepRecords;
  9. global: the global (block-ELL) backend, which launches no
     hand-written kernel, at 3D refs=2, visc 0.02, float32 (the step's
     configuration with backend="global"): global against patch on the
     same mesh (the deformation operator A at X0, J x and J^T x at the ns
     phase's 0.02 state, within 1e-5 of max |y|), spmv_flat_pair's backward
     against the spmv on the transposed values and the transposed ELL
     preconditioner's adjointness, and whether each operator repeats bit
     for bit;
     then one optimization step from the ns phase's 0.02 ladder state with
     the launch counts set to 0 before and read after (every count must be
     0), held to step_gates, to the patch step 0's accepting attempt and to
     10% of its drag decrease, its seconds per phase, adjoint, linear
     counts, peak memory and set-up beside the patch step 0's; the ELL
     Jacobian's assembly timed at its JAC_ELEM_CHUNK (two calls' blocks
     within 1e-6 of max |W|, and whether bit for bit); then at 3D refs=1 sigma_sweep on the patch
     backend with best_candidate, and geometry_sweep on that patch problem
     (it runs on the global context of the same mesh, built at first use)
     over X0 and X0 plus half the first sweep candidate's u, each candidate
     against its single admm_inner call (equal counts, u within 1e-5 of
     max |u|);
 10. pcd: at refs=2, float32, with the PCD pressure block: one rung, the
     Newton solve at visc 0.02 from the mass ladder's converged visc 0.04
     state (alone: ns_run.run(ctx, target_visc=0.02), the whole ladder;
     Newton and linear counts, |R|, assembly seconds of the velocity data,
     the PCD data and the Jacobian, seconds per linear iteration; the last
     |R| rechecked in float64 with the plain residual), drag, adjoint (cut
     to 100 iterations) and J' at visc 0.02, the rung against the mass
     ladder's, launches per phase, peak memory, and a profiled window of
     the Krylov operators for the card's busy share and K5's share of
     device time (scripts/torch_vel_inner.py runs the rung with 1 and 2
     velocity-block Richardson steps in turns);
 11. variants: ROADMAP item 9b at 3D refs=2, float32, from the ns phase's
     mass ladder states (alone: its own ladder on the global backend):
     (a) the matrix-free J x (torch.func.jvp) and J^T x (torch.func.vjp)
     against the assembled ELL forms within 1e-5 of max |y|, their ms at
     the module's NS_ELEM_CHUNK (one element block), and one adjoint cut
     to 100 iterations with the matrix-free form and 200 with the
     assembled one (ms per iteration, peak memory); (b) vorder=1, stab 0.05 on the patch backend: a Newton solve
     at visc 0.16 (converged, float64 |R| <= accept_tol, drag within 25% of
     the P2 drag) and a cut adjoint, K5 and K5^T on the level-k lattice,
     the path's launches counted from 0; (c) b2nd_order with
     high_order_scaling 1: one global step from the 0.02 state, held to
     step_gates, beside the first-order global step; (d) PCD on the global
     backend: the rung 0.04 -> 0.02 twice (the counts must repeat), beside
     the global mass rung and the patch PCD rung; (e) two ns_residual and
     pressure_mass_lumped calls bitwise equal, the global NS re-solve on
     the global step's mesh twice (the counts must repeat), J' twice;
 12. small: refs=1 solve, ADMM run, PCD ladder to visc 0.08 (with drag,
     adjoint and J') and one optimization step from the cold start held
     against the port's float64 CPU runs: the solve and the ADMM run here,
     the ladder as kept in tests/goldens/chip_pcd_ladder_refs1.npz and the
     step in tests/goldens/chip_step_refs1.npz (made on the CPU, in
     minutes, by tests/goldens/make_chip_reference.py); small and cli run
     one after the other in a side process on the same card, started after
     shard, beside the phases from ns on (the card idles most of the time
     on all of them), and the run joins it after variants;
 13. cli: python -m admm_optim_tpu_torch.cli -dim 3 -numRefs 1 -numSteps 1
     -visc 0.16 -admmSteps 40 -nsMaxIts 8 -tau 2 -bNewtonOutput 1
     -bActivateProfiler 1, called in this process: exit code 0, one
     accepted step, __Drag.txt, __Iterations_per_step.txt (9 columns),
     checkpoint.npz at step 0, __NewtonStats_step_0_.txt, and the step
     against the same argv with -x64 run on the CPU and kept in
     tests/goldens/chip_cli_refs1.npz (the same accepting attempt, the
     drags within STEP_DRAG_SHARE of the CPU step's decrease).
 14. sizes: bench.py's largest size and its smallest (bench.py:470-486):
     the refs=5 hierarchy (22,384,134 DoF, 6 levels, fine lattice
     33^3 x 224), whose refine and patchset a child process started with
     the run makes on the host beside the phases before this one and hands
     back pickled through a temporary directory, on the refs=4 levels of
     the slice phase after that context is released; prepare and assemble on the card with their
     seconds and peak device memory, the IR solve with bench.py's settings
     (converged, float64 true relative residual <= 1e-8, x finite, the JAX
     record's 2 rounds and 20 +- 2 inner CG iterations, K1, K2 and K4
     launched at 33^3 x 224, its peak device memory), three warm solves,
     DoF/s, the V-cycle cost table, one profiled solve (the card's busy
     share), and K1 (the assembled symmetric f32 W), K2 (its bf16 pencil
     stream) and K4 (a (hi, lo) split of a seeded field, its error over
     sum |W||x|) on that operator against their twins, timed as in the
     kernels phase; then the same solve at refs=3 (19 +- 2 iterations);
Each path (solve, ADMM, the shard ranks, the refs=5 and refs=3 solves, NS, step, step 1 resumed, global step, PCD, variants, CLI) is driven with the launch
counts set to 0 just before it (the NS paths reset them before each of their phases) and
read just after; each of its kernels must have launched.  The counts are
printed per kernel and per kernel and lattice.
The last three lines are the kernel table as one JSON object, the
nvidia-smi name/power-limit line, and {"ok": true, "device": {...}}.  Any failure
raises, and the run exits nonzero without that last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import multiprocessing
import os
import pathlib
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from admm_optim_tpu_torch import _build, admm_run, cli, ns_run, xupdate_solve
from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import Hierarchy, refine
from admm_optim_tpu_torch.core.patches import build_patchset
from admm_optim_tpu_torch.io.checkpoint import load_checkpoint
from admm_optim_tpu_torch.io.telemetry import TelemetryWriter
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt, ProblemConfig, f32_presets
from admm_optim_tpu_torch.ops import navier_stokes as nsops
from admm_optim_tpu_torch.ops import ns_patchjac as nsjac
from admm_optim_tpu_torch.ops import patchdeform as pdfm
from admm_optim_tpu_torch.ops import patchstencil as st
from admm_optim_tpu_torch.ops import stencil_kernels as sk
from admm_optim_tpu_torch.ops.deformation import barycenter
from admm_optim_tpu_torch.ops.geometry import elem_geometry
from admm_optim_tpu_torch.optim import admm as admm_mod
from admm_optim_tpu_torch.optim.admm import ADMMConfig
from admm_optim_tpu_torch.optim.spaces import PatchOps
from admm_optim_tpu_torch.parallel import launch
from admm_optim_tpu_torch.parallel.patch_shard import build_sharded_mg
from admm_optim_tpu_torch.parallel.sharding import make_mesh
from admm_optim_tpu_torch.solvers import patch_mg
from admm_optim_tpu_torch.solvers.ns_solver import NewtonConfig, transpose_M
from admm_optim_tpu_torch.utils.profiling import Profiler

import graft_entry_torch

SOURCE = "admm_optim_tpu_torch/csrc/stencil.cu"
PALLAS = "admm_optim_tpu/ops/pallas_stencil.py"
FINE_SHAPE = ((17, 17, 17), 224)  # refs=4 fine lattice, P
NS_SHAPE = ((9, 9, 9), 224)  # refs=2 fine lattice of the NS velocity V-cycle
PCD_SHAPE = ((5, 5, 5), 224)  # refs=2 pressure lattice: the PCD Schur block's fine level
PCD_COARSE_SHAPE = ((3, 3, 3), 224)  # its coarse level
ODD_P_SHAPE = ((5, 5, 5), 222)  # P % 4 != 0: the scalar kernel's scalar-width form
SMALL_SHAPE = ((3, 3, 3), 5)
# one rank's block of the refs=4 and refs=2 lattices on two ranks
SHARD_FINE_SHAPE = ((17, 17, 17), 112)
SHARD_NS_SHAPE = ((9, 9, 9), 112)
SHARD_ADMM_SHAPE = ((5, 5, 5), 112)
# the kernel groups of kernel_phase: all at 17^3, 9^3 and 3^3 x 5; what the
# coarse levels, the PCD path and the step's x-update (K1 on 5 lanes) run
# at 5^3 and 3^3 x 224
GROUPS = ("full", "sym", "pencil", "lanes", "batched", "df", "hess", "cgrads")
COARSE_GROUPS = ("full", "sym", "pencil", "lanes", "batched")
PENCIL_GROUPS = ("pencil", "batched")  # K2 and K3, also timed at the scalar-width shapes
# the device kernel of K1, K5 and K5^T on a field of C = 3, as the profiler names it
C3_KERNEL = "apply_w_c3_kernel"
REPS = 20
LANES = 5  # 1 + m lanes of the 3D x-update
LANE_COUNTS = (2, LANES, 8)  # K1's lane kernel and K3 are checked at these
POISON = 1e30  # put into W where no apply may read it
# published H100 SXM rates (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 and float64 rates outside the tensor cores, for the bounds
H100_SXM_GBPS = 3350.0
# what one H100 SM holds (CUDA occupancy rules, compute capability 9.0):
# registers, shared memory with the largest carveout, blocks, warps
SM_REGISTERS, SM_SHARED, SM_BLOCKS, SM_WARPS = 65536, 233472, 32, 64
PENCIL_KERNEL = "apply_w_pencil_kernel"  # K2 and K3's device kernel
PENCIL_THREADS = 64  # its block size, kPcThreads in csrc/stencil.cu
# the counts of the refs=4 paths recorded in PERF.md before K2 and K3's
# redesign, printed beside this run's: solve (inner CG iterations, IR
# rounds), ADMM (iterations, Newton, Krylov)
SOLVE_COUNTS = (19, 2)
ADMM_COUNTS = (1, 2, 98)
F32_FLOPS = 67e12
F64_FLOPS = 34e12
NS_VISC = 0.16  # the first rung of the JAX package's cold-start ladder
PCD_VISC = 0.02  # its last: the reference's default viscosity
# the refs=1 PCD ladder of the small phase: 0.16 -> 0.08 (it climbed to
# 0.02 once; the variants and shard phases were paid for by cutting it);
# card float32 against CPU float64, relative (pcd_small says why)
SMALL_VISC = 0.08
DRAG_TOL = 2e-4
JPRIME_TOL = 3e-4
SMALL_REFERENCE = pathlib.Path(__file__).resolve().parent / "tests" / "goldens" / "chip_pcd_ladder_refs1.npz"
REFERENCE_THREADS = 2
# adjoint iterations of the mass-block and PCD phases at refs=2, one
# Arnoldi chunk (200 before PR 11's variants phase; the step phase runs its
# adjoint at visc 0.02 to the exit)
NS_ADJOINT_BUDGET = 100
PHASES = ("kernels", "slice", "admm", "shard", "ns", "step", "global", "pcd", "variants", "small", "cli", "sizes")
# the sizes phase: bench.py's other sizes (bench.py:470-486), refs=5 then
# refs=3, each beside the JAX package's record of (inner CG iterations, IR
# rounds) on one v5e (docs/bench_r5_full.logtxt:32-43 and :50-59): the rounds
# must be the record's, the iterations within SIZE_ITER_SLACK of it
SIZES = {5: (20, 2), 3: (19, 2)}
SIZE_ITER_SLACK = 2
SIZES_SHAPE = ((33, 33, 33), 224)  # the refs=5 fine lattice, P
SIZES_SEED = 13  # the field K1, K2 and K4 take on the assembled refs=5 operator
# the seconds the phase waits for the child that refines the refs=5
# hierarchy (it starts with the run, minutes of host work)
SIZES_HOST_WAIT_S = 600.0
# the shard phase: two gloo ranks on the one card, each the block of
# SHARD_P patches of the refs=4 lattice (and of the refs=2 one); its seeded
# exchange field, the limits it holds the sharded solve and ADMM to, and
# the seconds its ranks may take (each collective too)
SHARD_RANKS = 2
SHARD_P = 112
SHARD_SEED = 11
SHARD_X_REL = 1e-5
# u and the dual tensor read 3.7e-4 and 2.7e-4 of max apart (PERF.md, PR 12)
SHARD_U_REL = 1e-3
SHARD_TIMEOUT_S = 600.0
STEP_VISC = PCD_VISC  # 3d_admm.lua's default viscosity
# the refs=1 step, card against CPU, at the ladder's first rung: one Newton
# solve from the cold start, so the float64 CPU reference takes minutes
STEP_SMALL_VISC = NS_VISC
# the x-update of the JAX package's 3D reference run
# (scripts/run_reference_3d.py:88-92): CG x-solves on the symmetric KKT Hessian
STEP_ADMM = dict(admm_steps=40, ns_max_its=8, tau=2.0, lin_max_iters=250, x_solver="cg")
STEP_REFERENCE = pathlib.Path(__file__).resolve().parent / "tests" / "goldens" / "chip_step_refs1.npz"
# the refs=1 step: card drag after the step within this share of the CPU step's drag decrease
STEP_DRAG_SHARE = 0.1
# the CLI at 3D refs=1, on the card (float32, f32_presets) and with -x64 on
# the CPU (float64), kept in CLI_REFERENCE
CLI_ARGV = ["-dim", "3", "-numRefs", "1", "-numSteps", "1", "-visc", "0.16", "-admmSteps", "40", "-nsMaxIts", "8",
            "-tau", "2", "-bNewtonOutput", "1", "-bActivateProfiler", "1"]
CLI_REFERENCE = pathlib.Path(__file__).resolve().parent / "tests" / "goldens" / "chip_cli_refs1.npz"
# the PCD phase's one rung: from the mass ladder's state at PCD_FROM_VISC
# to PCD_VISC (the ns phase covers the ladder itself)
PCD_FROM_VISC = 0.04
# the kernels each path must launch, and the TPU kernel each replaces
PATHS = {
    "solve": ("apply_w_sym", "apply_w_pencil", "apply_w_df_sym"),
    "admm": ("apply_w_sym/lanes", "apply_w_pencil_batched", "assemble_hess", "constraint_grads"),
    "ns": ("apply_w_full", "apply_w_full_t"),
    "pcd": ("apply_w_full", "apply_w_full_t", "apply_w_full/c1", "apply_w_full_t/c1"),
    # K1 on lanes in the x-update's batched CG, K5 in the NS re-solve, K5^T in the adjoint
    "step": ("apply_w_sym/lanes", "apply_w_full", "apply_w_full_t"),
    # step 1, resumed from step 0's checkpoint and warm sidecar
    "resume": ("apply_w_sym/lanes", "apply_w_full", "apply_w_full_t"),
    # the CLI's refs=1 ladder rung and step
    "cli": ("apply_w_sym/lanes", "apply_w_full", "apply_w_full_t"),
    # the global (block-ELL) step: no hand-written kernel, every count 0
    "global": (),
    # two ranks' blocks of 112 patches: the refs=4 IR solve (K1, K2, K4)
    # and the refs=2 ADMM's lane solves (K1 on lanes), summed over the ranks
    "shard": ("apply_w_sym", "apply_w_pencil", "apply_w_df_sym", "apply_w_sym/lanes"),
    # vorder=1 on the patch backend: the velocity block on the level-k lattice
    "variants": ("apply_w_full", "apply_w_full_t"),
    # the refs=5 IR solve (33^3 x 224) and the refs=3 one (9^3 x 224)
    "sizes": ("apply_w_sym", "apply_w_pencil", "apply_w_df_sym"),
    "sizes3": ("apply_w_sym", "apply_w_pencil", "apply_w_df_sym"),
}
# the sweeps at 3D refs=1: sigma_sweep's candidates (one since PR 11, whose
# variants phase it pays for; PR 10 ran (0.3, 0.15)), and geometry_sweep's
# second mesh, X0 plus this share of the first candidate's u
SWEEP_SIGMAS = (0.3,)
GEOMETRY_SHARE = 0.5
# global against patch: the share of the patch step 0's drag decrease the
# global step's may differ by
GLOBAL_DECREASE_SHARE = 0.1
# the variants phase (ROADMAP item 9b): P1/P1's Brezzi-Pitkaranta weight,
# its drag against the P2 drag at NS_VISC (tests/test_ns.py:91-106), and
# the cut adjoints
VARIANT_STAB = 0.05
P1_DRAG_SHARE = 0.25
VARIANT_ADJOINT_BUDGET = 200
REPLACES = {
    "apply_w_sym": f"{PALLAS}:213",
    # what jax.vmap makes of the same kernel (admm_optim_tpu/optim/spaces.py:269-296)
    "apply_w_sym/lanes": f"{PALLAS}:213 (its jax.vmap over the lanes of the x-update)",
    "apply_w_pencil": f"{PALLAS}:370",
    "apply_w_pencil_batched": f"{PALLAS}:337",
    "apply_w_df_sym": f"{PALLAS}:588",
    "apply_w_full": f"{PALLAS}:97",
    # the JAX package transposes K5 with jax.vjp inside transpose_M
    "apply_w_full_t": f"{PALLAS}:97 (its jax.vjp, admm_optim_tpu/solvers/ns_solver.py:907)",
    # the same Pallas kernel at C = 1 (C = y_ref.shape[0], :68), reached from the PCD Schur block
    "apply_w_full/c1": f"{PALLAS}:97 (C = 1, from admm_optim_tpu/solvers/ns_solver.py:772-773)",
    "apply_w_full_t/c1": f"{PALLAS}:97 (C = 1, its jax.vjp, admm_optim_tpu/solvers/ns_solver.py:907)",
    # no TPU kernel: the JAX package leaves the assembly to XLA
    "assemble_hess": "none (admm_optim_tpu/optim/spaces.py PatchOps.hess_fn, assembled by XLA)",
    # KC: no TPU kernel either, XLA computes the pass
    "constraint_grads": "none (admm_optim_tpu/optim/spaces.py PatchOps.constraint_grads, computed by XLA)",
}
# the shape each kernel's JSON entry is timed at: the main path's fine level
JSON_SHAPE = {name: "17^3x224" for name in REPLACES}
JSON_SHAPE.update({"apply_w_full": "9^3x224", "apply_w_full_t": "9^3x224",
                   "apply_w_full/c1": "5^3x224", "apply_w_full_t/c1": "5^3x224"})
# the other shapes each kernel's JSON entry gives its times at: the coarse
# levels the paths launch it on, and the scalar kernel's scalar-width form
# (33^3x224: the assembled refs=5 operator of the sizes phase)
BY_SHAPE = {
    "apply_w_sym": ("9^3x224", "5^3x224", "3^3x224", "17^3x112", "9^3x112", "33^3x224"),
    "apply_w_sym/lanes": ("5^3x224", "3^3x224", "5^3x112"),
    "apply_w_pencil": ("9^3x224", "5^3x224", "3^3x224", "5^3x222", "3^3x5", "17^3x112", "9^3x112", "33^3x224"),
    "apply_w_df_sym": ("9^3x224", "5^3x222", "3^3x5", "17^3x112", "9^3x112", "33^3x224"),
    "apply_w_pencil_batched": ("9^3x224", "5^3x224", "3^3x224", "5^3x222", "3^3x5"),
    "apply_w_full": ("5^3x224", "3^3x224"),
    "apply_w_full_t": ("5^3x224", "3^3x224"),
    "apply_w_full/c1": ("3^3x224", "5^3x222"),
    "apply_w_full_t/c1": ("3^3x224", "5^3x222"),
    "assemble_hess": ("9^3x224", "3^3x5"),
    "constraint_grads": ("9^3x224", "3^3x5"),
}
# the Hessian assembly's floating-point operations (csrc/stencil.cu, an FMA
# as 2): a cell's state at one of its corners (geometry, A, cof(A), S,
# C g_a), a diagonal block, an off-diagonal block (with its mask and sum),
# and per site the W_A + pvalid * sums of each stored entry
HESS_STATE_FLOPS, HESS_DIAG_FLOPS, HESS_BLOCK_FLOPS, HESS_OUT_FLOPS = 215, 54, 112, 2
# KC's (csrc/stencil.cu, an FMA as 2): a cell's state at one of its
# corners with its 12 values there (cell_state 166, det(A), C g_a, the
# centroid and the sums 89), and per output value the pvalid product
CGRADS_CELL_FLOPS, CGRADS_OUT_FLOPS = 255, 1


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


_flush = []  # one 512 MB buffer, made at first use


def median_ms(fn, reps=REPS):
    """Median device time of fn() over reps runs after two warm-ups.  Each
    timed run follows the zeroing of a 512 MB buffer.  That empties the 50
    MB L2, as the callers do: the Krylov loops stream hundreds of MB between
    two applies of one W.  And while the card works on it the host enqueues
    fn, so a fn of one launch is timed on the device, not by the host's
    path to the launch."""
    return _median_ms(fn, reps, flush_buffer().zero_)


def flush_buffer():
    if not _flush:
        _flush.append(torch.empty(128 * 2**20, dtype=torch.float32, device="cuda"))
    return _flush[0]


def clean_ms(fn, reps=REPS):
    """median_ms with the L2 emptied by reading the 512 MB buffer instead of
    zeroing it: the L2 then holds clean lines, and fn's reads evict them
    without writing them back."""
    return _median_ms(fn, reps, flush_buffer().sum)


def call_ms(fn, reps=REPS):
    """Median event interval around one fn() made on an idle card: the
    wrapper's and the launch's host time included, L2 warm."""
    return _median_ms(fn, reps, lambda: None)


def _median_ms(fn, reps, before):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        before()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def template_args(mangled):
    """The template arguments at the head of mangled, an Itanium I...E list
    (Li5E an int, f float, 6float4 a named type), as strings."""
    args, k = [], 1
    while k < len(mangled) and mangled[k] != "E":
        if mangled.startswith("Li", k):
            end = mangled.index("E", k)
            args.append(mangled[k + 2:end])
            k = end + 1
        elif mangled[k] == "f":
            args.append("float")
            k += 1
        else:
            n = re.match(r"\d+", mangled[k:]).group()
            k += len(n)
            args.append(mangled[k:k + int(n)])
            k += int(n)
    return args


def ptxas_report(nvcc_log):
    """(kernel<template arguments>, registers, shared memory and spills)
    per entry function of nvcc's -Xptxas -v output."""
    out, kernel, spills = [], None, ""
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+((?:apply_w|empty|assemble_hess|constraint_grads)\w*?_kernel)"
                      r"(I\w+)?", line)
        if m:
            args = template_args(m.group(2)) if m.group(2) else []
            kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and kernel:
            out.append((kernel, f"{line.split(':', 1)[1].strip()}; {spills}"))
            kernel = None
    return out


def blocks_per_sm(used, threads):
    """Blocks of threads threads that one SM holds, from the registers and
    static shared memory in ptxas's report used: registers are allocated
    per warp in units of 256, and each block takes 1 KB of shared memory
    besides its own, in units of 128 bytes."""
    regs = int(re.search(r"Used (\d+) registers", used).group(1))
    smem = re.search(r"(\d+) bytes smem", used)
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    shared = -(-(int(smem.group(1)) if smem else 0) // 128) * 128 + 1024
    return min(SM_BLOCKS, SM_WARPS // warps, SM_REGISTERS // (per_warp * warps), SM_SHARED // shared)


def warm_ms(fn, reps=REPS):
    """median_ms with the L2 left as it is: each timed run follows a spin
    of ~0.2 ms that touches no memory, so the host is still ahead of the
    card and fn finds in L2 what its last run left there."""
    return _median_ms(fn, reps, lambda: torch.cuda._sleep(300_000))


def stencil_patchset():
    """A small 3D channel patchset: the kernels need only its 15-slot
    Kuhn stencil, which every channel_3d hierarchy shares."""
    lv = [geomgen.channel_3d(n_side=(2, 1, 1))]
    lv.append(refine(lv[0]))
    return build_patchset(Hierarchy(lv))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, flops, flops_per_s):
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or the flops over
    the peak rate of their type, whichever is larger."""
    t_bytes = moved / (H100_SXM_GBPS * 1e9) * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_times(got, ref, fn, plain, moved, flops, rate=F32_FLOPS, extra=None, timed=True, scale=None, l2=True,
                 plain_reps=REPS):
    """One kernel's result got against its twin's ref: max_abs_err, rel_err
    (over scale, max |ref| when None); when timed, ms (device, L2
    emptied), call_ms (one call to an idle card), plain_ms (the twin, the
    median of plain_reps runs), extra_ms (extra, where given) and, where
    l2, clean_ms (L2 emptied of clean lines) and warm_ms (L2 left warm),
    else nan; bound_ms and bound_by of moved bytes and flops at rate."""
    err = float((got - ref).abs().max())
    nan = float("nan")
    bms, bby = bound(moved, flops, rate)
    return dict(
        max_abs_err=err, rel_err=err / (float(ref.abs().max()) if scale is None else scale),
        ms=median_ms(fn) if timed else nan, clean_ms=clean_ms(fn) if timed and l2 else nan,
        warm_ms=warm_ms(fn) if timed and l2 else nan, call_ms=call_ms(fn) if timed else nan,
        plain_ms=median_ms(plain, plain_reps) if timed else nan,
        extra_ms=median_ms(extra) if timed and extra else nan, bound_ms=bms, bound_by=bby,
    )


def kernel_phase(ps, shape, seed, timed, groups=GROUPS, device="cuda", l2=False, lane_counts=LANE_COUNTS):
    """The kernels of groups (GROUPS: "full" K5 and K5^T at C = 3 and
    C = 1, "sym" K1 on one field, "pencil" K2, "lanes" K1 on lanes at
    lane_counts, "batched" K3, "df" K4) against their twins on random data
    of one shape; returns per kernel a dict of max_abs_err, rel_err, ms
    (device), call_ms (one call to an idle card), plain_ms, extra_ms,
    bound_ms, bound_by, and per C the adjointness of K5/K5^T; for the
    groups timed names (True: all), and where l2 (the shapes of the
    kernels line's entries), also clean_ms (L2 emptied of clean lines) and
    warm_ms (L2 left warm).  Flops count 2 per multiply-add of the full
    15-slot stencil, per lane.  Every kernel must also give the same result
    with POISON in the W entries no apply may read, and each lane of the
    lane kernels must equal the one-field kernel on that lane's field bit
    for bit."""
    lat, P = shape
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    free = (torch.rand(lat + (P,), generator=g, device=dev) > 0.2).float()
    out = {}

    def record(group, name, got, ref, fn, plain, moved, fl, extra=None, rate=F32_FLOPS, plain_reps=REPS):
        out[name] = kernel_times(got, ref, fn, plain, moved, fl, rate, extra, timed is True or group in timed, l2=l2,
                                 plain_reps=plain_reps)

    def poisoned(what, W, pairs):
        """The same result, bit for bit, with POISON in every W entry whose
        neighbour lies outside the lattice: pairs of (apply(W'), result)."""
        Wp = sk.fill_unused_w(ps, W, POISON)
        check(all(torch.equal(fn(Wp), y) for fn, y in pairs),
              f"{what} at {lat} x {P} reads no W entry whose neighbour lies outside the lattice")

    def full(C):
        """K5 and K5^T on a nonsymmetric full slot-major W, as the NS
        conv-diff V-cycle (C = 3) and the PCD Schur block (C = 1) have, and
        their adjointness."""
        sfx = "" if C == 3 else "/c1"
        Wf = torch.randn((len(ps.stencil), C, C) + lat + (P,), generator=g, device=dev)
        Wf = st.bake_dirichlet_w(ps, ps.k, Wf, free=free).contiguous()
        xf = torch.randn((C,) + lat + (P,), generator=g, device=dev) * free
        yt = torch.randn((C,) + lat + (P,), generator=g, device=dev) * free
        fl = 2.0 * len(ps.stencil) * C * C * free.numel()
        y = sk.apply_w_full(ps, Wf, xf)
        record(
            "full", "apply_w_full" + sfx, y, sk._apply_w_full(ps, Wf, xf),
            lambda: sk.apply_w_full(ps, Wf, xf), lambda: sk._apply_w_full(ps, Wf, xf),
            nbytes(Wf, xf, y), fl,
        )
        z = sk.apply_w_full_t(ps, Wf, yt)
        record(
            "full", "apply_w_full_t" + sfx, z, sk._apply_w_full_t(ps, Wf, yt),
            lambda: sk.apply_w_full_t(ps, Wf, yt), lambda: sk._apply_w_full_t(ps, Wf, yt),
            nbytes(Wf, yt, z), fl,
        )
        a = float(torch.sum(y.double() * yt.double()))
        b = float(torch.sum(xf.double() * z.double()))
        out["adjointness" + sfx] = abs(a - b) / max(abs(a), abs(b))
        poisoned(f"K5 and K5^T at C = {C}", Wf,
                 ((lambda Wp: sk.apply_w_full(ps, Wp, xf), y), (lambda Wp: sk.apply_w_full_t(ps, Wp, yt), z)))

    if "full" in groups:
        full(3)
        full(1)
    if not set(groups) - {"full"}:
        return out
    H = len(st.half_slots(ps))
    W = torch.randn((H, 3, 3) + lat + (P,), generator=g, device=dev)
    W = st.bake_dirichlet_w(ps, ps.k, W, free=free).contiguous()
    x64 = torch.randn((3,) + lat + (P,), generator=g, device=dev, dtype=torch.float64)
    x64 = x64 * free[None].double()
    xh = x64.float()
    xl = (x64 - xh.double()).float()
    W_pc = sk.to_pencil_major(ps, W, torch.bfloat16)
    flops = 2.0 * len(ps.stencil) * 9 * free.numel()  # one field

    if "sym" in groups:
        y = sk.apply_w_sym(ps, W, xh)
        record(
            "sym", "apply_w_sym", y, sk._apply_w_sym(ps, W, xh),
            lambda: sk.apply_w_sym(ps, W, xh), lambda: sk._apply_w_sym(ps, W, xh),
            nbytes(W, xh, y), flops,
        )
        poisoned("K1 on one field", W, ((lambda Wp: sk.apply_w_sym(ps, Wp, xh), y),))
    # K2 and K3's 1e30 check: POISON into the expanded W (the symmetric
    # W_pc's wrapped entries are zero there), then pencil-major bf16
    Wx = st.expand_sym_w(ps, W)

    def pencil(apply, x):
        return lambda Wp: apply(ps, sk.to_pencil_major(ps, Wp, torch.bfloat16), x)

    if "pencil" in groups:
        y = sk.apply_w_pencil(ps, W_pc, xh)
        record(
            "pencil", "apply_w_pencil", y, sk._apply_w_pencil(ps, W_pc, xh),
            lambda: sk.apply_w_pencil(ps, W_pc, xh), lambda: sk._apply_w_pencil(ps, W_pc, xh),
            nbytes(W_pc, xh, y), flops,
        )
        poisoned("K2", Wx, ((pencil(sk.apply_w_pencil, xh), y),))
    xb = torch.randn((LANES, 3) + lat + (P,), generator=g, device=dev) * free
    if "lanes" in groups:
        # K1's lane kernel: against the twin, bit for bit against K1 on each
        # lane's field, and with POISON where it may not read
        for B in lane_counts:
            xB = xb if B == LANES else torch.randn((B, 3) + lat + (P,), generator=g, device=dev) * free
            y = sk.apply_w_sym(ps, W, xB)
            record(
                "lanes", "apply_w_sym/lanes" + ("" if B == LANES else f" B={B}"), y,
                sk._lanes(sk._apply_w_sym, ps, W, xB),
                lambda: sk.apply_w_sym(ps, W, xB), lambda: sk._lanes(sk._apply_w_sym, ps, W, xB),
                nbytes(W, xB, y), B * flops,
            )
            check(all(torch.equal(y[b], sk.apply_w_sym(ps, W, xB[b])) for b in range(B)),
                  f"K1 on {B} lanes at {lat} x {P} equals K1 on each lane's field bit for bit")
            poisoned(f"K1 on {B} lanes", W, ((lambda Wp: sk.apply_w_sym(ps, Wp, xB), y),))
    if "batched" in groups:
        # K3 against its twin, at LANES lanes also against LANES launches of
        # K2 (extra_ms), bit for bit against K2 on each lane's field, and
        # with POISON where it may not read
        for B in LANE_COUNTS:
            xB = xb if B == LANES else torch.randn((B, 3) + lat + (P,), generator=g, device=dev) * free
            y = sk.apply_w_pencil_batched(ps, W_pc, xB)
            record(
                "batched", "apply_w_pencil_batched" + ("" if B == LANES else f" B={B}"), y,
                sk._apply_w_pencil_batched(ps, W_pc, xB),
                lambda: sk.apply_w_pencil_batched(ps, W_pc, xB),
                lambda: sk._apply_w_pencil_batched(ps, W_pc, xB),
                nbytes(W_pc, xB, y), B * flops,
                extra=(lambda: [sk.apply_w_pencil(ps, W_pc, x) for x in xB]) if B == LANES else None,
            )
            check(all(torch.equal(y[b], sk.apply_w_pencil(ps, W_pc, xB[b])) for b in range(B)),
                  f"K3 on {B} lanes at {lat} x {P} equals K2 on each lane's field bit for bit")
            poisoned(f"K3 on {B} lanes", Wx, ((pencil(sk.apply_w_pencil_batched, xB), y),))
    if "df" in groups:
        yh, yl = sk.apply_w_df_sym(ps, W, xh, xl)
        ref64 = sk._apply_w_sym(ps, W.double(), xh.double() + xl.double())
        record(
            "df", "apply_w_df_sym", yh.double() + yl.double(), ref64,
            lambda: sk.apply_w_df_sym(ps, W, xh, xl),
            lambda: sk._apply_w_df_full(ps, st.expand_sym_w(ps, W), xh, xl),
            nbytes(W, xh, xl, yh, yl), flops, rate=F64_FLOPS,  # f64 accumulation
        )
        poisoned("K4", W, ((lambda Wp: torch.cat(sk.apply_w_df_sym(ps, Wp, xh, xl)), torch.cat((yh, yl))),))
    if "hess" in groups:
        hess_group(ps, lat, P, W, free, g, dev, record, out)
    if "cgrads" in groups:
        cgrads_group(ps, lat, P, free, g, dev, record, out)
    return out


def jittered_lattice(lat, P, free, g, dev):
    """The coordinates of a lattice of spacing 1/16 jittered by a tenth of
    it (every Kuhn cell keeps its orientation), P patches side by side
    along x, and u of 0.05 of the spacing, zero where free is."""
    h = 1.0 / 16
    site = torch.stack(torch.meshgrid(*[torch.arange(n, device=dev) for n in lat], indexing="ij")).float()
    patch = torch.arange(P, device=dev).float() * (lat[0] - 1)
    cp = site[..., None] * h + torch.stack([patch * h, 0 * patch, 0 * patch]).reshape(3, 1, 1, 1, P)
    cp = (cp + 0.1 * h * torch.rand(cp.shape, generator=g, device=dev)).contiguous()
    u = (0.05 * h * torch.randn(cp.shape, generator=g, device=dev) * free).contiguous()
    return cp, u


def hess_group(ps, lat, P, W, free, g, dev, record, out):
    """The Hessian assembly (stencil_kernels.assemble_hess) on W as W_A, a
    jittered lattice and a random Lambda: against its twin, the twin timed
    once (its ~27,000 launches at 17^3 x 224 take most of a second), twice
    bit for bit, and its byte and FP32 bounds beside each other
    (out[name]["bounds_ms"])."""
    cp, u = jittered_lattice(lat, P, free, g, dev)
    lam = torch.randn(4, generator=g, device=dev)
    args = (W, cp, u, lam, free)
    y = sk.assemble_hess(ps, *args)
    check(torch.equal(y, sk.assemble_hess(ps, *args)), f"assemble_hess at {lat} x {P}: two calls, the same bits")
    cells = math.prod(n - 1 for n in lat) * P
    stored = sum(p >= 0 for p in sk.stencil_tables(ps).hess_rows(True)[72:])  # of the 6 x 16 pairs
    fl = cells * (24 * HESS_STATE_FLOPS + 24 * HESS_DIAG_FLOPS + (stored - 24) * HESS_BLOCK_FLOPS)
    fl += HESS_OUT_FLOPS * y.numel()
    moved = nbytes(W, cp, u, free, y)
    record("hess", "assemble_hess", y, sk._assemble_hess(ps, *args), lambda: sk.assemble_hess(ps, *args),
           lambda: sk._assemble_hess(ps, *args), moved, fl, plain_reps=1)
    out["assemble_hess"]["bounds_ms"] = bounds_ms(moved, fl)


def cgrads_group(ps, lat, P, free, g, dev, record, out):
    """KC, the constraint gradients (stencil_kernels.constraint_grads), on
    a jittered lattice: against its twin (patchdeform
    .constraint_grads_analytic_p over the cell geometry, which the
    program derives once), without pvalid and with one that zeroes every
    fifth patch, twice bit for bit, and its byte and FP32 bounds beside
    each other (out[name]["bounds_ms"])."""
    cp, u = jittered_lattice(lat, P, free, g, dev)
    pvalid = (torch.arange(P, device=dev) % 5 != 0).float()
    for pv in (pvalid, None):  # the unmasked call last: it is timed
        geo = pdfm.cell_geometry(ps, cp, pv)
        y = sk.constraint_grads(ps, geo, cp, u, pv)
        ref = pdfm.constraint_grads_analytic_p(ps, geo, u, 0.0, None)
        what = f"constraint_grads at {lat} x {P}{'' if pv is None else ' with pvalid'}"
        check(torch.equal(y, sk.constraint_grads(ps, geo, cp, u, pv)), f"{what}: two calls, the same bits")
        err = float((y - ref).abs().max()) / float(ref.abs().max())
        check(err <= 1e-5, f"{what}: rel err {err:.3e} > 1e-05")
    fl = math.prod(n - 1 for n in lat) * P * 24 * CGRADS_CELL_FLOPS + CGRADS_OUT_FLOPS * y.numel()
    moved = nbytes(cp, u, y)
    record("cgrads", "constraint_grads", y, ref, lambda: sk.constraint_grads(ps, geo, cp, u),
           lambda: pdfm.constraint_grads_analytic_p(ps, geo, u, 0.0, None), moved, fl, plain_reps=3)
    out["constraint_grads"]["bounds_ms"] = bounds_ms(moved, fl)


def bounds_ms(moved, fl):
    """The byte and FP32 bounds of a kernel side by side, and its GFLOP."""
    return {"bytes": moved / (H100_SXM_GBPS * 1e9) * 1e3, "fp32": fl / F32_FLOPS * 1e3, "gflop": fl / 1e9}


def log_kernel(tag, name, label, t, floor_ms):
    """One kernel_times result t on a line, held to its limit: 1e-5 of
    max |y| (1e-13 for K4, against a float64 apply)."""
    limit = 1e-13 if name == "apply_w_df_sym" else 1e-5
    log(
        f"[{tag}] {name:22s} {label:9s} max_abs_err {t['max_abs_err']:.3e} rel {t['rel_err']:.3e} "
        f"(limit {limit:.0e}) kernel {t['ms']:.4f} ms (one call to an idle card "
        f"{t['call_ms']:.4f} ms) twin {t['plain_ms']:.4f} ms bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
        f"floor {floor_ms:.4f} ms"
        + (f" {LANES} x K2 {t['extra_ms']:.4f} ms" if name == "apply_w_pencil_batched" else "")
        + (f" L2 emptied of clean lines {t['clean_ms']:.4f} ms, L2 warm {t['warm_ms']:.4f} ms"
           if t["clean_ms"] == t["clean_ms"] else "")
        + (f" bounds: bytes {t['bounds_ms']['bytes']:.4f} ms, FP32 {t['bounds_ms']['fp32']:.4f} ms "
           f"({t['bounds_ms']['gflop']:.2f} GFLOP)" if "bounds_ms" in t else "")
    )
    check(t["rel_err"] <= limit, f"{name} at {label}: rel err {t['rel_err']:.3e} > {limit:.0e}")


def read_launches(path, by_lattice):
    """Launch counts of one path's run (counts were reset just before it),
    of the kernels that launched; each kernel of the path must have.  The
    counts by kernel and lattice go into by_lattice[path] and the log."""
    torch.cuda.synchronize()
    by_lattice[path] = dict(sk.launches_by_lattice)
    log_lattices(path, by_lattice[path])
    return required_launched(path, {name: n for name, n in sk.launches.items() if n})


def log_lattices(tag, counts, phase=None):
    """One line of launch counts by kernel and lattice: {(name, lattice): n}."""
    per = {}
    for (name, lat), n in sorted(counts.items()):
        per.setdefault(name, {})[lattice_name(lat)] = n
    log(f"[{tag}] launches by lattice{f' in the {phase} phase' if phase else ''}: {per}")


def sum_lattices(by_phase):
    """{(name, lattice): n} summed over the phases of a path."""
    total = {}
    for counts in by_phase.values():
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
    return total


def required_launched(path, counts):
    for name in PATHS[path]:
        check(counts.get(name, 0) > 0, f"{name} launched by the {path} path")
    return counts


def true_rel_residual(ctx, b, x64):
    """||b - A x|| / ||b|| in f64 with the plain apply and exchange, x64
    the solution in float64 (a check of the result, not part of the
    solve)."""
    ps, data = ctx.ps, ctx.data
    tab = data.tabs[ps.k]
    W64 = data.W[ps.k].double()
    y = st.exchange_sum(None, sk._apply_w_sym(ps, W64, x64), tab)
    free = tab.free.double()[None]
    b64 = b.double()
    r = (b64 - y) * free
    return float(torch.sqrt(st.owner_dot(None, r, r, tab)) / torch.sqrt(st.owner_dot(None, b64, b64, tab)))


def device_ms(prof):
    """(device ms of all kernels, of C3_KERNEL (K5/K5^T at
    C = 3), of apply_w_scalar_kernel (at C = 1), the five kernels with
    the most device time as (name, ms, count)) in a torch.profiler run, or
    None when the trace holds no device time."""
    from torch.autograd import DeviceType

    total = k5 = k5c1 = 0.0
    by_name = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        total += t
        by_name.append((e.key[:60], t / 1e3, e.count))
        if "apply_w_scalar_kernel" in e.key:
            k5c1 += t
        elif C3_KERNEL in e.key:
            k5 += t
    top = sorted(by_name, key=lambda r: -r[1])[:5]
    return (total / 1e3, k5 / 1e3, k5c1 / 1e3, top) if total > 0 else None


def ns_profile(tag, ctx, s, reps=2):
    """The Krylov operators of an NS path at the state s: wall and device
    time of reps x (M, then J) and of reps x (M^T, then J^T), untraced and
    under torch.profiler, and K5's share of the device time."""
    m_args = ctx.pre_full(ctx.coords, s, ctx.visc)
    W = m_args[-1]
    MT = transpose_M(lambda r: ctx.M_fn(r, *m_args), ctx.n_state, s.dtype, s.device)
    v = torch.randn(ctx.n_state, generator=torch.Generator(device=s.device).manual_seed(5), device=s.device)
    ops = {
        "M then J": lambda: [ctx.jv(ctx.M_fn(v, *m_args), W) for _ in range(reps)],
        "M^T then J^T": lambda: [ctx.jtv(MT(v), W) for _ in range(reps)],
    }
    def untraced_ms(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    for label, fn in ops.items():
        wall = untraced_ms(fn)
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            traced = (time.perf_counter() - t0) * 1e3
        dev = device_ms(prof)
        if dev is None:
            log(f"[{tag}] {reps} x ({label}): {wall / reps:.3f} ms each untraced; device time not measured "
                "(the trace holds no device events)")
            continue
        total, k5, k5c1, top = dev
        check(k5 > 0, f"[{tag}] the trace of {label} holds device time of K5/K5^T at C = 3 under {C3_KERNEL}")
        log(
            f"[{tag}] {reps} x ({label}): {wall / reps:.3f} ms each untraced, {traced / reps:.3f} ms traced; "
            f"device busy {total / reps:.3f} ms each ({100 * total / wall:.1f}% of the untraced wall); "
            f"K5/K5^T at C = 3 {k5 / reps:.3f} ms each ({100 * k5 / total:.1f}% of device time), at C = 1 "
            f"{k5c1 / reps:.3f} ms each ({100 * k5c1 / total:.1f}%); top kernels "
            + "; ".join(f"{n} {100 * t / total:.1f}% ({c})" for n, t, c in top)
        )


def counted(fn, lattices):
    """fn() with the launch counts set to 0 just before and read just
    after: (result, synchronized seconds, counts); the counts by kernel and
    lattice go into the dict lattices."""
    sync()
    sk.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    lattices.update(sk.launches_by_lattice)
    return out, time.perf_counter() - t0, dict(sk.launches)


def path_launches(path, by_phase):
    """The launches of one NS path summed over its phases; each kernel of
    the path must have launched."""
    counts = {name: sum(n[name] for n in by_phase.values()) for name in sk.launches}
    return required_launched(path, {name: n for name, n in counts.items() if n})


def report_rungs(tag, rungs):
    """One line per attempted rung of a ladder; returns the linear
    iterations and the seconds outside assembly of the converged rungs."""
    lin_all = secs_all = 0.0
    for r in rungs:
        nw = r.newton
        lin = sum(nw.lin_iters)
        asm = {k: sum(a.get(k, 0.0) for a in r.assembly_seconds)
               for k in ("velocity", "pcd", "jacobian", "coupling")}
        outside = r.seconds - sum(asm.values())
        if nw.converged:
            lin_all += lin
            secs_all += outside
        log(
            f"[{tag}] rung nu={r.nu:.5g}{' (inserted)' if r.inserted else ''}: converged {nw.converged}, "
            f"{nw.iters} Newton, linear {nw.lin_iters} ({lin}), |R| {nw.res_norm:.3e}, {r.seconds:.3f} s; "
            f"assembly over the rung: velocity data {asm['velocity']:.3f} s, PCD data {asm['pcd']:.3f} s, "
            f"Jacobian {asm['jacobian']:.3f} s; {1e3 * outside / max(lin, 1):.2f} ms per linear iteration "
            f"outside assembly (line search and recycling included)"
        )
    return lin_all, secs_all


def check_adjoint_and_gradient(tag, ctx, adj, drag, jp, exits):
    check(adj.exit in exits, f"{tag}: adjoint exit {adj.exit}")
    check(bool(torch.isfinite(adj.lam).all()), f"{tag}: finite adjoint")
    check(adj.res_norm < adj.target / ctx.cfg.adj_rel_tol, f"{tag}: the adjoint residual fell below |dJ/ds|")
    check(np.isfinite(drag) and drag > 0, f"{tag}: finite positive drag")
    off = (ctx.obstacle_vmask == 0)[None].expand_as(jp)
    check(jp.shape == (3, ctx.space.n_vertices) and bool(torch.isfinite(jp).all()), f"{tag}: finite J'")
    check(float(jp[off].abs().max()) == 0.0 and float(jp.abs().max()) > 0, f"{tag}: J' nonzero only on the obstacle")


def float64_residual(ctx, s, X=None):
    """|R| of the state s on the mesh X (default ctx.coords), in float64
    with the plain residual."""
    X = ctx.coords if X is None else X
    return float(torch.linalg.vector_norm(
        nsops.ns_residual(ctx.space, X.double(), s.double(), ctx.visc, ctx.stab)))


def ns_phase(ctx_pcd, launches, by_lattice):
    """The NS path with the lumped-mass pressure block at refs=2, float32,
    on the tables of the PCD context: the cold-start ladder to PCD_VISC
    for the comparison with PCD, then drag, adjoint and J' at its first
    rung, the cold-start solve at NS_VISC.  The adjoint gets
    NS_ADJOINT_BUDGET iterations (one Arnoldi chunk), a seventh of what its
    stagnation exit takes there: the step phase runs its adjoints to the
    exit.  Returns the ladder's records."""
    ctx = dataclasses.replace(ctx_pcd, pressure_precond="mass", pcd_tabs=None, pcd_struct=None)
    log(f"[ns] refs=2 n_state={ctx.n_state}, mass pressure block, ladder {NS_VISC} -> {PCD_VISC}")
    by_phase, seconds = {}, {}
    lat = {phase: {} for phase in ("newton", "drag", "adjoint", "jprime")}
    try:
        lad, seconds["newton"], by_phase["newton"] = counted(lambda: ns_run.solve_ladder(ctx), lat["newton"])
        rungs = lad.rungs
    except ns_run.LadderError as err:
        rungs = err.rungs
        log(f"[ns] finding: the mass block did not reach visc {PCD_VISC}: {err}")
        by_phase["newton"] = dict(sk.launches)
        lat["newton"].update(sk.launches_by_lattice)
    lin, secs = report_rungs("ns", rungs)
    log(f"[ns] ladder: {len(rungs)} rungs attempted, {lin:.0f} linear iterations on the converged ones, "
        f"{1e3 * secs / max(lin, 1):.2f} ms each outside assembly; launches {by_phase['newton']}")
    first = rungs[0]
    nw = first.newton
    ctx16 = ctx.at_visc(NS_VISC)
    r64 = float64_residual(ctx16, nw.s)
    log(f"[ns] visc {NS_VISC} from the cold start: {nw.iters} Newton iterations, |R| history "
        f"{[f'{v:.3e}' for v in nw.res_history]}, final |R| {nw.res_norm:.3e} (float64 recheck {r64:.3e}), "
        f"per Newton iteration {[round(v, 3) for v in nw.seconds]} s")
    check(first.nu == NS_VISC and nw.converged and nw.res_norm <= ctx.cfg.accept_tol, "refs=2 Newton converged")
    check(r64 <= ctx.cfg.accept_tol, f"refs=2 float64 |R| {r64:.3e} <= accept_tol")
    drag, seconds["drag"], by_phase["drag"] = counted(
        lambda: float(nsops.drag(ctx.space, ctx.coords, nw.s, NS_VISC)), lat["drag"])
    # adjoint_solve_stepped's budget is 4 * lin_max_iters
    cut = dataclasses.replace(ctx16, cfg=dataclasses.replace(ctx.cfg, lin_max_iters=NS_ADJOINT_BUDGET // 4))
    adj, seconds["adjoint"], by_phase["adjoint"] = counted(lambda: ns_run.adjoint(cut, nw.s), lat["adjoint"])
    jp, seconds["jprime"], by_phase["jprime"] = counted(lambda: ns_run.jprime(ctx16, nw.s, adj.lam), lat["jprime"])
    for phase, n in by_phase.items():
        log(f"[ns] launches in the {phase} phase: {n}")
        log_lattices("ns", lat[phase], phase)
    by_lattice["ns"] = sum_lattices(lat)
    check(by_phase["newton"]["apply_w_full"] > 0, "K5 launched in the Newton phase")
    check(by_phase["adjoint"]["apply_w_full_t"] > 0, "K5^T launched in the adjoint phase")
    launches["ns"] = path_launches("ns", by_phase)
    log(
        f"[ns] adjoint at visc {NS_VISC}, budget cut to {NS_ADJOINT_BUDGET} iterations: exit {adj.exit}, "
        f"{adj.iters} iterations in {adj.cycles} cycles, |r| {adj.res_norm:.3e}, target {adj.target:.3e}, "
        f"{seconds['adjoint']:.3f} s ({1e3 * seconds['adjoint'] / max(adj.iters, 1):.2f} ms per iteration), "
        f"K5^T launches per iteration {by_phase['adjoint']['apply_w_full_t'] / max(adj.iters, 1):.2f}"
    )
    log(f"[ns] drag {drag:.10g} ({seconds['drag']:.4f} s), |J'| {float(torch.linalg.vector_norm(jp)):.6e} "
        f"({seconds['jprime']:.3f} s)")
    check_adjoint_and_gradient("refs=2 mass", ctx16, adj, drag, jp, ("target", "stagnation", "budget"))
    ns_profile("ns", ctx16, nw.s)
    jac_assembly(ctx16, nw.s)
    return rungs


def jac_assembly(ctx, s):
    """The refs=2 NS Jacobian assembly (ctx.jac, what every Newton iterate
    and the adjoint assemble) at the state s, at the module's
    JAC_CELL_CHUNK (settled on the H100 against 4096 and 65536 cells):
    synchronized seconds of one call after a warm-up, the peak device
    memory above what was allocated before, and the blocks of the two calls
    within 1e-6 of max |W| of each other."""
    W0 = ctx.jac(ctx.coords, s, ctx.visc)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    W = ctx.jac(ctx.coords, s, ctx.visc)
    sync()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    cells = int(np.prod(W.shape[3:]))
    chunk = nsjac.JAC_CELL_CHUNK
    diff = rel_diff(W, W0)
    log(f"[ns] Jacobian assembly at visc {ctx.visc}, JAC_CELL_CHUNK {chunk}: {cells} cells per class in "
        f"{-(-cells // chunk)} batch(es), {1e3 * secs:.1f} ms, peak {peak / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB held before; W {tuple(W.shape)}, bitwise equal to the warm-up's "
        f"{torch.equal(W, W0)}, max |W - W(warm-up)| / max |W| {diff:.3e}")
    check(diff <= 1e-6, "the Jacobian blocks of two assemblies agree")
    del W, W0
    torch.cuda.empty_cache()


def step_config(num_refs, visc):
    """3D channel, the x-update of STEP_ADMM, float32 presets (the card's
    run and its float64 CPU reference use the same tolerances)."""
    return f32_presets(ProblemConfig(dim=3, num_refs=num_refs, visc=visc, admm=ADMMConfig(**STEP_ADMM)))


def host_constraints(prob, X):
    """Volume and unnormalized barycenter of the mesh X, float64 on the
    host."""
    X64 = X.detach().double().cpu()
    E = prob.elems.cpu()
    return float(elem_geometry(X64, E)[3].sum()), barycenter(X64, E, torch.zeros_like(X64.T)).numpy()


def log_step(tag, prob, hist):
    """The step's record, its attempts and per phase its seconds, launches
    and launches by lattice."""
    log_ = prob.step_log[-1]
    for a in log_["attempts"]:
        log(f"[{tag}] attempt {a['attempt']}: sigma {a['sigma']:g}, scaling {a['scaling']:g}, {a['outcome']}"
            + (f", halved {a['halved']}" if a["halved"] else "")
            + f"; ADMM {a['admm_it']} iterations, {a['newton']} Newton, {a['krylov']} Krylov"
            + (f"; drag {a['drag']:.10g} ({a['drag_diff']:+.4e}), <J', u> scaled {a['shape_derivative']:+.4e}"
               if "drag" in a else ""))
    adj = log_["adjoint"]
    log(f"[{tag}] adjoint: {adj['iters']} iterations, exit {adj['exit']}, |r| {adj['res_norm']:.3e}, "
        f"target {adj['target']:.3e}; NS re-solves: "
        + "; ".join(f"{n['iters']} Newton, linear {n['lin_iters']}, |R| {n['res_norm']:.3e}" for n in log_["ns"]))
    for r in hist:
        log(f"[{tag}] {r}")
    total = sum(log_["seconds"].values())
    log(f"[{tag}] seconds per phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in log_["seconds"].items())
        + f"; {total:.3f} s in the phases, wall {hist[-1].wall_time if hist else float('nan'):.3f} s")
    for phase, n in log_["launches"].items():
        log(f"[{tag}] launches in the {phase} phase: {n}")
        log_lattices(tag, log_["by_lattice"][phase], phase)


def step_gates(tag, prob, rec, drag_old, log_):
    """The gates of an accepted step at refs=2: the drag fell, min det > 0,
    the re-solved |R| rechecked in float64 <= accept_tol, and volume and
    barycenter of the new mesh (float64, on the host) within 10 x
    ns_abs_llambda_tol of the undeformed mesh's."""
    cfg = prob.cfg
    X, s = prob.X_final, prob.s_final
    r64 = float64_residual(prob.ns, s, X)
    vol, bary = host_constraints(prob, X)
    vol0, bary0 = host_constraints(prob, prob.X0)
    dvol, dbary = abs(vol - vol0), float(np.abs(bary - bary0).max())
    limit = 10 * cfg.admm.ns_abs_llambda_tol
    min_det = prob._min_det(X)
    log(f"[{tag}] drag {drag_old:.10g} -> {rec.drag:.10g} ({-rec.drag_diff:+.4e}, {-rec.drag_diff / drag_old:+.3e} "
        f"relative), {rec.attempts} attempt(s); min det {min_det:.4e}; re-solved |R| {log_['ns'][-1]['res_norm']:.3e} "
        f"(float64 recheck {r64:.3e}, accept_tol {cfg.ns.accept_tol:g}); volume {vol:.10g} vs {vol0:.10g} "
        f"(|diff| {dvol:.3e}), barycenter max |diff| {dbary:.3e} (limit {limit:g}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(rec.attempts <= cfg.max_attempts_per_step, f"{tag}: accepted within {cfg.max_attempts_per_step} attempts")
    check(rec.drag < drag_old, f"{tag}: the drag fell")
    check(min_det > 0, f"{tag}: min det {min_det:.3e} > 0")
    check(r64 <= cfg.ns.accept_tol, f"{tag}: float64 |R| {r64:.3e} <= accept_tol")
    check(dvol <= limit and dbary <= limit, f"{tag}: volume and barycenter within {limit:g}")


def step_launches(path, log_, launches, by_lattice):
    """The launches of one step's phases (the counts were set to 0 just
    before its run); each kernel of the path must have launched."""
    counts = {name: sum(n.get(name, 0) for n in log_["launches"].values()) for name in sk.launches}
    by_lattice[path] = sum_lattices(log_["by_lattice"])
    launches[path] = required_launched(path, {name: n for name, n in counts.items() if n})


def check_drag_file(tag, path, hist, drag_init, dim=3):
    """__Drag.txt holds one row per record of hist, its columns equal to
    the records' (the shape derivative raw in 3D, 3d_admm.lua:1343, over
    scaling * sigma in 2D)."""
    rows = [[float(v) for v in line.split("\t")] for line in path.read_text().strip().splitlines()]
    want = [[r.step, r.drag, r.drag / drag_init, r.drag_diff,
             r.shape_derivative / (r.scaling * r.sigma) if dim == 2 else r.shape_derivative] for r in hist]
    log(f"[{tag}] {path.name}: {rows}")
    check(rows == want, f"{tag}: {path.name} has {len(hist)} rows equal to the StepRecords")


def step_phase(launches, by_lattice, ladder_s=None):
    """Two optimization steps at 3D refs=2, visc STEP_VISC, float32, mass
    block, through ObstacleShapeOpt.run, across a process-like boundary.
    Step 0: ladder_s, the state the ns phase's ladder reached at
    STEP_VISC, is handed to run as the JAX package's "step -1" state
    (without it run climbs its own ladder), with telemetry, a checkpoint
    path and a profiler.  Step 1: that model deleted, a fresh one runs from
    load_checkpoint(checkpoint) with its warm sidecar (the adjoint's
    lambda and recycle space, the forward recycle space).  The launch
    counts are set to 0 just before each run and read just after; each
    step path's are those of its own phases (the ladder's are not)."""
    t0 = time.perf_counter()
    cfg = step_config(2, STEP_VISC)
    prob = ObstacleShapeOpt(cfg)
    sync()
    setup0 = time.perf_counter() - t0
    log(f"[step] refs=2 n_state={prob.ns.n_state}, deformation lattice {prob.xu.ps.fine.lat_shape} x "
        f"{prob.xu.ps.P}, velocity lattice {prob.ns.pre_ps.fine.lat_shape} x {prob.ns.pre_ps.P}, visc {STEP_VISC}, "
        f"x-update {STEP_ADMM}, set-up {setup0:.2f} s")
    resume = None
    if ladder_s is not None:
        resume = dict(X=prob.X0, s=ladder_s, sigma=cfg.sigma_threshold, step=-1,
                      drag_old=float(nsops.drag(prob.ns.space, prob.X0, ladder_s, STEP_VISC)))
        log(f"[step] resumed from the ns phase's ladder state at visc {STEP_VISC}: drag {resume['drag_old']:.10g}")
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        ckpt = str(out / "checkpoint.npz")
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launches()
        t0 = time.perf_counter()
        tele, prof = TelemetryWriter(tmp), Profiler()
        hist = prob.run(num_steps=1, resume=resume, telemetry=tele, checkpoint_path=ckpt, profiler=prof)
        tele.close()
        sync()
        seconds = time.perf_counter() - t0
        if prob.ladder is not None:
            report_rungs("step", prob.ladder.rungs)
        log_step("step", prob, hist)
        log(f"[step] run {seconds:.3f} s; profiler:\n{prof.report()}")
        log0 = prob.step_log[-1]
        step_launches("step", log0, launches, by_lattice)
        check(len(hist) == 1, "refs=2 step 0 accepted")
        step_gates("refs=2 step 0", prob, hist[0], prob.drag_init, log0)
        check(load_checkpoint(ckpt)["step"] == 0 and os.path.exists(ckpt + ".warm.npz"),
              "refs=2 step 0: the checkpoint and its warm sidecar were written")
        patch0 = step_record(prob, hist[0], log0, setup0, seconds)
        drag_init = prob.drag_init
        del prob
        torch.cuda.empty_cache()

        # step 1: a fresh model from the checkpoint and its sidecar
        t0 = time.perf_counter()
        prob = ObstacleShapeOpt(cfg)
        sync()
        setup = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launches()
        t0 = time.perf_counter()
        tele, prof = TelemetryWriter(tmp), Profiler()
        hist1 = prob.run(num_steps=2, resume=load_checkpoint(ckpt), telemetry=tele, checkpoint_path=ckpt,
                         profiler=prof)
        tele.close()
        sync()
        seconds1 = time.perf_counter() - t0
        log(f"[step] step 1 from the checkpoint: rebuild {setup:.2f} s, warm sidecar restored "
            f"{ {k: tuple(v) for k, v in prob.sidecar_restored.items()} }, run {seconds1:.3f} s; "
            f"profiler:\n{prof.report()}")
        log_step("step 1", prob, hist1[1:])
        log1 = prob.step_log[-1]
        step_launches("resume", log1, launches, by_lattice)
        check(prob.ladder is None and [r.step for r in hist1] == [0, 1], "refs=2 step 1 accepted after step 0")
        check(set(prob.sidecar_restored) == {"lam_adj", "adj_U", "ns_U"}, "refs=2 step 1: the warm sidecar restored")
        check(hist1[0] == hist[0], "refs=2 step 1: step 0's record restored from the checkpoint")
        step_gates("refs=2 step 1", prob, hist1[1], hist[0].drag, log1)
        check_drag_file("step 1", out / "__Drag.txt", hist1, drag_init, cfg.dim)
        its = [line.split("\t") for line in (out / "__Iterations_per_step.txt").read_text().strip().splitlines()]
        check(len(its) == 2 and all(len(r) == 9 for r in its), "refs=2: __Iterations_per_step.txt in the 3D layout")
    log("[step] step 0 vs step 1 (warm from the sidecar), seconds per phase: "
        + ", ".join(f"{k} {log0['seconds'][k]:.3f} / {log1['seconds'].get(k, 0.0):.3f}" for k in log0["seconds"])
        + f"; in the phases {sum(log0['seconds'].values()):.3f} / {sum(log1['seconds'].values()):.3f} s; adjoint "
        f"{log0['adjoint']['iters']} / {log1['adjoint']['iters']} iterations ({log0['adjoint']['exit']} / "
        f"{log1['adjoint']['exit']})")
    del prob
    torch.cuda.empty_cache()
    return patch0


def step_small_run(device, dtype):
    """One step at 3D refs=1 from the cold start (a one-rung ladder at
    STEP_SMALL_VISC): (problem, history)."""
    prob = ObstacleShapeOpt(step_config(1, STEP_SMALL_VISC), device=device, dtype=dtype)
    return prob, prob.run(num_steps=1)


def step_summary(prob, hist):
    """What step_small holds the card's refs=1 step to, as numpy arrays."""
    log_ = prob.step_log[-1]
    return dict(
        accepted=np.array(len(hist) == 1), attempts=np.array(len(log_["attempts"])),
        outcomes=np.array([a["outcome"] for a in log_["attempts"]]),
        drag_init=np.array(prob.drag_init), drag=np.array(hist[0].drag if hist else np.nan),
        drag_diff=np.array(hist[0].drag_diff if hist else np.nan),
        admm_iters=np.array([a["admm_it"] for a in log_["attempts"]]),
        newton=np.array([a["newton"] for a in log_["attempts"]]),
        adjoint_iters=np.array(log_["adjoint"]["iters"]),
    )


def step_reference():
    """step_small_run in float64 on the CPU with REFERENCE_THREADS threads:
    tests/goldens/make_chip_reference.py keeps it in STEP_REFERENCE."""
    torch.set_num_threads(REFERENCE_THREADS)
    return dict(step_summary(*step_small_run("cpu", torch.float64)), threads=np.array(REFERENCE_THREADS))


def step_small():
    """The refs=1 step on the card in float32 against the port's float64
    CPU run kept in STEP_REFERENCE: both accept on the same attempt, and
    the drags after the step lie within STEP_DRAG_SHARE of the CPU step's
    drag decrease."""
    t0 = time.perf_counter()
    prob, hist = step_small_run("cuda", torch.float32)
    log(f"[step] refs=1 step on the card, float32, from the cold start at visc {STEP_SMALL_VISC}: "
        f"{time.perf_counter() - t0:.1f} s")
    log_step("step refs=1", prob, hist)
    g, c = step_summary(prob, hist), np.load(STEP_REFERENCE)
    gap = abs(float(g["drag"]) - float(c["drag"]))
    log(f"[step] refs=1 card f32 vs CPU f64 ({STEP_REFERENCE.name}, {int(c['threads'])} threads): attempts "
        f"{g['outcomes'].tolist()} vs {c['outcomes'].tolist()}, ADMM {g['admm_iters'].tolist()} vs "
        f"{c['admm_iters'].tolist()}, Newton {g['newton'].tolist()} vs {c['newton'].tolist()}, adjoint "
        f"{int(g['adjoint_iters'])} vs {int(c['adjoint_iters'])}, drag {float(g['drag_init']):.10g} -> "
        f"{float(g['drag']):.10g} vs {float(c['drag_init']):.10g} -> {float(c['drag']):.10g}: the drags after the "
        f"step {gap:.3e} apart, {gap / float(c['drag_diff']):.3e} of the CPU step's decrease (limit {STEP_DRAG_SHARE:g})")
    check(bool(g["accepted"]) and bool(c["accepted"]) and int(g["attempts"]) == int(c["attempts"]),
          "refs=1 step: card and CPU accept on the same attempt")
    check(gap <= STEP_DRAG_SHARE * float(c["drag_diff"]), "refs=1 step: the card's drag agrees with the CPU's")


def step_record(prob, rec, log_, setup, seconds):
    """What the global phase compares its step with: the accepting attempt,
    the drag decrease, seconds per phase, adjoint, linear counts, peak
    memory and set-up of one step."""
    adj = log_["adjoint"]
    return dict(
        attempts=rec.attempts, drag_old=rec.drag + rec.drag_diff, drag_diff=rec.drag_diff,
        seconds=dict(log_["seconds"]), wall=seconds, setup=setup, adjoint_iters=adj["iters"],
        adjoint_ms=1e3 * log_["seconds"].get("adjoint", 0.0) / max(adj["iters"], 1),
        ns_lin=[sum(n["lin_iters"]) for n in log_["ns"]], admm=rec.admm_iters, newton=rec.newton_iters,
        krylov=rec.lin_iters, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )


def rel_diff(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def global_operator_checks(prob, ctx_ns, s):
    """Global against patch on the same mesh and the ELL transposes, within
    1e-5 of max |y| (the stencil kernels' limit): the deformation operator A
    at X0 (the patch x-update's, K1, against GlobalOps' spmv), J x and J^T x
    at the state s (the lattice Jacobian against the per-element one),
    spmv_flat_pair's backward on the finest velocity level against the
    spmv on its transposed values, and <M r, z> = <r, M^T z> for the ELL
    block preconditioner and its transpose_M.  Each ELL operator is applied
    twice: do the card's results repeat bit for bit?"""
    from admm_optim_tpu_torch.ops import sparsity
    from admm_optim_tpu_torch.optim.spaces import GlobalOps, PatchOps

    gen = torch.Generator(device="cuda").manual_seed(7)
    X, a = prob.X0, prob.cfg.admm
    hier = prob.hier
    free = prob.ns.free_def
    x = torch.randn(free.shape, generator=gen, device="cuda", dtype=free.dtype) * free
    repeats = {}
    gdata = xupdate_solve.assemble(prob.xu, X)
    gops = GlobalOps(prob.xu.struct, gdata, X, prob.elems, free, prob.xu.vplan)
    y_g = gops.A(x) * free
    repeats["A"] = torch.equal(y_g, gops.A(x) * free)
    repeats["ELL assembly"] = all(torch.equal(u, v) for u, v in zip(gdata.vals, xupdate_solve.assemble(prob.xu, X).vals))
    pxu = xupdate_solve.prepare(hier, "cuda", X.dtype, a.c_eps, a.tau, a.c_mass, smoothing={})
    pops = PatchOps(pxu.struct, xupdate_solve.assemble(pxu, X), st.to_patch(pxu.ps.fine, X.T))
    y_p = st.from_patch(pxu.ps.fine, pops.A(st.to_patch(pxu.ps.fine, x)), X.shape[0], mode="owner")
    errs = {"A at X0": rel_diff(y_g, y_p)}
    del pxu, pops
    v = torch.randn(prob.ns.n_state, generator=gen, device="cuda", dtype=X.dtype)
    Wg, Wp = prob.ns.jac(X, s, STEP_VISC), ctx_ns.jac(X, s, STEP_VISC)
    jv_g, jtv_g = prob.ns.jv(v, Wg), prob.ns.jtv(v, Wg)
    errs["J x"] = rel_diff(jv_g, ctx_ns.jv(v, Wp))
    errs["J^T x"] = rel_diff(jtv_g, ctx_ns.jtv(v, Wp))
    repeats["J x"] = torch.equal(jv_g, prob.ns.jv(v, Wg))
    repeats["J^T x"] = torch.equal(jtv_g, prob.ns.jtv(v, Wg))
    repeats["ELL Jacobian"] = torch.equal(Wg, prob.ns.jac(X, s, STEP_VISC))
    del Wp
    m_args = prob.ns.pre_full(X, s, STEP_VISC)
    pre = m_args[0]
    pat = prob.ns.pre_space.patterns[-1]
    xf = torch.randn(pat.n_flat, generator=gen, device="cuda", dtype=X.dtype).requires_grad_(True)
    zf = torch.randn(pat.n_flat, generator=gen, device="cuda", dtype=X.dtype)
    with torch.enable_grad():
        yf = sparsity.spmv_flat_pair(pat, pre.vals[-1], pre.vals_t[-1], xf)
    (gf,) = torch.autograd.grad(yf, xf, zf)
    errs["pair backward vs spmv on vals_t"] = rel_diff(gf, sparsity.spmv_flat(pat, pre.vals_t[-1], zf))
    lhs = float(torch.dot(yf.detach().double(), zf.double()))
    rhs = float(torch.dot(xf.detach().double(), gf.double()))
    errs["<Ax, y> - <x, A^T y>"] = abs(lhs - rhs) / float(torch.linalg.vector_norm(yf.detach())
                                                           * torch.linalg.vector_norm(zf))
    M = lambda r: prob.ns.M_fn(r, *m_args)  # noqa: E731
    MT = transpose_M(M, prob.ns.n_state, X.dtype, X.device)
    r = torch.randn(prob.ns.n_state, generator=gen, device="cuda", dtype=X.dtype)
    z = torch.randn(prob.ns.n_state, generator=gen, device="cuda", dtype=X.dtype)
    Mr, MTz = M(r), MT(z)
    repeats["M"] = torch.equal(Mr, M(r))
    repeats["M^T"] = torch.equal(MTz, MT(z))
    errs["<M r, z> - <r, M^T z>"] = abs(float(torch.dot(Mr.double(), z.double()))
                                        - float(torch.dot(r.double(), MTz.double()))) / float(
        torch.linalg.vector_norm(Mr) * torch.linalg.vector_norm(z))
    for what, e in errs.items():
        log(f"[global] {what}: {e:.3e} (limit 1e-5)")
    log(f"[global] bitwise repeat of a second call on the card: {repeats}")
    for what, e in errs.items():
        check(e <= 1e-5, f"global operator check {what}: {e:.3e}")
    del m_args, pre, Wg
    torch.cuda.empty_cache()


def jac_elem_assembly(prob, s):
    """The ELL Jacobian's assembly (ns_elljac.assemble_ns_jacobian) at 3D
    refs=2 and the state s, at the module's JAC_ELEM_CHUNK (settled on the
    H100 against 4096 and all 86,016 elements): synchronized seconds
    of one call after a warm-up and the peak temporaries above what was
    held before; the blocks of the two calls within 1e-6 of max |W| of
    each other, and whether bit for bit."""
    from admm_optim_tpu_torch.ops import ns_elljac

    W0 = prob.ns.jac(prob.X0, s, STEP_VISC)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    W = prob.ns.jac(prob.X0, s, STEP_VISC)
    sync()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    diff = rel_diff(W, W0)
    E, chunk = W.shape[0], ns_elljac.JAC_ELEM_CHUNK
    log(f"[global] ELL Jacobian assembly, JAC_ELEM_CHUNK {chunk}: {E} elements in {-(-E // chunk)} batch(es), "
        f"{1e3 * secs:.1f} ms, peak {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before (W itself "
        f"{W.numel() * W.element_size() / 2**30:.3f} GiB); bitwise equal to the warm-up's {torch.equal(W, W0)}, "
        f"max |W - W(warm-up)| / max |W| {diff:.3e}")
    check(diff <= 1e-6, "the ELL Jacobian blocks of two assemblies agree")
    del W, W0
    torch.cuda.empty_cache()


def global_phase(ctx_ns, launches, by_lattice, ladder_s=None, patch0=None):
    """One optimization step on the global backend at 3D refs=2, visc
    STEP_VISC, float32, from ladder_s (the ns phase's 0.02 ladder state,
    where the patch step 0 started; without it run climbs its own ladder),
    with the operator checks before it, then the ELL Jacobian's chunks and
    the sweeps.  patch0 (the step phase's step_record) gives what the
    global step is compared with.  Returns the problem, its step_record and
    ladder_s for the variants phase."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(step_config(2, STEP_VISC), backend="global")
    prob = ObstacleShapeOpt(cfg, device="cuda")
    sync()
    setup = time.perf_counter() - t0
    pre = prob.ns.pre_space
    log(f"[global] refs=2 n_state={prob.ns.n_state}, {prob.hier.fine.num_vertices} vertices, "
        f"{prob.hier.fine.num_elems} elements, ELL Jacobian {prob.ns.ell.nloc}^2 x {prob.ns.ell.E} "
        f"({prob.ns.ell.nloc ** 2 * prob.ns.ell.E * 4 / 1e6:.1f} MB in float32), velocity cycle on "
        f"{len(pre.patterns)} levels, finest {pre.nv[-1]} vertices {len(pre.elems[-1])} elements (K = "
        f"{pre.patterns[-1].K}); set-up {setup:.2f} s: host x-update space {prob.xu.host_seconds:.2f} s, NS side "
        f"(velocity space patterns, Jacobian wiring, segment sums) {prob.ns.host_seconds:.2f} s")
    check(not prob.use_patch and prob.xu.ps is None and prob.ns.ps is None,
          "backend='global' selected the block-ELL pieces")
    if ctx_ns is None:
        ctx_ns = ns_run.build(device="cuda", visc=STEP_VISC, hier=prob.hier)
    s_chk = ladder_s if ladder_s is not None else ns_run.initial_state(ctx_ns)
    global_operator_checks(prob, ctx_ns, s_chk)
    del ctx_ns
    resume = None
    if ladder_s is not None:
        resume = dict(X=prob.X0, s=ladder_s, sigma=cfg.sigma_threshold, step=-1,
                      drag_old=float(nsops.drag(prob.ns.space, prob.X0, ladder_s, STEP_VISC)))
    torch.cuda.reset_peak_memory_stats()
    sync()
    sk.reset_launches()
    t0 = time.perf_counter()
    prof = Profiler()
    hist = prob.run(num_steps=1, resume=resume, profiler=prof)
    sync()
    seconds = time.perf_counter() - t0
    counts = dict(sk.launches)
    by_lattice["global"] = dict(sk.launches_by_lattice)
    launches["global"] = counts
    if prob.ladder is not None:
        report_rungs("global", prob.ladder.rungs)
    log_step("global", prob, hist)
    log(f"[global] run {seconds:.3f} s; kernel launches {counts}; profiler:\n{prof.report()}")
    check(all(n == 0 for n in counts.values()), "the global step launched no hand-written kernel")
    check(len(hist) == 1, "refs=2 global step accepted")
    log_ = prob.step_log[-1]
    g = step_record(prob, hist[0], log_, setup, seconds)
    step_gates("refs=2 global step", prob, hist[0], prob.drag_init, log_)
    if patch0 is not None:
        log("[global] global / patch step 0 from the same state: seconds per phase "
            + ", ".join(f"{k} {g['seconds'].get(k, 0.0):.3f} / {patch0['seconds'].get(k, 0.0):.3f}"
                        for k in patch0["seconds"])
            + f"; in the phases {sum(g['seconds'].values()):.3f} / {sum(patch0['seconds'].values()):.3f} s, wall "
            f"{g['wall']:.3f} / {patch0['wall']:.3f} s; adjoint {g['adjoint_iters']} / {patch0['adjoint_iters']} "
            f"iterations at {g['adjoint_ms']:.2f} / {patch0['adjoint_ms']:.2f} ms each; NS re-solve linear "
            f"{g['ns_lin']} / {patch0['ns_lin']}; ADMM {g['admm']} / {patch0['admm']}, Newton {g['newton']} / "
            f"{patch0['newton']}, Krylov {g['krylov']} / {patch0['krylov']}; attempts {g['attempts']} / "
            f"{patch0['attempts']}; drag decrease {g['drag_diff']:.6e} / {patch0['drag_diff']:.6e}; peak device "
            f"memory {g['peak_gib']:.2f} / {patch0['peak_gib']:.2f} GiB; set-up {g['setup']:.2f} / "
            f"{patch0['setup']:.2f} s")
        check(abs(g["drag_old"] - patch0["drag_old"]) <= 1e-6 * patch0["drag_old"],
              "the global and patch steps start from the same drag")
        check(g["attempts"] == patch0["attempts"], "the global step accepts on the patch step 0's attempt")
        gap = abs(g["drag_diff"] - patch0["drag_diff"])
        log(f"[global] drag decrease {gap / patch0['drag_diff']:.3e} of the patch step's apart (limit "
            f"{GLOBAL_DECREASE_SHARE:g})")
        check(gap <= GLOBAL_DECREASE_SHARE * patch0["drag_diff"],
              "the global step's drag decrease within 10% of the patch step's")
    else:
        log("[global] the step phase did not run: no comparison with the patch step 0")
    jac_elem_assembly(prob, prob.s_final)
    torch.cuda.empty_cache()
    sweep_phase()
    return dict(prob=prob, record=g, ladder_s=ladder_s)


def sweep_jp(prob):
    """A shape gradient (d, V) pointing into the obstacle, as
    tests/test_sweep.py's."""
    X = prob.X0
    Jp = -X / torch.clamp_min(torch.linalg.vector_norm(X, dim=1, keepdim=True), 0.3)
    return (Jp * prob.obstacle_vmask[:, None] * 0.15).T.contiguous()


def same_candidate(tag, states, b, st):
    """A sweep candidate against its single call: equal counts and flags, u
    within 1e-5 of max |u|."""
    got = (int(states.admm_it[b]), int(states.total_newton[b]), int(states.total_lin_iters[b]),
           states.solver_iters[b].tolist(), bool(states.converged[b]), bool(states.failed[b]))
    want = (st.admm_it, st.total_newton, st.total_lin_iters, list(st.solver_iters), st.converged, st.failed)
    du = rel_diff(states.u[b], st.u) if float(st.u.abs().max()) > 0 else float(states.u[b].abs().max())
    log(f"[sweep] {tag} candidate {b}: (ADMM, Newton, Krylov, per lane, converged, failed) {got}, single call "
        f"{want}; u {du:.3e} of max |u| apart")
    check(got == want and du <= 1e-5, f"{tag} candidate {b} equals its single admm_inner call")


def sweep_phase():
    """At 3D refs=1, visc NS_VISC, on the patch backend: sigma_sweep over
    SWEEP_SIGMAS and best_candidate from the cold-start Newton state;
    geometry_sweep (on the global context of the same mesh,
    sweep.global_xupdate) over X0 and X0 + GEOMETRY_SHARE u of the first
    candidate; each candidate against its single call."""
    from admm_optim_tpu_torch.models import sweep
    from admm_optim_tpu_torch.optim.admm import admm_inner_global

    t0 = time.perf_counter()
    pp = ObstacleShapeOpt(step_config(1, NS_VISC), device="cuda")
    X, Jp = pp.X0, sweep_jp(pp)
    nres, _ = ns_run.newton(pp.ns, recycle=pp._ns_recycle)
    check(nres.converged, "refs=1 cold-start Newton converged")
    t1 = time.perf_counter()
    states = sweep.sigma_sweep(pp, X, Jp, SWEEP_SIGMAS)
    sync()
    t2 = time.perf_counter()
    mg = xupdate_solve.assemble(pp.xu, X)
    for b, sigma in enumerate(SWEEP_SIGMAS):
        same_candidate("sigma_sweep (patch)", states, b, pp._admm(mg, X, Jp, sigma, 1.0))
    idx, drags = sweep.best_candidate(pp, X, nres.s, states)
    sync()
    log(f"[sweep] refs=1 sigma_sweep over {SWEEP_SIGMAS} on the patch backend: {t2 - t1:.2f} s; best_candidate "
        f"{idx}, drags {drags.tolist()} (start {pp._drag(X, nres.s):.10g}); set-up and Newton {t1 - t0:.2f} s")
    check(np.isfinite(drags[idx]), "best_candidate found a candidate")
    Xs = [X, (X + GEOMETRY_SHARE * states.u[0].T).contiguous()]
    t3 = time.perf_counter()
    gstates = sweep.geometry_sweep(pp, Xs, [Jp, Jp], sigma=SWEEP_SIGMAS[0])
    sync()
    log(f"[sweep] refs=1 geometry_sweep over 2 meshes on the patch problem (global context built at first use): "
        f"{time.perf_counter() - t3:.2f} s")
    gx = sweep.global_xupdate(pp)
    check(gx.space is not None, "geometry_sweep ran on the global context of the patch problem's mesh")
    for b, Xb in enumerate(Xs):
        single = admm_inner_global(pp.cfg.admm, gx.struct, xupdate_solve.assemble(gx, Xb), Xb, pp.elems,
                                   pp.ns.free_def, Jp, SWEEP_SIGMAS[0], 1.0, pp.ref_volume, pp.ref_barycenter,
                                   vplan=gx.vplan)
        same_candidate("geometry_sweep (global)", gstates, b, single)
    del pp, gx
    torch.cuda.empty_cache()


class _Tee(io.StringIO):
    """stdout kept and passed on."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def cli_run(argv, out):
    """cli.main(argv) in this process, writing into the directory out:
    (exit code, its standard output, the accepted steps of history.jsonl)."""
    buf = _Tee()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["-outDir", str(out)])
    sys.stdout.flush()
    hist = [json.loads(line) for line in (out / "history.jsonl").read_text().splitlines()]
    return rc, buf.getvalue(), hist


def cli_reference():
    """CLI_ARGV with -x64 (float64 on the CPU) and REFERENCE_THREADS
    threads: tests/goldens/make_chip_reference.py keeps it in CLI_REFERENCE."""
    torch.set_num_threads(REFERENCE_THREADS)
    with tempfile.TemporaryDirectory() as tmp:
        rc, _, hist = cli_run(CLI_ARGV + ["-x64"], pathlib.Path(tmp))
    check(rc == 0 and len(hist) == 1, "the CPU run of CLI_ARGV accepts a step")
    r = hist[0]
    return dict({k: np.array(r[k]) for k in ("drag", "drag_diff", "attempts", "admm_iters", "newton_iters",
                                              "lin_iters", "sigma", "scaling")},
                threads=np.array(REFERENCE_THREADS))


def cli_phase(launches, by_lattice):
    """python -m admm_optim_tpu_torch.cli CLI_ARGV on the card, in this
    process so that the launch counts (set to 0 just before) can be read:
    its files, and the step against the -x64 CPU run kept in CLI_REFERENCE
    (the same accepting attempt, the drags within STEP_DRAG_SHARE of the
    CPU step's decrease)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        sk.reset_launches()
        t0 = time.perf_counter()
        rc, text, hist = cli_run(CLI_ARGV, out)
        launches["cli"] = read_launches("cli", by_lattice)
        seconds = time.perf_counter() - t0
        drag = [line.split("\t") for line in (out / "__Drag.txt").read_text().strip().splitlines()]
        its = [line.split("\t") for line in (out / "__Iterations_per_step.txt").read_text().strip().splitlines()]
        files = sorted(p.name for p in out.iterdir())
        ck = load_checkpoint(str(out / "checkpoint.npz"))
        log(f"[cli] {' '.join(CLI_ARGV)}: exit {rc}, {seconds:.3f} s, launches {launches['cli']}; files {files}; "
            f"__Drag.txt {drag}; __Iterations_per_step.txt {its}; checkpoint at step {ck['step']}")
        check(rc == 0, "cli: exit code 0")
        check("DONE: 1 accepted steps" in text, "cli: DONE: 1 accepted steps")
        check(len(drag) == 1 and len(hist) == 1, "cli: __Drag.txt has one row")
        check(len(its) == 1 and len(its[0]) == 9, "cli: __Iterations_per_step.txt in the 3D layout of 9 columns")
        check(ck["step"] == 0, "cli: checkpoint.npz at step 0")
        check("__NewtonStats_step_0_.txt" in files, "cli: __NewtonStats_step_0_.txt written")
    g, c = hist[0], np.load(CLI_REFERENCE)
    gap = abs(g["drag"] - float(c["drag"]))
    log(f"[cli] card f32 vs CPU f64 ({CLI_REFERENCE.name}, {int(c['threads'])} threads): attempts {g['attempts']} vs "
        f"{int(c['attempts'])}, ADMM {g['admm_iters']} vs {int(c['admm_iters'])}, Newton {g['newton_iters']} vs "
        f"{int(c['newton_iters'])}, Krylov {g['lin_iters']} vs {int(c['lin_iters'])}, sigma {g['sigma']} vs "
        f"{float(c['sigma'])}, scaling {g['scaling']} vs {float(c['scaling'])}, drag {g['drag']:.10g} vs "
        f"{float(c['drag']):.10g}: {gap:.3e} apart, {gap / float(c['drag_diff']):.3e} of the CPU step's decrease "
        f"(limit {STEP_DRAG_SHARE:g})")
    check(g["attempts"] == int(c["attempts"]), "cli: card and CPU accept on the same attempt")
    check(gap <= STEP_DRAG_SHARE * float(c["drag_diff"]), "cli: the card's drag agrees with the CPU's")


def pcd_phase(ctx, launches, by_lattice, mass_rungs):
    """The PCD path at refs=2, float32: one PCD rung, the Newton solve at
    PCD_VISC from the mass ladder's converged state at PCD_FROM_VISC (alone,
    without the ns phase's ladder, the whole PCD ladder as ns_run.run with a
    target), then drag, adjoint and J' there; the launch counts are reset
    before each of its phases and read after.  Returns the last rung's
    linear iterations and ms per iteration outside assembly."""
    torch.cuda.reset_peak_memory_stats()
    log(
        f"[pcd] refs=2 n_state={ctx.n_state} velocity lattice {ctx.pre_ps.fine.lat_shape} x "
        f"{ctx.pre_ps.P}, pressure lattice {ctx.ps.fine.lat_shape} x {ctx.ps.P}, host set-up "
        f"{ctx.host_seconds:.2f} s, target visc {PCD_VISC}, accept_tol {ctx.cfg.accept_tol:g}"
    )
    start = [r.newton.s for r in mass_rungs if r.nu == PCD_FROM_VISC and r.newton.converged]
    if start:
        log(f"[pcd] one PCD rung to visc {PCD_VISC} from the mass ladder's visc {PCD_FROM_VISC} state")
    out = ns_run.run(ctx, target_visc=PCD_VISC, adjoint_iters=NS_ADJOINT_BUDGET, s0=start[-1] if start else None)
    ctx = ctx.at_visc(PCD_VISC)
    for phase, n in out.launches.items():
        log(f"[pcd] launches in the {phase} phase: {n}")
        log_lattices("pcd", out.launches_by_lattice[phase], phase)
    by_lattice["pcd"] = sum_lattices(out.launches_by_lattice)
    check(out.launches["newton"]["apply_w_full/c1"] > 0, "K5 at C = 1 launched in the Newton phase")
    check(out.launches["adjoint"]["apply_w_full_t/c1"] > 0, "K5^T at C = 1 launched in the adjoint phase")
    launches["pcd"] = path_launches("pcd", out.launches)
    lin, secs = report_rungs("pcd", out.rungs)
    inserted = [r.nu for r in out.rungs if r.inserted]
    log(f"[pcd] Newton: {out.seconds['newton']:.3f} s, {len(out.rungs)} rungs attempted, inserted {inserted}, "
        f"{lin:.0f} linear iterations, {1e3 * secs / max(lin, 1):.2f} ms each outside assembly; K5 launches per "
        f"linear iteration {out.launches['newton']['apply_w_full'] / max(lin, 1):.2f} at C = 3, "
        f"{out.launches['newton']['apply_w_full/c1'] / max(lin, 1):.2f} at C = 1")
    # PCD against the mass block, rung by rung, on the rungs both converged on
    mass = {r.nu: r for r in mass_rungs if r.newton.converged}
    for r in out.rungs:
        m = mass.get(r.nu)
        if m is None or not r.newton.converged:
            log(f"[pcd] rung nu={r.nu:.5g}: not converged by both blocks, no comparison")
            continue
        lp, lm = sum(r.newton.lin_iters), sum(m.newton.lin_iters)
        tp = r.seconds - sum(sum(a.values()) for a in r.assembly_seconds)
        tm = m.seconds - sum(sum(a.values()) for a in m.assembly_seconds)
        log(f"[pcd] rung nu={r.nu:.5g}: PCD {r.newton.iters} Newton, {lp} linear at {1e3 * tp / max(lp, 1):.2f} ms; "
            f"mass {m.newton.iters} Newton, {lm} linear at {1e3 * tm / max(lm, 1):.2f} ms (the ladder's, its "
            f"recycle space carried); PCD/mass linear iterations {lp / max(lm, 1):.3f}, ms per iteration "
            f"{(tp / max(lp, 1)) / (tm / max(lm, 1)):.3f}, seconds outside assembly {tp / tm:.3f}")
    nw, adj = out.newton, out.adjoint
    r64 = float64_residual(ctx, nw.s)
    log(f"[pcd] visc {PCD_VISC}: |R| history {[f'{v:.3e}' for v in nw.res_history]}, final |R| "
        f"{nw.res_norm:.3e} (float64 recheck {r64:.3e})")
    log(
        f"[pcd] adjoint at visc {PCD_VISC}, budget cut to {NS_ADJOINT_BUDGET} iterations: exit {adj.exit}, {adj.iters} iterations in {adj.cycles} cycles, "
        f"|r| {adj.res_norm:.3e}, target {adj.target:.3e}, {out.seconds['adjoint']:.3f} s "
        f"({1e3 * out.seconds['adjoint'] / max(adj.iters, 1):.2f} ms per iteration), K5^T launches per "
        f"iteration {out.launches['adjoint']['apply_w_full_t'] / max(adj.iters, 1):.2f} at C = 3, "
        f"{out.launches['adjoint']['apply_w_full_t/c1'] / max(adj.iters, 1):.2f} at C = 1"
    )
    log(
        f"[pcd] drag {out.drag:.10g} ({out.seconds['drag']:.4f} s), |J'| {out.jprime_norm:.6e} "
        f"({out.seconds['jprime']:.3f} s), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    check(out.rungs[-1].nu == PCD_VISC and nw.converged and nw.res_norm <= ctx.cfg.accept_tol,
          f"refs=2 PCD Newton converged at visc {PCD_VISC}")
    if not start:
        check(set(ns_run.continuation_ladder(PCD_VISC)) <= {r.nu for r in out.rungs if r.newton.converged},
              "every planned rung of the PCD ladder converged")
    check(r64 <= ctx.cfg.accept_tol, f"refs=2 PCD float64 |R| {r64:.3e} <= accept_tol")
    check_adjoint_and_gradient("refs=2 PCD", ctx, adj, out.drag, out.jprime, ("target", "stagnation", "budget"))
    ns_profile("pcd", ctx, nw.s)
    last = out.rungs[-1]
    lin_last = sum(last.newton.lin_iters)
    outside = last.seconds - sum(sum(a.values()) for a in last.assembly_seconds)
    return dict(nu=last.nu, lin=lin_last, ms=1e3 * outside / max(lin_last, 1))


def vel_inner_rung(ctx, s0, vel_inner, tag="pcd"):
    """The Newton solve at ctx.visc from the state s0 with vel_inner
    Richardson steps of the velocity V-cycle per preconditioner apply and
    no recycle space: (result, seconds, ms per linear iteration outside
    assembly)."""
    c = dataclasses.replace(ctx, vel_inner=vel_inner)
    sync()
    t0 = time.perf_counter()
    res, asm = ns_run.newton(c, s0, recycle={})
    sync()
    secs = time.perf_counter() - t0
    lin = sum(res.lin_iters)
    ms = 1e3 * (secs - sum(sum(a.values()) for a in asm)) / max(lin, 1)
    log(f"[{tag}] vel_inner {vel_inner}: the visc {c.visc:g} rung from the rung before it, no recycle space: "
        f"converged {res.converged}, {res.iters} Newton, linear {res.lin_iters} ({lin}), |R| {res.res_norm:.3e}, "
        f"{secs:.3f} s, {ms:.2f} ms per linear iteration outside assembly")
    return res, secs, ms


def rung_summary(res, asm, secs):
    """(linear iterations, ms per linear iteration outside assembly) of one
    Newton solve."""
    lin = sum(res.lin_iters)
    return lin, 1e3 * (secs - sum(sum(a.values()) for a in asm)) / max(lin, 1)


def timed_newton(ctx, s0, visc, X=None):
    """ns_run.newton from s0 with no recycle space: (result, assembly
    seconds, synchronized seconds)."""
    sync()
    t0 = time.perf_counter()
    res, asm = ns_run.newton(ctx, s0, visc=visc, recycle={}, X=X)
    sync()
    return res, asm, time.perf_counter() - t0


def timed_adjoint(ctx, s, budget):
    """ns_run.adjoint at s with its budget cut to about budget iterations:
    (result, seconds, peak device memory above what was held before, GiB)."""
    cut = dataclasses.replace(ctx, cfg=dataclasses.replace(ctx.cfg, lin_max_iters=budget // 4))
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adj = ns_run.adjoint(cut, s)
    sync()
    return adj, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**30


def matfree_checks(gctx, s, reps=5):
    """(a) on the global backend at the state s, visc STEP_VISC: the
    matrix-free J x (torch.func.jvp of ns_residual) and J^T x (one
    torch.func.vjp, re-applied) against the assembled ELL forms within
    1e-5 of max |y|, each apply's median ms; then one adjoint cut to
    VARIANT_ADJOINT_BUDGET iterations with each form (ms per iteration,
    peak memory), the matrix-free one at the module's NS_ELEM_CHUNK (all
    elements of refs=2 in one block; settled on the H100 against 16384)."""
    from admm_optim_tpu_torch.solvers import ns_solver

    X, visc = gctx.coords, STEP_VISC
    mf = dataclasses.replace(gctx, assembled=False)
    gen = torch.Generator(device="cuda").manual_seed(11)
    v = torch.randn(gctx.n_state, generator=gen, device="cuda", dtype=X.dtype)

    def R(ss):
        return nsops.ns_residual(gctx.space, X, ss, visc, gctx.stab)

    W = gctx.jac(X, s, visc)
    jv_a, jtv_a = gctx.jv(v, W), gctx.jtv(v, W)
    jv_m = torch.func.jvp(R, (s,), (v,))[1]
    Jt = ns_solver.residual_vjp(gctx.space, X, s, visc, gctx.stab)
    jtv_m = Jt(v)
    errs = {"J x": rel_diff(jv_m, jv_a), "J^T x": rel_diff(jtv_m, jtv_a)}
    for what, e in errs.items():
        log(f"[variants] (a) matrix-free {what} against the assembled ELL form: {e:.3e} of max |y| (limit 1e-5)")
        check(e <= 1e-5, f"(a) matrix-free {what} within 1e-5 of the assembled form")
    ms = {"assembled J x": call_ms(lambda: gctx.jv(v, W), reps),
          "assembled J^T x": call_ms(lambda: gctx.jtv(v, W), reps)}
    E = gctx.space.elems.shape[0]
    blocks = nsops._elem_chunks(E)[0]
    ms[f"jvp, {blocks} block(s)"] = call_ms(lambda: torch.func.jvp(R, (s,), (v,))[1], reps)
    ms[f"vjp apply, {blocks} block(s)"] = call_ms(lambda: Jt(v), reps)
    ms[f"residual, {blocks} block(s)"] = call_ms(lambda: R(s), reps)
    del Jt
    torch.cuda.empty_cache()
    # half the assembled adjoint's cut
    adjoints = {f"matrix-free, {blocks} block(s)": timed_adjoint(mf, s, VARIANT_ADJOINT_BUDGET // 2)}
    del W
    torch.cuda.empty_cache()
    adjoints["assembled"] = timed_adjoint(gctx, s, VARIANT_ADJOINT_BUDGET)
    log(f"[variants] (a) ms per apply, median of {reps} event intervals around one call on an idle card "
        f"(host time included), at 3D refs=2 (E = {E}): "
        + ", ".join(f"{k} {t:.3f}" for k, t in ms.items()))
    for label, (adj, secs, peak) in adjoints.items():
        log(f"[variants] (a) adjoint, {label}: {adj.iters} iterations ({adj.exit}), |r| {adj.res_norm:.3e}, "
            f"{secs:.3f} s, {1e3 * secs / max(adj.iters, 1):.2f} ms per iteration, peak {peak:.3f} GiB above the "
            f"memory held before")
        check(bool(torch.isfinite(adj.lam).all()), f"(a) adjoint {label}: finite")
    return adjoints["assembled"][0].lam


def variants_phase(gvars, mass_rungs, pcd_rec, launches, by_lattice):
    """The settings of ROADMAP item 9b at 3D refs=2, float32, f32_presets:
    (a) the matrix-free J x / J^T x and adjoint against the assembled ones
    on the global backend; (b) vorder=1 with stab VARIANT_STAB on the patch
    backend, a Newton solve at NS_VISC (K5 and K5^T on the level-k lattice);
    (c) b2nd_order, one global step from the 0.02 state beside the
    first-order global step; (d) PCD on the global backend, one rung
    PCD_FROM_VISC -> PCD_VISC, twice; (e) the NS residual's fixed-order
    sums: two calls bitwise equal, the global NS re-solve twice with equal
    counts, J' twice.  gvars is what global_phase returned (its problem,
    step record and start state); without it, and without the ns phase's
    ladder, the phase builds its own and climbs its own ladder."""
    from admm_optim_tpu_torch.solvers import ns_solver

    t_phase = time.perf_counter()
    if gvars is None:
        gprob = ObstacleShapeOpt(dataclasses.replace(step_config(2, STEP_VISC), backend="global"))
        grec = None
    else:
        gprob, grec = gvars["prob"], gvars["record"]
    gctx = gprob.ns.at_visc(STEP_VISC)
    X = gprob.X0
    states = {r.nu: r.newton.s for r in mass_rungs if r.newton.converged}
    if not {NS_VISC, PCD_FROM_VISC, STEP_VISC} <= set(states):
        lad = ns_run.solve_ladder(gctx)
        report_rungs("variants", lad.rungs)
        states = {r.nu: r.newton.s for r in lad.rungs if r.newton.converged}
        log("[variants] the ns phase did not run: the global mass ladder above is this phase's own")
    s16, s04, s02 = states[NS_VISC], states[PCD_FROM_VISC], states[STEP_VISC]
    log(f"[variants] refs=2 n_state={gctx.n_state}, global backend, ELL Jacobian {gctx.jac_bytes / 1e6:.1f} MB "
        f"(ns_jac_mem_cap {gprob.cfg.ns_jac_mem_cap:.3g}), states from the mass ladder at {NS_VISC}, "
        f"{PCD_FROM_VISC}, {STEP_VISC}")

    # (e) first: two identical residual calls
    r1 = nsops.ns_residual(gctx.space, X, s02, STEP_VISC)
    r2 = nsops.ns_residual(gctx.space, X, s02, STEP_VISC)
    pm1, pm2 = (nsops.pressure_mass_lumped(gctx.space, X, STEP_VISC) for _ in range(2))
    log(f"[variants] (e) two identical ns_residual calls bitwise equal: {torch.equal(r1, r2)}; "
        f"pressure_mass_lumped: {torch.equal(pm1, pm2)}")
    check(torch.equal(r1, r2) and torch.equal(pm1, pm2), "(e) ns_residual and pressure_mass_lumped repeat bit for bit")
    del r1, r2

    # (a) matrix-free against assembled
    sk.reset_launches()
    lam02 = matfree_checks(gctx, s02)
    check(sum(sk.launches.values()) == 0, "(a) the global matrix-free operators launched no hand-written kernel")

    # (b) vorder=1 on the patch backend: K5 and K5^T on the level-k lattice
    t0 = time.perf_counter()
    ctx1 = ns_run.build(device="cuda", visc=NS_VISC, hier=gprob.hier, vorder=1, stab=VARIANT_STAB)
    setup1 = time.perf_counter() - t0
    lat = {}
    (res1, asm1), secs1, n_newton = counted(lambda: ns_run.newton(ctx1, recycle={}), lat)
    lat_newton = dict(lat)
    lat = {}
    cut1 = dataclasses.replace(ctx1, cfg=dataclasses.replace(ctx1.cfg, lin_max_iters=VARIANT_ADJOINT_BUDGET // 8))
    adj1, secs_adj1, n_adj = counted(lambda: ns_run.adjoint(cut1, res1.s), lat)
    by_lattice["variants"] = sum_lattices({"newton": lat_newton, "adjoint": lat})
    launches["variants"] = path_launches("variants", {"newton": n_newton, "adjoint": n_adj})
    log_lattices("variants", lat_newton, "vorder=1 Newton")
    log_lattices("variants", lat, "vorder=1 adjoint")
    r64 = float64_residual(ctx1, res1.s)
    drag1 = float(nsops.drag(ctx1.space, X, res1.s, NS_VISC))
    drag2 = float(nsops.drag(gctx.space, X, s16, NS_VISC))
    lin1, ms1 = rung_summary(res1, asm1, secs1)
    log(f"[variants] (b) vorder=1, stab {VARIANT_STAB}, patch backend, velocity lattice "
        f"{ctx1.pre_ps.fine.lat_shape} x {ctx1.pre_ps.P} (set-up {setup1:.2f} s), n_state {ctx1.n_state}: Newton "
        f"at visc {NS_VISC} from the cold start: converged {res1.converged}, {res1.iters} Newton, linear "
        f"{res1.lin_iters} ({lin1}) at {ms1:.2f} ms outside assembly, |R| {res1.res_norm:.3e} (float64 recheck "
        f"{r64:.3e}), {secs1:.3f} s; drag {drag1:.10g} against the P2 drag {drag2:.10g} "
        f"({(drag1 - drag2) / drag2:+.3e}, limit {P1_DRAG_SHARE:g}); adjoint cut to {VARIANT_ADJOINT_BUDGET // 2} "
        f"iterations: {adj1.iters} ({adj1.exit}) in {secs_adj1:.3f} s; launches Newton {n_newton}, adjoint {n_adj}")
    check(res1.converged and r64 <= ctx1.cfg.accept_tol, f"(b) vorder=1 Newton converged, float64 |R| {r64:.3e}")
    check(abs(drag1 - drag2) <= P1_DRAG_SHARE * drag2, "(b) the P1/P1 drag within 25% of the P2 drag")
    del ctx1, res1, adj1
    torch.cuda.empty_cache()

    # (c) b2nd_order: one global step from the 0.02 state
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(step_config(2, STEP_VISC), backend="global", b2nd_order=True, high_order_scaling=1.0)
    prob2 = ObstacleShapeOpt(cfg2)
    sync()
    setup2 = time.perf_counter() - t0
    resume = dict(X=prob2.X0, s=s02, sigma=cfg2.sigma_threshold, step=-1,
                  drag_old=float(nsops.drag(prob2.ns.space, prob2.X0, s02, STEP_VISC)))
    torch.cuda.reset_peak_memory_stats()
    sync()
    sk.reset_launches()
    t0 = time.perf_counter()
    hist2 = prob2.run(num_steps=1, resume=resume, profiler=Profiler())
    sync()
    secs2 = time.perf_counter() - t0
    check(sum(sk.launches.values()) == 0, "(c) the b2nd_order global step launched no hand-written kernel")
    log_step("variants b2nd", prob2, hist2)
    check(len(hist2) == 1, "(c) refs=2 b2nd_order step accepted")
    log2 = prob2.step_log[-1]
    b = step_record(prob2, hist2[0], log2, setup2, secs2)
    step_gates("(c) refs=2 b2nd_order step", prob2, hist2[0], prob2.drag_init, log2)
    if grec is not None:
        log("[variants] (c) b2nd_order / first-order global step from the same state: attempts "
            f"{b['attempts']} / {grec['attempts']}, ADMM {b['admm']} / {grec['admm']}, Newton {b['newton']} / "
            f"{grec['newton']}, Krylov {b['krylov']} / {grec['krylov']}, drag decrease {b['drag_diff']:.6e} / "
            f"{grec['drag_diff']:.6e}; seconds per phase "
            + ", ".join(f"{k} {b['seconds'].get(k, 0.0):.3f} / {grec['seconds'].get(k, 0.0):.3f}" for k in grec["seconds"])
            + f"; wall {b['wall']:.3f} / {grec['wall']:.3f} s; peak {b['peak_gib']:.2f} / {grec['peak_gib']:.2f} GiB")
    else:
        log(f"[variants] (c) b2nd_order step: {b}; the global phase did not run, no first-order record beside it")
    del prob2, hist2
    torch.cuda.empty_cache()

    # (d) PCD on the global backend, one rung from the 0.04 state, twice
    p_space, p_struct = ns_solver.ns_pcd_spaces(gprob.hier)
    pctx = dataclasses.replace(gctx, pressure_precond="pcd", p_space=p_space, pcd_struct=p_struct)
    runs = [timed_newton(pctx, s04, PCD_VISC) for _ in range(2)]
    mass = timed_newton(gctx, s04, PCD_VISC)
    for i, (res, asm, secs) in enumerate(runs):
        lin, ms = rung_summary(res, asm, secs)
        log(f"[variants] (d) global PCD rung {PCD_FROM_VISC} -> {PCD_VISC}, call {i + 1}: converged {res.converged}, "
            f"{res.iters} Newton, linear {res.lin_iters} ({lin}) at {ms:.2f} ms outside assembly, |R| "
            f"{res.res_norm:.3e}, {secs:.3f} s, PCD data {sum(a.get('pcd', 0.0) for a in asm):.3f} s")
    lin_m, ms_m = rung_summary(*mass)
    log(f"[variants] (d) global mass rung from the same state: converged {mass[0].converged}, linear "
        f"{mass[0].lin_iters} ({lin_m}) at {ms_m:.2f} ms" + (
            f"; patch PCD rung (pcd phase): {pcd_rec['lin']} at {pcd_rec['ms']:.2f} ms" if pcd_rec else
            "; the pcd phase did not run"))
    check(all(r[0].converged for r in runs), "(d) the global PCD rung converged")
    check(runs[0][0].lin_iters == runs[1][0].lin_iters and runs[0][0].iters == runs[1][0].iters,
          "(d) the global PCD rung's counts repeat on a second call")
    del pctx, runs, mass
    torch.cuda.empty_cache()

    # (e) the global NS re-solve twice, J' twice
    X_new = gprob.X_final if gvars is not None else X
    s_from = gvars["ladder_s"] if gvars is not None and gvars["ladder_s"] is not None else s02
    re = [timed_newton(gctx, s_from, STEP_VISC, X=X_new) for _ in range(2)]
    same = re[0][0].lin_iters == re[1][0].lin_iters and re[0][0].iters == re[1][0].iters
    log(f"[variants] (e) the global NS re-solve on the {'step' if gvars is not None else 'undeformed'} mesh, twice: "
        f"linear {re[0][0].lin_iters} / {re[1][0].lin_iters}, |R| {re[0][0].res_norm:.3e} / {re[1][0].res_norm:.3e}, "
        f"states bitwise equal {torch.equal(re[0][0].s, re[1][0].s)}")
    check(same, "(e) the global NS re-solve repeats its counts")
    jp1, jp2 = (ns_run.jprime(gctx, s02, lam02) for _ in range(2))
    log(f"[variants] (e) J' twice at the 0.02 state: bitwise equal {torch.equal(jp1, jp2)}, max |diff| / max |J'| "
        f"{rel_diff(jp1, jp2):.3e} (its backward scatters the element gathers)")
    log(f"[variants] phase {time.perf_counter() - t_phase:.1f} s")
    del gprob, gctx, re
    torch.cuda.empty_cache()


def small_reference():
    """The refs=1 PCD ladder to SMALL_VISC with drag, adjoint and J', in
    float64 on the CPU with the float32 presets and REFERENCE_THREADS
    threads: what pcd_small holds the card's float32 run to, as numpy
    arrays.  tests/goldens/make_chip_reference.py runs it once (minutes on
    the CPU) and keeps it in SMALL_REFERENCE."""
    torch.set_num_threads(REFERENCE_THREADS)
    cfg = ns_run.f32_presets(NewtonConfig())
    ctx = ns_run.build(1, "cpu", torch.float64, visc=SMALL_VISC, cfg=cfg, pressure_precond="pcd")
    out = ns_run.run(ctx, target_visc=SMALL_VISC)
    rungs = small_summary(out)["rungs"]
    return dict(
        nu=np.array([r[0] for r in rungs]), converged=np.array([r[1] for r in rungs]),
        newton=np.array([r[2] for r in rungs]), lin=np.concatenate([r[3] for r in rungs]),
        lin_len=np.array([len(r[3]) for r in rungs]), res=np.array([r[4] for r in rungs]),
        drag=np.array(out.drag), adjoint_iters=np.array(out.adjoint.iters),
        adjoint_exit=np.array(out.adjoint.exit), jprime_norm=np.array(out.jprime_norm),
        jprime=out.jprime.numpy(), threads=np.array(REFERENCE_THREADS),
    )


def load_small_reference():
    """SMALL_REFERENCE as small_summary's dict, with J' as a numpy array."""
    z = np.load(SMALL_REFERENCE)
    lin = np.split(z["lin"], np.cumsum(z["lin_len"])[:-1])
    rungs = [(float(nu), bool(c), int(n), [int(v) for v in li], float(r))
             for nu, c, n, li, r in zip(z["nu"], z["converged"], z["newton"], lin, z["res"])]
    return dict(rungs=rungs, drag=float(z["drag"]), adjoint=(int(z["adjoint_iters"]), str(z["adjoint_exit"])),
                jprime_norm=float(z["jprime_norm"]), jprime=z["jprime"], threads=int(z["threads"]))


def small_summary(out):
    return dict(
        rungs=[(r.nu, r.newton.converged, r.newton.iters, list(r.newton.lin_iters), r.newton.res_norm)
               for r in out.rungs],
        drag=out.drag, adjoint=(out.adjoint.iters, out.adjoint.exit), jprime_norm=out.jprime_norm,
    )


def pcd_small():
    """refs=1 PCD ladder to SMALL_VISC with drag, adjoint and J', card
    float32 against the port's CPU float64 run kept in SMALL_REFERENCE,
    both with the float32 presets.  The Newton |R| history
    amplifies rounding (tests/test_torch_ns_slice_newton.py) and |R| lands
    near accept_tol, so which iteration first accepts, and with it the state
    the next rung starts from, differs with the last bits: two float64 CPU
    runs of the ladder to visc 0.02 with other thread counts gave Newton 5
    and 4 on the first rung, first linear counts 416 and 366 on the last,
    rung totals up to 22% apart (564 and 464 at visc 0.04), and drags 1.0e-6
    apart; the float32 CPU run lay
    2.5e-7 (drag) and 5.0e-6 of max|J'| (J') from the second.  At visc 0.16
    with the mass block float32 alone moved them 2.0e-5 and 2.6e-5.  Held:
    the same rungs converge on both, the first linear count from the cold
    start is equal, every rung's linear total is within 50%, and drag and
    J' agree within DRAG_TOL and JPRIME_TOL, ten times the largest
    differences seen."""
    cfg = ns_run.f32_presets(NewtonConfig())
    t0 = time.perf_counter()
    out = ns_run.run(ns_run.build(1, dtype=torch.float32, visc=SMALL_VISC, cfg=cfg, pressure_precond="pcd"),
                     target_visc=SMALL_VISC)
    g = small_summary(out)
    log(f"[small] refs=1 PCD ladder on the card, float32: {time.perf_counter() - t0:.1f} s")
    c = load_small_reference()
    log(f"[small] CPU float64 reference: {SMALL_REFERENCE.name}, {c['threads']} threads")
    for (nu, gc, gi, gl, gr), (nu_c, cc, ci, cl, cr) in zip(g["rungs"], c["rungs"]):
        log(f"[small] rung nu={nu:.5g} GPU f32 vs nu={nu_c:.5g} CPU f64: converged {gc} vs {cc}, Newton {gi} vs {ci}, "
            f"linear {gl} vs {cl}, |R| {gr:.3e} vs {cr:.3e}")
    ddrag = abs(g["drag"] - c["drag"]) / abs(c["drag"])
    djp = float(np.abs(out.jprime.double().cpu().numpy() - c["jprime"]).max() / np.abs(c["jprime"]).max())
    log(f"[small] refs=1 PCD at visc {SMALL_VISC} GPU f32 vs CPU f64: adjoint {g['adjoint']} vs {c['adjoint']}, "
        f"drag {g['drag']:.10g} vs {c['drag']:.10g} (rel diff {ddrag:.3e}, limit {DRAG_TOL:g}), |J'| "
        f"{g['jprime_norm']:.6e} vs {c['jprime_norm']:.6e}, J' rel max diff {djp:.3e} (limit {JPRIME_TOL:g})")
    check([r[:2] for r in g["rungs"]] == [r[:2] for r in c["rungs"]] and all(r[1] for r in g["rungs"]),
          "refs=1 PCD ladder: the same rungs, all converged, on both")
    check(g["rungs"][0][3][0] == c["rungs"][0][3][0], "refs=1 PCD ladder: first linear count from the cold start equal")
    check(all(abs(sum(a[3]) - sum(b[3])) <= 0.5 * sum(b[3]) for a, b in zip(g["rungs"], c["rungs"])),
          "refs=1 PCD ladder: linear iterations per rung within 50%")
    check(ddrag <= DRAG_TOL and djp <= JPRIME_TOL, "refs=1 GPU drag and J' agree with the f64 CPU run")


def lattice_name(lattice):
    n0, n1, n2, P = lattice
    return f"{n0}^3x{P}" if n0 == n1 == n2 else f"{n0}x{n1}x{n2}x{P}"


def kernel_table(phases, floor_ms, launches, by_lattice):
    """The entries of the kernels line: per kernel its times at the main
    path's fine shape (and at 17^3 x 224 where that is another, and at the
    shapes of BY_SHAPE), its bound, the launch floor and its launches per
    path, and per path and lattice.  library_ms is null for every kernel:
    no single PyTorch call computes a per-site variable stencil."""
    kernels = []
    for name, replaces in REPLACES.items():
        shape = JSON_SHAPE[name]
        t = phases[shape][name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sum(n.get(name, 0) for n in launches.values()),
            "launches_by_path": {path: n[name] for path, n in launches.items() if name in n},
            "launches_by_lattice": {
                path: {lattice_name(lat): c for (nm, lat), c in n.items() if nm == name}
                for path, n in by_lattice.items() if any(nm == name for nm, _ in n)
            },
            "max_abs_err": t["max_abs_err"], "rel_err": t["rel_err"], "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "floor_ms": floor_ms, "library_ms": None, "shape": shape,
        }
        if name in ("apply_w_sym/lanes", "apply_w_pencil_batched"):
            entry["lanes"] = LANES
            for B in LANE_COUNTS:
                if B != LANES:
                    ln = phases[shape][f"{name} B={B}"]
                    entry[f"lanes_{B}"] = {k: ln[k] for k in ("max_abs_err", "ms", "call_ms", "bound_ms")}
        if name == "apply_w_pencil_batched":
            entry["k2_x_lanes_ms"] = t["extra_ms"]
        entry.update({k: v for k, v in t.items() if k in ("clean_ms", "warm_ms", "bounds_ms")})
        if shape != "17^3x224":
            f = phases["17^3x224"][name]
            entry.update(ms_17=f["ms"], call_ms_17=f["call_ms"], plain_ms_17=f["plain_ms"],
                         bound_ms_17=f["bound_ms"], max_abs_err_17=f["max_abs_err"])
        entry["by_shape"] = {  # no nan: the times not taken at a shape are left out
            label: {k: v for k, v in phases[label][name].items() if k != "extra_ms" and v == v}
            for label in BY_SHAPE.get(name, ()) if label in phases
        }
        kernels.append(entry)
    return kernels


def main(phases_run=PHASES):
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # the refs=5 hierarchy's host work, in a child process from the start;
    # every child process is stopped however the run ends
    children = []
    if "sizes" in phases_run:
        children.append(HostHierarchy(max(SIZES)))
    try:
        run_phases(kind, phases_run, children)
    finally:
        for child in children:
            child.close()


_T0 = time.perf_counter()


def phase_done(name):
    log(f"[phase] {name} done, {time.perf_counter() - _T0:.1f} s since the start")


def run_phases(kind, phases_run, children):
    host = children[0] if children else None

    # 2. build
    t0 = time.perf_counter()
    nvcc_s, nvcc_log = _build.build()
    _build.lib()
    log(f"[build] {SOURCE} -> {_build.LIBRARY.name}: nvcc {nvcc_s:.2f} s, total {time.perf_counter() - t0:.2f} s")
    report = ptxas_report(nvcc_log)
    for kernel, used in report:
        if kernel.startswith(PENCIL_KERNEL):
            used += f"; {blocks_per_sm(used, PENCIL_THREADS)} blocks of {PENCIL_THREADS} threads per SM"
        log(f"[build] {kernel}: {used}")
    for kernel, used in report:
        check(not kernel.startswith(PENCIL_KERNEL) or "0 bytes spill stores, 0 bytes spill loads" in used,
              f"{kernel} does not spill")

    # 3. kernels vs twins; the limits are relative to max |y|: float32 sums
    # of 15 or 45 products in another order than the twin's (~1e-7), and
    # K4's f64 sums against a float64 apply
    ps_k = stencil_patchset()
    # (the shapes of the kernels line's entries are also timed with the L2
    # emptied of clean lines and left warm)
    phases = {
        "17^3x224": kernel_phase(ps_k, FINE_SHAPE, seed=1, timed=True, l2=True),
        "9^3x224": kernel_phase(ps_k, NS_SHAPE, seed=3, timed=True, l2=True),
        "5^3x224": kernel_phase(ps_k, PCD_SHAPE, seed=4, timed=True, groups=COARSE_GROUPS, l2=True,
                                lane_counts=(LANES,)),
        "3^3x224": kernel_phase(ps_k, PCD_COARSE_SHAPE, seed=5, timed=True, groups=COARSE_GROUPS,
                                lane_counts=(LANES,)),
        "5^3x222": kernel_phase(ps_k, ODD_P_SHAPE, seed=6, timed=True, groups=("full", "df") + PENCIL_GROUPS),
        "3^3x5": kernel_phase(ps_k, SMALL_SHAPE, seed=2, timed=PENCIL_GROUPS + ("df",)),
        # the shard phase's blocks: K1, K2, K4 of the refs=4 solve, K1 on
        # the refs=2 ADMM's lanes
        "17^3x112": kernel_phase(ps_k, SHARD_FINE_SHAPE, seed=7, timed=True, groups=("sym", "pencil", "df")),
        "9^3x112": kernel_phase(ps_k, SHARD_NS_SHAPE, seed=8, timed=True, groups=("sym", "pencil", "df")),
        "5^3x112": kernel_phase(ps_k, SHARD_ADMM_SHAPE, seed=9, timed=True, groups=("lanes",)),
    }
    floor_ms = median_ms(lambda: sk.launch_empty("cuda"))
    _flush.clear()
    log(f"[kernel] launch floor: an empty kernel takes {floor_ms:.4f} ms of device time (the same median, L2 emptied; "
        f"{warm_ms(lambda: sk.launch_empty('cuda')):.4f} ms with L2 left warm)")
    for label, res in phases.items():
        for sfx, C in (("", 3), ("/c1", 1)):
            if "apply_w_full" + sfx not in res:  # K5/K5^T not run at this shape (the shard blocks)
                continue
            adj = res.pop("adjointness" + sfx)
            log(f"[kernel] K5/K5^T adjointness C = {C} {label:9s} |<Ax,y> - <x,A^T y>| / max {adj:.3e} (limit 1e-5)")
            check(adj <= 1e-5, f"K5/K5^T adjointness at C = {C}, {label}: {adj:.3e}")
        for name, t in res.items():
            log_kernel("kernel", name, label, t, floor_ms)
    phase_done("kernels")
    if phases_run == ("kernels",):
        print(json.dumps({"kernels": kernel_table(phases, floor_ms, {}, {})}))
        print(nvidia_smi())
        log("[kernel] --phase kernels: the paths were not driven, so this run proves nothing about them")
        return
    launches, by_lattice = {}, {}

    # 4-5. the solve path and the ADMM path on one refs=4 context
    ctx = None
    if "slice" in phases_run:
        ctx = solve_phase(launches, by_lattice)
    if "admm" in phases_run:
        admm_phase(ctx, launches, by_lattice)
    phase_done("slice, admm")

    # 6. the multi-device layer: two gloo ranks on the card against it
    if "shard" in phases_run:
        shard_phase(ctx, launches, by_lattice)
        phase_done("shard")
    levels = None if ctx is None else ctx.hier.levels
    del ctx
    torch.cuda.empty_cache()

    # 12-13. the refs=1 phases held against float64 CPU runs (small, cli),
    # in a side process beside the phases from here on
    side = None
    if set(SIDE_PHASES) & set(phases_run):
        side = SidePhases(tuple(n for n in SIDE_PHASES if n in phases_run))
        children.append(side)

    # 7. the NS path at refs=2 with the mass block: the ladder, then drag,
    # adjoint and J' at visc 0.16; the PCD context's tables serve both
    ctx_pcd = ns_run.build(2, visc=PCD_VISC, pressure_precond="pcd") if {"ns", "pcd"} & set(phases_run) else None
    mass_rungs = ns_phase(ctx_pcd, launches, by_lattice) if "ns" in phases_run else []
    phase_done("ns")
    torch.cuda.empty_cache()


    # 8. the optimization step at refs=2, from the mass ladder's state at STEP_VISC
    at = [r.newton.s for r in mass_rungs if r.nu == STEP_VISC and r.newton.converged]
    patch0 = None
    if "step" in phases_run:
        patch0 = step_phase(launches, by_lattice, at[-1] if at else None)
        torch.cuda.empty_cache()
        phase_done("step")

    # 9. the global (block-ELL) backend: one step from the same state, the sweeps
    gvars = None
    if "global" in phases_run:
        ctx_mass = None if ctx_pcd is None else dataclasses.replace(
            ctx_pcd, pressure_precond="mass", pcd_tabs=None, pcd_struct=None)
        gvars = global_phase(ctx_mass, launches, by_lattice, at[-1] if at else None, patch0)
        del ctx_mass
        torch.cuda.empty_cache()
        phase_done("global")
    del at

    # 10. the PCD path at refs=2: one rung to visc 0.02, drag, adjoint, J'
    pcd_rec = None
    if "pcd" in phases_run:
        pcd_rec = pcd_phase(ctx_pcd, launches, by_lattice, mass_rungs)
        phase_done("pcd")
    del ctx_pcd
    torch.cuda.empty_cache()

    # 11. ROADMAP item 9b: matrix-free, vorder=1, b2nd_order, global PCD, the repair
    if "variants" in phases_run:
        variants_phase(gvars, mass_rungs, pcd_rec, launches, by_lattice)
        phase_done("variants")
    del gvars, mass_rungs
    torch.cuda.empty_cache()

    # 12-13. small-input agreement (GPU float32 against the port's float64
    # CPU runs) and the CLI at 3D refs=1: the side process's results
    if side is not None:
        out = side.result(SIDE_WAIT_S)
        launches.update(out["launches"])
        by_lattice.update(out["by_lattice"])
        phase_done(", ".join(side.names))

    # 14. bench.py's largest and smallest sizes, refs=5 and refs=3, with the
    # refs=4 context's device tensors released (bench.py:475); last, so
    # that the host child has long made the refs=5 hierarchy and nothing
    # runs after the phase's 7 GiB and its profiled solve
    if "sizes" in phases_run:
        gc.collect()  # the earlier phases' contexts, held in reference cycles
        torch.cuda.empty_cache()
        sizes_phase(levels, host, launches, by_lattice, floor_ms, phases)
        phase_done("sizes")
    del levels

    print(json.dumps({"kernels": kernel_table(phases, floor_ms, launches, by_lattice)}))
    print(nvidia_smi())
    if phases_run != PHASES:
        log(f"[phase] ran {', '.join(phases_run)} of {', '.join(PHASES)}: no ok line")
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


def solve_phase(launches, by_lattice):
    """xupdate_solve.build(4) + solve on the card, counts from 0; returns
    the refs=4 context."""
    sk.reset_launches()
    ctx = xupdate_solve.build(4, "cuda", torch.float32)
    b = xupdate_solve.random_rhs(ctx, seed=0)
    res = xupdate_solve.solve(ctx, b)
    launches["solve"] = read_launches("solve", by_lattice)
    log(
        f"[slice] refs=4 dofs={ctx.n_dofs} P={ctx.ps.P} lat={ctx.ps.fine.lat_shape}: "
        f"host setup {ctx.host_seconds:.2f} s, assembly {ctx.assembly_seconds:.2f} s, "
        f"inner CG iterations {res.inner_iters}, IR rounds {res.rounds}, "
        f"res_norm {float(res.res_norm):.3e}, converged {res.converged}, launches {launches['solve']} "
        f"(recorded before: {SOLVE_COUNTS[0]} CG iterations, {SOLVE_COUNTS[1]} IR rounds)"
    )
    solve_checks("slice", "refs=4", ctx, b, res)
    warm_solves("slice", ctx, b)
    log(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del res, b
    return ctx


def solve_checks(tag, what, ctx, b, res):
    """The checks of an IR solve res of ctx's system A x = b: converged,
    every PatchMGData tensor on the card, the bf16 smoother stream built,
    x finite and of b's shape, and the true relative residual <= 1e-8,
    rechecked in float64 with the plain apply."""
    check(res.converged, f"{what} cg_ir_p converged")
    data = ctx.data
    tensors = data.W + data.inv_diag + data.lmax + [data.base_inv] + [
        w.a for w in (data.W_sm or []) if w is not None
    ]
    check(all(t.is_cuda for t in tensors), f"{what}: every PatchMGData tensor on cuda")
    check(data.W_sm is not None, f"{what}: bf16 pencil smoother stream built")
    x = res.x_hi + res.x_lo
    check(x.shape == b.shape and bool(torch.isfinite(x).all()), f"{what}: finite solution of the right shape")
    true_rel = true_rel_residual(ctx, b, res.x_hi.double() + res.x_lo.double())
    log(f"[{tag}] {what} true relative residual (f64 check) {true_rel:.3e}")
    check(true_rel <= 1e-8, f"{what} true relative residual {true_rel:.3e} <= 1e-8")


def warm_solves(tag, ctx, b):
    """Three warm solves of ctx's system, each converged: logs ms/solve
    (median and each), DoF/s and the V-cycle cost table; returns the
    seconds of each."""
    times, iters = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = xupdate_solve.solve(ctx, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        iters.append(r.inner_iters)
        check(r.converged, "warm solve converged")
    ms = statistics.median(times) * 1e3
    log(
        f"[{tag}] {ms:.2f} ms/solve (median of {len(times)} warm solves: "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)}; inner iterations {iters}), "
        f"{ctx.n_dofs / (ms / 1e3):.4e} DoF/s"
    )
    log(f"[{tag}] V-cycle cost table at the H100 SXM's published {H100_SXM_GBPS:.0f} GB/s:")
    log(xupdate_solve.patch_mg.vcycle_cost_table(ctx.struct, ctx.data, H100_SXM_GBPS))
    return times


def admm_phase(ctx, launches, by_lattice):
    """admm_run.run on the resident refs=4 stencils, counts from 0; a
    second run from the same inputs is timed warm."""
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    run = admm_run.run(ctx)
    launches["admm"] = read_launches("admm", by_lattice)
    st = run.state
    check(bool(torch.isfinite(st.u).all()) and bool(torch.isfinite(st.Lambda).all()),
          "refs=4 ADMM: finite u and Lambda")
    check(st.admm_it >= 1 and float(st.u.abs().max()) > 0.0, "refs=4 ADMM: the iterate moved")
    warm = admm_run.run(ctx)
    for label, r_ in (("first", run), ("warm", warm)):
        s_ = r_.state
        log(
            f"[admm] refs=4 {label}: admm_it {s_.admm_it} total_newton {s_.total_newton} "
            f"total_lin_iters {s_.total_lin_iters} solver_iters {s_.solver_iters} "
            f"converged {s_.converged} failed {s_.failed}; {r_.seconds:.3f} s, "
            f"{s_.admm_it / r_.seconds:.4f} ADMM it/s, Lambda {[round(float(v), 6) for v in s_.Lambda]} "
            f"(recorded before: admm_it {ADMM_COUNTS[0]}, {ADMM_COUNTS[1]} Newton, {ADMM_COUNTS[2]} Krylov)"
        )
    log(
        f"[admm] launches {launches['admm']}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )


def shard_rank(rank, world, device, ps, lvl0, coords, b, x_add, xh, xl, deep):
    """The shard phase on one rank of a world-rank space axis on the card:
    (a) the exchange and the double-float exchange of the seeded fields,
    (b) the refs=4 IR solve with the slice phase's settings from its block
    of the fine lattice, its launches counted from 0, (d) the same solve
    again, (c) the refs=2 ADMM of graft_entry_torch's deep phase.  Fields
    gathered whole (numpy, rank 0's), seconds and launches per rank."""
    mesh = make_mesh(world, 1, device)
    sh = build_sharded_mg(ps, mesh, data_dtype=torch.float32, **xupdate_solve.BENCH_SMOOTHING)
    out = {}

    def whole(t):
        return sh.gather_field(t).cpu().numpy()

    t0 = time.perf_counter()
    tabs = sh.make_tables()
    tab = tabs[-1]
    y = st.exchange_sum(None, sh.shard_field(x_add), tab, spmd=sh.spmd)
    yh, yl = st.exchange_sum_df(tab, sh.shard_field(xh), sh.shard_field(xl), spmd=sh.spmd)
    out["exchange"], out["df"] = whole(y), (whole(yh), whole(yl))
    coords_p = sh.to_patch_sharded(coords.T, torch.float32)
    data = sh.assemble(coords_p, lvl0, tabs=tabs)
    sync()
    out["setup_s"] = time.perf_counter() - t0
    bl = sh.shard_field(b)
    out["solves"] = []
    for i in range(2):
        sk.reset_launches()
        t0 = time.perf_counter()
        res = sh.solve_ir(data, bl, **xupdate_solve.SOLVE_SETTINGS)
        sync()
        secs = time.perf_counter() - t0
        if i == 0:
            out["solve_launches"] = dict(sk.launches_by_lattice)
        out["solves"].append(dict(rounds=res.rounds, inner_iters=res.inner_iters, res_norm=float(res.res_norm),
                                  converged=res.converged, seconds=secs, x_hi=whole(res.x_hi), x_lo=whole(res.x_lo)))
    del data, tabs
    t0 = time.perf_counter()
    out["deep"] = graft_entry_torch.deep_rank(rank, world, device, deep, admm_only=True)
    out["deep_s"] = time.perf_counter() - t0
    out["sent_bytes"] = sh.spmd.sent_bytes
    return out


def deep_single(deep, device):
    """graft_entry_torch's deep-phase ADMM on one device: the same operator
    (the ranks' default smoothing, c_eps = c_grad = c_mass = 1) on the
    whole refs=2 lattice."""
    cfg = graft_entry_torch.ADMM_DEEP
    ps, dt = deep.ps, torch.float32
    struct = patch_mg.PatchMGStructure(ps)
    coords_p = st.to_patch(ps.fine, torch.as_tensor(deep.coords.T, dtype=dt, device=device))
    data = xupdate_solve.assemble_deformation_p(ps, struct, deep.lvl0, coords_p,
                                                patch_mg.make_level_tables(ps, dt, device), cfg)
    Jp = st.to_patch(ps.fine, torch.as_tensor(deep.Jp, dtype=dt, device=device))
    return admm_mod.admm_inner(cfg, PatchOps(struct, data, coords_p), Jp, graft_entry_torch.DEEP_SIGMA, 1.0,
                               torch.tensor(deep.ref_vol, dtype=dt, device=device),
                               torch.as_tensor(deep.ref_bary, dtype=dt, device=device))


def shard_phase(ctx, launches, by_lattice, device="cuda"):
    """The multi-device layer on two gloo ranks sharing the card, against
    the single-device port on the same card: (a) the sharded exchange and
    double-float exchange bit for bit; (b) the refs=4 IR solve converged to
    a true relative residual <= 1e-8 (float64 recheck) and within
    SHARD_X_REL of the single-device solve; (c) the 3D refs=2 ADMM of
    graft_entry_torch's deep phase (level 0 agglomerated) with the
    single-device admm_it, Newton and Krylov counts (per lane too), u and
    the dual tensor finite and within SHARD_U_REL; (d) the IR solve
    twice bit for bit.  The path's launches are the ranks' summed: (b)'s
    first solve and (c), each counted from 0 on its rank.  Seconds per
    piece are no scaling number: the ranks share one card, and their
    collectives go through the host."""
    t_phase = time.perf_counter()
    dev = torch.device(device)
    if ctx is None:
        ctx = xupdate_solve.build(4, dev, torch.float32)
    ps = ctx.ps
    check(ps.P == SHARD_RANKS * SHARD_P, f"the refs=4 lattice splits into {SHARD_RANKS} blocks of {SHARD_P}")
    rng = np.random.default_rng(SHARD_SEED)
    shape = (3,) + ps.fine.lat_shape + (ps.P,)
    x_add = rng.normal(size=shape).astype(np.float32)
    x64 = rng.normal(size=shape)
    xh = x64.astype(np.float32)
    xl = (x64 - xh).astype(np.float32)
    tab = ctx.tabs[-1]
    y1 = st.exchange_sum(None, torch.from_numpy(x_add).to(dev), tab).cpu().numpy()
    yh1, yl1 = (t.cpu().numpy() for t in st.exchange_sum_df(tab, torch.from_numpy(xh).to(dev),
                                                              torch.from_numpy(xl).to(dev)))
    b = xupdate_solve.random_rhs(ctx, seed=0)
    t0 = time.perf_counter()
    res1 = xupdate_solve.solve(ctx, b)
    sync()
    solve1_s = time.perf_counter() - t0
    x1 = res1.x_hi.double() + res1.x_lo.double()
    deep = graft_entry_torch.problem_deep()
    t0 = time.perf_counter()
    st1 = deep_single(deep, dev)
    sync()
    deep1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = launch.spawn(shard_rank, SHARD_RANKS, "gloo", dev, SHARD_TIMEOUT_S, ps, ctx.hier.levels[0],
                        ctx.hier.fine.coords, b.cpu().numpy(), x_add, xh, xl, deep)
    spawn_s = time.perf_counter() - t0
    o = outs[0]
    # (a)
    same = (np.array_equal(o["exchange"], y1), np.array_equal(o["df"][0], yh1), np.array_equal(o["df"][1], yl1))
    log(f"[shard] (a) refs=4 fine lattice {ps.fine.lat_shape} x {ps.P} on {SHARD_RANKS} ranks of {SHARD_P}: "
        f"exchange bit for bit {same[0]}, double-float exchange hi {same[1]} lo {same[2]}")
    check(all(same), "sharded exchange and double-float exchange equal the single-device forms bit for bit")
    # (b), (d)
    s1, s2 = o["solves"]
    x = torch.as_tensor(s1["x_hi"], device=dev).double() + torch.as_tensor(s1["x_lo"], device=dev).double()
    true_rel = true_rel_residual(ctx, b, x)
    dx = float((x - x1).abs().max() / x1.abs().max())
    log(f"[shard] (b) refs=4 IR solve: rounds {s1['rounds']} inner CG {s1['inner_iters']} (single device "
        f"{res1.rounds}, {res1.inner_iters}), res_norm {s1['res_norm']:.3e}, converged {s1['converged']}, true "
        f"relative residual (float64) {true_rel:.3e}, x against the single device {dx:.3e} of max |x| "
        f"(limit {SHARD_X_REL:.0e}); seconds per solve {s1['seconds']:.3f}, {s2['seconds']:.3f} against "
        f"{solve1_s:.3f} single device")
    check(s1["converged"] and true_rel <= 1e-8, f"sharded refs=4 IR solve converged, true residual {true_rel:.3e}")
    check(dx <= SHARD_X_REL, f"sharded refs=4 solution within {SHARD_X_REL:.0e} of the single device's")
    again = (np.array_equal(s1["x_hi"], s2["x_hi"]) and np.array_equal(s1["x_lo"], s2["x_lo"])
             and (s1["rounds"], s1["inner_iters"]) == (s2["rounds"], s2["inner_iters"]))
    log(f"[shard] (d) the sharded solve twice: rounds {s1['rounds']}/{s2['rounds']}, inner CG "
        f"{s1['inner_iters']}/{s2['inner_iters']}, x bit for bit {again}")
    check(again, "two sharded refs=4 solves bitwise equal")
    for r, out in enumerate(outs):
        log_lattices(f"shard rank {r}", out["solve_launches"], "refs=4 solve")
        for name in ("apply_w_sym", "apply_w_pencil", "apply_w_df_sym"):
            n = sum(c for (nm, lat), c in out["solve_launches"].items() if nm == name and lat[-1] == SHARD_P)
            check(n > 0, f"{name} launched on rank {r}'s block of {SHARD_P} patches")
    # (c)
    d = o["deep"]["admm"]
    u1, lam1 = st1.u.double().cpu().numpy(), st1.lam.double().cpu().numpy()
    du = float(np.abs(d["u"] - u1).max() / np.abs(u1).max())
    dlam = float(np.abs(d["lam"] - lam1).max() / np.abs(lam1).max())
    log(f"[shard] (c) 3D refs=2 ADMM, level 0 agglomerated, P {o['deep']['P']} on {SHARD_RANKS} ranks of "
        f"{o['deep']['P_local']}: admm_it {d['admm_it']} total_newton {d['total_newton']} total_lin_iters "
        f"{d['total_lin_iters']} solver_iters {d['solver_iters']} converged {d['converged']} failed {d['failed']} "
        f"(single device: {st1.admm_it}, {st1.total_newton}, {st1.total_lin_iters}, {st1.solver_iters}, "
        f"{st1.converged}, {st1.failed}); u {du:.3e}, lam {dlam:.3e} of max (limit {SHARD_U_REL:.0e}); "
        f"{o['deep_s']:.2f} s on the ranks (set-up included) against {deep1_s:.2f} s single device")
    cfg = graft_entry_torch.ADMM_DEEP
    check((d["admm_it"], d["total_newton"]) == (st1.admm_it, st1.total_newton),
          "sharded ADMM: the single-device admm_it and Newton count")
    check((d["total_lin_iters"], d["solver_iters"]) == (st1.total_lin_iters, list(st1.solver_iters)),
          "sharded ADMM: the single-device Krylov count, per lane too")
    check(np.isfinite(d["u"]).all() and np.isfinite(d["lam"]).all() and du <= SHARD_U_REL and dlam <= SHARD_U_REL,
          f"sharded ADMM u and lam finite and within {SHARD_U_REL:.0e} of the single device's")
    check(not (d["failed"] and d["admm_it"] < cfg.admm_steps) and not (st1.failed and st1.admm_it < cfg.admm_steps),
          "no early solver exit in the ADMM")
    for r, out in enumerate(outs):
        log_lattices(f"shard rank {r}", out["deep"]["admm"]["launches"], "refs=2 ADMM")
        n = sum(c for (nm, lat), c in out["deep"]["admm"]["launches"].items()
                if nm == "apply_w_sym/lanes" and lat[-1] == SHARD_P)
        check(n > 0, f"apply_w_sym/lanes launched on rank {r}'s block of {SHARD_P} patches")
    # the path's launches: both ranks, the first solve and the ADMM
    counts = {}
    for out in outs:
        for part in (out["solve_launches"], out["deep"]["admm"]["launches"]):
            for key, n in part.items():
                counts[key] = counts.get(key, 0) + n
    by_lattice["shard"] = counts
    launches["shard"] = required_launched("shard", {name: sum(n for (nm, _), n in counts.items() if nm == name)
                                                    for name, _ in counts})
    log(f"[shard] launches {launches['shard']}; collectives: "
        f"{', '.join(f'rank {r} {out['sent_bytes'] / 2**20:.1f} MiB' for r, out in enumerate(outs))} handed to "
        f"all_reduce; seconds: rank set-up (tables, exchanges, assembly) {o['setup_s']:.2f}, ranks started and "
        f"joined {spawn_s:.2f}, phase {time.perf_counter() - t_phase:.2f}")
    del res1, x1, x, st1


def host_hierarchy(num_refs, path):
    """In a child process: the 3D channel refined num_refs times and its
    patchset (xupdate_solve.build's host work), pickled to path with the
    seconds of each part."""
    t0 = time.perf_counter()
    levels = [geomgen.channel_3d()]
    for _ in range(num_refs):
        levels.append(refine(levels[-1]))
    t1 = time.perf_counter()
    ps = build_patchset(Hierarchy(levels))
    t2 = time.perf_counter()
    with open(path + ".part", "wb") as f:
        pickle.dump(dict(levels=levels, ps=ps, refine_s=t1 - t0, patchset_s=t2 - t1), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".part", path)


class HostHierarchy:
    """The refs=num_refs hierarchy and patchset of host_hierarchy, made in
    a child process started with the run, so that its minutes of host work
    overlap the phases before sizes; handed back pickled through a
    temporary directory.  close() stops the child and removes the
    directory."""

    def __init__(self, num_refs):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_")
        self.path = os.path.join(self.dir, f"refs{num_refs}.pkl")
        self.t0 = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=host_hierarchy, args=(num_refs, self.path), daemon=True)
        self.proc.start()

    def result(self, timeout):
        """The child's dict (levels, ps, refine_s, patchset_s) with the
        seconds the caller waited for it and took to load it."""
        t0 = time.perf_counter()
        self.proc.join(timeout)
        check(self.proc.exitcode == 0, f"the host child made the hierarchy (exit code {self.proc.exitcode})")
        t1 = time.perf_counter()
        with open(self.path, "rb") as f:
            out = pickle.load(f)
        os.remove(self.path)
        out.update(waited_s=t1 - t0, load_s=time.perf_counter() - t1, asked_s=t0 - self.t0)
        return out

    def close(self):
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(10)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
        shutil.rmtree(self.dir, ignore_errors=True)


SIDE_PHASES = ("small", "cli")
# the seconds the run waits, after its other phases, for the side process
SIDE_WAIT_S = 300.0


def side_phases(names, path, log_path):
    """In a child process on the same card: the phases of names (of
    SIDE_PHASES) one after another, its standard output and error into
    log_path, and their launch counts by path and lattice and seconds
    pickled to path."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    launches, by_lattice, seconds = {}, {}, {}
    for name in SIDE_PHASES:
        if name in names:
            t0 = time.perf_counter()
            small_phase() if name == "small" else cli_phase(launches, by_lattice)
            seconds[name] = time.perf_counter() - t0
    with open(path + ".part", "wb") as f:
        pickle.dump(dict(launches=launches, by_lattice=by_lattice, seconds=seconds), f)
    os.replace(path + ".part", path)


class SidePhases:
    """The refs=1 phases held against float64 CPU runs (SIDE_PHASES), run by
    side_phases in a child process beside the main sequence: host-bound
    work on a card the other phases leave idle most of the time.  result()
    waits for it, prints its log and returns what it measured; close()
    stops it and removes its directory."""

    def __init__(self, names):
        self.names = names
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_side_")
        self.path = os.path.join(self.dir, "side.pkl")
        self.log_path = os.path.join(self.dir, "side.log")
        self.t0 = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=side_phases, args=(names, self.path, self.log_path), daemon=True)
        self.proc.start()

    def result(self, timeout):
        t0 = time.perf_counter()
        self.proc.join(timeout)
        waited = time.perf_counter() - t0
        with open(self.log_path) as f:
            sys.stdout.write(f.read())
        check(self.proc.exitcode == 0, f"the side phases {', '.join(self.names)} ran (exit code {self.proc.exitcode})")
        with open(self.path, "rb") as f:
            out = pickle.load(f)
        log(f"[phase] {', '.join(f'{n} {t:.1f} s' for n, t in out['seconds'].items())} in a side process "
            f"started {self.t0 - _T0:.1f} s after the start; the run waited {waited:.1f} s for it")
        return out

    def close(self):
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(10)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def size_solve(refs, hier, launches, by_lattice, ps=None):
    """bench.py's solve at refs on the card, float32: prepare (ps: the
    patchset of hier, built here when None) and assemble at the
    undeformed mesh, the peak device memory of each; one solve of
    random_rhs(seed=0) with the launch counts from 0 (path "sizes" at
    refs=5, "sizes3" at refs=3), held to solve_checks, to SIZES[refs]'s
    rounds and its iterations within SIZE_ITER_SLACK, K1, K2 and K4
    launched on the fine lattice; then three warm solves.  Returns (ctx,
    b, the warm seconds)."""
    tag, path = f"sizes refs={refs}", "sizes" if refs == max(SIZES) else f"sizes{refs}"
    t0 = time.perf_counter()
    ctx = xupdate_solve.prepare(hier, "cuda", torch.float32, ps=ps)
    prepare_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ctx.data = xupdate_solve.assemble(ctx, ctx.coords)
    sync()
    asm_s = time.perf_counter() - t0
    log(f"[{tag}] {ctx.n_dofs} DoF, {len(hier.levels)} levels, fine lattice {ctx.ps.fine.lat_shape} x {ctx.ps.P}: "
        f"prepare (tables on the card{'' if ps is not None else ', patchset'}) {prepare_s:.2f} s")
    log(f"[{tag}] assembly {asm_s:.2f} s")
    log(f"[{tag}] assembly peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"({before / 2**30:.3f} GiB resident before it, {torch.cuda.memory_allocated() / 2**30:.3f} GiB after)")
    b = xupdate_solve.random_rhs(ctx, seed=0)
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    t0 = time.perf_counter()
    res = xupdate_solve.solve(ctx, b)
    sync()
    first_s = time.perf_counter() - t0
    launches[path] = read_launches(path, by_lattice)
    log(f"[{tag}] solve peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    want_iters, want_rounds = SIZES[refs]
    log(f"[{tag}] first solve {first_s:.3f} s: inner CG iterations {res.inner_iters}, IR rounds {res.rounds}, "
        f"res_norm {float(res.res_norm):.3e}, converged {res.converged}, launches {launches[path]} "
        f"(the JAX record: {want_iters} CG iterations, {want_rounds} rounds)")
    solve_checks(tag, f"refs={refs}", ctx, b, res)
    check(res.rounds == want_rounds and abs(res.inner_iters - want_iters) <= SIZE_ITER_SLACK,
          f"refs={refs}: {res.rounds} IR rounds and {res.inner_iters} inner CG iterations, the JAX record "
          f"{want_rounds} and {want_iters} +- {SIZE_ITER_SLACK}")
    fine = ctx.ps.fine.lat_shape + (ctx.ps.P,)
    for name in PATHS[path]:
        check(by_lattice[path].get((name, fine), 0) > 0, f"{name} launched at {fine} by the refs={refs} solve")
    del res
    return ctx, b, warm_solves(tag, ctx, b)


def profiled_solve(tag, ctx, b, wall_s):
    """One solve under torch.profiler: the card's busy time against
    wall_s, the untraced median, and the kernels with the most device
    time."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        xupdate_solve.solve(ctx, b)
        sync()
        traced = time.perf_counter() - t0
    dev = device_ms(prof)
    if dev is None:
        log(f"[{tag}] profiled solve: device time not measured (the trace holds no device events)")
        return
    total, _, _, top = dev
    log(f"[{tag}] one profiled solve: {traced * 1e3:.2f} ms traced, device busy {total:.2f} ms, "
        f"{100 * total / (wall_s * 1e3):.1f}% of the untraced median {wall_s * 1e3:.2f} ms; top kernels "
        + "; ".join(f"{n} {t:.2f} ms {100 * t / total:.1f}% ({c})" for n, t, c in top))


def assembled_kernels(ctx, floor_ms, seed=SIZES_SEED):
    """K1 (data.W at the fine level, symmetric f32), K2 (its bf16 pencil
    smoother stream) and K4 (on a (hi, lo) split of a seeded float64
    field) on the assembled operator of ctx against their twins, timed as
    kernel_phase times them; K4's error over max sum |W||x| (a float64
    apply of |W| to |x|).  Returns {name: kernel_times}."""
    ps, data = ctx.ps, ctx.data
    W, W_pc, free = data.W[ps.k], data.W_sm[ps.k].a, data.tabs[ps.k].free
    g = torch.Generator(device="cuda").manual_seed(seed)
    x64 = torch.randn((3,) + tuple(free.shape), generator=g, device="cuda", dtype=torch.float64) * free.double()
    xh = x64.float()
    xl = (x64 - xh.double()).float()
    flops = 2.0 * len(ps.stencil) * 9 * free.numel()
    out = {}
    y = sk.apply_w_sym(ps, W, xh)
    out["apply_w_sym"] = kernel_times(y, sk._apply_w_sym(ps, W, xh), lambda: sk.apply_w_sym(ps, W, xh),
                                      lambda: sk._apply_w_sym(ps, W, xh), nbytes(W, xh, y), flops)
    y = sk.apply_w_pencil(ps, W_pc, xh)
    out["apply_w_pencil"] = kernel_times(y, sk._apply_w_pencil(ps, W_pc, xh), lambda: sk.apply_w_pencil(ps, W_pc, xh),
                                         lambda: sk._apply_w_pencil(ps, W_pc, xh), nbytes(W_pc, xh, y), flops)
    del y
    yh, yl = sk.apply_w_df_sym(ps, W, xh, xl)
    x64 = xh.double() + xl.double()
    ref = sk._apply_w_sym(ps, W.double(), x64)
    scale = float(sk._apply_w_sym(ps, W.double().abs(), x64.abs()).max())
    out["apply_w_df_sym"] = kernel_times(
        yh.double() + yl.double(), ref, lambda: sk.apply_w_df_sym(ps, W, xh, xl),
        lambda: sk._apply_w_df_full(ps, st.expand_sym_w(ps, W), xh, xl), nbytes(W, xh, xl, yh, yl), flops,
        rate=F64_FLOPS, scale=scale)
    del ref, x64, yh, yl
    _flush.clear()
    label = lattice_name(ps.fine.lat_shape + (ps.P,))
    for name, t in out.items():
        log_kernel("sizes refs=5", name, label + (" (K4 over sum |W||x|)" if name == "apply_w_df_sym" else ""),
                   t, floor_ms)
    return out


def sizes_phase(levels, host, launches, by_lattice, floor_ms, phases):
    """bench.py's largest size and its smallest on the card: the refs=5
    hierarchy (levels, the slice phase's refs=4 levels, plus the one
    refine the host child made; alone, the child's from scratch), its
    solve (size_solve), one profiled solve, K1, K2 and K4 on its assembled
    operator (assembled_kernels, into phases["33^3x224"]); then refs=3 on
    the first four levels.  A failure here fails the run."""
    t_phase = time.perf_counter()
    h = host.result(SIZES_HOST_WAIT_S)
    log(f"[sizes] the host child (started with the run): refine to refs={len(h['levels']) - 1} {h['refine_s']:.2f} s, "
        f"patchset {h['patchset_s']:.2f} s; the phase asked for it {h['asked_s']:.1f} s after the start, "
        f"waited {h['waited_s']:.2f} s and loaded it in {h['load_s']:.2f} s; device memory resident "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    if levels is None:
        levels = h["levels"]
    else:
        k = len(levels)
        check(all(np.array_equal(a.coords, c.coords) and np.array_equal(a.elems, c.elems)
                  for a, c in zip(levels, h["levels"][:k])),
              "the host child's coarse levels equal the slice phase's")
        levels = list(levels) + h["levels"][k:]
    ctx, b, times = size_solve(max(SIZES), Hierarchy(levels), launches, by_lattice, ps=h["ps"])
    del h
    check(ctx.ps.fine.lat_shape + (ctx.ps.P,) == SIZES_SHAPE[0] + (SIZES_SHAPE[1],),
          f"the refs=5 fine lattice is {SIZES_SHAPE}")
    profiled_solve("sizes refs=5", ctx, b, statistics.median(times))
    phases[lattice_name(ctx.ps.fine.lat_shape + (ctx.ps.P,))] = assembled_kernels(ctx, floor_ms)
    del ctx, b
    torch.cuda.empty_cache()
    refs3 = min(SIZES)
    ctx, b, _ = size_solve(refs3, Hierarchy(levels[:refs3 + 1]), launches, by_lattice)
    del ctx, b
    torch.cuda.empty_cache()
    log(f"[sizes] phase {time.perf_counter() - t_phase:.2f} s")


def small_phase():
    """refs=1 solve, ADMM run, PCD ladder and optimization step, card
    float32 against the port's float64 CPU runs."""
    # The solves converge to 1e-8 of their own operator (the
    # float32 rounding of the operator moves x by ~eps * cond).  The bench
    # ADMM stops its Newton after two iterations, short of ns_tol, so u
    # keeps the float32 rounding of the constraint defects (sums of ~5e4
    # cell terms): on the CPU the port's float32 u lies 3.9e-3 of max|u|
    # from its float64 u, and the JAX package's float32 u 3.3e-2 from its
    # own float64 u.  Hence 1e-2; the counts must be equal
    small = xupdate_solve.build(1, "cuda", torch.float32)
    ref = xupdate_solve.build(1, "cpu", torch.float64)
    xs = xupdate_solve.solve(small, xupdate_solve.random_rhs(small, seed=0))
    xr = xupdate_solve.solve(ref, xupdate_solve.random_rhs(ref, seed=0))
    xg = (xs.x_hi.double() + xs.x_lo.double()).cpu()
    xc = xr.x_hi + xr.x_lo
    dx = float((xg - xc).abs().max() / xc.abs().max())
    log(f"[small] refs=1 solve GPU f32 vs CPU f64: rel max diff {dx:.3e}, iterations {xs.inner_iters} vs {xr.inner_iters}")
    check(xs.converged and xr.converged and dx <= 1e-5, "refs=1 GPU solve agrees with the f64 CPU solve")
    ag, ac = admm_run.run(small).state, admm_run.run(ref).state
    du = float((ag.u.double().cpu() - ac.u).abs().max() / ac.u.abs().max())
    log(
        f"[small] refs=1 ADMM GPU f32 vs CPU f64: admm_it {ag.admm_it} vs {ac.admm_it}, "
        f"total_newton {ag.total_newton} vs {ac.total_newton}, total_lin_iters "
        f"{ag.total_lin_iters} vs {ac.total_lin_iters}, u rel max diff {du:.3e}"
    )
    check((ag.admm_it, ag.total_newton) == (ac.admm_it, ac.total_newton) and du <= 1e-2,
          "refs=1 GPU ADMM agrees with the f64 CPU ADMM")
    pcd_small()
    step_small()


def parse_phases(argv):
    """The phases an argument list selects, in PHASES order: none selects
    all; --phase NAME[,NAME] (--kernels-only is --phase kernels) selects
    kernels and the named ones, and admm brings slice, whose refs=4
    context it runs on."""
    if not argv:
        return PHASES
    if argv == ["--kernels-only"]:
        argv = ["--phase", "kernels"]
    names = set(argv[1].split(",")) if len(argv) == 2 and argv[0] == "--phase" else {""}
    if not names <= set(PHASES):
        raise SystemExit(__doc__)
    names |= {"kernels"} | ({"slice"} if "admm" in names else set())
    return tuple(p for p in PHASES if p in names)


if __name__ == "__main__":
    main(parse_phases(sys.argv[1:]))
