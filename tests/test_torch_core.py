"""The port's jax-free copies of the host-side core (geomgen, mesh, ugx,
meshkit, patches, quadrature, spaces) give arrays identical to the JAX
package's, and the port imports with JAX unavailable."""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.core import mesh as jmesh
from admm_optim_tpu.core import patches as jpatches
from admm_optim_tpu.core import quadrature as jquadrature
from admm_optim_tpu.core import spaces as jspaces
from admm_optim_tpu_torch.core import geomgen, mesh, patches, quadrature, spaces

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


def _dataclass_same(a, b, where):
    for f in dataclasses.fields(a):
        _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")


@pytest.mark.parametrize("refs", [0, 1, 2])
def test_core_copies_match_jax_package(refs):
    j_levels = [jgeomgen.channel_3d()]
    t_levels = [geomgen.channel_3d()]
    for _ in range(refs):
        j_levels.append(jmesh.refine(j_levels[-1]))
        t_levels.append(mesh.refine(t_levels[-1]))
    for l, (a, b) in enumerate(zip(j_levels, t_levels)):
        _dataclass_same(a, b, f"level{l}")
    jps = jpatches.build_patchset(jmesh.Hierarchy(j_levels))
    tps = patches.build_patchset(mesh.Hierarchy(t_levels))
    for name in ("dim", "k", "P", "class_offsets", "stencil", "stencil_slot"):
        _assert_same(getattr(jps, name), getattr(tps, name), f"ps.{name}")
    for l, (a, b) in enumerate(zip(jps.levels, tps.levels)):
        _dataclass_same(a, b, f"ps.levels[{l}]")


@pytest.mark.parametrize("dim", [2, 3])
def test_quadrature_and_space_tables_match_jax_package(dim):
    """simplex_rule, p1_tab, p2_tab (every degree the NS space uses) and
    p2_elem_dofs, bit for bit."""
    for degree in (1, 2, 3, 4, 5):
        _assert_same(quadrature.simplex_rule(dim, degree), jquadrature.simplex_rule(dim, degree),
                     f"simplex_rule({dim}, {degree})")
        _assert_same(spaces.p1_tab(dim, degree), jspaces.p1_tab(dim, degree), f"p1_tab({dim}, {degree})")
        _assert_same(spaces.p2_tab(dim, degree), jspaces.p2_tab(dim, degree), f"p2_tab({dim}, {degree})")
    base = geomgen.channel_3d() if dim == 3 else geomgen.channel_2d(diag="fixed")
    jbase = jgeomgen.channel_3d() if dim == 3 else jgeomgen.channel_2d(diag="fixed")
    lv, jlv = mesh.refine(base), jmesh.refine(jbase)
    _assert_same(spaces.p2_elem_dofs(lv), jspaces.p2_elem_dofs(jlv), "p2_elem_dofs")
    _assert_same(spaces.p2_dof_coords(lv), jspaces.p2_dof_coords(jlv), "p2_dof_coords")


def test_port_imports_without_jax():
    """Every module of the port (and chip_smoke.py) imports with JAX and
    the JAX package made unimportable, as on a GPU machine without JAX."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['admm_optim_tpu'] = None\n"
        "import admm_optim_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'admm_optim_tpu_torch.solvers.patch_mg' in names\n"
        "assert 'admm_optim_tpu_torch.xupdate_solve' in names\n"
        "for n in ('core.quadrature', 'core.spaces', 'ops.convdiff', 'ops.navier_stokes',\n"
        "          'ops.ns_patchjac', 'solvers.ns_solver', 'ns_run', 'models.obstacle',\n"
        "          'io.checkpoint', 'io.telemetry', 'io.vtk', 'io.resume', 'utils.debug',\n"
        "          'utils.profiling', 'cli', 'solvers.mg', 'ops.p1space', 'ops.ns_elljac',\n"
        "          'models.sweep'):\n"
        "    assert 'admm_optim_tpu_torch.' + n in names, n\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # importing cli does not run main (which would print its parameters)
    assert "THE PARAMETERS" not in out.stdout
    assert int(out.stdout.strip().splitlines()[-1]) >= 35
