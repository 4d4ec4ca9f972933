"""The port's io/ (admm_optim_tpu_torch/io) against the JAX package's, as
tests/test_io.py holds the JAX package's: the telemetry and VTU writers
give byte-identical files on the same records, a checkpoint round-trips in
either direction, and the deformed-mesh .ugx dump reads back equal."""
import json

import numpy as np
import pytest
import torch

from admm_optim_tpu.core import geomgen as jgeomgen
from admm_optim_tpu.io import checkpoint as jcheckpoint
from admm_optim_tpu.io import telemetry as jtelemetry
from admm_optim_tpu.io import vtk as jvtk
from admm_optim_tpu_torch import ns_run
from admm_optim_tpu_torch.core.ugx import read_ugx
from admm_optim_tpu_torch.io import checkpoint, telemetry, vtk
from admm_optim_tpu_torch.models.obstacle import ObstacleShapeOpt, ProblemConfig

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
NEWTON_ROWS_2D = [[0.0, 1e-3, 2e-3, 5e-3, 7.0, 3.0, 2.0, 2.0], [0.0, 1e-6, 2e-6, 5e-6, 5.0, 2.0, 2.0, 2.0]]
NEWTON_ROWS_3D = [[0.0, *RNG.random(3).tolist(), 9.0, 4.0, 3.0, 3.0, 3.0]]
ADMM_STATS = {f"c{i}": RNG.random(5).tolist() for i in range(6)} | {"c10": [1.0] * 3}
# each writer with the records it gets from ObstacleShapeOpt.run: Python ints and floats
WRITERS = {
    "drag": lambda t: t.write_drag([0, 1, 2], [0.9070213492728532, 0.8383638952232686, 0.7916512648075379],
                                   [1.0, 0.9243044784947716, 0.8728033418862677], [0.1, 0.06865745404958457, 1e-17],
                                   [-0.26242092339391987, -0.16811178061300333, -3.5e-9]),
    "iterations_2d": lambda t: t.write_iterations([0, 1], [8, 5], [0.3, 0.15], [30, 43], [352, 512],
                                                  solver_iters=[(107, 83, 81, 81), (163, 122, 116, 111)], dim=2),
    "iterations_3d": lambda t: t.write_iterations([0, 1], [16, 31], [0.3, 0.3], [122, 195], [1752, 3663],
                                                  solver_iters=[(1, 2, 3, 4, 5), (6, 7, 8, 9, 10)], dim=3),
    "iterations_no_solver": lambda t: t.write_iterations([0], [2], [0.3], [7], [50]),
    "newton_2d": lambda t: (t.write_newton_stats(3, NEWTON_ROWS_2D), t.write_newton_iterations(3, NEWTON_ROWS_2D)),
    "newton_3d": lambda t: (t.write_newton_stats(0, NEWTON_ROWS_3D), t.write_newton_iterations(0, NEWTON_ROWS_3D)),
    "newton_empty": lambda t: (t.write_newton_stats(1, []), t.write_newton_iterations(1, [])),
    "failures": lambda t: t.write_failures([0, 1], [2, 2], [0.81, 0.8000000000000002], [1e-3, 2.5e-4], [0.3, 0.15]),
    "admm_stats": lambda t: t.write_admm_stats(4, ADMM_STATS),
    "jsonl": lambda t: (t.log_step({"step": 0, "drag": 0.8383638952232686, "solver_iters": [1, 2]}),
                        t.log_step({"step": 1, "drag": 1e-300, "attempts": 2})),
}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_telemetry_files_equal_the_jax_package(tmp_path, case):
    dirs = {}
    for name, mod in (("port", telemetry), ("jax", jtelemetry)):
        d = tmp_path / name
        t = mod.TelemetryWriter(str(d))
        WRITERS[case](t)
        t.close()
        dirs[name] = _files(d)
    assert dirs["port"] and dirs["port"] == dirs["jax"]


def test_write_columns_ragged_equal_the_jax_package(tmp_path):
    cols = [[0, 1, 2], [0.5], [], [1e-20, -3.0]]
    telemetry.write_columns(str(tmp_path / "a.txt"), cols)
    jtelemetry.write_columns(str(tmp_path / "b.txt"), cols)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


def _vtu_cases():
    l2 = jgeomgen.channel_2d()
    l3 = jgeomgen.channel_3d()
    return {
        "2d": (l2.coords, l2.elems, {"u": RNG.normal(size=l2.coords.shape), "p": RNG.normal(size=len(l2.coords))},
               {"area": RNG.random(len(l2.elems))}),
        "3d": (l3.coords, l3.elems, {"v": RNG.normal(size=l3.coords.shape)},
               {"grad": RNG.normal(size=(len(l3.elems), 3, 3))}),
        "bare": (l2.coords, l2.elems, None, None),
    }


@pytest.mark.parametrize("case", ["2d", "3d", "bare"])
def test_vtu_equal_the_jax_package(tmp_path, case):
    coords, elems, pd, cd = _vtu_cases()[case]
    vtk.write_vtu(str(tmp_path / "a.vtu"), coords, elems, point_data=pd, cell_data=cd)
    jvtk.write_vtu(str(tmp_path / "b.vtu"), coords, elems, point_data=pd, cell_data=cd)
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu").read_bytes()


def _load_eq(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert type(a[k]) is type(b[k]), k


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_checkpoint_round_trips(tmp_path, writer, reader):
    """Equal keys and values (an npz carries zip timestamps, so the
    contents are compared, not the bytes), through either package."""
    save = {"port": checkpoint.save_checkpoint, "jax": jcheckpoint.save_checkpoint}[writer]
    load = {"port": checkpoint.load_checkpoint, "jax": jcheckpoint.load_checkpoint}[reader]
    X, s = RNG.normal(size=(10, 2)), RNG.normal(size=(37,))
    extra = {"drag_init": 0.9, "history_json": json.dumps([{"step": 0, "drag": 0.8}]), "failures_json": "[]"}
    path = str(tmp_path / "ck.npz")
    save(path, step=-1, X=X, s=s, sigma=0.15, drag_old=0.83, extra=extra)
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    z = load(path)
    want = dict(step=-1, X=X, s=s, sigma=0.15, drag_old=0.83, **extra)
    _load_eq(z, want)
    _load_eq(z, jcheckpoint.load_checkpoint(path))


def test_deformed_mesh_ugx_reads_back_equal(tmp_path):
    """-bDebugOutput's per-step mesh dump (ObstacleShapeOpt._write_mesh_ugx)
    at a deformed X: coordinates, triangles, edges and vertex subsets."""
    prob = ObstacleShapeOpt(ProblemConfig(dim=2, num_refs=1), device="cpu", dtype=torch.float64)
    X = prob.X0 + 0.01 * torch.as_tensor(RNG.normal(size=tuple(prob.X0.shape)))
    path = str(tmp_path / "Mesh_lev1_step0.ugx")
    prob._write_mesh_ugx(path, X)
    g = read_ugx(path)
    lvl = ns_run.channel(1, 2).fine
    np.testing.assert_array_equal(g.coords[:, :2], X.numpy())
    assert not g.coords[:, 2].any()
    np.testing.assert_array_equal(g.triangles, lvl.elems)
    np.testing.assert_array_equal(g.edges, lvl.edges)
    assert len(g.tetrahedrons) == 0
    assert sorted(g.subsets) == sorted(lvl.subset_vertices)
    for name, mask in lvl.subset_vertices.items():
        np.testing.assert_array_equal(g.subsets[name].vertices, np.nonzero(mask)[0])
