"""What tests/goldens/make_e2e_goldens.py's ``global`` target runs on the
JAX package's global (block-ELL) backend and the port's tests of that
backend run again: the configurations, the synthetic shape gradient of
the ADMM and sweep goldens, and the channel mesh written as a .ugx file.

Imports neither JAX nor torch: the golden maker passes the JAX package's
modules, the tests the port's."""
import numpy as np

# tests/test_e2e_2d.py:20-28 and tests/test_e2e_3d.py:22-33 on the global
# backend: the 2D channel with alternating diagonals (no brick metadata)
CONFIGS = {
    "2dg": dict(dim=2, num_refs=1, visc=0.05, sigma_threshold=0.3, backend="global",
                admm=dict(admm_steps=40, ns_max_its=8, tau=2.0, lin_max_iters=120)),
    "3dg": dict(dim=3, num_refs=0, visc=0.1, sigma_threshold=0.3, backend="global",
                admm=dict(admm_steps=60, ns_max_its=10, tau=2.0, lin_max_iters=400),
                ns=dict(lin_max_iters=1200, lin_restart=100)),
}
# one step on the .ugx file of the coarse 2D "alt" channel, refined once
GRID_CONFIG = dict(dim=2, num_refs=1, visc=0.05, sigma_threshold=0.3,
                   admm=dict(admm_steps=40, ns_max_its=8, tau=2.0, lin_max_iters=120))
GRID_NAME = "channel_2d_alt.ugx"
# the ADMM goldens: admm_inner at the undeformed mesh with jp_of's J'
ADMM_SIGMA, ADMM_SCALING = 0.3, 1.0
# the sweep goldens on the 2dg problem: sigma_sweep over SWEEP_SIGMAS, then
# geometry_sweep over X0 and X0 + GEOMETRY_SHARE * u of the first candidate
SWEEP_SIGMAS = (0.15, 0.3)
GEOMETRY_SHARE = 0.5
GEOMETRY_SIGMA = 0.3
# the CLI goldens: the JAX CLI's __Drag.txt and __Iterations_per_step.txt
CLI_ARGVS = {
    "backend": ["-dim", "2", "-numRefs", "1", "-numSteps", "1", "-admmSteps", "8", "-visc", "0.05",
                "-backend", "global", "-x64"],
    "grid": ["-dim", "2", "-numRefs", "1", "-numSteps", "1", "-admmSteps", "8", "-visc", "0.05", "-x64"],
}


def jp_of(X, obstacle_vmask):
    """A shape gradient (C, V) pointing into the obstacle, as
    tests/test_sweep.py's _jp: numpy in, numpy out."""
    X = np.asarray(X, np.float64)
    Jp = -X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 0.3)
    return (Jp * np.asarray(obstacle_vmask, np.float64)[:, None] * 0.15).T


def write_channel_ugx(path, ugx, geomgen):
    """The coarse 2D channel with alternating diagonals as a .ugx file,
    its subsets with their vertices and edges (the P2 velocity's Dirichlet
    edges), through the given package's core.ugx and core.geomgen."""
    lvl = geomgen.channel_2d(diag="alt")
    empty = np.zeros((0,), np.int32)
    coords = np.zeros((lvl.num_vertices, 3))
    coords[:, :2] = lvl.coords
    subsets = {
        name: ugx.SubsetInfo(
            name=name, vertices=np.nonzero(mask)[0].astype(np.int32),
            edges=np.nonzero(lvl.subset_edges[name])[0].astype(np.int32), faces=empty, volumes=empty,
        )
        for name, mask in lvl.subset_vertices.items()
    }
    ugx.write_ugx(str(path), ugx.UgxGrid(
        name="channel", coords=coords, edges=np.asarray(lvl.edges, np.int32),
        triangles=np.asarray(lvl.elems, np.int32), tetrahedrons=np.zeros((0, 4), np.int32), subsets=subsets,
    ))


# geometry_sweep on a patch-backend problem: tests/test_sweep.py:14-22's 2D
# refs=1 backend="auto" problem (a geomgen mesh with brick metadata, so
# its x-update runs on the patch backend and the sweep on the global one),
# over the undeformed mesh and PATCH_SWEEP_LANES - 1 meshes perturbed as
# that test perturbs them (:53-64), at sigma PATCH_SWEEP_SIGMA
PATCH_SWEEP_CONFIG = dict(dim=2, num_refs=1, visc=0.05,
                          admm=dict(admm_steps=80, ns_max_its=8, tau=2.0, lin_max_iters=100))
PATCH_SWEEP_LANES = 2
PATCH_SWEEP_SIGMA = 0.3


def perturbed_meshes(X0, free, lanes, seed=0, scale=0.02):
    """(lanes, V, d): X0 (V, d) and lanes - 1 copies moved by scale times a
    normal draw on the free components free (d, V), lane 0 unmoved, the
    draws of tests/test_sweep.py::test_geometry_sweep."""
    rng = np.random.default_rng(seed)
    X0 = np.asarray(X0, np.float64)
    free = np.asarray(free, np.float64).T
    return np.stack([X0 + scale * rng.normal(size=X0.shape) * free * (b > 0) for b in range(lanes)])
