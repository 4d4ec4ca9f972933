"""What tests/goldens/make_e2e_goldens.py's ``variants`` target runs on the
JAX package and the port's tests of the ObstacleShapeOpt variants run
again (tests/goldens/e2e_variants.npz): one optimization step from the
cold start at 2D refs=1, visc 0.16 (a one-rung ladder), with the x-update
of tests/test_b2nd_order.py:53-66, for each of

  * "b2nd": b2nd_order with high_order_scaling 1 (the JAX test's step): the
    x-update on the global backend with the J'' term, the NS side on the
    patch backend's assembled lattice Jacobian;
  * "pcdg": pressure_precond "pcd" on the global backend (the ELL PCD
    forms), on the channel with alternating diagonals;
  * "jacoff": ns_assembled_jac "off" on the patch backend (the matrix-free
    NS jvp / vjp with the residual's B^T);
  * "p1": vorder 1 with stab 0.05 (P1/P1 Brezzi-Pitkaranta, matrix-free);

and the NS path alone at visc 0.16 from the cold start (Newton counts,
drag, adjoint, J'): "mf" matrix-free on the patch backend, "p1" P1/P1 with
stab 0.05, and "p1_mono", the JAX package's monolithic newton_solve with
its default block-diagonal preconditioner on the P1/P1 space.

Imports neither JAX nor torch."""

ADMM = dict(admm_steps=20, ns_max_its=6, tau=2.0, lin_max_iters=200)
BASE = dict(dim=2, num_refs=1, visc=0.16, sigma_threshold=0.3, admm=ADMM)
CONFIGS = {
    "b2nd": dict(BASE, b2nd_order=True, high_order_scaling=1.0),
    "pcdg": dict(BASE, backend="global", pressure_precond="pcd"),
    "jacoff": dict(BASE, ns_assembled_jac="off"),
    "p1": dict(BASE, vorder=1, stab=0.05),
}
# the NS path alone: ProblemConfig keywords (the x-update's do not matter)
NS_CASES = {
    "ns_mf": dict(dim=2, num_refs=1, visc=0.16, ns_assembled_jac="off"),
    "ns_p1": dict(dim=2, num_refs=1, visc=0.16, vorder=1, stab=0.05),
}
NS_VISC = 0.16
P1_STAB = 0.05
