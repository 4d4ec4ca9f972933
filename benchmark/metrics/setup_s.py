"""setup_s: seconds from process start to the start of the measured window
(imports, the kernel library, the mesh, the port's patchset, tables and
assembly, the traffic's pool, the warm-up requests)."""


def read(run):
    return run.setup_s
