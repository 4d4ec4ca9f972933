"""Minimal VTU (VTK XML unstructured grid) writer for meshes + nodal fields.

Replaces the reference's ``VTKOutput`` usage (2d_admm.lua:695, 750-764,
1350-1372): triangle / tetrahedron meshes with point data vectors/scalars,
readable by ParaView.

The port's copy of admm_optim_tpu/io/vtk.py (host numpy arrays in, the same
file out).
"""
from __future__ import annotations

import numpy as np

VTK_TRIANGLE = 5
VTK_TETRA = 10


def write_vtu(path: str, coords: np.ndarray, elems: np.ndarray, point_data=None, cell_data=None):
    coords = np.asarray(coords, dtype=np.float64)
    elems = np.asarray(elems, dtype=np.int64)
    V, d = coords.shape
    E, nl = elems.shape
    ctype = VTK_TRIANGLE if nl == 3 else VTK_TETRA
    pts3 = np.zeros((V, 3))
    pts3[:, :d] = coords

    def arr(a, name, ncomp):
        flat = " ".join(repr(float(x)) for x in np.asarray(a, dtype=np.float64).ravel())
        return (
            f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="ascii">{flat}</DataArray>'
        )

    pd = ""
    if point_data:
        entries = []
        for name, a in point_data.items():
            a = np.asarray(a)
            ncomp = 1 if a.ndim == 1 else a.shape[1]
            if ncomp == 2:  # pad 2D vectors to 3 components for ParaView
                a = np.pad(a, ((0, 0), (0, 1)))
                ncomp = 3
            entries.append(arr(a, name, ncomp))
        pd = "<PointData>" + "".join(entries) + "</PointData>"
    cd = ""
    if cell_data:
        entries = []
        for name, a in cell_data.items():
            a = np.asarray(a)
            ncomp = 1 if a.ndim == 1 else int(np.prod(a.shape[1:]))
            entries.append(arr(a.reshape(len(a), -1), name, ncomp))
        cd = "<CellData>" + "".join(entries) + "</CellData>"

    conn = " ".join(str(x) for x in elems.ravel())
    offs = " ".join(str((i + 1) * nl) for i in range(E))
    types = " ".join(str(ctype) for _ in range(E))
    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid><Piece NumberOfPoints="{V}" NumberOfCells="{E}">
{pd}{cd}
<Points>{arr(pts3, "points", 3)}</Points>
<Cells>
<DataArray type="Int64" Name="connectivity" format="ascii">{conn}</DataArray>
<DataArray type="Int64" Name="offsets" format="ascii">{offs}</DataArray>
<DataArray type="UInt8" Name="types" format="ascii">{types}</DataArray>
</Cells>
</Piece></UnstructuredGrid></VTKFile>
"""
    with open(path, "w") as f:
        f.write(xml)
