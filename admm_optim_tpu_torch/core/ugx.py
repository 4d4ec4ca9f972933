"""UG4 ``.ugx`` grid-file reader/writer.

TPU-native re-implementation of the loader behind ``LoadDomain`` in the
reference (``2d_admm.lua:131-132``).  The ``.ugx`` format is a small XML
dialect::

    <grid name="...">
      <vertices coords="3"> x0 y0 z0 x1 y1 z1 ... </vertices>
      <edges> a0 b0 a1 b1 ... </edges>
      <triangles> i j k ... </triangles>
      <tetrahedrons> i j k l ... </tetrahedrons>
      <subset_handler name="...">
        <subset name="outer" ...>
          <vertices> ... </vertices> <edges> ... </edges>
          <faces> ... </faces> <volumes> ... </volumes>
        </subset>
        ...
      </subset_handler>
    </grid>

Indices inside subsets refer to positions in the global element lists.
Both reference grids (``grids/refined.ugx``, ``grids/box_3D_elongated.ugx``)
use the five subsets ``outer, wall, obstacle_surface, inlet, outlet``.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np


@dataclasses.dataclass
class SubsetInfo:
    """Entity index lists of one named subset (host-side, numpy int32)."""

    name: str
    vertices: np.ndarray  # (nv,) indices into grid vertex list
    edges: np.ndarray  # (ne,) indices into grid edge list
    faces: np.ndarray  # (nf,) indices into grid triangle list (3D) / == elems (2D)
    volumes: np.ndarray  # (nvol,) indices into tetrahedron list (3D only)


@dataclasses.dataclass
class UgxGrid:
    """Raw parsed contents of a .ugx file (host-side numpy)."""

    name: str
    coords: np.ndarray  # (V, 3) float64 - always stored with 3 coordinates
    edges: np.ndarray  # (Ne, 2) int32
    triangles: np.ndarray  # (Nt, 3) int32
    tetrahedrons: np.ndarray  # (Ntet, 4) int32
    subsets: dict[str, SubsetInfo]

    @property
    def dim(self) -> int:
        return 3 if len(self.tetrahedrons) else 2


def _ints(text: str | None) -> np.ndarray:
    if not text or not text.strip():
        return np.zeros((0,), dtype=np.int32)
    return np.fromstring(text, sep=" ", dtype=np.int64).astype(np.int32)


def read_ugx(path: str) -> UgxGrid:
    root = ET.parse(path).getroot()
    vert_el = root.find("vertices")
    assert vert_el is not None, "ugx file missing <vertices>"
    ncoord = int(vert_el.get("coords", "3"))
    coords = np.fromstring(vert_el.text or "", sep=" ").reshape(-1, ncoord)
    if ncoord < 3:  # normalize to 3 columns
        coords = np.pad(coords, ((0, 0), (0, 3 - ncoord)))

    def elem(tag: str, width: int) -> np.ndarray:
        el = root.find(tag)
        if el is None:
            return np.zeros((0, width), dtype=np.int32)
        return _ints(el.text).reshape(-1, width)

    edges = elem("edges", 2)
    tris = elem("triangles", 3)
    tets = elem("tetrahedrons", 4)

    subsets: dict[str, SubsetInfo] = {}
    sh = root.find("subset_handler")
    if sh is not None:
        for sub in sh.findall("subset"):
            name = sub.get("name", "")

            def part(tag: str) -> np.ndarray:
                el = sub.find(tag)
                return _ints(el.text if el is not None else None)

            subsets[name] = SubsetInfo(
                name=name,
                vertices=part("vertices"),
                edges=part("edges"),
                faces=part("faces"),
                volumes=part("volumes"),
            )
    return UgxGrid(
        name=root.get("name", ""),
        coords=coords,
        edges=edges,
        triangles=tris,
        tetrahedrons=tets,
        subsets=subsets,
    )


def write_ugx(path: str, grid: UgxGrid) -> None:
    """Write a grid back to .ugx (used by ``SaveGridLevelToFile`` parity,
    reference 2d_admm.lua:788)."""

    def fmt(arr: np.ndarray) -> str:
        return " ".join(str(x) for x in np.asarray(arr).ravel().tolist())

    root = ET.Element("grid", name=grid.name or "defGrid")
    v = ET.SubElement(root, "vertices", coords="3")
    v.text = " ".join(repr(float(x)) for x in grid.coords.ravel())
    if len(grid.edges):
        ET.SubElement(root, "edges").text = fmt(grid.edges)
    if len(grid.triangles):
        ET.SubElement(root, "triangles").text = fmt(grid.triangles)
    if len(grid.tetrahedrons):
        ET.SubElement(root, "tetrahedrons").text = fmt(grid.tetrahedrons)
    sh = ET.SubElement(root, "subset_handler", name="defSH")
    for name, info in grid.subsets.items():
        s = ET.SubElement(sh, "subset", name=name)
        if len(info.vertices):
            ET.SubElement(s, "vertices").text = fmt(info.vertices)
        if len(info.edges):
            ET.SubElement(s, "edges").text = fmt(info.edges)
        if len(info.faces):
            ET.SubElement(s, "faces").text = fmt(info.faces)
        if len(info.volumes):
            ET.SubElement(s, "volumes").text = fmt(info.volumes)
    ET.ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)
