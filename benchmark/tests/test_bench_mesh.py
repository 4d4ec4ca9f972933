"""The frozen mesh generator makes the port's mesh, array for array, and
its cache hands the same arrays back."""
import numpy as np
import pytest

from admm_optim_tpu_torch.core import geomgen
from admm_optim_tpu_torch.core.mesh import refine
from benchmark import meshgen

FIELDS = ("coords", "elems", "edges", "elem_edges", "parents")


def _equal(mine: dict, port) -> None:
    for key in FIELDS:
        assert np.array_equal(mine[key], getattr(port, key)), key
    for key in meshgen._DICTS:
        a, b = mine[key], getattr(port, key)
        assert set(a) == set(b), key
        for name in a:
            assert np.array_equal(a[name], b[name]), (key, name)


@pytest.mark.parametrize("refs", [0, 1, 2])
def test_matches_port(refs):
    mine, port = meshgen.channel_3d(), geomgen.channel_3d()
    assert np.array_equal(mine["bricks"], port.bricks) and mine["elems_per_brick"] == port.elems_per_brick
    for _ in range(refs):
        mine, port = meshgen.refine(mine), refine(port)
    _equal(mine, port)


def test_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(meshgen, "CACHE_DIR", tmp_path)
    made, info = meshgen.load_levels(1, log=lambda *a: None)
    assert not info["cache_hit"] and info["cache_bytes"] > 0
    loaded, info = meshgen.load_levels(1, log=lambda *a: None)
    assert info["cache_hit"]
    for a, b in zip(made, loaded):
        assert a["elems_per_brick"] == b["elems_per_brick"]
        assert (a["bricks"] is None) == (b["bricks"] is None)
        for key in FIELDS:
            assert np.array_equal(a[key], b[key])
        for key in meshgen._DICTS:
            for name in a[key]:
                assert np.array_equal(a[key][name], b[key][name])
    assert meshgen.cache_path(1).name.startswith(meshgen.source_hash()[:16])


def test_sizes_of_the_configurations():
    lv = meshgen.build_levels(2)
    assert [len(l["coords"]) for l in lv] == [360, 2298, 16290]
    assert len(lv[-1]["elems"]) == 86016
