"""The port's CLI on the global (block-ELL) backend against the JAX CLI,
float64 on the CPU: -backend global on the generated 2D channel (its
alternating diagonals) and -grid on a .ugx file of that channel that the
port's core/ugx.write_ugx writes into tmp_path, each at 2D refs=1 for one
step with -x64 (tests/torch_global_golden.py's CLI_ARGVS).  Their
__Drag.txt and __Iterations_per_step.txt are held against the JAX CLI's on
the same argv (tests/goldens/e2e_global.npz, made by
tests/goldens/make_e2e_goldens.py global): the integer columns and sigma
equal, the drag columns to 1e-7 of the drag (as tests/test_torch_cli.py
holds the drive recipe)."""
import pathlib

import numpy as np
import pytest
import torch

import torch_global_golden as G
from admm_optim_tpu_torch import cli
from admm_optim_tpu_torch.core import geomgen, ugx

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).parent / "goldens" / "e2e_global.npz")
DRAG_REL = 1e-7


def _table(text):
    return np.array([r.split("\t") for r in text.strip().splitlines()], float)


@pytest.mark.parametrize("case", ["backend", "grid"])
def test_global_cli_writes_the_jax_clis_files(tmp_path, capsys, case):
    argv = list(G.CLI_ARGVS[case])
    if case == "grid":
        path = tmp_path / G.GRID_NAME
        G.write_channel_ugx(path, ugx, geomgen)
        argv += ["-grid", str(path)]
    out = tmp_path / "out"
    assert cli.main(argv + ["-outDir", str(out)]) == 0
    assert "DONE: 1 accepted steps" in capsys.readouterr().out
    got = {k: _table((out / f).read_text()) for k, f in (("drag", "__Drag.txt"),
                                                           ("iterations", "__Iterations_per_step.txt"))}
    want = {k: _table(str(GOLD[f"cli_{case}_{k}"])) for k in ("drag", "iterations")}
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    assert got["drag"].shape == want["drag"].shape == (1, 5)
    np.testing.assert_array_equal(got["drag"][:, 0], want["drag"][:, 0])
    scale = np.abs(want["drag"][:, 1]).max()
    assert np.abs(got["drag"][:, 1:] - want["drag"][:, 1:]).max() <= DRAG_REL * scale
