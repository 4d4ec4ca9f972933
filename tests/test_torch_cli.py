"""The port's CLI (admm_optim_tpu_torch/cli.py) against the JAX package's
(admm_optim_tpu/cli.py): the same flags, defaults and choices, the same
parsed namespace and ProblemConfig on the same argv, and the drive recipe
of the JAX package's verify notes

    python -m admm_optim_tpu_torch.cli -dim 2 -numRefs 1 -numSteps 2 -admmSteps 8 -x64

writing the __Drag.txt and __Iterations_per_step.txt of the JAX CLI on
that argv (tests/goldens/e2e_cli_2d.npz, made by
tests/goldens/make_e2e_goldens.py cli).  Without -x64 the CLI takes the
card, and without one it raises; -b2ndOrder 1 and -vorder 1 run, in the
process and through the module entry point.  The
global backend's runs (-backend global, -grid) are in
tests/test_torch_cli_global.py."""
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from admm_optim_tpu import cli as jcli
from admm_optim_tpu.models import obstacle as jobstacle
from admm_optim_tpu_torch import cli, convert
from admm_optim_tpu_torch.io.checkpoint import load_checkpoint

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = np.load(REPO / "tests" / "goldens" / "e2e_cli_2d.npz")
RECIPE = ["-dim", "2", "-numRefs", "1", "-numSteps", "2", "-admmSteps", "8", "-x64"]
# argv lists that together take every choice of every choice flag
ARGVS = {
    "defaults": [],
    "recipe": RECIPE,
    "3d": ["-dim", "3", "-normName", "spectral", "-vorder", "1", "-backend", "global", "-pressurePrecond", "pcd",
           "-velInner", "2", "-lambda_vol", "0.1", "-lambda_z", "0.2", "-grid", "g.ugx", "-x64"],
    "numbers": ["-backend", "patch", "-normName", "frobenius", "-vorder", "2", "-pressurePrecond", "mass",
                "-numRefs", "2", "-numSteps", "5", "-visc", "0.05", "-stab", "0.1", "-stabType", "1", "-control", "2",
                "-sigma_threshold", "0.2", "-scaling", "2", "-admm_tolerance", "1e-3",
                "-admm_gradient_tolerance", "0.1", "-step_length", "0.5", "-line_search", "1e-4", "-tau", "2",
                "-relaxAlpha", "1.5", "-nsMaxIts", "8", "-nsTol", "1e-8", "-nsAbsLuTol", "1e-11",
                "-nsAbsLlambdaTol", "1e-10", "-nsRelLuTol", "1e-9", "-nsRelLlambdaTol", "1e-7", "-lambda_x", "0.3",
                "-lambda_y", "-0.1", "-bDoNothing", "0", "-b2ndOrder", "1", "-hscaling", "0.5"],
    "outputs": ["-backend", "auto", "-bOutputMesh", "0", "-bOutputFlows", "1", "-bOutputPressure", "1",
                "-bOutputAdjoints", "1", "-bDebugOutput", "1", "-bDebugNodalPositions", "1", "-bDebugSensitivity", "1",
                "-bOutputIntermediateUp", "1", "-bNewtonOutput", "1", "-debugNans", "1", "-bSaveFailures", "0",
                "-bActivateProfiler", "1", "-traceDir", "t", "-verbose", "0", "-restart", "ck.npz",
                "-autoResume", "3", "-outDir", "o"],
}
# the drive recipe at visc 0.02: the ladder's last rung ends at |R| ~8e-9
# after 5 Newton iterations in the JAX run and 6 in the port's, where the
# two paths part, and every drag-derived column moves by up to 5.4e-8 of
# the drag (measured); the integer columns and sigma are equal
RECIPE_DRAG_REL = 1e-7


def _flags(parser):
    return sorted((a.option_strings, a.default, a.choices, a.type, a.nargs, a.const)
                  for a in parser._actions if a.dest != "help")


def test_parsers_have_the_same_flags_defaults_and_choices():
    flags = _flags(cli.build_parser())
    assert flags == _flags(jcli.build_parser())
    assert len(flags) == 53


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parsed_namespaces_equal(name):
    assert vars(cli.build_parser().parse_args(ARGVS[name])) == vars(jcli.build_parser().parse_args(ARGVS[name]))


class _Captured(Exception):
    pass


@pytest.fixture
def jax_cli_config(monkeypatch, tmp_path):
    """The ProblemConfig the JAX CLI builds for an argv, caught where it
    constructs its ObstacleShapeOpt; its compilation cache lands under
    tmp_path, and the JAX settings its main changes are restored."""
    def stub(cfg, *a, **kw):
        raise _Captured(cfg)

    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs", "jax_platforms",
        "jax_enable_x64")}
    monkeypatch.setattr(jobstacle, "ObstacleShapeOpt", stub)
    monkeypatch.setenv("HOME", str(tmp_path))

    def get(argv):
        with pytest.raises(_Captured) as e:
            jcli.main(argv + ["-outDir", str(tmp_path / "out")])
        return e.value.args[0]

    yield get
    for k, v in saved.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("name", ["defaults", "recipe", "3d", "numbers"])
def test_problem_config_equals_the_jax_clis(jax_cli_config, name):
    """Field by field, through convert.problem_config; without -x64 both
    apply f32_presets."""
    got = cli.problem_config(cli.build_parser().parse_args(ARGVS[name]))
    assert got == convert.problem_config(jax_cli_config(ARGVS[name]))


def test_drive_recipe_writes_the_jax_clis_files(tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main(RECIPE + ["-outDir", str(out)]) == 0
    assert "DONE: 2 accepted steps" in capsys.readouterr().out
    got = {k: np.array([r.split("\t") for r in (out / f).read_text().strip().splitlines()], float)
           for k, f in (("drag", "__Drag.txt"), ("iterations", "__Iterations_per_step.txt"))}
    want = {k: np.array([r.split("\t") for r in str(GOLDEN[k]).strip().splitlines()], float) for k in GOLDEN.files}
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    assert got["drag"].shape == want["drag"].shape == (2, 5)
    np.testing.assert_array_equal(got["drag"][:, 0], want["drag"][:, 0])
    scale = np.abs(want["drag"][:, 1]).max()
    assert np.abs(got["drag"][:, 1:] - want["drag"][:, 1:]).max() <= RECIPE_DRAG_REL * scale
    assert load_checkpoint(str(out / "checkpoint.npz"))["step"] == 1
    assert (out / "checkpoint.npz.warm.npz").exists()
    assert sorted(p.name for p in out.glob("mesh_step_*.vtu")) == ["mesh_step_0000.vtu", "mesh_step_0001.vtu"]


def test_without_x64_the_cli_takes_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-dim", "2", "-numRefs", "0", "-outDir", str(tmp_path)])


# a one-step run at 2D refs=0, visc 0.16, one attempt with a small x-update
VARIANT_ARGV = ["-dim", "2", "-numRefs", "0", "-numSteps", "1", "-visc", "0.16", "-admmSteps", "3", "-nsMaxIts", "3",
                "-tau", "2", "-x64"]


@pytest.mark.parametrize("flags", [["-b2ndOrder", "1"], ["-vorder", "1"]])
def test_unported_flags_raise(tmp_path, capsys, flags):
    """The flags that ROADMAP item 9b brought run: exit code 0, the ladder
    and the step's telemetry written."""
    assert cli.main(VARIANT_ARGV + ["-outDir", str(tmp_path)] + flags) == 0
    assert "DONE:" in capsys.readouterr().out
    assert (tmp_path / "checkpoint.npz").exists()


def test_module_entry_point_exits_nonzero_on_an_unported_flag(tmp_path):
    """python -m admm_optim_tpu_torch.cli with -b2ndOrder 1, which raised
    before ROADMAP item 9b, exits 0; an unknown choice still exits nonzero."""
    out = subprocess.run(
        [sys.executable, "-m", "admm_optim_tpu_torch.cli"] + VARIANT_ARGV + ["-b2ndOrder", "1", "-outDir",
                                                                             str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and "DONE:" in out.stdout, out.stderr[-2000:]
    bad = subprocess.run([sys.executable, "-m", "admm_optim_tpu_torch.cli", "-vorder", "3"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "-vorder" in bad.stderr
