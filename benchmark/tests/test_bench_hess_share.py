"""hess_kernel_share on synthetic span records, read as a run on the card
reads them: the share of admm.hess records inside the traced loops whose
Hessian the kernel assembled, and nothing read where no assembly says how
it ran, off the card, or without a loop."""
import pytest

from benchmark import harness, spans_admm

CARD = "NVIDIA H100 80GB HBM3"


def _run(kind=CARD):
    return harness.Run(config={}, traffic={}, cell={}, seed=0, device_kind=kind)


def _recs(paths, loop=True):
    """A root admm.inner (or, without a loop, a root of another name) with
    one admm.newton holding an admm.hess record per path (None: no path
    attribute) and a host.sync after each; and one admm.hess outside the
    loop, which is not read."""
    recs = [dict(name="admm.hess", start_ns=0, end_ns=1, parent=None, request=0, attrs={"path": "plain"}),
            dict(name=spans_admm.ROOT if loop else "admm.iter", start_ns=0, end_ns=10, parent=None, request=1,
                 attrs={}),
            dict(name="admm.newton", start_ns=1, end_ns=9, parent=1, request=1, attrs={})]
    for p in paths:
        recs.append(dict(name="admm.hess", start_ns=1, end_ns=2, parent=2, request=1,
                         attrs={} if p is None else {"path": p}))
        recs.append(dict(name="host.sync", start_ns=2, end_ns=3, parent=2, request=1, attrs={}))
    return recs


@pytest.fixture
def program(monkeypatch):
    from admm_optim_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "spans", lambda: recs)

    return use


@pytest.mark.parametrize("paths, share", [
    (["kernel"] * 17, 1.0),
    (["plain"] * 3 + ["kernel"] * 14, 14 / 17),
    (["plain"] * 17, 0.0),
])
def test_share_of_kernel_assemblies(program, paths, share):
    program(_recs(paths))
    assert harness.load_reader("hess_kernel_share").read(_run()) == pytest.approx(share, rel=1e-15)


def test_nothing_read_without_the_attribute(program):
    """A program whose assemblies carry no path attribute (the parent of
    the kernel) reads nothing, not 0."""
    program(_recs([None] * 17))
    assert harness.load_reader("hess_kernel_share").read(_run()) is None


def test_nothing_read_off_the_card_or_without_a_loop(program):
    reader = harness.load_reader("hess_kernel_share")
    program(_recs(["kernel"] * 4))
    assert reader.read(_run("cpu")) is None and reader.read(_run("")) is None
    program(_recs(["kernel"] * 4, loop=False))
    assert reader.read(_run()) is None
