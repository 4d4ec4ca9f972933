"""cgrads_kernel_share and admm_cgrads_ms_per_loop on synthetic span
records, read as a run on the card reads them: the share of admm.cgrads
records inside the traced loops whose constraint gradients the kernel
computed, their summed ms a loop, and nothing read where the loops hold no
admm.cgrads record (a program without the span), where none says how it
ran, off the card, or without a loop."""
import pytest

from benchmark import harness, spans_admm

CARD = "NVIDIA H100 80GB HBM3"


def _run(kind=CARD):
    return harness.Run(config={}, traffic={}, cell={}, seed=0, device_kind=kind)


def _recs(paths, loop=True):
    """A root admm.inner (or, without a loop, a root of another name) with
    one admm.newton holding an admm.cgrads record of 2 ms per path (None:
    no path attribute) and an admm.hess after each; and one admm.cgrads
    outside the loop, which is not read."""
    recs = [dict(name="admm.cgrads", start_ns=0, end_ns=7_000_000, parent=None, request=0, attrs={"path": "plain"}),
            dict(name=spans_admm.ROOT if loop else "admm.iter", start_ns=0, end_ns=10, parent=None, request=1,
                 attrs={}),
            dict(name="admm.newton", start_ns=1, end_ns=9, parent=1, request=1, attrs={})]
    for p in paths:
        recs.append(dict(name="admm.cgrads", start_ns=1_000_000, end_ns=3_000_000, parent=2, request=1,
                         attrs={} if p is None else {"path": p}))
        recs.append(dict(name="admm.hess", start_ns=3_000_000, end_ns=4_000_000, parent=2, request=1,
                         attrs={"path": "kernel"}))
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
def test_share_of_kernel_gradients(program, paths, share):
    program(_recs(paths))
    assert harness.load_reader("cgrads_kernel_share").read(_run()) == pytest.approx(share, rel=1e-15)


def test_ms_per_loop(program):
    """17 spans of 2 ms in one loop: 34 ms; the span outside the loop and
    the admm.hess records are not counted."""
    program(_recs(["kernel"] * 17))
    assert harness.load_reader("admm_cgrads_ms_per_loop").read(_run()) == pytest.approx(34.0, rel=1e-15)


def test_nothing_read_without_the_span_or_the_attribute(program):
    """A program without admm.cgrads spans in its loops (the parent of the
    kernel) reads nothing for either metric, not 0; spans without the path
    attribute read no share."""
    program([r for r in _recs(["kernel"] * 17) if r["name"] != "admm.cgrads" or r["parent"] is None])
    assert harness.load_reader("admm_cgrads_ms_per_loop").read(_run()) is None
    assert harness.load_reader("cgrads_kernel_share").read(_run()) is None
    program(_recs([None] * 17))
    assert harness.load_reader("cgrads_kernel_share").read(_run()) is None


@pytest.mark.parametrize("name", ["cgrads_kernel_share", "admm_cgrads_ms_per_loop"])
def test_nothing_read_off_the_card_or_without_a_loop(program, name):
    reader = harness.load_reader(name)
    program(_recs(["kernel"] * 4))
    assert reader.read(_run("cpu")) is None and reader.read(_run("")) is None
    program(_recs(["kernel"] * 4, loop=False))
    assert reader.read(_run()) is None
