"""vcycle_replay_share on synthetic span records, read as a run on the card
reads them: the share of mg.vcycle records replayed from a CUDA graph, and
nothing read where no cycle says how it ran, off the card, or without a
root."""
import pytest

from benchmark import harness, spans

CARD = "NVIDIA H100 80GB HBM3"


def _run(kind=CARD):
    return harness.Run(config={}, traffic={}, cell={}, seed=0, device_kind=kind)


def _recs(modes, root=True):
    """A root xupdate.solve with one mg.vcycle record per mode (None: no
    graph attribute), each with an mg.smooth inside where it ran eagerly."""
    recs = [dict(name=spans.ROOT, start_ns=0, end_ns=10, parent=None, request=0, attrs={})] if root else []
    for m in modes:
        recs.append(dict(name="mg.vcycle", start_ns=1, end_ns=2, parent=0, request=0,
                         attrs={} if m is None else {"graph": m}))
        if m != "replay":
            recs.append(dict(name="mg.smooth", start_ns=1, end_ns=2, parent=len(recs) - 1, request=0,
                             attrs={"level": 1}))
    return recs


@pytest.fixture
def program(monkeypatch):
    from admm_optim_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "spans", lambda: recs)

    return use


@pytest.mark.parametrize("modes, share", [
    (["eager", "capture"] + ["replay"] * 20, 20 / 22),
    (["replay"] * 22, 1.0),
    (["eager"] * 22, 0.0),
])
def test_share_of_replayed_cycles(program, modes, share):
    program(_recs(modes))
    assert harness.load_reader("vcycle_replay_share").read(_run()) == pytest.approx(share, rel=1e-15)


def test_nothing_read_without_the_attribute(program):
    """A program whose cycles carry no graph attribute (the parent of the
    CUDA graphs) reads nothing, not 0."""
    program(_recs([None] * 22))
    assert harness.load_reader("vcycle_replay_share").read(_run()) is None


def test_nothing_read_off_the_card_or_without_a_root(program):
    reader = harness.load_reader("vcycle_replay_share")
    program(_recs(["replay"] * 4))
    assert reader.read(_run("cpu")) is None and reader.read(_run("")) is None
    program(_recs(["replay"] * 4, root=False))
    assert reader.read(_run()) is None
