"""parallel.sharding (the rank grid, element sharding and padding)
against the JAX package's parallel.sharding on its virtual CPU mesh
(tests/conftest.py), and parallel.launch's failure handling."""
import time

import jax
import numpy as np
import pytest
import torch

import torch_shard_ranks as R
from admm_optim_tpu.parallel import sharding as jsharding
from admm_optim_tpu_torch.parallel import launch, sharding

torch.set_num_threads(1)


def _elems(E):
    return np.arange(E * 3, dtype=np.int32).reshape(E, 3)


@pytest.mark.parametrize("E,multiple", [(10, 4), (12, 4), (7, 2), (9, 1)])
def test_pad_elements_matches_jax(E, multiple):
    got = sharding.pad_elements(_elems(E), multiple)
    want = jsharding.pad_elements(_elems(E), multiple)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("n_batch,n_space", [(1, 4), (2, 2)])
def test_shard_elements_and_replicate_match_jax(n_batch, n_space):
    """Each space index's block is the JAX package's shard of the same
    element array on the same grid; replicate keeps the whole array."""
    a, _ = sharding.pad_elements(_elems(10), n_space)
    jarr = jsharding.shard_elements(jsharding.make_mesh(n_space, n_batch), a)
    devs = np.asarray(jax.devices()[: n_batch * n_space]).reshape(n_batch, n_space)
    for b in range(n_batch):
        for s in range(n_space):
            mesh = sharding.Mesh(n_batch, n_space, b, s, None, torch.device("cpu"))
            want = next(np.asarray(sh.data) for sh in jarr.addressable_shards if sh.device == devs[b, s])
            np.testing.assert_array_equal(sharding.shard_elements(mesh, a).numpy(), want)
            np.testing.assert_array_equal(sharding.replicate(mesh, a).numpy(), a)
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_elements(sharding.Mesh(1, 4, 0, 0, None, torch.device("cpu")), _elems(10))


def test_make_mesh_grid_on_ranks():
    """A (2, 2) grid of four gloo ranks: rank r at batch r // 2, space
    r % 2; an all-reduce over its space group sums its batch row's ranks;
    its shard_elements block is its space index's."""
    a, _ = sharding.pad_elements(_elems(10), 2)
    outs = launch.spawn(R.grid_rank, 4, "gloo", "cpu", 120.0, 2, 2, a)
    for r, o in enumerate(outs):
        b, s = divmod(r, 2)
        assert (o["batch"], o["space"]) == (b, s)
        assert o["space_sum"] == float(2 * b + 2 * b + 1)
        np.testing.assert_array_equal(o["block"], a[s * 5 : (s + 1) * 5])


def test_make_mesh_refuses_a_wrong_world():
    with pytest.raises(RuntimeError, match="need 6 ranks"):
        launch.spawn(R.grid_rank, 2, "gloo", "cpu", 60.0, 3, 2, _elems(6))


def test_spawn_fails_fast_when_a_rank_raises():
    """Rank 1 raises while rank 0 waits in a collective: spawn raises with
    the rank's error long before the collectives' timeout, and leaves no
    rank running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank1: .*rank 1 fails on purpose"):
        launch.spawn(R.raising_rank, 2, "gloo", "cpu", 120.0)
    assert time.monotonic() - t0 < 60.0


def test_spawn_fails_at_its_deadline_when_a_collective_hangs():
    """Rank 1 never joins rank 0's all-reduce: the collective times out
    (or the caller's deadline passes) after timeout_s, spawn raises and
    kills the rank still sleeping."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        launch.spawn(R.hanging_rank, 2, "gloo", "cpu", 5.0)
    assert time.monotonic() - t0 < 30.0
