"""The traffic's pools repeat by seed, differ between seeds, keep their
sizes and are zero where masked."""
import torch

from benchmark import pools

KEEP = torch.tensor([True, False, True, True, False, True] * 50)
TRAFFIC = {"pool": {"size": 8, "distribution": "normal", "scale": 1.0}}


def test_same_seed_same_pool():
    big = 2**31 + 12345
    a = pools.pool_from_traffic(big, TRAFFIC, 3, KEEP)
    b = pools.pool_from_traffic(big, TRAFFIC, 3, KEEP)
    assert torch.equal(a, b) and a.shape == (8, 3, KEEP.numel())


def test_seeds_differ_sizes_do_not():
    a = pools.pool_from_traffic(1, TRAFFIC, 3, KEEP)
    b = pools.pool_from_traffic(2, TRAFFIC, 3, KEEP)
    assert a.shape == b.shape and not torch.equal(a, b)


def test_masked_and_scaled():
    a = pools.masked_normal(7, 4, 3, KEEP, scale=0.01)
    assert torch.all(a[:, :, ~KEEP] == 0)
    assert 0.005 < float(a[:, :, KEEP].std()) < 0.02
    assert torch.equal(a, pools.masked_normal(7, 4, 3, KEEP) * 0.01)


def test_huge_and_negative_seeds():
    for seed in (2**40 + 3, -5, 2**64 + 1):
        assert torch.equal(pools.masked_normal(seed, 2, 3, KEEP), pools.masked_normal(seed, 2, 3, KEEP))
