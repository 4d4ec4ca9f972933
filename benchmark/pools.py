"""Traffic generators: the pools of inputs a mix cycles through, made from
the run's seed in a few large calls on the device.

A pool is ``size`` fields of ``comps`` components on the mesh's vertices,
normal, zero on the masked vertices, times ``scale``: the right-hand sides
of the IR solve (scale 1), as bench.py makes them.  Every seed gives the
same sizes; only the values differ.  The same seed on the same kind of device gives
the same pool, so the reference can make it again once the window has
closed.
"""
from __future__ import annotations

import torch

SEED_MODULUS = 2**64


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % SEED_MODULUS)
    return gen


def masked_normal(seed: int, size: int, comps: int, keep: torch.Tensor, scale: float = 1.0,
                  dtype=torch.float32) -> torch.Tensor:
    """(size, comps, V) normal values from seed, zero where keep (V,) is
    False, times scale, in dtype on keep's device."""
    gen = generator(seed, keep.device)
    pool = torch.randn((size, comps, keep.shape[0]), generator=gen, device=keep.device, dtype=dtype)
    pool.mul_(keep.to(dtype))
    if scale != 1.0:
        pool.mul_(scale)
    return pool


def pool_from_traffic(seed: int, traffic: dict, comps: int, keep: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The pool a traffic file's ``pool`` block describes."""
    spec = traffic["pool"]
    if spec["distribution"] != "normal":
        raise ValueError(f"unknown pool distribution {spec['distribution']!r}")
    return masked_normal(seed, int(spec["size"]), comps, keep, float(spec["scale"]), dtype)
