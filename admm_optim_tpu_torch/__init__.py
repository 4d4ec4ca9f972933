"""admm_optim_tpu_torch: the PyTorch/CUDA port of admm_optim_tpu.

Mirrors the JAX package's module paths and function names; the JAX package
stays the reference that every module here is tested against.  Nothing in
this package imports JAX (the GPU machines have none).
"""

import torch as _torch

# TF32 keeps ~3 decimal digits: a float32 matmul or convolution running on
# it leaves a ~1e-2 relative noise floor under every Krylov loop (the same
# trap the JAX package pins "highest" matmul precision against,
# admm_optim_tpu/__init__.py:5-11).  Force full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device=None) -> "_torch.device":
    """The device an entry point runs on: the card unless the caller names
    another one.  ``None`` means ``cuda`` and raises when there is none; it
    never falls back to the CPU (the tests ask for ``"cpu"``)."""
    if device is not None:
        return _torch.device(device)
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on the GPU by default; pass device='cpu' to run "
            "the plain PyTorch forms on the CPU"
        )
    return _torch.device("cuda")
