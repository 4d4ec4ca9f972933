"""Checkpoint/resume for optimization runs.

The reference's ``-restart`` flag is vestigial (it only gates initial VTK
output, 3d_admm.lua:761-768; SaveToFile is commented out at 3d_admm.lua:1392)
- real checkpointing is one of the rebuild's additions (SURVEY.md section 5).
State saved: mesh coordinates, NS state, sigma/scaling, step counter, drag
history.  npz-based (self-contained, no service deps); orbax can be layered
on top for multi-host async checkpointing.

The port's copy of admm_optim_tpu/io/checkpoint.py, the same npz keys, so
a checkpoint written by either package loads in the other.  It takes host
arrays: np.asarray of a CUDA tensor raises, so ObstacleShapeOpt.run hands it
``t.detach().cpu().numpy()``.
"""
from __future__ import annotations

import os

import numpy as np


def save_checkpoint(path: str, *, step: int, X, s, sigma: float, drag_old: float, extra=None):
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        step=step,
        X=np.asarray(X),
        s=np.asarray(s),
        sigma=sigma,
        drag_old=drag_old,
        **(extra or {}),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] if z[k].ndim else z[k].item() for k in z.files}
