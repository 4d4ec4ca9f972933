"""Fault-tolerant run loop: retry-from-checkpoint around the outer loop.

The port of admm_optim_tpu/io/resume.py.  The reference has no counterpart
(its ``-restart`` flag is vestigial, 3d_admm.lua:761-768): long runs can
die mid-step on a device fault, and the checkpoint written after every
accepted step lets the run continue instead of starting over.  Because the
checkpoint also carries the accepted-step history, the telemetry files
(``__Drag.txt`` etc.) stay contiguous across restarts.  A restart builds
the model anew on the same device; it never moves the run to the CPU.
"""
from __future__ import annotations

import os
import time
import traceback

import torch

from .checkpoint import load_checkpoint


def resumable_run(
    build_model,
    checkpoint_path: str,
    max_restarts: int = 10,
    resume: dict | None = None,
    restart_delay_s: float = 5.0,
    **run_kwargs,
):
    """Run ``build_model().run(...)`` with retry-from-checkpoint.

    build_model: zero-arg callable returning a fresh ObstacleShapeOpt -
    called again after a fault so that every device buffer is rebuilt; the
    card's cached blocks are released between attempts.
    resume: optional initial resume state (e.g. from an earlier process).
    Remaining kwargs go to ObstacleShapeOpt.run.  After max_restarts
    faults the last one is raised.

    Returns the FULL history (restored + new accepted steps).
    """
    attempt = 0
    while True:
        model = build_model()
        try:
            return model.run(
                resume=resume, checkpoint_path=checkpoint_path, **run_kwargs
            )
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 - device faults surface as
            # various RuntimeError subclasses
            traceback.print_exc()
            attempt += 1
            if attempt > max_restarts:
                raise
            on_card = getattr(model, "device", torch.device("cpu")).type == "cuda"
            del model
            if on_card:
                torch.cuda.empty_cache()
            has_ckpt = os.path.exists(checkpoint_path)
            print(
                f"[resumable_run] run failed ({type(e).__name__}: {e}); "
                f"restart {attempt}/{max_restarts} "
                + (f"from {checkpoint_path}" if has_ckpt else "from scratch")
            )
            time.sleep(restart_delay_s)
            # no checkpoint yet (fault during the cold start): retry from
            # scratch rather than giving up
            resume = load_checkpoint(checkpoint_path) if has_ckpt else None
