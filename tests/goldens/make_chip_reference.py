"""Make tests/goldens/chip_pcd_ladder_refs1.npz, the reference that
chip_smoke.py holds the card's refs=1 PCD ladder to: the port's own refs=1
PCD ladder to visc 0.02 with drag, adjoint and J', float64 on the CPU with
the float32 presets (chip_smoke.small_reference).  Needs no card and no
JAX; takes minutes on the CPU.  Run from the repository root:

    python tests/goldens/make_chip_reference.py
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    t0 = time.perf_counter()
    ref = chip_smoke.small_reference()
    np.savez_compressed(chip_smoke.SMALL_REFERENCE, **ref)
    print(f"wrote {chip_smoke.SMALL_REFERENCE} in {time.perf_counter() - t0:.1f} s: rungs {ref['nu'].tolist()}, "
          f"Newton {ref['newton'].tolist()}, linear {ref['lin'].tolist()}, drag {float(ref['drag']):.10g}, "
          f"adjoint {int(ref['adjoint_iters'])} ({ref['adjoint_exit']}), |J'| {float(ref['jprime_norm']):.6e}")


if __name__ == "__main__":
    main()
