"""Start ranks of a torch.distributed group and collect what they return.

    results = spawn(fn, 2, "gloo", "cuda", 120.0, *args)

runs ``fn(rank, world_size, device, *args)`` in ``nprocs`` fresh
processes (the ``spawn`` start method: the caller may have initialised
CUDA), each a member of one process group created from a file in a
temporary directory, not from a TCP port, so that runs started at once
never collide.  ``fn`` must be importable by its module path, and its
arguments and return value picklable.  The group's collectives time out
after ``timeout_s``, and the caller gives up on the ranks at the same
deadline, killing those still running; a rank that raises fails the
caller with its traceback.  On a CUDA device every rank runs on card 0 and
the kernel library is built in the caller before any rank starts.
"""
from __future__ import annotations

import datetime
import pathlib
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, nprocs, backend, device, timeout_s, tmp, args):
    torch.set_num_threads(1)  # ranks share the host's cores
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/init", rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        out = fn(rank, nprocs, device, *args)
    except BaseException:
        # the caller reports every rank's error: the first rank to fail may
        # be one whose peer failed first
        (pathlib.Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    torch.save(out, pathlib.Path(tmp) / f"rank{rank}.pt")


def spawn(fn, nprocs: int, backend: str, device, timeout_s: float, *args) -> list:
    """fn's return value on each rank, in rank order."""
    if torch.device(device).type == "cuda":
        from .. import _build

        _build.build()  # two ranks must not race to compile the library
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, backend, str(device), timeout_s, tmp, args), nprocs=nprocs,
            join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__qualname__} still running after {timeout_s} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errors = sorted(pathlib.Path(tmp).glob("rank*.err"))
            raise RuntimeError(f"{fn.__qualname__} failed on {len(errors)} of {nprocs} ranks:\n"
                               + "\n".join(f"{f.stem}: {f.read_text()}" for f in errors)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(pathlib.Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]
