"""Build and load the hand-written CUDA kernels (csrc/stencil.cu).

The source is compiled with nvcc for sm_90a (Hopper) into
``_build/libstencil.so``, a shared library with a plain C interface that is
loaded with ctypes: no PyTorch headers, so a build takes seconds.  It is
compiled once per part of its entry points (-DSTENCIL_PART, PARTS of them,
each holding some of the kernels' instantiations), all at once, and the
objects are linked.  A stamp
file holds the source's SHA-256; the library is rebuilt when it changes.
Nothing is built at import: the first kernel launch, or ``build()``, does
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "stencil.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libstencil.so"
_STAMP = BUILD_DIR / "libstencil.sha256"
# flags of a one-step build of the whole source into a library
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
PARTS = 3  # csrc/stencil.cu's STENCIL_PART values

_lib = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def _source_hash() -> str:
    return hashlib.sha256(SOURCE.read_bytes()).hexdigest()


def build() -> tuple[float, str]:
    """Compile the kernels unless an up-to-date library exists.  Returns
    (seconds spent compiling, nvcc's output including the -Xptxas -v
    register report); (0.0, "") when the library was current."""
    digest = _source_hash()
    if LIBRARY.exists() and _STAMP.exists() and _STAMP.read_text() == digest:
        return 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    objs = [BUILD_DIR / f"stencil.{k}.{os.getpid()}.o" for k in range(1, PARTS + 1)]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    cmds = [[nvcc(), *compile_flags, f"-DSTENCIL_PART={k}", "-o", str(o), str(SOURCE)]
            for k, o in enumerate(objs, 1)]
    cmds.append([nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])
    t0 = time.perf_counter()
    try:
        parts = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        runs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, parts)]
        if all(rc == 0 for _, _, rc in runs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            runs.append((cmds[-1], link.stdout + link.stderr, link.returncode))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(out for _, out, _ in runs)
    for cmd, out, rc in runs:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, LIBRARY)
    _STAMP.write_text(digest)
    return seconds, log


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    handle = ctypes.CDLL(str(LIBRARY))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr, n_int in (
        # pointers (the last one the slot table in host memory, 15 x 4
        # ints), n0, n1, n2, P, [lanes | threads,] device, stream
        ("apply_w_df_sym_f32", 6, 5),
        ("apply_w_pencil_bf16", 4, 6),
        ("apply_w_sym_lanes_f32", 4, 6),
        ("apply_w_scalar_f32", 4, 6),
        ("apply_w_c3_f32", 4, 5),
        ("launch_empty", 0, 1),
    ):
        fn = getattr(handle, name)
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = i
    handle.stencil_error_string.argtypes = [i]
    handle.stencil_error_string.restype = ctypes.c_char_p
    _lib = handle
    return _lib


def error_string(err: int) -> str:
    return f"{err} ({lib().stencil_error_string(err).decode()})"
