"""Build and load the hand-written CUDA kernels (csrc/stencil.cu).

The source is compiled with nvcc for sm_90a (Hopper) into
``_build/libstencil.so``, a shared library with a plain C interface that is
loaded with ctypes: no PyTorch headers, so a build takes seconds.  A stamp
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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

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
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
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
    for name, n_ptr in (
        ("apply_w_sym_f32", 4),
        ("apply_w_pencil_bf16", 4),
        ("apply_w_df_sym_f32", 6),
    ):
        fn = getattr(handle, name)
        # pointers..., n_slots, n0, n1, n2, P, device, stream
        fn.argtypes = [p] * n_ptr + [i] * 6 + [p]
        fn.restype = i
    handle.stencil_error_string.argtypes = [i]
    handle.stencil_error_string.restype = ctypes.c_char_p
    _lib = handle
    return _lib


def error_string(err: int) -> str:
    return f"{err} ({lib().stencil_error_string(err).decode()})"
