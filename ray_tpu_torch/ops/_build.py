"""Build and load the port's CUDA kernels.

The source under ``csrc/`` exposes a plain C interface, so it is
compiled by ``nvcc`` straight into a shared library and bound with
`ctypes` (no PyTorch headers, so a build takes seconds, not minutes).
The library is built at first use into ``ray_tpu_torch/_build/`` (listed
in ``.gitignore``), named by a hash of its source and flags, so an edited
source rebuilds and an unchanged one loads from disk.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` (the CPU tests), and only a CUDA tensor reaching a
kernel wrapper calls `load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> (argtypes, restype) of every C entry point the wrappers call.
SIGNATURES = {
    "rtt_paged_decode": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _I, _P], _I),
    "rtt_paged_mq": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                      _I, _P], _I),
    "rtt_error_string": ([_I], ctypes.c_char_p),
}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH); the port's kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernel source (if its library is not on disk yet);
    returns the library path and nvcc's ptxas report (empty when
    cached)."""
    src = SOURCE
    out = _lib_path(src)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a half-written .so is never loaded
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point's
    ctypes signature declared (pointers and the stream as ``c_void_p``,
    so 64-bit addresses are never cut to ``int``)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = load().rtt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
