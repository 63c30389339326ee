"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` (``*.cu``) exposes a plain C interface, so
each is compiled by ``nvcc`` straight into a shared library of its own
and bound with `ctypes` (no PyTorch headers, so a build takes seconds,
not minutes). The headers beside them (``*.cuh``) hold device code that
several sources include. The libraries are built at first use into
``ray_tpu_torch/_build/`` (listed in ``.gitignore``), each named by a
hash of its own source, the headers and the flags, so an edited source
or header rebuilds and an unchanged one loads from disk. Sources that
need building are compiled in parallel, one ``nvcc`` process each, all
started together.

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
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> (argtypes, restype) of every C entry point the wrappers call.
SIGNATURES = {
    "rtt_paged_decode": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _F, _I, _P], _I),
    "rtt_paged_mq": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                      _P], _I),
    "rtt_paged_mq_tc": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _F, _P], _I),
    "rtt_decode": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], _I),
    "rtt_error_string": ([_I], ctypes.c_char_p),
    "rtt_flash_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
                      _I),
    "rtt_flash_fwd_tc": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
                         _I),
    "rtt_flash_dq": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                      _I, _P], _I),
    "rtt_flash_dkv": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                       _I, _I, _P], _I),
    "rtt_flash_dq_tc": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                         _P], _I),
    "rtt_flash_dkv_tc": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                          _I, _P], _I),
    "rtt_xent_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "rtt_xent_fwd_tc": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "rtt_xent_fwd_merge": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "rtt_xent_dx": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "rtt_xent_de": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "rtt_xent_dlog": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P], _I),
    "rtt_xent_dx_tc": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "rtt_xent_de_tc": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH); the port's kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> tuple[list[Path], str]:
    """Compile every kernel source whose library is not on disk yet, all
    at once; returns the library paths (one per source) and nvcc's
    ptxas reports (empty for libraries loaded from disk)."""
    todo = {}
    for src in sources():
        out = _lib_path(src)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            todo[src] = (proc, tmp, out)
    reports, failed = [], []
    for src, (proc, tmp, out) in todo.items():
        log = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)   # atomic: a half-written .so is never loaded
            reports.append(log)
        else:
            failed.append(f"nvcc failed on {src.name}:\n{log}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_lib_path(s) for s in sources()], "".join(reports)


@functools.cache
def load() -> types.SimpleNamespace:
    """Every C entry point of every kernel library (built on first call),
    as attributes, each with its ctypes signature declared (pointers and
    the stream as ``c_void_p``, so 64-bit addresses are never cut to
    ``int``)."""
    paths, _ = build()
    libs = [ctypes.CDLL(str(p)) for p in paths]
    fns = {}
    for name, (argtypes, restype) in SIGNATURES.items():
        found = [lib for lib in libs if hasattr(lib, name)]
        if len(found) != 1:
            raise RuntimeError(f"entry point {name} is in {len(found)} "
                               "kernel libraries, want exactly one")
        fn = getattr(found[0], name)
        fn.argtypes = argtypes
        fn.restype = restype
        fns[name] = fn
    return types.SimpleNamespace(**fns)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = load().rtt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
