"""Native (C++) runtime components of the port, built at first use with
the host's ``g++``.

`store.cc` (the shared-memory arena, copied from the JAX package's) is
compiled into ``ray_tpu_torch/_build/`` under a file lock, named by the
hash of its source and flags, so concurrent first users build it once and
a stale library is never loaded. The port never loads the JAX package's
``libstore.so``.

``RAY_TPU_DISABLE_NATIVE=1`` is the explicit switch to the file-backed
store. Without it a failed build raises and names the compiler's error:
the store does not fall back without a word.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_BUILD_LOCK = threading.Lock()


class NativeCompileError(RuntimeError):
    """The native extension did not compile (the compiler's output is the
    message)."""


def native_disabled() -> bool:
    return os.environ.get("RAY_TPU_DISABLE_NATIVE", "") == "1"


def library_path(name: str) -> str:
    """``_build/lib<name>-<hash>.so``: the hash covers the source and the
    flags, so an edited source never loads an old build."""
    with open(os.path.join(_DIR, name + ".cc"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_extension(name: str) -> str:
    """Compile ``<name>.cc`` unless its library exists; returns the path.
    Raises `NativeCompileError` when the compiler fails or is missing."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _BUILD_LOCK:
        fd = os.open(os.path.join(BUILD_DIR, f"lib{name}.lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)   # across processes
            if os.path.exists(out):
                return out                   # another process built it
            tmp = f"{out}.tmp.{os.getpid()}"
            try:
                proc = subprocess.run(
                    ["g++", *FLAGS, "-o", tmp,
                     os.path.join(_DIR, name + ".cc"), "-lpthread"],
                    capture_output=True, text=True, timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                raise NativeCompileError(
                    f"building {name}.cc with g++ failed: {e!r} (set "
                    "RAY_TPU_DISABLE_NATIVE=1 for the file store)") from e
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise NativeCompileError(
                    f"g++ failed on {name}.cc (exit {proc.returncode}; set "
                    "RAY_TPU_DISABLE_NATIVE=1 for the file store):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)   # atomic: a half-written .so never loads
            return out
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)
