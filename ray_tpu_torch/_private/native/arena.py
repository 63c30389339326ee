"""ctypes client for the native shared-memory arena store (store.cc),
copied from `ray_tpu/_private/native/arena.py` against the port's own
build of `store.cc` (`ray_tpu_torch/_build/`).

A plasma-style client (`plasma/client.h`): create →
write payload → seal; lookup returns a zero-copy memoryview into this
process's mapping of the arena. One arena per session lives at
`<session_dir>/arena.shm`; creation is serialized across processes with an
flock'd sidecar file so exactly one process initializes the header.
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap
import os

from ray_tpu_torch._private import native as _native


def _default_capacity() -> int:
    # re-resolved per open (not the import-time constant): arena creation
    # happens after process start, and tests/operators set the override in
    # an already-running process
    from ray_tpu_torch._private import config, constants  # noqa: F401
    v = config.get("OBJECT_STORE_BYTES")
    if v:
        return v
    # auto: 20% of system RAM, min 512 MiB — tmpfs-backed and sparse, so
    # the file costs only the pages actually written
    try:
        pages = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return max(512 << 20, int(pages * 0.20))
    except (ValueError, OSError):
        return 512 << 20


class _Lib:
    """Lazily-loaded libstore with typed signatures."""
    _instance = None

    def __init__(self, path: str):
        self.path = path
        lib = ctypes.CDLL(path)
        lib.rts_open.restype = ctypes.c_void_p
        lib.rts_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.rts_close.argtypes = [ctypes.c_void_p]
        lib.rts_create.restype = ctypes.c_uint64
        lib.rts_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
        lib.rts_seal.restype = ctypes.c_int
        lib.rts_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_lookup.restype = ctypes.c_uint64
        lib.rts_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
        lib.rts_contains.restype = ctypes.c_int
        lib.rts_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_delete.restype = ctypes.c_int
        lib.rts_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_pin.restype = ctypes.c_int
        lib.rts_pin.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.rts_acquire.restype = ctypes.c_uint64
        lib.rts_acquire.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_uint64)]
        lib.rts_poisoned.restype = ctypes.c_int
        lib.rts_poisoned.argtypes = [ctypes.c_void_p]
        lib.rts_evict.restype = ctypes.c_uint64
        lib.rts_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rts_release_all.restype = ctypes.c_uint64
        lib.rts_release_all.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.rts_stats.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint64)]
        self.lib = lib

    @classmethod
    def get(cls):
        """The loaded library (built at first use); a failed build
        raises."""
        if cls._instance is None:
            cls._instance = cls(_native.build_extension("store"))
        return cls._instance


def loaded_library() -> str | None:
    """Path of the libstore this process loaded, or None."""
    return _Lib._instance.path if _Lib._instance is not None else None


class Arena:
    """Per-process handle to the session arena: use
    Arena.open(session_dir), which returns None when native is switched
    off and raises when the library does not build or the arena file
    cannot be opened."""

    def __init__(self, lib: _Lib, handle: int, path: str):
        self._lib = lib.lib
        self._h = handle
        self._path = path
        stats = (ctypes.c_uint64 * 6)()
        self._lib.rts_stats(self._h, stats)
        self._map_len = stats[5]
        # Map the arena once in this process for zero-copy reads/writes.
        # ctypes gives us the .so's mapping base; re-deriving a Python
        # memoryview needs our own mmap of the same file.
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, self._map_len)
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)

    @classmethod
    def open(cls, session_dir: str,
             capacity: int | None = None) -> "Arena | None":
        if _native.native_disabled():
            return None      # the switch is read at every open
        if capacity is None:
            capacity = _default_capacity()
        lib = _Lib.get()
        path = os.path.join(session_dir, "arena.shm")
        lockpath = path + ".lock"
        lock_fd = os.open(lockpath, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
            handle = lib.lib.rts_open(path.encode(), capacity, 1)
        finally:
            fcntl.flock(lock_fd, fcntl.LOCK_UN)
            os.close(lock_fd)
        if not handle:
            raise OSError(f"could not open the native arena at {path}")
        return cls(lib, handle, path)

    # -- plasma-style verbs --------------------------------------------------

    def create(self, object_id: str, size: int) -> memoryview | None:
        """Reserve `size` bytes; returns a writable view or None if full."""
        off = self._lib.rts_create(self._h, object_id.encode(), size)
        if off == 0:
            return None
        return self._view[off:off + size]

    def seal(self, object_id: str) -> bool:
        return self._lib.rts_seal(self._h, object_id.encode()) == 0

    def lookup(self, object_id: str) -> memoryview | None:
        """Zero-copy read view of a sealed object, or None if absent."""
        size = ctypes.c_uint64()
        off = self._lib.rts_lookup(self._h, object_id.encode(),
                                   ctypes.byref(size))
        if off == 0:
            return None
        return self._view[off:off + size.value].toreadonly()

    def acquire(self, object_id: str) -> memoryview | None:
        """Pin + zero-copy read view, atomically: the returned view stays
        valid even if the object is later deleted (block is condemned, not
        freed, until the pin is released)."""
        size = ctypes.c_uint64()
        off = self._lib.rts_acquire(self._h, object_id.encode(),
                                    ctypes.byref(size))
        if off == 0:
            return None
        return self._view[off:off + size.value].toreadonly()

    def acquire_mapped(self, object_id: str):
        """Pin + zero-copy view over a DEDICATED per-object mmap.

        Buffer exports from deserialized consumers (numpy arrays etc.)
        land on the underlying exporter object. With the shared arena
        map, that exporter is one mmap for every object, so nothing can
        tell whose bytes are still borrowed; with a per-object mmap,
        `mmap.close()` raising BufferError is a precise
        "still-borrowed" probe, which the store's free path uses to keep
        the pin (condemning the block) instead of letting the allocator
        reuse bytes underneath live zero-copy arrays.

        Returns (mmap, view) or (None, None).
        """
        size = ctypes.c_uint64()
        off = self._lib.rts_acquire(self._h, object_id.encode(),
                                    ctypes.byref(size))
        if off == 0:
            return None, None
        page = mmap.ALLOCATIONGRANULARITY
        base = (off // page) * page
        delta = off - base
        try:
            fd = os.open(self._path, os.O_RDONLY)
            try:
                m = mmap.mmap(fd, delta + size.value, offset=base,
                              access=mmap.ACCESS_READ)
            finally:
                os.close(fd)
        except Exception:
            # rts_acquire already pinned the block; failing to map must
            # not leak the pin (a leaked pin condemns the block forever).
            self._lib.rts_pin(self._h, object_id.encode(), -1)
            raise
        return m, memoryview(m)[delta:delta + size.value]

    def poisoned(self) -> bool:
        return self._lib.rts_poisoned(self._h) == 1

    def contains(self, object_id: str) -> bool:
        return self._lib.rts_contains(self._h, object_id.encode()) == 1

    def delete(self, object_id: str) -> bool:
        return self._lib.rts_delete(self._h, object_id.encode()) == 0

    def pin(self, object_id: str, delta: int = 1) -> int:
        return self._lib.rts_pin(self._h, object_id.encode(), delta)

    def evict(self, nbytes: int) -> int:
        return self._lib.rts_evict(self._h, nbytes)

    def release_all(self, pid: int) -> int:
        """Force-release every pin a (dead) process holds and reclaim its
        unsealed creations; returns slots touched. The plasma
        disconnected-client-release analog."""
        return self._lib.rts_release_all(self._h, pid)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 6)()
        self._lib.rts_stats(self._h, out)
        return {"capacity": out[0], "used": out[1], "num_objects": out[2],
                "num_evictions": out[3]}

    def close(self) -> None:
        if self._h:
            try:
                self._view.release()
                self._mm.close()
            except BufferError:
                pass  # live object views reference the map; dies with process
            self._lib.rts_close(self._h)
            self._h = 0
