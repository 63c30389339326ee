"""Shared-memory object store ("plasma-lite"), copied from
`ray_tpu/_private/object_store.py` and trimmed to one machine (the port
imports nothing of `ray_tpu`).

One node-local store holding immutable serialized objects that any
process on the host can map zero-copy:

- The hot path is the native C++ arena (`_private/native/store.cc`:
  boundary-tag allocator + object index in one shm mapping) reached via
  the ctypes client in `_private/native/arena.py`. Objects put by the
  runtime are pinned so LRU eviction only reclaims explicitly released
  space; lifetime is owner-driven via `delete`.
- With ``RAY_TPU_DISABLE_NATIVE=1``, or when the arena is full, objects go
  to one file per object under the port's spill root on real disk — same
  put/get/delete verbs, so callers never see the difference. `backend`
  says which of the two the store took ("native" or "file").
- Small objects never touch the store; they ride inline in control
  messages.

Any process may create an object (workers write results directly); the
*directory* of which objects exist lives with the driver's node
(ownership, reference count).
"""

import mmap
import os
import shutil
import threading
from dataclasses import dataclass

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.constants import INLINE_OBJECT_MAX_BYTES
from ray_tpu_torch.exceptions import ObjectLostError


@dataclass(frozen=True)
class Descriptor:
    """Location of a sealed object's bytes: inline, arena, or file-backed."""
    object_id: str
    size: int
    inline: bytes | None = None  # set iff the object is small
    path: str | None = None      # set iff the object lives in a spill file
    arena: bool = False          # set iff the object lives in the shm arena


class ObjectStore:
    """Per-process handle to the session's object store."""

    def __init__(self, session_dir: str):
        # Arena-overflow objects (and every store-backed object under
        # RAY_TPU_DISABLE_NATIVE=1) go to real disk, not tmpfs, so shm
        # usage stays bounded by the arena capacity. Paths are absolute in
        # descriptors, so any local process can read another's files.
        from ray_tpu_torch._private.config import get as _cfg
        base = os.path.basename(session_dir.rstrip("/"))
        self._spill_dir = os.path.join(_cfg("TORCH_OBJECT_SPILL_ROOT"), base)
        # Keep mmaps alive while deserialized views may reference them.
        # obj_id -> mmap for file-backed objects only.
        self._maps: dict[str, mmap.mmap] = {}
        self._lock = threading.Lock()
        from ray_tpu_torch._private.native.arena import Arena
        self._arena = Arena.open(session_dir)
        # object_id -> (per-object mmap, view) handed to zero-copy
        # deserialization; the mmap is the buffer exporter, so close()
        # raising BufferError detects live borrowers at free time
        self._mviews: dict[str, tuple] = {}
        # object_id -> mmaps still borrowed when the object was freed;
        # one arena pin is held per entry (block condemned) until a
        # later sweep finds the borrowers gone. A list because an
        # object id can be reused and condemned again before the first
        # incarnation's borrowers die.
        self._condemned: dict[str, list] = {}
        # ids this process put (and therefore owner-pinned)
        self._owned: set[str] = set()

    @property
    def backend(self) -> str:
        """"native" (the shared-memory arena) or "file" (native switched
        off with RAY_TPU_DISABLE_NATIVE=1)."""
        return "native" if self._arena is not None else "file"

    # -- write path ---------------------------------------------------------

    def put(self, object_id: str, value) -> Descriptor:
        """Serialize `value`; small -> inline descriptor, large -> shm arena
        (native) with per-object file fallback."""
        size, meta, buffers = serialization.serialized_size(value)
        if size <= INLINE_OBJECT_MAX_BYTES:
            out = bytearray(size)
            n = serialization.write_envelope(memoryview(out), meta, buffers)
            return Descriptor(object_id, n, inline=bytes(out[:n]))
        if self._arena is not None:
            buf = self._arena.create(object_id, size)
            if buf is not None:
                try:
                    n = serialization.write_envelope(buf, meta, buffers)
                except BaseException:
                    # reclaim the reservation or it leaks for the session
                    self._arena.delete(object_id)
                    raise
                # pin BEFORE sealing: a sealed unpinned object is a valid
                # LRU-eviction victim for a concurrent out-of-space create
                self._arena.pin(object_id, 1)
                self._arena.seal(object_id)
                with self._lock:
                    self._owned.add(object_id)
                return Descriptor(object_id, n, arena=True)
        path = self._spill_path(object_id)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "wb+") as f:
            f.truncate(size)
            with mmap.mmap(f.fileno(), size) as m:
                n = serialization.write_envelope(memoryview(m), meta, buffers)
        if n != size:
            with open(tmp, "rb+") as f:
                f.truncate(n)
        os.rename(tmp, path)  # atomic seal: object visible only when complete
        return Descriptor(object_id, n, path=path)

    def put_serialized(self, object_id: str, payload) -> Descriptor:
        """Store an already-serialized envelope (bytes-like)."""
        if len(payload) <= INLINE_OBJECT_MAX_BYTES:
            return Descriptor(object_id, len(payload),
                              inline=bytes(payload))
        if self._arena is not None:
            buf = self._arena.create(object_id, len(payload))
            if buf is not None:
                buf[:] = payload
                self._arena.pin(object_id, 1)   # before seal; see put()
                self._arena.seal(object_id)
                with self._lock:
                    self._owned.add(object_id)
                return Descriptor(object_id, len(payload), arena=True)
        path = self._spill_path(object_id)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "wb") as f:
            f.write(payload)
        os.rename(tmp, path)
        return Descriptor(object_id, len(payload), path=path)

    def _spill_path(self, object_id: str) -> str:
        os.makedirs(self._spill_dir, exist_ok=True)
        return os.path.join(self._spill_dir, object_id)

    def purge_spill(self) -> None:
        """Remove this session's spill files (store OWNER only: the node
        on shutdown; readers must never call this)."""
        shutil.rmtree(self._spill_dir, ignore_errors=True)

    # -- read path ----------------------------------------------------------

    def get(self, desc: Descriptor):
        """Deserialize the object a descriptor points at (zero-copy mmap)."""
        if desc.inline is not None:
            return serialization.loads(desc.inline)
        if desc.arena:
            view = self._arena_read_view(desc)
            self._sweep_condemned()
            return serialization.loads(view)
        with self._lock:
            m = self._maps.get(desc.object_id)
            if m is None:
                try:
                    with open(desc.path, "rb") as f:
                        m = mmap.mmap(f.fileno(), desc.size,
                                      access=mmap.ACCESS_READ)
                except FileNotFoundError:
                    raise ObjectLostError(
                        f"object {desc.object_id} missing from store "
                        f"({desc.path})") from None
                self._maps[desc.object_id] = m
        return serialization.loads(m)

    def _arena_read_view(self, desc: Descriptor) -> memoryview:
        """Pinned read view over a PER-OBJECT mmap, handed to zero-copy
        deserialization. Buffer exports from the deserialized arrays
        land on this object's own mmap, so the free path can probe
        "still borrowed?" precisely (mmap.close() raises BufferError) —
        the analog of plasma clients holding the buffer until Release,
        but with reclamation the moment the last borrower dies."""
        if self._arena is None:
            raise ObjectLostError(
                f"object {desc.object_id} is arena-backed but this process "
                "has no native arena (RAY_TPU_DISABLE_NATIVE mismatch?)")
        with self._lock:
            cached = self._mviews.get(desc.object_id)
            if cached is None:
                m, view = self._arena.acquire_mapped(desc.object_id)
                if view is None:
                    raise ObjectLostError(
                        f"object {desc.object_id} missing from arena "
                        "(evicted or deleted)")
                cached = (m, view)
                self._mviews[desc.object_id] = cached
        return cached[1][:desc.size]

    def _sweep_condemned(self) -> None:
        """Free condemned blocks whose borrowers have since died."""
        if not self._condemned:
            return
        with self._lock:
            items = [(oid, m) for oid, ms in self._condemned.items()
                     for m in list(ms)]
        for oid, m in items:
            try:
                m.close()
            except BufferError:
                continue        # still borrowed
            with self._lock:
                ms = self._condemned.get(oid)
                if ms and m in ms:
                    ms.remove(m)
                    if not ms:
                        del self._condemned[oid]
                    self._arena.pin(oid, -1)

    # -- lifecycle ----------------------------------------------------------

    def arena_stats(self) -> dict | None:
        """{capacity, used, num_objects, num_evictions} or None without a
        native arena."""
        return self._arena.stats() if self._arena is not None else None

    def adopt(self, object_id: str) -> bool:
        """Take over the owner pin of an arena object whose origin process
        died: pin it under THIS process (before the dead process's pins are
        force-released) and treat it as owned, so the free path releases
        the adopted pin like any put-time pin."""
        if self._arena is None:
            return False
        with self._lock:
            if object_id in self._owned:
                return True
            if self._arena.pin(object_id, 1) < 0:
                return False
            self._owned.add(object_id)
            return True

    def release_all_pins(self, pid: int) -> int:
        """Reclaim every arena pin a dead process held (owner pins from
        put, reader pins from get) plus its unsealed creations."""
        if self._arena is None:
            return 0
        return self._arena.release_all(pid)

    def delete(self, desc: Descriptor) -> None:
        if desc.arena:
            if self._arena is not None:
                oid = desc.object_id
                with self._lock:
                    mview = self._mviews.pop(oid, None)
                    owned = oid in self._owned
                    self._owned.discard(oid)
                # drop THIS process's pins only (owner pin from put, reader
                # pins from get) — never another process's reader pin —
                # then delete: frees now if unpinned, else condemns until
                # the last remaining reader releases
                if mview is not None:
                    m, v = mview
                    try:
                        v.release()
                    except BufferError:
                        pass
                    try:
                        # the per-object mmap is the exporter for every
                        # zero-copy array deserialized from this object:
                        # close() raises while any borrower is alive
                        m.close()
                    except BufferError:
                        with self._lock:
                            self._condemned.setdefault(oid, []).append(m)
                    else:
                        self._arena.pin(oid, -1)
                if owned:
                    self._arena.pin(oid, -1)
                self._arena.delete(oid)
                self._sweep_condemned()
            return
        with self._lock:
            m = self._maps.pop(desc.object_id, None)
        if m is not None:
            try:
                m.close()
            except BufferError:
                pass  # live views reference it; the mmap dies with the process
        if desc.path is not None:
            try:
                os.unlink(desc.path)
            except FileNotFoundError:
                pass

    def close(self) -> None:
        with self._lock:
            maps, self._maps = self._maps, {}
        for m in maps.values():
            try:
                m.close()
            except BufferError:
                pass
        if self._arena is not None:
            with self._lock:
                mviews, self._mviews = self._mviews, {}
                condemned, self._condemned = self._condemned, {}
            for m, v in mviews.values():
                for h in (v, m):
                    try:
                        h.release() if isinstance(h, memoryview) \
                            else h.close()
                    except BufferError:
                        pass  # borrower outlives the session; mmap dies
                              # with the process
            for ms in condemned.values():
                for m in ms:
                    try:
                        m.close()
                    except BufferError:
                        pass
            self._arena.close()
            self._arena = None
