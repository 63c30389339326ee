"""URI-keyed pluggable storage for checkpoints: a copy of
`ray_tpu/util/storage.py` (the port imports nothing of the JAX package),
with the same `_MEM_ROOT` and `COMMIT_FILE`, so a ``mem://`` upload made
by either package reads back in the other.

Counterpart of the reference's remote-storage seam
(`air/_internal/remote_storage.py` upload_to_uri/download_from_uri over
pyarrow filesystems, `tune/syncer.py` experiment sync,
`_private/external_storage.py:246` spill targets): one scheme-keyed
registry of backends with copy-only semantics (no shared-filesystem
shortcuts), so the same code path runs against a real object store.

Built-in schemes:
- ``file://`` (and plain paths) — the local filesystem.
- ``mem://`` — a FAKE remote: bytes land under a hidden local root but
  are reachable only through the backend verbs, which is exactly how
  tests exercise the seam across processes (reference: the mock:// fs
  used by Train/Tune storage tests).
- ``gs://`` / ``s3://`` — not bundled (zero-egress image); register one
  with :func:`register_backend` to enable.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Callable, Dict

_MEM_ROOT = "/tmp/ray_tpu_memfs"

# Commit marker for atomic-ish remote uploads: data objects are written
# first, this checksummed manifest last. Readers treat its absence as
# "no checkpoint here" — an interrupted upload can never be restored.
COMMIT_FILE = ".ray_tpu_commit.json"


class UncommittedError(RuntimeError):
    """The URI holds no committed upload (nothing there, an interrupted
    upload with no commit marker, or bytes failing the marker's
    checksums)."""


def is_uri(path: str | None) -> bool:
    return bool(path) and "://" in path


def parse(uri: str) -> tuple[str, str]:
    """'scheme://rest' -> (scheme, rest); plain paths -> ('file', path)."""
    if not is_uri(uri):
        return "file", uri
    scheme, _, rest = uri.partition("://")
    return scheme, rest


def uri_join(uri: str, *parts: str) -> str:
    out = uri.rstrip("/")
    for p in parts:
        out += "/" + str(p).strip("/")
    return out


def staging_dir(uri: str) -> str:
    """Deterministic local staging dir for a URI (same URI -> same dir in
    every process on this machine, so a restore finds the paths a
    previous run recorded)."""
    scheme, rest = parse(uri)
    digest = hashlib.sha1(uri.encode()).hexdigest()[:12]
    safe = rest.replace("/", "_")[-40:]
    return os.path.join("/tmp/ray_tpu_staging", f"{scheme}_{safe}_{digest}")


class StorageBackend:
    """Copy-only verbs against one scheme. Paths are the URI's
    scheme-stripped remainder (e.g. ``bucket/exp/ckpt_0``)."""

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        """Remove a file or an entire prefix (directory)."""
        raise NotImplementedError

    def list_prefix(self, path: str) -> list[str]:
        """All file paths under `path`, relative to it."""
        raise NotImplementedError

    # -- generic directory transfer over the byte verbs -----------------

    def upload_dir(self, local_dir: str, path: str) -> None:
        for root, _dirs, files in os.walk(local_dir):
            for name in files:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, local_dir)
                with open(full, "rb") as f:
                    self.write_bytes(path.rstrip("/") + "/" + rel,
                                     f.read())

    def download_dir(self, path: str, local_dir: str) -> None:
        os.makedirs(local_dir, exist_ok=True)
        for rel in self.list_prefix(path):
            dest = os.path.join(local_dir, rel)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:
                f.write(self.read_bytes(path.rstrip("/") + "/" + rel))


class _FSBackend(StorageBackend):
    """Filesystem-rooted backend (local paths, and the mem:// fake which
    roots everything under a hidden directory)."""

    def __init__(self, root: str = ""):
        self.root = root

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, path) if self.root else path

    def write_bytes(self, path: str, data: bytes) -> None:
        full = self._abs(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp.%d" % os.getpid()
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, full)

    def read_bytes(self, path: str) -> bytes:
        try:
            with open(self._abs(path), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no object at {path!r} in {type(self).__name__}") \
                from None

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def delete(self, path: str) -> None:
        full = self._abs(path)
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        else:
            try:
                os.unlink(full)
            except FileNotFoundError:
                pass

    def list_prefix(self, path: str) -> list[str]:
        base = self._abs(path)
        out = []
        for root, _dirs, files in os.walk(base):
            for name in files:
                out.append(os.path.relpath(os.path.join(root, name), base))
        return sorted(out)


_lock = threading.Lock()
_backends: Dict[str, StorageBackend] = {}
_factories: Dict[str, Callable[[], StorageBackend]] = {
    "file": lambda: _FSBackend(""),
    "mem": lambda: _FSBackend(_MEM_ROOT),
    "mock": lambda: _FSBackend(_MEM_ROOT),
}


def register_backend(scheme: str,
                     factory: Callable[[], StorageBackend]) -> None:
    """Plug in a real object-store backend, e.g.
    ``register_backend("gs", lambda: MyGCSBackend())``."""
    with _lock:
        _factories[scheme] = factory
        _backends.pop(scheme, None)


def get_backend(uri: str) -> tuple[StorageBackend, str]:
    """Resolve a URI to (backend, scheme-stripped path)."""
    scheme, rest = parse(uri)
    with _lock:
        b = _backends.get(scheme)
        if b is None:
            factory = _factories.get(scheme)
            if factory is None:
                raise ValueError(
                    f"no storage backend for scheme {scheme!r} "
                    f"(register one with ray_tpu_torch.util.storage."
                    f"register_backend)")
            b = _backends[scheme] = factory()
    return b, rest


# -- convenience wrappers ----------------------------------------------------

def upload_dir(local_dir: str, uri: str) -> None:
    b, path = get_backend(uri)
    b.upload_dir(local_dir, path)


def download_dir(uri: str, local_dir: str) -> None:
    b, path = get_backend(uri)
    b.download_dir(path, local_dir)


def upload_dir_committed(local_dir: str, uri: str) -> None:
    """Upload a directory with commit-marker semantics: every data file
    first (checksummed as it streams), then one COMMIT_FILE manifest
    LAST. A writer that dies mid-upload leaves objects but no marker, so
    `download_dir_committed` / `Checkpoint.from_uri` refuse the
    partial upload instead of restoring it."""
    b, root = get_backend(uri)
    entries = []
    for walk_root, _dirs, files in os.walk(local_dir):
        for name in sorted(files):
            full = os.path.join(walk_root, name)
            rel = os.path.relpath(full, local_dir)
            if rel == COMMIT_FILE:
                continue
            with open(full, "rb") as f:
                data = f.read()
            b.write_bytes(root.rstrip("/") + "/" + rel, data)
            entries.append({"path": rel,
                            "sha256": hashlib.sha256(data).hexdigest(),
                            "size": len(data)})
    manifest = json.dumps({"files": sorted(entries,
                                           key=lambda e: e["path"])},
                          sort_keys=True).encode()
    b.write_bytes(root.rstrip("/") + "/" + COMMIT_FILE, manifest)


def download_dir_committed(uri: str, local_dir: str) -> None:
    """Download a committed upload into a CLEAN `local_dir` (wiped
    first, so stale staging files never mask what the backend holds).
    Raises UncommittedError when there is no commit marker, a listed
    object is missing, or bytes fail their recorded checksum."""
    b, root = get_backend(uri)
    try:
        manifest = json.loads(
            b.read_bytes(root.rstrip("/") + "/" + COMMIT_FILE))
    except FileNotFoundError:
        present = b.list_prefix(root)
        detail = ("nothing uploaded" if not present else
                  f"{len(present)} object(s) but no commit marker "
                  f"(interrupted upload?)")
        raise UncommittedError(f"{uri!r}: {detail}") from None
    if os.path.isdir(local_dir):
        shutil.rmtree(local_dir)
    os.makedirs(local_dir, exist_ok=True)
    for entry in manifest["files"]:
        src = root.rstrip("/") + "/" + entry["path"]
        try:
            data = b.read_bytes(src)
        except FileNotFoundError:
            raise UncommittedError(
                f"{uri!r}: committed file {entry['path']!r} is missing "
                f"from the backend") from None
        if hashlib.sha256(data).hexdigest() != entry["sha256"]:
            raise UncommittedError(
                f"{uri!r}: checksum mismatch on {entry['path']!r}")
        dest = os.path.join(local_dir, entry["path"])
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as f:
            f.write(data)


def is_committed(uri: str) -> bool:
    b, root = get_backend(uri)
    return b.exists(root.rstrip("/") + "/" + COMMIT_FILE)


def write_bytes(uri: str, data: bytes) -> None:
    b, path = get_backend(uri)
    b.write_bytes(path, data)


def read_bytes(uri: str) -> bytes:
    b, path = get_backend(uri)
    return b.read_bytes(path)


def exists(uri: str) -> bool:
    b, path = get_backend(uri)
    return b.exists(path)


def delete(uri: str) -> None:
    b, path = get_backend(uri)
    b.delete(path)


def list_prefix(uri: str) -> list[str]:
    b, path = get_backend(uri)
    return b.list_prefix(path)


class DirSyncer:
    """Incremental local->URI mirror (reference: tune/syncer.py): each
    sync_up pass uploads only files whose (mtime, size) changed since the
    last pass."""

    def __init__(self, local_dir: str, uri: str):
        self.local_dir = local_dir
        self.uri = uri
        self._seen: dict[str, tuple] = {}

    def sync_up(self) -> int:
        b, path = get_backend(self.uri)
        n = 0
        for root, _dirs, files in os.walk(self.local_dir):
            for name in files:
                if name.endswith(".tmp") or ".tmp." in name:
                    continue
                full = os.path.join(root, name)
                rel = os.path.relpath(full, self.local_dir)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                sig = (st.st_mtime_ns, st.st_size)
                if self._seen.get(rel) == sig:
                    continue
                with open(full, "rb") as f:
                    b.write_bytes(path.rstrip("/") + "/" + rel, f.read())
                self._seen[rel] = sig
                n += 1
        return n

    def sync_down(self) -> None:
        download_dir(self.uri, self.local_dir)
