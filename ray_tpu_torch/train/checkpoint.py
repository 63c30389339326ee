"""Checkpoint artifact: the counterpart of `ray_tpu/train/checkpoint.py`
(a dict- or directory-backed checkpoint, interconvertible with a
directory and a storage URI, and the atomic-directory commit that
`train/ft.py` shares).

One difference, deliberate: the reference writes a dict checkpoint's
array trees with orbax (``pytree/``), and the port has no orbax. The
port writes them in `train/ft.py`'s shard + manifest layout (raw shards,
a sha256 for each, a pickled skeleton) under ``arrays/``; the rest goes
to ``data.pkl`` as in the reference. A directory that holds orbax's
``pytree/`` raises `CheckpointError` naming orbax: it is never read as
empty (ROADMAP C, known gaps).

Array leaves (tensors or numpy arrays) are held as host tensors: a dict
checkpoint snapshots them to the CPU at `from_dict`, and `to_dict`
returns CPU tensors in both forms.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import pickle
import shutil
import tempfile
import threading
import uuid

import numpy as np
import torch

_ORBAX_SUBDIR = "pytree"
_ARRAYS_SUBDIR = "arrays"
_PICKLE_FILE = "data.pkl"
_counter_lock = threading.Lock()
_counter = 0
_tmpdirs: list[str] = []


class CheckpointError(RuntimeError):
    """A checkpoint is missing, partial, or corrupt."""


def fsync_dir(path: str) -> None:
    """fsync a directory so its entries (a just-renamed checkpoint)
    survive power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_dir(path: str):
    """Write a directory atomically (`ray_tpu.train.checkpoint.atomic_dir`):
    yields a sibling temp dir to fill; on clean exit the temp dir is
    fsynced and renamed into place (any previous `path` is replaced). On
    error, or a crash at any point, `path` is never a half-written
    directory: readers see the old content, the new content, or nothing.
    The `train/ft.py` commit path and `Checkpoint.to_directory` both go
    through here."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-{tag}")
    os.makedirs(tmp)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    fsync_dir(tmp)
    if os.path.lexists(path):
        # move the old version aside first: os.replace can't atomically
        # swap non-empty directories, and a crash in this window leaves
        # `path` absent (detectable), never partial
        old = os.path.join(parent, f".{os.path.basename(path)}.old-{tag}")
        if os.path.isdir(path):
            os.replace(path, old)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.unlink(path)
    os.replace(tmp, path)
    fsync_dir(parent)


def _next_tmpdir() -> str:
    global _counter
    with _counter_lock:
        _counter += 1
        n = _counter
    d = os.path.join(tempfile.gettempdir(),
                     f"ray_tpu_torch_ckpt_{os.getpid()}_{n}")
    os.makedirs(d, exist_ok=True)
    _tmpdirs.append(d)
    return d


@atexit.register
def _cleanup_tmpdirs():
    for d in _tmpdirs:
        shutil.rmtree(d, ignore_errors=True)


def _is_array_tree(value) -> bool:
    from ray_tpu_torch.train import ft
    leaves = ft.tree_leaves(value)
    return bool(leaves) and all(
        isinstance(x, (torch.Tensor, np.ndarray)) for x in leaves)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


class Checkpoint:
    """A dict- or directory-backed checkpoint. Construct with `from_dict` /
    `from_directory`; read with `to_dict` / `to_directory` /
    `as_directory` (`ray_tpu.train.checkpoint.Checkpoint`)."""

    def __init__(self, path: str | None = None, *, _data: dict | None = None):
        self.path = path
        self._data = _data

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        # Snapshot arrays to host tensors now: detaches from the caller's
        # (possibly device, possibly updated in place) storage.
        from ray_tpu_torch.train import ft
        snap = {k: (ft.tree_map(_to_host, v) if _is_array_tree(v) else v)
                for k, v in data.items()}
        return cls(_data=snap)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    # -- accessors ----------------------------------------------------------

    def to_dict(self) -> dict:
        if self._data is not None:
            return dict(self._data)
        from ray_tpu_torch.train import ft
        if os.path.isdir(os.path.join(self.path, _ORBAX_SUBDIR)):
            raise CheckpointError(
                f"{self.path!r} holds array trees written by orbax "
                f"({_ORBAX_SUBDIR}/), which the port cannot read; write the "
                "arrays with ray_tpu.train.ft (shard + manifest) instead")
        out = {}
        arrays = os.path.join(self.path, _ARRAYS_SUBDIR)
        if os.path.isdir(arrays):
            tree, _ = ft.read_tree(arrays, device="cpu")
            out.update(tree)
        pkl = os.path.join(self.path, _PICKLE_FILE)
        if os.path.exists(pkl):
            with open(pkl, "rb") as f:
                out.update(pickle.load(f))
        return out

    def to_directory(self, path: str) -> str:
        # atomic_dir: a crash mid-write leaves no readable half-written
        # checkpoint dir for from_directory to load
        if self._data is not None:
            from ray_tpu_torch.train import ft
            arrays = {k: v for k, v in self._data.items()
                      if _is_array_tree(v)}
            rest = {k: v for k, v in self._data.items() if k not in arrays}
            with atomic_dir(path) as tmp:
                if arrays:
                    dest = os.path.join(tmp, _ARRAYS_SUBDIR)
                    os.makedirs(dest)
                    ft.write_tree(dest, 0, arrays)
                with open(os.path.join(tmp, _PICKLE_FILE), "wb") as f:
                    pickle.dump(rest, f, protocol=5)
        elif os.path.abspath(path) != os.path.abspath(self.path):
            with atomic_dir(path) as tmp:
                shutil.copytree(self.path, tmp, dirs_exist_ok=True)
        return path

    def as_directory(self) -> str:
        if self._data is not None:
            # Materialize once; the dir lives until process exit.
            self.path = self.to_directory(_next_tmpdir())
            self._data = None
        return self.path

    # -- remote storage -----------------------------------------------------

    def to_uri(self, uri: str) -> str:
        """Upload this checkpoint through the URI-keyed storage seam
        (`util.storage`; ``mem://`` or a registered backend). The upload
        is committed: data files go first and a checksummed commit
        manifest lands last, so `from_uri` refuses an interrupted one."""
        from ray_tpu_torch.util import storage
        storage.upload_dir_committed(self.as_directory(), uri)
        return uri

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """Download a committed checkpoint. Raises CheckpointError if the
        URI holds nothing, an interrupted (uncommitted) upload, or bytes
        that fail the commit manifest's checksums."""
        from ray_tpu_torch.util import storage
        local = storage.staging_dir(uri)
        try:
            storage.download_dir_committed(uri, local)
        except storage.UncommittedError as e:
            raise CheckpointError(
                f"no restorable checkpoint at {uri!r}: {e}") from None
        return cls(local)

    def __repr__(self):
        kind = "dict" if self._data is not None else self.path
        return f"Checkpoint({kind})"
