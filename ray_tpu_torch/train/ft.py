"""Fault-tolerant training on one device: asynchronous checkpoints and
resume. The counterpart of `ray_tpu/train/ft.py`, with its on-disk
format (``ray_tpu_ft_v1``), so each package restores what the other
wrote.

- `AsyncCheckpointer`: every `every` steps `maybe_snapshot` queues a
  device-side clone of every leaf of the state on the training stream,
  right behind the dispatch that produced it (the port's step updates
  parameters and moments in place, so the clone plays the reference's
  donation-safe ``jnp.copy``), and records an event behind the clones.
  A writer thread copies the clones to host memory on a stream of its
  own once that event has fired (through two reused pinned staging
  buffers), then commits them. The training
  thread never waits on the host, and the writer never synchronises the
  device (that would also wait for the steps queued after the snapshot):
  it waits on its own copy's event only. The clones stay referenced
  until their copy is complete. At most `max_in_flight` snapshots exist
  between device and disk; a slower disk stalls `maybe_snapshot`
  (counted in `stalls`), never memory.
- Atomic commit (`write_checkpoint`): one raw shard per leaf, a pickled
  tree skeleton whose leaves are `_ShardRef`s, and a manifest with a
  sha256 for each shard and for the skeleton and a ``spec`` list per
  leaf, written into a temp dir that is fsynced and renamed into place
  last (`train.checkpoint.atomic_dir`). A killed writer leaves a
  committed checkpoint or an ignorable temp dir, never a readable
  partial one.
- `restore_resharded`: reads a committed checkpoint onto one device, or,
  with ``mesh=``, each rank's block of every leaf under its recorded
  spec re-validated for that mesh (`parallel.sharding.valid_spec_for`,
  the reference's elastic resume). On one card every leaf is whole: the
  port records ``[None] * ndim`` as each leaf's spec and reads any
  recorded spec (a data-sharded leaf of the reference comes back
  whole). A mesh trainer's state is saved by `write_sharded_state`:
  every leaf gathered whole, rank 0 writes it with the leaf's spec.

The skeleton names the reference's classes (``ray_tpu.train.spmd.
TrainState``, ``ray_tpu.train.ft._ShardRef`` and optax's
``EmptyState``, ``ScaleByAdamState`` and ``ScaleByScheduleState``). The
port imports neither package: it writes those names through a pickler
that emits them for its own stand-ins, and reads a skeleton through an
unpickler that maps exactly those five names to the stand-ins and
refuses every other. `state_to_tree` and `state_from_tree` carry the
port's `spmd.TrainState` to and from that tree (``{"params",
"opt_state", "step"}`` with `default_optimizer`'s optax state).

bf16 shards are read and written byte for byte through 16-bit views
(the reference decodes them through ``ml_dtypes``, which the port does
not use).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import queue
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from ray_tpu_torch.models._stacked import nest
from ray_tpu_torch.train.checkpoint import CheckpointError, atomic_dir
from ray_tpu_torch.util import tracing as _tracing

MANIFEST = "manifest.json"
_SKELETON = "skeleton.pkl"
_FORMAT = "ray_tpu_ft_v1"
_STEP_RE = re.compile(r"^step_(\d{8})$")
# Threads that hash and write (or read and check) a checkpoint's shards.
_IO_THREADS = 4

# The dtypes a shard may hold, by the name the manifest records (numpy's
# names, which torch's match).
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


# -- the skeleton's classes ---------------------------------------------------

class _ShardRef:
    """Placeholder leaf in the pickled tree skeleton: `index` names the
    shard file holding the real array (``ray_tpu.train.ft._ShardRef``)."""

    def __init__(self, index: int):
        self.index = index


class StoredTrainState:
    """Stand-in for ``ray_tpu.train.spmd.TrainState`` in a skeleton:
    ``params`` and ``opt_state`` trees and the ``step`` leaf."""

    def __init__(self, params, opt_state, step):
        self.params = params
        self.opt_state = opt_state
        self.step = step


class EmptyState(NamedTuple):
    """Stand-in for ``optax._src.base.EmptyState``."""


class ScaleByAdamState(NamedTuple):
    """Stand-in for ``optax._src.transform.ScaleByAdamState``."""
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """Stand-in for ``optax._src.transform.ScaleByScheduleState``."""
    count: Any


_REFERENCE_CLASSES = {
    ("ray_tpu.train.spmd", "TrainState"): StoredTrainState,
    ("ray_tpu.train.ft", "_ShardRef"): _ShardRef,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
}
_REFERENCE_NAMES = {cls: key for key, cls in _REFERENCE_CLASSES.items()}


class _SkeletonPickler(pickle._Pickler):
    """Pickles a skeleton with each stand-in under its reference's module
    and name, without importing either (the pure-Python pickler, whose
    global references can be written directly)."""

    def save_global(self, obj, name=None):
        ref = _REFERENCE_NAMES.get(obj)
        if ref is None:
            return super().save_global(obj, name)
        self.save(ref[0])
        self.save(ref[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _SkeletonUnpickler(pickle.Unpickler):
    """Reads a skeleton: the five reference names map to their
    stand-ins; any other global is refused."""

    def find_class(self, module, name):
        cls = _REFERENCE_CLASSES.get((module, name))
        if cls is None:
            raise CheckpointError(
                f"checkpoint skeleton names {module}.{name}, which is not "
                "one of the classes a train state holds "
                f"({sorted('.'.join(k) for k in _REFERENCE_CLASSES)})")
        return cls


def _dump_skeleton(skeleton) -> bytes:
    buf = io.BytesIO()
    _SkeletonPickler(buf, protocol=5).dump(skeleton)
    return buf.getvalue()


def _load_skeleton(data: bytes):
    return _SkeletonUnpickler(io.BytesIO(data)).load()


# -- trees --------------------------------------------------------------------

def tree_map(fn, tree):
    """Apply ``fn`` to every leaf, in JAX's flatten order (dict keys
    sorted, sequences and named tuples in order, a `StoredTrainState`'s
    params, opt_state, step); None is an empty subtree, as in JAX."""
    if isinstance(tree, StoredTrainState):
        return StoredTrainState(tree_map(fn, tree.params),
                                tree_map(fn, tree.opt_state),
                                tree_map(fn, tree.step))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _skeleton(tree) -> tuple[Any, list]:
    """(the tree with its leaves replaced by `_ShardRef`s, the leaves)."""
    leaves = []

    def ref(x):
        leaves.append(x)
        return _ShardRef(len(leaves) - 1)
    return tree_map(ref, tree), leaves


# -- carrying the port's train state across ------------------------------------

def _lookup(tree, name: str):
    for p in name.split("."):
        tree = tree[p]
    return tree


def state_to_tree(state) -> StoredTrainState:
    """The port's `spmd.TrainState` as the reference's tree (the tensors
    themselves, no copy): ``params`` is the model's parameters as the
    reference's nested dict, ``opt_state`` `default_optimizer`'s optax
    state ``(EmptyState(), (ScaleByAdamState(count, mu, nu),
    EmptyState(), ScaleByScheduleState(count)))`` with ``mu``/``nu``
    shaped like ``params``, and ``step``."""
    model, opt = state.params, state.opt_state
    mesh = getattr(model, "mesh", None)

    def whole(n, t):
        # on a mesh: the leaf gathered from every rank's block
        t = t.detach()
        if mesh is None:
            return t
        from ray_tpu_torch.parallel.sharding import gather_full
        return gather_full(t, model.specs[n], mesh)

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = nest((n, whole(n, p)) for n, p in model.named_parameters())
    mu = nest((n, whole(n, m)) for (n, _), m in zip(named, opt["mu"]))
    nu = nest((n, whole(n, v)) for (n, _), v in zip(named, opt["nu"]))
    count = opt["count"]
    adam = ScaleByAdamState(count, mu, nu)
    return StoredTrainState(
        params, (EmptyState(), (adam, EmptyState(),
                                ScaleByScheduleState(count))), state.step)


class _Spec:
    """A JSON spec as a leaf of a tree shaped like a train state's."""

    def __init__(self, entries: list):
        self.entries = entries


def state_specs(state) -> list[list]:
    """One JSON PartitionSpec per leaf of `state_to_tree`'s tree, in
    flatten order: each parameter's and moment's spec on the model's
    mesh (``[None] * ndim`` on one card), ``[]`` for the scalars."""
    from ray_tpu_torch.parallel.sharding import spec_to_json
    model = state.params
    specs = getattr(model, "specs", {})

    def leaf(n, p):
        return _Spec(spec_to_json(specs[n]) if n in specs
                     else [None] * p.ndim)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    moments = nest((n, leaf(n, p)) for n, p in named)
    count = _Spec([])
    tree = StoredTrainState(
        nest((n, leaf(n, p)) for n, p in model.named_parameters()),
        (EmptyState(), (ScaleByAdamState(count, moments, moments),
                        EmptyState(), ScaleByScheduleState(count))),
        _Spec([]))
    return [s.entries for s in tree_leaves(tree)]


def write_sharded_state(root: str, step: int, state) -> str | None:
    """Commit a train state under ``root/step_{step:08d}`` with each
    leaf's spec recorded. On a mesh every rank calls it: each leaf is
    gathered whole (`state_to_tree`), rank 0 writes, and every rank
    waits for the commit. Returns the directory (rank 0; None on the
    others)."""
    import torch.distributed as dist
    tree = state_to_tree(state)
    specs = state_specs(state)
    path = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        host = tree_map(lambda t: torch.as_tensor(t).detach().cpu(), tree)
        path = write_checkpoint(root, step, host, specs)
    if dist.is_initialized() and getattr(state.params, "mesh", None):
        dist.barrier()
    return path


def _find(tree, cls):
    if isinstance(tree, cls):
        return tree
    if isinstance(tree, tuple):
        for x in tree:
            got = _find(x, cls)
            if got is not None:
                return got
    return None


def _family(cfg):
    from ray_tpu_torch.models import gpt, moe, vit
    for mod, kind in ((gpt, gpt.GPTConfig), (moe, moe.MoEConfig),
                      (vit, vit.ViTConfig)):
        if isinstance(cfg, kind):
            return mod
    raise TypeError(f"no model family for config {type(cfg).__name__}")


def state_from_tree(tree: StoredTrainState, cfg, device=None, mesh=None,
                    rules: dict | None = None):
    """A restored reference-format tree as the port's `spmd.TrainState`
    on ``device`` (the card unless told otherwise): ``params`` through
    the model family's ``params_from_numpy`` (f32 trainable masters; the
    family is ``cfg``'s: GPT, MoE or ViT), ``ScaleByAdamState``'s
    ``mu``/``nu`` as the optimizer's lists in the order of the model's
    trainable parameters, ``count`` from ``ScaleByAdamState.count``
    (checked against ``ScaleByScheduleState.count`` where the optimizer
    has one) and ``step`` as it is.

    ``mesh`` (GPT): the model keeps each rank's block under
    `models.gpt.param_logical_axes` and ``rules``; a leaf may come whole
    (`restore_resharded` without a mesh: any recorded spec) or as that
    very block (`restore_resharded` onto the same mesh of a checkpoint
    that recorded the model's specs, as `write_sharded_state` does);
    anything else raises."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import spmd
    device = gpt.resolve_device(device)
    if not isinstance(tree, StoredTrainState):
        raise CheckpointError(f"not a train state: {type(tree).__name__}")
    adam = _find(tree.opt_state, ScaleByAdamState)
    if adam is None:
        raise CheckpointError("the optimizer state holds no ScaleByAdamState")
    sched = _find(tree.opt_state, ScaleByScheduleState)
    count = torch.as_tensor(adam.count)
    if sched is not None and int(torch.as_tensor(sched.count)) != int(count):
        raise CheckpointError(
            f"ScaleByAdamState.count {int(count)} != ScaleByScheduleState."
            f"count {int(torch.as_tensor(sched.count))}")
    kw = {}
    if mesh is not None and mesh.size > 1:
        if _family(cfg) is not gpt:
            raise NotImplementedError(
                f"{type(cfg).__name__} trains on one card; meshes are "
                "GPT's (ROADMAP A6 (b))")
        kw = dict(mesh=mesh, rules=rules)
    model = _family(cfg).params_from_numpy(
        tree.params, cfg, device=device, dtype=torch.float32, trainable=True,
        **kw)
    params = dict(model.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]

    def moment(t, name):
        t = torch.as_tensor(_lookup(t, name))
        want = tuple(params[name].shape)
        if kw and tuple(t.shape) != want:
            from ray_tpu_torch.parallel.sharding import local_shard
            if tuple(t.shape) == tuple(model.whole_shapes[name]):
                t = local_shard(t, model.specs[name], model.mesh)
        if tuple(t.shape) != want:
            raise CheckpointError(f"moment {name} has shape "
                                  f"{tuple(t.shape)}; the model's leaf is "
                                  f"{want}")
        return t.to(device=device, dtype=torch.float32).contiguous()

    opt = {"count": count.to(device=device, dtype=torch.int32),
           "mu": [moment(adam.mu, n) for n in names],
           "nu": [moment(adam.nu, n) for n in names]}
    step = torch.as_tensor(tree.step).to(device=device, dtype=torch.int32)
    return spmd.TrainState(model, opt, step)


# -- on-disk format -------------------------------------------------------------

def _sha256(data) -> str:
    return hashlib.sha256(data).hexdigest()


def _write_file(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _leaf_bytes(leaf) -> tuple[memoryview, list, str]:
    """(the leaf's bytes, without a copy where it is contiguous; shape;
    dtype name)."""
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    t = torch.as_tensor(leaf).detach()
    if t.device.type != "cpu":
        raise ValueError(f"a host tree leaf is on {t.device}")
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"cannot write a {t.dtype} leaf")
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    return memoryview(flat.numpy()), list(t.shape), name


def write_tree(dest: str, step: int, host_tree: Any,
               specs: list[list] | None = None,
               stats: dict | None = None) -> None:
    """Write one host tree (leaves: CPU tensors or numpy arrays) into the
    existing directory ``dest``: the shards, the skeleton and, last, the
    manifest. ``specs`` holds one JSON-ready PartitionSpec per leaf in
    flatten order (default ``[None] * ndim``: whole). ``stats`` (if
    given) accumulates the seconds spent hashing (``hash_s``) and
    writing with fsync (``write_s``), summed over the `_IO_THREADS`
    threads that write the shards, and the bytes (``bytes``)."""
    skeleton, leaves = _skeleton(host_tree)
    if specs is None:
        specs = [[None] * np.ndim(x) for x in leaves]
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    stats = {} if stats is None else stats
    for k in ("hash_s", "write_s", "bytes"):
        stats.setdefault(k, 0)
    pc = time.perf_counter

    def shard(i):
        data, shape, dtype = _leaf_bytes(leaves[i])
        name = f"shard_{i:05d}.bin"
        t0 = pc()
        digest = _sha256(data)
        t1 = pc()
        _write_file(os.path.join(dest, name), data)
        return ({"file": name, "shape": shape, "dtype": dtype,
                 "spec": specs[i], "sha256": digest},
                t1 - t0, pc() - t1, data.nbytes)

    # hashlib and file writes release the GIL: shards go in parallel
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        done = list(pool.map(shard, range(len(leaves))))
    shards = [d[0] for d in done]
    for _, hash_s, write_s, nbytes in done:
        stats["hash_s"] += hash_s
        stats["write_s"] += write_s
        stats["bytes"] += nbytes
    skel = _dump_skeleton(skeleton)
    _write_file(os.path.join(dest, _SKELETON), skel)
    manifest = json.dumps({
        "format": _FORMAT,
        "step": int(step),
        "shards": shards,
        "skeleton": {"file": _SKELETON, "sha256": _sha256(skel)},
    }, indent=1).encode()
    _write_file(os.path.join(dest, MANIFEST), manifest)


def write_checkpoint(root: str, step: int, host_tree: Any,
                     specs: list[list] | None = None,
                     stats: dict | None = None) -> str:
    """Commit one host-side snapshot under ``root/step_{step:08d}``
    atomically (temp dir -> fsynced manifest -> rename)."""
    dest = os.path.join(root, f"step_{step:08d}")
    with atomic_dir(dest) as tmp:
        write_tree(tmp, step, host_tree, specs, stats)
    return dest


def load_manifest(path: str) -> dict:
    """Read + sanity-check a committed checkpoint dir's manifest."""
    mf = os.path.join(path, MANIFEST)
    if not os.path.isfile(mf):
        raise CheckpointError(
            f"{path!r} holds no committed checkpoint (no {MANIFEST} — "
            f"a crashed writer's partial dir is never committed)")
    try:
        with open(mf, "rb") as f:
            manifest = json.load(f)
    except ValueError as e:
        raise CheckpointError(f"unreadable manifest in {path!r}: {e}") \
            from None
    if manifest.get("format") != _FORMAT:
        raise CheckpointError(
            f"{path!r}: unknown checkpoint format "
            f"{manifest.get('format')!r}")
    return manifest


def _read_checked(path: str, entry: dict, validate: bool) -> bytearray:
    full = os.path.join(path, entry["file"])
    try:
        with open(full, "rb") as f:
            data = bytearray(os.fstat(f.fileno()).st_size)
            f.readinto(data)
    except FileNotFoundError:
        raise CheckpointError(
            f"{path!r}: shard {entry['file']!r} listed in the manifest is "
            f"missing") from None
    if validate and _sha256(data) != entry["sha256"]:
        raise CheckpointError(
            f"{path!r}: checksum mismatch on {entry['file']!r} (torn write "
            f"or corruption)")
    return data


def validate_checkpoint(path: str) -> dict:
    """Verify every shard (and the skeleton) against the manifest's
    checksums. Returns the manifest; raises CheckpointError on any
    mismatch or missing file."""
    manifest = load_manifest(path)
    entries = list(manifest["shards"]) + [manifest["skeleton"]]
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        for _ in pool.map(lambda e: _read_checked(path, e, True) and None,
                          entries):
            pass
    return manifest


def committed_steps(root: str) -> list[tuple[int, str]]:
    """(step, dir) for every COMMITTED checkpoint under `root`,
    ascending. Temp/partial dirs (no manifest, unparseable) are
    ignored. Accepts a local path or a storage URI."""
    from ray_tpu_torch.util import storage
    if storage.is_uri(root):
        steps = {}
        for rel in storage.list_prefix(root):
            head, _, tail = rel.partition("/")
            m = _STEP_RE.match(head)
            if m and tail == storage.COMMIT_FILE:
                steps[int(m.group(1))] = storage.uri_join(root, head)
        return sorted(steps.items())
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        full = os.path.join(root, name)
        if m and os.path.isfile(os.path.join(full, MANIFEST)):
            out.append((int(m.group(1)), full))
    return sorted(out)


def latest_checkpoint(root: str) -> str | None:
    """Newest committed checkpoint dir (or URI) under `root`, else
    None."""
    steps = committed_steps(root)
    return steps[-1][1] if steps else None


def read_tree(path: str, device=None, *, validate: bool = True, mesh=None
              ) -> tuple[Any, int]:
    """Read the tree a committed directory holds, every leaf whole on
    ``device`` (the card unless told otherwise), whatever spec it was
    recorded under; with a ``mesh`` (of more than one rank) this rank's
    block of each leaf under its recorded spec re-validated for the mesh
    (`parallel.sharding.valid_spec_for`). Each shard (and the skeleton)
    is checked against its sha256 as it is read when ``validate``.
    Returns (tree, step)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import active_mesh
    device = gpt.resolve_device(device)
    mesh = active_mesh(mesh)
    manifest = load_manifest(path)
    skeleton = _load_skeleton(
        bytes(_read_checked(path, manifest["skeleton"], validate)))
    shards = manifest["shards"]
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        blobs = list(pool.map(lambda e: _read_checked(path, e, validate),
                              shards))

    def materialize(ref):
        if not isinstance(ref, _ShardRef):
            raise CheckpointError(f"{path!r}: skeleton leaf {ref!r} is not "
                                  "a shard reference")
        entry = shards[ref.index]
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            raise CheckpointError(f"{path!r}: shard {entry['file']!r} has "
                                  f"dtype {entry['dtype']!r}")
        data = blobs[ref.index]
        if len(data) == 0:
            t = torch.empty(entry["shape"], dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype).reshape(entry["shape"])
        if mesh is not None:
            t = sharding.local_shard(t, sharding.valid_spec_for(
                mesh, sharding.spec_from_json(entry["spec"]), t.shape), mesh)
        return t.to(device)

    return tree_map(materialize, skeleton), int(manifest["step"])


def restore_resharded(source: str, device=None, *, mesh=None,
                      validate: bool = True) -> tuple[Any, int]:
    """Restore a committed checkpoint onto ``device`` (the card unless
    told otherwise): `ray_tpu.train.ft.restore_resharded`. With no mesh
    (or one of one rank) every leaf is placed whole whatever spec it was
    saved under; with a ``mesh`` each rank materialises its block of
    every leaf by its recorded spec re-validated for that mesh, which may
    have another rank count than the one that wrote it (elastic resume).
    Returns (tree, step); `state_from_tree` turns a train state's tree
    into the port's `spmd.TrainState`.

    `source` is a committed checkpoint dir, a root holding step_* dirs
    (the newest committed one is used), or a storage URI of either."""
    from ray_tpu_torch.util import storage
    if storage.is_uri(source):
        uri = source
        if not storage.is_committed(uri):
            latest = latest_checkpoint(uri)
            if latest is None:
                raise CheckpointError(
                    f"no committed checkpoint under {uri!r}")
            uri = latest
        local = storage.staging_dir(uri)
        try:
            storage.download_dir_committed(uri, local)
        except storage.UncommittedError as e:
            raise CheckpointError(str(e)) from None
        source = local
    if not os.path.isfile(os.path.join(source, MANIFEST)):
        latest = latest_checkpoint(source)
        if latest is None:
            raise CheckpointError(
                f"no committed checkpoint under {source!r}")
        source = latest
    return read_tree(source, device, validate=validate, mesh=mesh)


def fast_forward(host_iter: Iterable, n: int) -> Iterator:
    """Skip the first `n` host batches — positions a deterministic data
    stream at the restored step so the resumed trajectory replays the
    exact batches the lost run would have seen."""
    it = iter(host_iter)
    for _ in range(int(n)):
        next(it)
    return it


# -- snapshots ------------------------------------------------------------------

class _Snapshot:
    """One snapshot in flight: the skeleton, the leaves' private copies
    (device clones, or host copies for CPU leaves), the checkpointer's
    `_Staging` and, on the card, the timing events around the clones on
    the training stream (``done`` is what the writer's copy waits
    for)."""

    def __init__(self, state, staging: "_Staging"):
        from ray_tpu_torch.train import spmd
        self.staging = staging
        tree = (state_to_tree(state) if isinstance(state, spmd.TrainState)
                else state)
        self.skeleton, leaves = _skeleton(tree)
        tensors = [torch.as_tensor(x) if not isinstance(x, torch.Tensor)
                   else x.detach() for x in leaves]
        cuda = [t for t in tensors if t.is_cuda]
        self.device = cuda[0].device if cuda else None
        self.start = self.done = None
        self.d2h_ms = None
        if self.device is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        # a private copy of each leaf, queued on the training stream
        self.leaves = [t.clone() for t in tensors]
        if self.device is not None:
            self.done = torch.cuda.Event(enable_timing=True)
            self.done.record()
        self.specs = [[None] * t.dim() for t in self.leaves]

    def clone_ms(self) -> float | None:
        """Device time of the clones (valid once ``done`` has fired)."""
        return None if self.done is None else self.start.elapsed_time(
            self.done)


# The writer copies a snapshot to the host through two pinned buffers of
# this size, reused: a large pinned allocation holds up the training
# thread's CUDA calls for as long as it takes (~1 s for a 3 GB snapshot
# on an H100 host), a pageable copy in chunks does not.
_STAGING_BYTES = 64 << 20


class _Staging:
    """The writer's stream and its two pinned staging buffers, made at the
    first snapshot from a device and kept by the checkpointer."""

    def __init__(self):
        self.stream = None

    def ready(self, device) -> "_Staging":
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=device)
            self.bufs = [torch.empty(_STAGING_BYTES, dtype=torch.uint8,
                                     pin_memory=True) for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
        return self


def _device_get(snap: _Snapshot) -> list:
    """The ONLY place this module moves device values to the host
    (`ray_tpu.train.ft._device_get`; tests patch it): the snapshot's
    clones into pageable host tensors, chunk by chunk through the
    staging buffers on the writer's stream, after the snapshot's
    ``done`` event; each chunk's copy rides under the host's read of the
    one before, and the host waits on each copy's own event only (never
    a device-wide synchronise, which would also wait for the steps
    queued after the snapshot). Called on the writer thread. Records the
    staged copy's span on the writer's stream in ``snap.d2h_ms``."""
    if snap.device is None:
        return list(snap.leaves)
    st = snap.staging.ready(snap.device)
    host = [torch.empty(t.shape, dtype=t.dtype) for t in snap.leaves]
    pending = [None, None]

    def drain(i):
        if pending[i] is not None:
            st.events[i].synchronize()
            dst, n = pending[i]
            dst.copy_(st.bufs[i][:n])
            pending[i] = None

    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    k = 0
    with torch.cuda.stream(st.stream):
        st.stream.wait_event(snap.done)
        begin.record(st.stream)
        for src, dst in zip(snap.leaves, host):
            s = src.reshape(-1).view(torch.uint8)
            d = dst.reshape(-1).view(torch.uint8)
            for off in range(0, s.numel(), _STAGING_BYTES):
                n = min(_STAGING_BYTES, s.numel() - off)
                i = k % 2
                drain(i)
                st.bufs[i][:n].copy_(s[off:off + n], non_blocking=True)
                st.events[i].record(st.stream)
                pending[i] = (d[off:off + n], n)
                k += 1
        end.record(st.stream)
    drain(k % 2)
    drain((k + 1) % 2)
    end.synchronize()
    snap.d2h_ms = begin.elapsed_time(end)
    return host


class AsyncCheckpointer:
    """Asynchronous checkpointer for `TrainLoop` (`train/loop.py`), the
    counterpart of `ray_tpu.train.ft.AsyncCheckpointer` (module
    docstring for the device side).

    `maybe_snapshot(state, step)` is called once per dispatch; every
    `every` steps it queues a snapshot of the state (the port's
    `spmd.TrainState`, written as the reference's tree by
    `state_to_tree`, or any tree of tensors) and returns. A daemon writer
    thread fetches it to the host (`_device_get`) and commits it under
    ``root/step_{NNNNNNNN}`` (`write_checkpoint`). With ``uri=`` (or a
    URI as ``root``) each committed dir is also mirrored through
    `util.storage`'s commit-marker upload. `keep` bounds committed
    checkpoints, oldest pruned first. Writer errors surface on the
    training thread at the next `maybe_snapshot`/`flush`. Each commit's
    split lands in `timings`: the clones' device ms, the copy to the
    host (device ms, and the writer's wall seconds waiting for it), the
    seconds hashing and writing with fsync, the bytes, the commit's
    wall seconds."""

    def __init__(self, root: str, *, every: int = 100,
                 max_in_flight: int = 2, keep: int = 2,
                 uri: str | None = None):
        from ray_tpu_torch.util import storage
        if storage.is_uri(root) and uri is None:
            uri, root = root, storage.staging_dir(root)
        self.root = root
        self.uri = uri
        self.every = max(1, int(every))
        self.max_in_flight = max(1, int(max_in_flight))
        self.keep = max(1, int(keep))
        os.makedirs(root, exist_ok=True)
        self._queue: queue.Queue = queue.Queue(maxsize=self.max_in_flight)
        self._error: BaseException | None = None
        self._last_snap_step: int | None = None
        self._closed = False
        # observability counters
        self.snapshots = 0      # device copies enqueued
        self.commits = 0        # checkpoints committed to disk
        self.stalls = 0         # times the in-flight bound back-pressured
        self.timings: list[dict] = []
        self._staging = _Staging()
        # The writer thread's spans nest under the span active when the
        # checkpointer was built (threads don't inherit it otherwise).
        self._trace_ctx = _tracing.capture_context()
        self._writer = threading.Thread(target=self._writer_loop,
                                        daemon=True,
                                        name="ft-checkpoint-writer")
        self._writer.start()

    # -- training-thread API ------------------------------------------------

    def maybe_snapshot(self, state, step: int, *,
                       force: bool = False) -> bool:
        """Snapshot if `step` is `every` past the last snapshot (or
        `force`). Never waits on the device; blocks only when
        `max_in_flight` snapshots are already pending (memory bound)."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        last = self._last_snap_step
        if not force and last is not None and step - last < self.every:
            return False
        if not force and last is None and step < self.every:
            return False
        snap = _Snapshot(state, self._staging)
        if self._queue.full():
            self.stalls += 1
        self._queue.put((int(step), snap))
        self._last_snap_step = int(step)
        self.snapshots += 1
        return True

    def flush(self) -> None:
        """Block until every enqueued snapshot is committed (the one
        deliberate end-of-run wait, mirroring MetricsRing.drain)."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._writer.join()
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- writer thread ------------------------------------------------------

    def _writer_loop(self):
        _tracing.attach_context(self._trace_ctx)
        pc = time.perf_counter
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, snap = item
                with _tracing.span("ft.checkpoint_commit",
                                   {"step": step, "root": self.root}):
                    t0 = pc()
                    host = _device_get(snap)   # off the training thread
                    t1 = pc()
                    record = {"step": step, "clone_ms": snap.clone_ms(),
                              "d2h_ms": snap.d2h_ms, "fetch_s": t1 - t0}
                    refs = iter(host)
                    host_tree = tree_map(lambda _: next(refs), snap.skeleton)
                    specs = snap.specs
                    del snap
                    dest = write_checkpoint(self.root, step, host_tree,
                                            specs, stats=record)
                    del host, host_tree
                    self.commits += 1
                    if self.uri is not None:
                        from ray_tpu_torch.util import storage
                        storage.upload_dir_committed(
                            dest, storage.uri_join(
                                self.uri, os.path.basename(dest)))
                    self._prune()
                    record["commit_s"] = pc() - t0
                    self.timings.append(record)
            except BaseException as e:       # surfaced on train thread
                self._error = e
            finally:
                self._queue.task_done()

    def _prune(self):
        from ray_tpu_torch.util import storage
        steps = committed_steps(self.root)
        excess = steps[:-self.keep] if len(steps) > self.keep else []
        for step, path in excess:
            shutil.rmtree(path, ignore_errors=True)
            if self.uri is not None:
                try:
                    storage.delete(storage.uri_join(
                        self.uri, os.path.basename(path)))
                except OSError:
                    pass

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                f"async checkpoint writer failed: {err!r}") from err

    # -- validation ---------------------------------------------------------

    def check_invariants(self) -> None:
        """In-flight bound respected, every committed checkpoint's shards
        match its manifest checksums, steps strictly increasing, no
        swallowed writer error."""
        assert self._queue.qsize() <= self.max_in_flight, \
            f"{self._queue.qsize()} in flight > bound {self.max_in_flight}"
        steps = committed_steps(self.root)
        assert len(steps) <= self.keep, \
            f"{len(steps)} committed > keep={self.keep}"
        last = None
        for step, path in steps:
            validate_checkpoint(path)       # raises on any mismatch
            assert last is None or step > last, \
                f"non-monotonic committed steps under {self.root!r}"
            last = step
        self._raise_pending()
