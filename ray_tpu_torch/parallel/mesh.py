"""Device meshes over `torch.distributed` ranks: the counterpart of
`ray_tpu/parallel/mesh.py`.

The JAX package is single-controller: one process holds a
`jax.sharding.Mesh` of devices and the compiler inserts every collective.
The port runs one process per rank, PyTorch's own idiom: a `Mesh` is
the same axis vocabulary laid over the global ranks of the process group,
plus this process's coordinate on each axis and one process group for
every set of axes of size > 1, so that code reads as it does inside
JAX's ``shard_map`` (``mesh.axis_index("seq")``,
``collectives.psum(x, "tensor", mesh)``).

Axis names (any subset, in logical-outer to logical-inner order):

- ``data``    pure data parallelism (gradients summed over the axis)
- ``fsdp``    data parallelism with parameter/optimizer sharding (ZeRO-3:
              a leaf is gathered before use and its gradient
              reduce-scattered)
- ``tensor``  tensor parallelism (Megatron column/row-split matmuls)
- ``seq``     sequence/context parallelism (ring attention)
- ``expert``  expert parallelism for MoE layers (not used by the port
              yet: ROADMAP A6 (b))
- ``pipe``    pipeline stages

A mesh of one rank needs no process group and makes no collective: the
code paths it drives are the single-card ones.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

AXIS_ORDER = ("pipe", "data", "fsdp", "seq", "expert", "tensor")

# Mesh axes that shard the batch dimension: anything data-like.
BATCH_AXES = ("data", "fsdp")


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's global rank (0 when no group is initialised)."""
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """Global ranks laid out on named axes (`AXIS_ORDER`). ``devices`` is
    the rank array (JAX's ``mesh.devices`` holds devices; a rank owns
    one), ``shape`` maps each axis to its size, ``coords`` holds this
    process's coordinate on each axis (None when it is not in the mesh).

    The constructor creates one process group per set of axes of size >
    1 and per position on the other axes, in the same order on every
    rank (``dist.new_group`` must be called by all ranks for every
    group, even one a rank is not in), so every rank of the world must
    build every mesh, in the same order."""

    def __init__(self, ranks, axis_names=AXIS_ORDER):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a rank array of shape {ranks.shape} for axes "
                             f"{tuple(axis_names)}")
        if len(set(ranks.ravel().tolist())) != ranks.size:
            raise ValueError(f"a rank appears twice in {ranks.tolist()}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self._coord_of = {int(ranks[idx]): dict(zip(self.axis_names, idx))
                          for idx in np.ndindex(ranks.shape)}
        self.coords = self._coord_of.get(world_rank())
        self._groups: dict[tuple, tuple] = {}
        self._tags: dict[tuple, int] = {}     # `collectives.ppermute`'s
        live = [a for a in self.axis_names if self.shape[a] > 1]
        if self.size > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a mesh of {self.size} ranks needs torch.distributed "
                    "initialised (init_process_group with this world's "
                    "address, size and rank)")
            if ranks.max() >= world_size():
                raise ValueError(f"mesh ranks {ranks.ravel().tolist()} "
                                 f"outside a world of {world_size()}")
            for r in range(1, len(live) + 1):
                for axes in itertools.combinations(live, r):
                    self._make_groups(axes)

    def _make_groups(self, axes: tuple) -> None:
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in pos]
        arr = np.transpose(self.devices, rest + pos).reshape(
            -1, math.prod(self.shape[a] for a in axes))
        for row in arr:
            members = [int(r) for r in row]
            group = dist.new_group(sorted(members))
            if self.coords is not None and world_rank() in members:
                self._groups[axes] = (group, members)

    # -- the shard_map vocabulary ---------------------------------------------

    def live_axes(self, axes) -> tuple:
        """``axes`` (a name or a tuple) without the axes of size 1, in
        `AXIS_ORDER`."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unknown mesh axis {a!r} (axes "
                                 f"{self.axis_names})")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def axis_size(self, axes) -> int:
        """The number of ranks along ``axes`` (JAX's ``psum(1, axes)``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's position along ``axes``, row-major over them in the
        order given (``jax.lax.axis_index``)."""
        return self._linear(self._me(), axes)

    def _me(self) -> dict:
        if self.coords is None:
            raise RuntimeError(f"rank {world_rank()} is not in this mesh "
                               f"({self.devices.ravel().tolist()})")
        return self.coords

    def _linear(self, coords: dict, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, axes):
        """``(process group, members)`` along ``axes`` for this rank, the
        members as global ranks in row-major order over ``axes`` as
        given; None when every axis of ``axes`` has size 1."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        live = self.live_axes(axes)
        if not live:
            return None
        self._me()
        group, members = self._groups[live]
        given = [a for a in axes if a in live]
        members = sorted(members, key=lambda r: self._linear(
            self._coord_of[r], given))
        return group, members

    def __repr__(self):
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({sizes})"


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. Sizes of -1 are inferred from the rank
    count (at most one -1). Axes of size 1 are kept (they make
    PartitionSpecs stable across scale changes)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def sizes(self) -> dict:
        return {"pipe": self.pipe, "data": self.data, "fsdp": self.fsdp,
                "seq": self.seq, "expert": self.expert,
                "tensor": self.tensor}

    def resolve(self, n_devices: int) -> dict:
        sizes = self.sizes()
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one axis may be -1, got {unknown}")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"cannot infer {unknown[0]}: {n_devices} devices not "
                    f"divisible by {known}")
            sizes[unknown[0]] = n_devices // known
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
                f"have {n_devices}")
        return sizes

    def build(self, devices=None) -> Mesh:
        """The mesh over ``devices`` (global ranks; default every rank of
        the world), laid out row-major in `AXIS_ORDER`: ``tensor``
        innermost, so tensor-parallel collectives run between
        neighbouring ranks (one host's NVLink peers), ``pipe``/``data``
        outermost."""
        return Mesh(self.rank_array(devices))

    def rank_array(self, devices=None) -> np.ndarray:
        """`build`'s layout: the ranks as an array shaped by `AXIS_ORDER`."""
        ranks = _ranks(devices)
        sizes = self.resolve(len(ranks))
        return np.asarray(ranks).reshape(tuple(sizes[a] for a in AXIS_ORDER))

    def build_multislice(self, num_slices: int, devices=None) -> Mesh:
        """Multi-slice mesh: the OUTER factor of the ``data`` (or, when
        data does not divide, ``pipe``) axis spans slices, each slice a
        contiguous block of ``n / num_slices`` ranks (the reference's
        layout without slice metadata, so a rank sits where JAX puts the
        device of the same id), so gradient sums cross slices once while
        every model axis stays inside one."""
        return Mesh(self.multislice_rank_array(num_slices, devices))

    def multislice_rank_array(self, num_slices: int,
                              devices=None) -> np.ndarray:
        """`build_multislice`'s layout as a rank array."""
        ranks = _ranks(devices)
        n = len(ranks)
        if n % num_slices:
            raise ValueError(
                f"{n} devices cannot split into {num_slices} slices")
        sizes = self.resolve(n)
        dcn_axis = "data" if sizes["data"] % num_slices == 0 else "pipe"
        if sizes[dcn_axis] % num_slices:
            raise ValueError(
                f"neither data={sizes['data']} nor pipe={sizes['pipe']} "
                f"divides into {num_slices} slices (the DCN axis must)")
        ici_sizes = dict(sizes)
        ici_sizes[dcn_axis] //= num_slices
        ici_shape = tuple(ici_sizes[a] for a in AXIS_ORDER)
        per = n // num_slices
        blocks = [np.asarray(ranks[i * per:(i + 1) * per]).reshape(ici_shape)
                  for i in range(num_slices)]
        return np.concatenate(blocks, axis=AXIS_ORDER.index(dcn_axis))


def _ranks(devices) -> list[int]:
    if devices is None:
        return list(range(world_size()))
    return [int(d) for d in devices]


def active_mesh(mesh):
    """``mesh`` if it spans more than one rank, else None: a mesh of one
    runs the single-card code."""
    return mesh if mesh is not None and mesh.size > 1 else None


def single_device_mesh() -> Mesh:
    """A mesh of this rank alone: the single-card code paths, with no
    collective."""
    return MeshSpec(data=1).build([world_rank()])


def dp_mesh(n: int | None = None) -> Mesh:
    """A data-parallel mesh over the first ``n`` ranks (default all)."""
    return MeshSpec(data=-1).build(
        list(range(world_size() if n is None else n)))
