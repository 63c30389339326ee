"""Logical-axis sharding rules: the counterpart of
`ray_tpu/parallel/sharding.py`.

Parameters and activations are annotated with *logical* axis names
("embed", "mlp", "heads", "batch", "length"); a rule table maps logical
axes to mesh axes, and a `PartitionSpec` names, per dimension, the mesh
axes that split it. In JAX a spec places a global array; here every rank
holds its own block, so the same spec says which block: `local_shard`
cuts a rank's block out of a whole value, `gather_full` puts the blocks
back together, and `shard_batch` keeps a rank's block of a host batch.

`spec_to_json`, `spec_from_json` and `valid_spec_for` are the
reference's, so checkpoints record and re-apply the same specs in both
packages. The serving specs (`kv_cache_specs`, `kv_pool_specs`,
`replicated`, `engine_io_shardings`) say which block of a KV cache or
pool a rank allocates and which per-step host inputs every rank of an
engine's mesh must agree on.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import Mesh

# Mesh axes a parameter may be split over only to save memory: the leaf is
# gathered over them before use (ZeRO-3). The model axes ("tensor" on the
# heads / mlp / vocab dims, "pipe" on the layer stack) are computed on
# split.
ZERO_AXES = ("data", "fsdp", "seq")

# Default rule table for transformer-family models. Each logical axis maps
# to a mesh axis (or None = replicated). Tuples shard one logical axis over
# several mesh axes.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("data", "fsdp"),   # batch sharded over all data-like axes
    "length": "seq",             # sequence/context parallelism
    "embed": "fsdp",             # ZeRO-3-style parameter sharding
    "mlp": "tensor",             # megatron column/row parallel
    "heads": "tensor",
    "kv": None,
    "vocab": "tensor",
    "expert": "expert",
    "stage": "pipe",
}


class PartitionSpec(tuple):
    """Per dimension: None (whole), a mesh axis name, or a tuple of them
    (the dimension split over their product, row-major); a tuple of one
    name is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _mesh_axes(mesh: Mesh) -> set:
    return set(mesh.axis_names)


def logical_to_spec(logical_axes: Sequence[str | None],
                    rules: dict | None = None,
                    mesh: Mesh | None = None) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec via the rule table.

    Mesh axes that don't exist on `mesh` (or have size 1) still produce
    valid specs: sharding over a size-1 axis is replication, which is what
    makes one model definition portable from 1 rank to many.
    """
    rules = DEFAULT_RULES if rules is None else rules
    present = _mesh_axes(mesh) if mesh is not None else None
    used = set()
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
            continue
        target = rules.get(ax)
        if target is None:
            out.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        axes = tuple(a for a in axes
                     if (present is None or a in present) and a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return PartitionSpec(*out)


def tree_shardings(mesh: Mesh, logical_tree, rules: dict | None = None):
    """Map a tree (nested dicts) of logical-axis tuples to PartitionSpecs
    (the reference returns NamedShardings; a spec is what a rank needs to
    cut its block)."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v, rules)
                for k, v in logical_tree.items()}
    return logical_to_spec(logical_tree or (), rules, mesh)


def fused_xent_specs(mesh: Mesh, rules: dict | None = None
                     ) -> tuple[PartitionSpec, PartitionSpec,
                                PartitionSpec]:
    """(x, embed, targets) PartitionSpecs for `ops.fused_xent`'s
    vocab-sharded composition: activations and targets follow the
    batch/length rules; the embedding keeps its vocab sharding but holds
    d_model whole (each shard reduces its own vocabulary rows to a
    partial log-sum-exp and partial target logit, and one psum over the
    vocab mesh axis combines them)."""
    x_spec = logical_to_spec(("batch", "length", None), rules, mesh)
    t_spec = logical_to_spec(("batch", "length"), rules, mesh)
    e_spec = logical_to_spec(("vocab", None), rules, mesh)
    return x_spec, e_spec, t_spec


def kv_cache_specs(mesh: Mesh, rules: dict | None = None) -> dict:
    """PartitionSpecs of a decode KV cache {"k", "v"} of ``[L, slots,
    max_len, H, Dh]``: slots over the data axes (each data rank serves
    its own rows), heads over ``tensor`` (the wq/wk/wv column split, so
    the rows a tensor rank writes are the heads it attends over); layers,
    length and head dim whole."""
    from ray_tpu_torch.models.gpt import kv_cache_logical_axes
    return {name: logical_to_spec(axes, rules, mesh)
            for name, axes in kv_cache_logical_axes().items()}


def kv_pool_specs(mesh: Mesh, rules: dict | None = None, *,
                  quantized: bool = False) -> dict:
    """PartitionSpecs of a paged block pool {"k", "v"} of ``[L, n_blocks,
    block_size, H, Dh]``: heads over ``tensor`` as the unpaged cache, the
    block axis whole (the allocator hands any block to any sequence, so
    blocks cannot sit on data ranks). With ``quantized`` (an int8 pool)
    {"k_scale", "v_scale"} of ``[L, n_blocks, block_size, H]`` follow
    their heads."""
    from ray_tpu_torch.models.gpt import kv_pool_logical_axes
    return {name: logical_to_spec(axes, rules, mesh)
            for name, axes in kv_pool_logical_axes(quantized).items()}


def replicated(mesh: Mesh) -> PartitionSpec:
    """The spec of a value every rank holds whole."""
    return PartitionSpec()


# The inference engine's per-step host inputs: current tokens, speculation
# windows, positions, block tables, temperatures.
ENGINE_IO = ("tokens", "window", "pos", "tables", "temps")


def engine_io_shardings(mesh: Mesh) -> dict:
    """``{name: spec}`` of the engine's per-step host inputs, all
    replicated: tiny int32/f32 arrays the scheduler rebuilds every tick,
    which every rank of the mesh must hold equal (the engine checks them
    against the mesh's first rank before each step)."""
    return {name: replicated(mesh) for name in ENGINE_IO}


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names, in order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else tuple(entry))
    return tuple(out)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh: Mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` value under ``spec``;
    a dimension its axes do not divide raises."""
    out = []
    for i, dim in enumerate(shape):
        n = mesh.axis_size(_entry_axes(spec[i]) if i < len(spec) else ())
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {n} ranks ({spec})")
        out.append(dim // n)
    return tuple(out)


def local_shard(x, spec, mesh: Mesh):
    """This rank's block of the whole value ``x`` (a tensor or numpy
    array) under ``spec``: each split dimension keeps the slice at the
    rank's position along its axes. A contiguous copy (numpy stays
    numpy)."""
    local_shape(x.shape, spec, mesh)
    for i, entry in enumerate(tuple(spec)[:x.ndim]):
        axes = _entry_axes(entry)
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        size = x.shape[i] // n
        start = mesh.axis_index(axes) * size
        if isinstance(x, np.ndarray):
            x = np.take(x, np.arange(start, start + size), axis=i)
        else:
            x = x.narrow(i, start, size)
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x)
    return x.contiguous()


def gather_full(x, spec, mesh: Mesh):
    """The whole value from every rank's block ``x`` under ``spec``
    (the inverse of `local_shard`; all ranks of the split axes call it),
    outside autograd."""
    with torch.no_grad():
        for i, entry in enumerate(tuple(spec)[:x.ndim]):
            axes = _entry_axes(entry)
            if mesh.axis_size(axes) > 1:
                x = collectives.all_gather(x, axes, mesh, dim=i)
    return x


def token_axes(mesh: Mesh, rules: dict | None = None) -> tuple:
    """The mesh axes (of size > 1) that split a batch's tokens
    ("batch", "length")."""
    return mesh.live_axes(spec_axes(
        logical_to_spec(("batch", "length"), rules, mesh)))


def row_axes(mesh: Mesh, rules: dict | None = None) -> tuple:
    """The mesh axes (of size > 1) that split a batch's rows (the
    ``"batch"`` rule)."""
    return mesh.live_axes(spec_axes(logical_to_spec(("batch",), rules,
                                                    mesh)))


def shard_batch(batch, mesh: Mesh, rules: dict | None = None,
                accum: int = 1):
    """A host batch (a dict of arrays, or one array) -> this rank's
    block of it: the leading two dimensions split by the
    ``("batch", "length")`` rules, the rest whole (the reference places
    the rows; its step then splits the tokens, a rank here takes its
    block at once). With ``accum=k`` the batch is the k microbatches a
    step splits it into, and the rank keeps its block of each,
    microbatch-major."""
    spec = PartitionSpec(None, *logical_to_spec(("batch", "length"),
                                                rules, mesh))

    def take(a):
        a = np.asarray(a)
        if a.shape[0] % accum:
            raise ValueError(f"batch of {a.shape[0]} rows does not split "
                             f"into accum={accum} microbatches")
        a = a.reshape((accum, a.shape[0] // accum) + a.shape[1:])
        a = local_shard(a, spec, mesh)
        return a.reshape((-1,) + a.shape[2:])
    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


# -- PartitionSpec (de)serialization for checkpoint manifests ---------------
#
# Mesh axis NAMES are stable across scale changes (MeshSpec keeps size-1
# axes for exactly this reason), so a spec recorded at save time can be
# re-applied to a mesh with a different device count at restore time —
# the elastic-resume path in train/ft.py. Sizes are not recorded: only
# names travel, and `valid_spec_for` re-validates them against the mesh
# that exists at restore.

def spec_to_json(spec) -> list:
    """PartitionSpec -> JSON-serializable list (None | str | [str, ...]
    per dim)."""
    out = []
    for entry in tuple(spec):
        if entry is None or isinstance(entry, str):
            out.append(entry)
        else:
            out.append(list(entry))
    return out


def spec_from_json(entries) -> PartitionSpec:
    """Inverse of `spec_to_json`."""
    out = []
    for entry in entries:
        if entry is None or isinstance(entry, str):
            out.append(entry)
        else:
            out.append(tuple(entry))
    return PartitionSpec(*out)


def valid_spec_for(mesh: Mesh, spec, shape) -> PartitionSpec:
    """Re-validate a recorded PartitionSpec against a (possibly different)
    mesh: axes that don't exist on `mesh`, are already used by an earlier
    dim, or don't divide the dim evenly are dropped (replicated) — the
    same degrade-to-replication contract as `logical_to_spec`, applied at
    restore time."""
    present = _mesh_axes(mesh)
    used: set = set()
    out = []
    entries = list(tuple(spec))[:len(shape)]
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if a in present and a not in used)
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        if not axes or (total and dim % total):
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return PartitionSpec(*out)
