"""Collectives over mesh axes: the counterpart of `jax.lax`'s collectives
inside ``shard_map`` (``axis_index``, ``psum``, ``pmax``, ``all_gather``,
``psum_scatter``, ``ppermute``), for code that runs one process per rank.

JAX's single-controller ``shard_map`` has no counterpart here: code
written per shard is what every rank runs already. Each collective is a
`torch.autograd.Function` whose backward is JAX's transpose of it:
`psum`'s is a psum, `all_gather`'s a reduce-scatter (and the reverse),
`ppermute`'s the inverse permutation. Beside them sit the two Megatron
conjugates, for values every rank of an axis holds whole: `copy_to`
(identity forward, all-reduce backward: a replicated input feeding a
split computation) and `reduce_from` (all-reduce forward, identity
backward: partial results combined into a replicated value), and
`gather_from` (all-gather forward, this rank's block of the cotangent
backward: a split value every rank then uses whole). `pmax`
has no transpose and returns a tensor outside autograd.

Backends: NCCL runs when every rank has a card of its own. gloo runs on
the CPU, and on the card where ranks share one device (NCCL refuses two
ranks on one card); gloo takes only host tensors here, so a CUDA tensor
on a gloo group is copied to the host, reduced there and copied back,
explicitly, and `STATS` counts those copies and their bytes. Every call
adds its wall seconds to ``STATS["seconds"]``; a host-staged call first
waits for the work queued before it on the device, so its seconds are
the collective's and the copies' alone. NCCL's seconds are the time to
enqueue it.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.autograd import Function

from ray_tpu_torch.parallel.mesh import Mesh, world_rank

STATS = {"calls": 0, "seconds": 0.0, "host_copies": 0, "host_bytes": 0}


def stats() -> dict:
    """Calls, wall seconds, host copies and host bytes since the last
    `reset_stats`."""
    return dict(STATS)


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, host_copies=0, host_bytes=0)


def stages_through_host(group, device) -> bool:
    """True where a tensor on ``device`` goes through host memory for a
    collective on ``group`` (gloo with a CUDA tensor)."""
    return (torch.device(device).type == "cuda"
            and dist.get_backend(group) == "gloo")


class _Call:
    """One collective's bookkeeping: ``wire(x)`` is the tensor the
    backend reads (a host copy when staged), ``back(y, like)`` returns a
    result to ``like``'s device."""

    def __init__(self, group, device):
        self.staged = stages_through_host(group, device)
        self.device = device

    def __enter__(self):
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()
        self.t0 = time.perf_counter()
        return self

    def wire(self, x):
        x = x.detach()
        if self.staged:
            STATS["host_copies"] += 1
            STATS["host_bytes"] += x.numel() * x.element_size()
            return x.to("cpu").contiguous()
        return x.contiguous()

    def back(self, y):
        if self.staged:
            STATS["host_copies"] += 1
            STATS["host_bytes"] += y.numel() * y.element_size()
            return y.to(self.device)
        return y

    def __exit__(self, *exc):
        STATS["calls"] += 1
        STATS["seconds"] += time.perf_counter() - self.t0


def _all_reduce(x, grp, op=dist.ReduceOp.SUM):
    group, _ = grp
    with _Call(group, x.device) as c:
        buf = c.wire(x)
        if buf.data_ptr() == x.data_ptr():
            buf = buf.clone()
        dist.all_reduce(buf, op=op, group=group)
        return c.back(buf)


def _all_gather(x, grp, dim: int):
    group, members = grp
    n, ranked = len(members), sorted(members)
    with _Call(group, x.device) as c:
        buf = c.wire(x)
        # flat buffers: the backends concatenate along dim 0
        out = buf.new_empty((n * buf.numel(),))
        dist.all_gather_into_tensor(out, buf.reshape(-1), group=group)
        # the backend orders by group rank (sorted global ranks); the
        # mesh orders by position along the axes
        out = out.view((n,) + tuple(buf.shape))[
            [ranked.index(m) for m in members]]
        return c.back(torch.cat(out.unbind(0), dim=dim))


def _reduce_scatter(x, grp, dim: int):
    group, members = grp
    n = len(members)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    parts = x.chunk(n, dim)
    with _Call(group, x.device) as c:
        buf = c.wire(torch.stack([parts[members.index(r)]
                                  for r in sorted(members)]))
        out = buf.new_empty((buf[0].numel(),))
        dist.reduce_scatter_tensor(out, buf.reshape(-1), group=group)
        return c.back(out.view(buf.shape[1:]))


def _ppermute(x, grp, pairs, tag: int):
    group, members = grp
    me = members.index(world_rank())
    ops, got = [], None
    with _Call(group, x.device) as c:
        for src, dst in pairs:
            if src == me and dst == me:
                got = x.detach().clone()
            elif src == me:
                ops.append(dist.P2POp(dist.isend, c.wire(x), members[dst],
                                      group, tag))
            elif dst == me:
                got = torch.empty(x.shape, dtype=x.dtype,
                                  device="cpu" if c.staged else x.device)
                ops.append(dist.P2POp(dist.irecv, got, members[src], group,
                                      tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if got is None:
            return torch.zeros_like(x)
        return c.back(got) if got.device != x.device else got


class _Psum(Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.grp), None


class _CopyTo(Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.grp), None


class _ReduceFrom(Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _all_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.grp, ctx.dim), None, None


class _GatherFrom(Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _all_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        group, members = ctx.grp
        part = g.chunk(len(members), ctx.dim)[members.index(world_rank())]
        return part.contiguous(), None, None


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _reduce_scatter(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.grp, ctx.dim), None, None


class _PPermute(Function):
    @staticmethod
    def forward(ctx, x, grp, pairs, tag):
        ctx.grp, ctx.pairs, ctx.tag = grp, pairs, tag
        return _ppermute(x, grp, pairs, tag)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.pairs]
        return (_ppermute(g, ctx.grp, inverse, ctx.tag + _BWD_TAG),
                None, None, None)


_BWD_TAG = 1 << 20


# -- public: the shard_map vocabulary -------------------------------------------

def axis_index(axis_name, mesh: Mesh) -> int:
    """This rank's position along ``axis_name`` (a name or a tuple, row-
    major in the order given)."""
    return mesh.axis_index(axis_name)


def psum(x, axis_name, mesh: Mesh):
    """Sum over the ranks of ``axis_name``; the backward is a psum of the
    cotangents (JAX's transpose). A Python number gives number x size."""
    if not isinstance(x, torch.Tensor):
        return x * mesh.axis_size(mesh.live_axes(axis_name))
    grp = mesh.group(axis_name)
    return x if grp is None else _Psum.apply(x, grp)


def pmax(x, axis_name, mesh: Mesh):
    """Elementwise max over the ranks of ``axis_name``, outside autograd
    (a max has no transpose)."""
    grp = mesh.group(axis_name)
    x = x.detach()
    return x if grp is None else _all_reduce(x, grp, dist.ReduceOp.MAX)


def all_gather(x, axis_name, mesh: Mesh, *, dim: int = 0):
    """Concatenate every rank's ``x`` along ``dim`` in axis order (JAX's
    ``all_gather(tiled=True)``); the backward reduce-scatters."""
    grp = mesh.group(axis_name)
    return x if grp is None else _AllGather.apply(x, grp, dim)


def reduce_scatter(x, axis_name, mesh: Mesh, *, dim: int = 0):
    """Sum over the ranks of ``axis_name`` and keep this rank's block of
    ``dim`` (JAX's ``psum_scatter(tiled=True)``); the backward
    all-gathers."""
    grp = mesh.group(axis_name)
    return x if grp is None else _ReduceScatter.apply(x, grp, dim)


def ppermute(x, axis_name, mesh: Mesh, perm):
    """Send ``x`` from position ``src`` to position ``dst`` along
    ``axis_name`` for each ``(src, dst)`` of ``perm``; a rank no pair
    sends to gets zeros (JAX's ``ppermute``). The backward sends the
    cotangents back along the inverse pairs. Every rank of the axis calls
    it with the same ``perm``, in the same order."""
    grp = mesh.group(axis_name)
    if grp is None:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    key = tuple(mesh.live_axes(axis_name))
    tag = mesh._tags.get(key, 0)
    mesh._tags[key] = (tag + 1) % _BWD_TAG
    return _PPermute.apply(x, grp, [tuple(p) for p in perm], tag)


def copy_to(x, axis_name, mesh: Mesh):
    """Megatron's f: identity forward, all-reduce backward, for a value
    every rank of the axis holds whole that feeds a computation split
    over it."""
    grp = mesh.group(axis_name)
    return x if grp is None else _CopyTo.apply(x, grp)


def gather_from(x, axis_name, mesh: Mesh, *, dim: int = 0):
    """The all-gather of a split value that every rank of the axis then
    uses whole, each computing the same loss from it: `all_gather`
    forward, and a backward that keeps this rank's block of the
    cotangent (a reduce-scatter would count the loss once a rank)."""
    grp = mesh.group(axis_name)
    return x if grp is None else _GatherFrom.apply(x, grp, dim)


def reduce_from(x, axis_name, mesh: Mesh):
    """Megatron's g: all-reduce forward, identity backward, for partial
    results combined into a value every rank of the axis then uses
    whole."""
    grp = mesh.group(axis_name)
    return x if grp is None else _ReduceFrom.apply(x, grp)
