"""Overlapped training loop: host-to-device prefetch, multi-step
dispatch, lagged metric fetches. The counterpart of
`ray_tpu/train/loop.py` for eager PyTorch on one device.

- `DevicePrefetcher` keeps ``depth`` batches in flight: each is copied
  from pinned host memory with a non-blocking copy on a side CUDA stream,
  and an event per batch makes the consumer's stream wait for exactly
  that copy, so the transfer of batch N+1 rides under the compute of
  step N.
- `fuse_steps` / `TrainLoop(unroll=u)` run u steps per dispatch. Without
  ``jit`` there is no single executable to fuse them into, so the steps
  run in a Python loop and their metrics are stacked; one `MetricsRing`
  push per dispatch, as in the reference.
- `MetricsRing` holds the device metrics and fetches them to the host at
  most every ``interval`` steps, only once they are ``lag`` dispatches
  old, through the module's one host-fetch seam `_to_host` (tests patch
  it): one device-to-host copy per fetch, so no step waits on the host.

Each loop is a telemetry source (``train<N>``, `util.telemetry`): its
`stats` (the last run's breakdown, MFU through `telemetry.mfu`, goodput)
reach the metrics registry at every snapshot. With ``unroll > 1`` the
fused dispatch counts a build per new input signature (the shapes and
dtypes of the stacked batch: what makes a jit trace again in the
reference) under ``dispatch_traces``, and a `RetraceSentinel` holds it to
one.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch.util import telemetry as _telemetry


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to_host(tree):
    """The ONLY place this module moves device values to the host: every
    tensor leaf of ``tree`` comes back as numpy through ONE
    device-to-host copy (leaves packed into one float64 buffer, which
    holds int32 and float32 values exactly)."""
    leaves = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return tree
    flat = torch.cat([x.detach().reshape(-1).to(torch.float64)
                      for x in leaves]).cpu().numpy()
    out, at = {}, 0
    for x in leaves:
        n = x.numel()
        out[id(x)] = flat[at:at + n].reshape(tuple(x.shape)).astype(
            str(x.dtype).split(".")[-1] if x.dtype != torch.bfloat16
            else np.float32)
        at += n
    return _map(lambda x: out[id(x)] if isinstance(x, torch.Tensor) else x,
                tree)


def make_placer(device=None, *, mesh=None, rules: dict | None = None,
                accum: int = 1) -> Callable[[Any], Any]:
    """Host-batch placement fn: every numpy leaf becomes a tensor on
    ``device`` (the card unless told otherwise), copied from pinned host
    memory without blocking the host. Leaves keep their leading axes,
    so a stacked ``[u, B, ...]`` group places the same way.

    With a ``mesh`` (of more than one rank) each rank places its block
    of every leaf, the one its trainer computes on: the
    ``("batch", "length")`` rules' block of each of the ``accum``
    microbatches (`parallel.sharding.shard_batch`)."""
    from ray_tpu_torch.models.gpt import resolve_device
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import active_mesh
    device = resolve_device(device)
    mesh = active_mesh(mesh)

    def put(a):
        t = torch.as_tensor(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def place(tree):
        if mesh is not None:
            tree = sharding.shard_batch(tree, mesh, rules, accum)
        return _map(put, tree)
    place.device = device
    return place


class DevicePrefetcher:
    """Keeps ``depth`` host-to-device transfers in flight ahead of the
    consumer. On a CUDA placer each batch is placed under a side stream
    and an event is recorded after it; `__next__` makes the current
    stream wait on that event (and marks the batch's memory as used by
    the current stream), so a step never reads a batch before its copy
    lands and the host never waits. Every yielded batch is a fresh
    allocation, never re-filled.

    Host batches are flat dicts of arrays. ``group=g`` stacks g of them
    leaf-wise (leading ``[g, ...]`` axis) before placing: the input of a ``TrainLoop(unroll=g)``
    dispatch. A trailing ragged group is dropped and counted in
    ``skipped_ragged``. A host-iterator exception is never masked as
    end-of-stream: batches already placed are delivered in order, then
    the original exception is raised (and keeps being raised)."""

    def __init__(self, host_iter: Iterable, place: Callable[[Any], Any],
                 *, depth: int = 2, group: int = 1):
        self._host = iter(host_iter)
        self._place = place
        self._depth = max(1, int(depth))
        self._group = max(1, int(group))
        self._buf: collections.deque = collections.deque()
        self._err: BaseException | None = None
        self._exhausted = False
        dev = getattr(place, "device", None)
        self._device = dev
        self._stream = (torch.cuda.Stream(dev) if dev is not None
                        and torch.device(dev).type == "cuda" else None)
        self.issued = 0
        self.skipped_ragged = 0

    def _next_host_batch(self):
        if self._group == 1:
            return next(self._host)
        parts = list(itertools.islice(self._host, self._group))
        if len(parts) < self._group:
            self.skipped_ragged += len(parts)
            raise StopIteration
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}

    def _issue(self, host):
        if self._stream is None:
            return self._place(host), None
        with torch.cuda.stream(self._stream):
            placed = self._place(host)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return placed, ev

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while (not self._exhausted and self._err is None
               and len(self._buf) < self._depth):
            try:
                self._buf.append(self._issue(self._next_host_batch()))
                self.issued += 1
            except StopIteration:
                self._exhausted = True
            except Exception as e:
                self._err = e
        if self._buf:
            batch, ev = self._buf.popleft()
            if ev is not None:
                cur = torch.cuda.current_stream(self._device)
                cur.wait_event(ev)
                for t in _leaves(batch):
                    t.record_stream(cur)
            return batch
        if self._err is not None:
            raise self._err
        raise StopIteration


class MetricsRing:
    """Device-side metrics with bounded, lagged host fetches. `push`
    stores the device metrics a dispatch returned (no sync); entries are
    fetched at most every ``interval`` steps, only once they are at
    least ``lag`` dispatches old, so the fetch finds them computed.
    `drain` fetches the rest (the one deliberate end-of-run sync)."""

    def __init__(self, interval: int = 10, lag: int = 2):
        self.interval = max(1, int(interval))
        self.lag = max(0, int(lag))
        self._pending: collections.deque = collections.deque()
        self.history: list = []
        self.fetches = 0
        self._steps_pushed = 0
        self._last_sync = 0

    def push(self, metrics, count: int = 1) -> None:
        """Store one dispatch's device metrics (``count`` = steps in the
        dispatch; leaves carry a leading [count] axis when count > 1)."""
        self._pending.append((count, metrics))
        self._steps_pushed += count
        if (self._steps_pushed - self._last_sync >= self.interval
                and len(self._pending) > self.lag):
            self._sync(keep=self.lag)
            self._last_sync = self._steps_pushed

    def _sync(self, keep: int) -> None:
        take = len(self._pending) - keep
        if take <= 0:
            return
        items = [self._pending.popleft() for _ in range(take)]
        hosts = _to_host([m for _, m in items])
        self.fetches += 1
        for (count, _), host in zip(items, hosts):
            if count == 1:
                self.history.append(host)
            else:
                self.history.extend(_map(lambda a, i=i: a[i], host)
                                    for i in range(count))

    def drain(self) -> list:
        self._sync(keep=0)
        self._steps_pushed = 0
        self._last_sync = 0
        return self.history


def fuse_steps(step_fn: Callable, unroll: int,
               on_trace: Callable | None = None) -> Callable:
    """One dispatch running ``unroll`` chained steps: takes batch leaves
    stacked ``[unroll, ...]`` and returns the metrics stacked the same
    way. Eager PyTorch has no executable to fuse the steps into, so they
    run in a Python loop. ``on_trace`` (if given) is called at the first
    dispatch of each new input signature (leaf names, shapes and
    dtypes): the compile-once counter seam the retrace sentinel watches,
    where the reference's jit traces."""
    unroll = int(unroll)
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    seen: set = set()

    def multi(state, stacked):
        if on_trace is not None:
            sig = tuple((k, tuple(v.shape), v.dtype)
                        for k, v in sorted(stacked.items()))
            if sig not in seen:
                seen.add(sig)
                on_trace()
        ms = []
        for i in range(unroll):
            state, m = step_fn(state, {k: v[i] for k, v in stacked.items()})
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return multi


class TrainLoop:
    """Overlap-aware driver around a ``(state, batch) -> (state,
    metrics)`` step: the step itself for ``unroll=1``, `fuse_steps`
    otherwise. Metrics go through a `MetricsRing`; `run` returns the
    drained per-step host metrics, so the only blocking sync is at the
    end of each run. ``checkpointer`` (``maybe_snapshot(state, step)`` +
    ``flush()``) and ``publisher(state, step)`` are optional hooks
    called after each dispatch, before the next one updates the state in
    place (`rl.FlywheelLoop` publishes its weights into its engine
    through ``publisher``; `train.ft.AsyncCheckpointer` is the
    checkpointer).
    ``device`` names the device whose peak `stats`' MFU is read
    against (default: the current CUDA device)."""

    def __init__(self, step_fn: Callable, *, unroll: int = 1,
                 metrics_interval: int = 10, metrics_lag: int = 2,
                 checkpointer=None, publisher: Callable | None = None,
                 flops_per_step: float | None = None, device=None):
        self.unroll = max(1, int(unroll))
        self.metrics_interval = metrics_interval
        self.metrics_lag = metrics_lag
        # Compile-once accounting for the fused dispatch; for unroll=1 the
        # dispatch is the caller's step_fn, which is not ours to
        # instrument, so the watch is unroll > 1 only (as the reference).
        self.dispatch_traces = 0

        def _count_trace():
            self.dispatch_traces += 1

        self._dispatch = (step_fn if self.unroll == 1
                          else fuse_steps(step_fn, self.unroll,
                                          on_trace=_count_trace))
        self.last_ring: MetricsRing | None = None
        self.last_breakdown: dict = {}
        self.flops_per_step = flops_per_step
        self.device = device
        self.last_mfu = 0.0
        self.last_goodput = 0.0
        self.name = _telemetry.next_name("train")
        self.sentinel = _telemetry.RetraceSentinel(self.name)
        if self.unroll > 1:
            self.sentinel.watch("dispatch", lambda: self.dispatch_traces,
                                cap=1, registered=True)
        _telemetry.register_stats_source(self.name, self, kind="train")
        self.checkpointer = checkpointer
        self.publisher = publisher

    def run(self, state, device_batches: Iterable,
            num_steps: int | None = None, *, start_step: int = 0):
        """Drive steps until ``num_steps`` TOTAL steps are reached (or the
        batches end). ``device_batches`` yields one batch per DISPATCH
        (leaves ``[unroll, B, ...]`` when unroll > 1, as
        ``DevicePrefetcher(group=unroll)`` makes them). Returns (state,
        per-step host metrics)."""
        ring = MetricsRing(self.metrics_interval, self.metrics_lag)
        self.last_ring = ring
        ckpt = self.checkpointer
        done = int(start_step)
        pc = time.perf_counter
        prefetch_s = dispatch_s = metrics_s = 0.0
        checkpoint_s = publish_s = 0.0
        t_run = pc()
        it = iter(device_batches)
        while True:
            t0 = pc()
            try:
                batch = next(it)
            except StopIteration:
                prefetch_s += pc() - t0
                break
            t1 = pc()
            state, metrics = self._dispatch(state, batch)
            t2 = pc()
            ring.push(metrics, count=self.unroll)
            t3 = pc()
            done += self.unroll
            if ckpt is not None:
                ckpt.maybe_snapshot(state, done)
            t4 = pc()
            if self.publisher is not None:
                self.publisher(state, done)
            t5 = pc()
            prefetch_s += t1 - t0
            dispatch_s += t2 - t1
            metrics_s += t3 - t2
            checkpoint_s += t4 - t3
            publish_s += t5 - t4
            if self.unroll > 1:
                self.sentinel.check()
            if num_steps is not None and done >= num_steps:
                break
        if ckpt is not None:
            t0 = pc()
            ckpt.flush()
            checkpoint_s += pc() - t0
        t0 = pc()
        out = ring.drain()
        metrics_s += pc() - t0
        total_s = pc() - t_run
        steps_run = done - int(start_step)
        denom = max(total_s, 1e-12)
        self.last_breakdown = {
            "steps": steps_run,
            "total_s": total_s,
            "prefetch_s": prefetch_s,
            "dispatch_s": dispatch_s,
            "metrics_s": metrics_s,
            "checkpoint_s": checkpoint_s,
            "publish_s": publish_s,
            "prefetch_share": prefetch_s / denom,
            "dispatch_share": dispatch_s / denom,
            "metrics_share": metrics_s / denom,
            "checkpoint_share": checkpoint_s / denom,
            "publish_share": publish_s / denom,
        }
        self.last_goodput = dispatch_s / denom
        if self.flops_per_step and steps_run:
            self.last_mfu = _telemetry.mfu(
                self.flops_per_step * steps_run / denom, n_devices=1,
                device=self.device)
        return state, out

    def stats(self) -> dict:
        """Telemetry-bridge stats dict (`util.telemetry` republishes these
        as train_* series at every snapshot): the last run's step-time
        breakdown plus MFU/goodput and the fused-dispatch compile-once
        accounting."""
        return {
            "dispatch_traces": self.dispatch_traces,
            "retraces_unexpected": self.sentinel.retraces_unexpected,
            "unroll": self.unroll,
            "mfu": self.last_mfu,
            "goodput": self.last_goodput,
            **self.last_breakdown,
        }


def run_steps(step_fn: Callable, state, device_batches: Iterable,
              *, num_steps: int | None = None, unroll: int = 1,
              metrics_interval: int = 10, metrics_lag: int = 2):
    """One-shot convenience over `TrainLoop` (build + run)."""
    loop = TrainLoop(step_fn, unroll=unroll,
                     metrics_interval=metrics_interval,
                     metrics_lag=metrics_lag)
    return loop.run(state, device_batches, num_steps=num_steps)
