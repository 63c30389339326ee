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

The reference's retrace sentinel watches jit retraces; eager PyTorch has
no compile cache to watch, so it has no counterpart here.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

# bf16 dense tensor-core peak per device, by name (NVIDIA's data sheets,
# SXM parts), for MFU. A device not listed reports no MFU.
PEAK_FLOPS = (("H100", 989e12), ("H200", 989e12))


def peak_flops(device) -> float | None:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, val in PEAK_FLOPS:
        if key in name:
            return val
    return None


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


def make_placer(device=None) -> Callable[[Any], Any]:
    """Host-batch placement fn: every numpy leaf becomes a tensor on
    ``device`` (the card unless told otherwise), copied from pinned host
    memory without blocking the host. Leaves keep their leading axes,
    so a stacked ``[u, B, ...]`` group places the same way."""
    from ray_tpu_torch.models.gpt import resolve_device
    device = resolve_device(device)

    def put(a):
        t = torch.as_tensor(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def place(tree):
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


def fuse_steps(step_fn: Callable, unroll: int) -> Callable:
    """One dispatch running ``unroll`` chained steps: takes batch leaves
    stacked ``[unroll, ...]`` and returns the metrics stacked the same
    way. Eager PyTorch has no executable to fuse the steps into, so they
    run in a Python loop."""
    unroll = int(unroll)
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")

    def multi(state, stacked):
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
    called after each dispatch (fault-tolerant checkpoints and the RL
    flywheel are ROADMAP A7 and A6)."""

    def __init__(self, step_fn: Callable, *, unroll: int = 1,
                 metrics_interval: int = 10, metrics_lag: int = 2,
                 checkpointer=None, publisher: Callable | None = None,
                 flops_per_step: float | None = None, device=None):
        self.unroll = max(1, int(unroll))
        self.metrics_interval = metrics_interval
        self.metrics_lag = metrics_lag
        self._dispatch = (step_fn if self.unroll == 1
                          else fuse_steps(step_fn, self.unroll))
        self.last_ring: MetricsRing | None = None
        self.last_breakdown: dict = {}
        self.flops_per_step = flops_per_step
        self.peak_flops = None if device is None else peak_flops(device)
        self.last_mfu: float | None = None
        self.last_goodput = 0.0
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
        if self.flops_per_step and self.peak_flops and steps_run:
            self.last_mfu = (self.flops_per_step * steps_run / denom
                             / self.peak_flops)
        return state, out

    def stats(self) -> dict:
        """The last run's step-time breakdown plus MFU (None where the
        device's peak is unknown, e.g. on the CPU) and goodput."""
        return {"unroll": self.unroll, "mfu": self.last_mfu,
                "goodput": self.last_goodput, **self.last_breakdown}


def run_steps(step_fn: Callable, state, device_batches: Iterable,
              *, num_steps: int | None = None, unroll: int = 1,
              metrics_interval: int = 10, metrics_lag: int = 2):
    """One-shot convenience over `TrainLoop` (build + run)."""
    loop = TrainLoop(step_fn, unroll=unroll,
                     metrics_interval=metrics_interval,
                     metrics_lag=metrics_lag)
    return loop.run(state, device_batches, num_steps=num_steps)
