"""Replica actor — hosts one copy of the user's deployment callable; a
copy of `ray_tpu/serve/replica.py` (the port imports nothing of `ray_tpu`).

Counterpart of the reference's `RayServeReplica`
(`serve/_private/replica.py:429`, handle_request :695): wraps the user
class/function, counts in-flight requests for autoscaling, and exposes
health checks. Async end-to-end: handle_request/handle_method are
coroutines, so the replica runs as an asyncio actor (one event loop,
max_concurrency as a semaphore — worker_main.py) and thousands of
concurrent slow requests overlap on awaits; sync user callables execute
on a worker thread so they can't stall the loop.
"""

from __future__ import annotations

import itertools
import threading
import time
from types import GeneratorType

STREAM_MARKER = "__serve_stream__"
from ray_tpu_torch._private.constants import (
    SERVE_STREAM_BATCH as _STREAM_BATCH,
    SERVE_STREAM_IDLE_TTL_S as _STREAM_IDLE_TTL_S,
)


class StreamingResponse:
    """Deployment return type for streamed HTTP bodies (reference:
    serve's StreamingResponse over `replica.py:249` generator replies).
    Wraps any iterable of bytes/str chunks."""

    def __init__(self, content, content_type: str = "text/plain",
                 status: int = 200):
        self.content = content
        self.content_type = content_type
        self.status = status


class Sealed:
    """A deployment's callable and init arguments, pickled once in the
    driver (`serve.api`). The controller keeps and forwards them without
    unpickling them, so it never imports what they need (an engine
    deployment's ``torch``); the replica opens them."""

    def __init__(self, value):
        import cloudpickle
        self.blob = cloudpickle.dumps(value)

    def open(self):
        import pickle
        return pickle.loads(self.blob)


class Replica:
    # Control-plane RPCs skip the actor's max_concurrency semaphore
    # (worker_main._run_task_async; reference: Ray's concurrency
    # groups): a replica whose whole admission window is parked in
    # long-blocking next_chunks pulls must still answer the
    # controller's stats scrape and health ping promptly — starving
    # them reads as dead replicas and invisible queue depth.
    _control_plane_methods = ("stats", "check_health", "ready",
                              "install_faults", "prepare_shutdown",
                              "cancel_stream")

    def __init__(self, serialized_init: dict):
        """serialized_init: {"callable": cls_or_fn, "init_args": tuple,
        "init_kwargs": dict, "deployment_name": str}"""
        self.deployment_name = serialized_init["deployment_name"]
        # Priority class stamped on requests that carry none of their
        # own (@serve.deployment(default_priority=...)).
        self._default_priority = int(
            serialized_init.get("default_priority", 0))
        target = serialized_init["callable"]
        args = serialized_init.get("init_args", ())
        kwargs = serialized_init.get("init_kwargs", {})
        if isinstance(target, Sealed):
            target, args, kwargs = target.open()
        if isinstance(target, type):
            self.callable = target(*args, **kwargs)
            self._is_function = False
        else:
            self.callable = target
            self._is_function = True
        self._inflight = 0
        self._total = 0
        self._lock = threading.Lock()
        self._started = time.time()
        # stream_id -> [iterator, last_access_ts]; idle entries are reaped
        # (a caller that got the marker but never drains would otherwise
        # pin the generator + its closure for the replica's lifetime)
        self._streams: dict[int, list] = {}
        self._stream_ids = itertools.count(1)
        # Sync handlers get a dedicated pool sized to the concurrency the
        # deployment declared: the default asyncio executor caps at
        # ~min(32, cpus+4) threads, which would throttle sync-handler
        # concurrency below max_concurrent_queries and can deadlock a
        # deployment whose sync handlers call back into itself.
        from concurrent.futures import ThreadPoolExecutor
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(
                serialized_init.get("max_concurrent_queries", 8))),
            thread_name_prefix=f"replica-{self.deployment_name}")
        # Telemetry bridge: this replica's stats() (its own counters
        # merged over the user callable's — engine stats for
        # InferenceReplica deployments) become replica_* series on
        # /metrics, tagged by a per-replica source id. Worker-resident
        # replicas reach the driver scrape via the metrics flusher.
        from ray_tpu_torch.util import telemetry as _telemetry
        self._telemetry_name = _telemetry.register_stats_source(
            _telemetry.next_name(f"replica:{self.deployment_name}#"),
            self, kind="replica")

    def ready(self) -> bool:
        return True

    def check_health(self) -> bool:
        """Reference: user-defined check_health on the deployment class
        (deployment_state.py health checks)."""
        from ray_tpu_torch.util import faults
        # fault site: 'fail' = a missed ping (controller strikes it),
        # 'kill' = the replica dies during the ping (a flap)
        faults.check("replica.health_ping")
        fn = getattr(self.callable, "check_health", None)
        if fn is not None:
            fn()
        return True

    def install_faults(self, plan) -> bool:
        """Install a `util.faults.FaultPlan` in THIS replica's process —
        the chaos tests' lever for killing/failing one specific replica
        at a deterministic point. Pass None to clear."""
        from ray_tpu_torch.util import faults
        if plan is None:
            faults.clear()
        else:
            faults.install(plan)
        return True

    def _enter(self):
        with self._lock:
            self._inflight += 1
            self._total += 1

    def _exit(self):
        with self._lock:
            self._inflight -= 1

    def _maybe_stream(self, result):
        """Generator / StreamingResponse results stay ON the replica; the
        caller gets a marker and drains chunk batches via next_chunks
        (reference: streaming replies, replica.py:249 — a generator can't
        ride the object store)."""
        if isinstance(result, StreamingResponse):
            return {STREAM_MARKER: self._register_stream(
                        iter(result.content)),
                    "content_type": result.content_type,
                    "status": result.status}
        if isinstance(result, GeneratorType):
            return {STREAM_MARKER: self._register_stream(result),
                    "content_type": "application/octet-stream",
                    "status": 200}
        return result

    def _register_stream(self, it) -> int:
        sid = next(self._stream_ids)
        now = time.time()
        with self._lock:
            stale = [s for s, (_, ts) in self._streams.items()
                     if now - ts > _STREAM_IDLE_TTL_S]
            for s in stale:
                dead, _ = self._streams.pop(s)
                if hasattr(dead, "close"):
                    try:
                        dead.close()
                    except Exception:
                        pass
            self._streams[sid] = [it, now]
        return sid

    @staticmethod
    def _pop_model_id(kwargs: dict) -> str:
        return kwargs.pop("__multiplexed_model_id__", "")

    def _pop_priority(self, kwargs: dict) -> int:
        return int(kwargs.pop("__serve_priority__",
                              self._default_priority))

    async def _invoke(self, target, args, kwargs):
        """Run the user callable without stalling the replica: coroutine
        functions are awaited on the replica's event loop; sync callables
        leave the loop for a worker thread (carrying the request context,
        so get_multiplexed_model_id still resolves there)."""
        import asyncio
        import contextvars
        import inspect
        result = None
        if inspect.iscoroutinefunction(target):
            result = await target(*args, **kwargs)
        else:
            ctx = contextvars.copy_context()
            loop = asyncio.get_running_loop()
            result = await loop.run_in_executor(
                self._executor, lambda: ctx.run(target, *args, **kwargs))
        if inspect.isawaitable(result):   # sync fn returning a coroutine
            result = await result
        return result

    async def handle_request(self, args: tuple, kwargs: dict):
        """__call__ path (HTTP and plain handle calls). Async end-to-end
        (reference: `serve/_private/replica.py:429` — the replica IS an
        asyncio actor; thousands of slow requests overlap on awaits)."""
        from ray_tpu_torch.serve.multiplex import _set_model_id
        from ray_tpu_torch.serve.priority import _set_priority
        kwargs = dict(kwargs)
        _set_model_id(self._pop_model_id(kwargs))
        _set_priority(self._pop_priority(kwargs))
        self._enter()
        try:
            target = (self.callable if self._is_function
                      else self.callable.__call__)
            return self._maybe_stream(
                await self._invoke(target, args, kwargs))
        finally:
            self._exit()

    async def handle_method(self, method: str, args: tuple, kwargs: dict):
        """handle.method.remote path (model composition)."""
        from ray_tpu_torch.serve.multiplex import _set_model_id
        from ray_tpu_torch.serve.priority import _set_priority
        kwargs = dict(kwargs)
        _set_model_id(self._pop_model_id(kwargs))
        _set_priority(self._pop_priority(kwargs))
        self._enter()
        try:
            return self._maybe_stream(await self._invoke(
                getattr(self.callable, method), args, kwargs))
        finally:
            self._exit()

    async def next_chunks(self, stream_id: int,
                          max_chunks: int = _STREAM_BATCH):
        """Pull the next batch of chunks from a registered stream.
        Returns (chunks, done); the stream is dropped when done. An
        unknown/TTL-reaped id returns (None, True) — consumers must treat
        that as an ERROR, not a clean EOF, or a reaped stream looks like
        a complete (truncated) response. Async wrapper: the user's
        generator may block per chunk (inference, I/O), which must not
        stall the replica's event loop."""
        import asyncio
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self._next_chunks_sync, stream_id, max_chunks)

    def _next_chunks_sync(self, stream_id: int, max_chunks: int):
        with self._lock:
            entry = self._streams.get(stream_id)
            if entry is not None:
                entry[1] = time.time()
        if entry is None:
            return None, True
        it = entry[0]
        chunks = []
        done = False
        try:
            for _ in range(max_chunks):
                chunks.append(next(it))
        except StopIteration:
            done = True
        if done:
            with self._lock:
                self._streams.pop(stream_id, None)
        return chunks, done

    def cancel_stream(self, stream_id: int) -> bool:
        with self._lock:
            entry = self._streams.pop(stream_id, None)
        if entry is not None and hasattr(entry[0], "close"):
            try:
                entry[0].close()
            except Exception:
                pass
        return entry is not None

    def stats(self) -> dict:
        """Autoscaling signal (reference: autoscaling_metrics.py pulls
        per-replica queue lengths). If the user callable exposes its own
        `stats()` (e.g. `InferenceReplica` surfacing the engine's
        `queue_depth` / `decode_tok_s` / queue-wait percentiles), those
        fields are merged in — the replica-level counters win on
        collision. `streams` counts still-registered response streams,
        which the controller's scale-down drain waits on alongside
        `inflight` (and which the stream-leak regression test pins to 0
        after handles abandon/time out). Engine-backed deployments also
        merge the fault-tolerance counters (``sheds``,
        ``watchdog_stalls`` — see `InferenceEngine.stats`), which the
        telemetry bridge republishes as `replica_*` series."""
        with self._lock:
            out = {"inflight": self._inflight, "total": self._total,
                   "streams": len(self._streams),
                   "uptime_s": time.time() - self._started}
        fn = getattr(self.callable, "stats", None)
        if callable(fn) and not self._is_function:
            try:
                user = fn()
                if isinstance(user, dict):
                    for k, v in user.items():
                        out.setdefault(k, v)
            except Exception:
                pass
        return out

    def prepare_shutdown(self) -> bool:
        """Graceful-teardown hook called by the controller before kill:
        runs the user's __del__ (resource release) while the process is
        still healthy (reference: replica graceful_shutdown,
        deployment_state.py)."""
        fn = getattr(self.callable, "__del__", None)
        if fn is not None:
            try:
                fn()
            except Exception:
                pass
        return True
