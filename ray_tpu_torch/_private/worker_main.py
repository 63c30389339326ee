"""Worker process entry point, copied from
`ray_tpu/_private/worker_main.py` and trimmed to one machine (the port
imports nothing of `ray_tpu`).

    python -m ray_tpu_torch._private.worker_main SOCKET WORKER_ID

A process that registers with its node, receives pushed tasks, resolves
dependencies from the shared-memory store, runs user code, and seals
results. The same process hosts either a pool ("generic") worker or a
dedicated actor. Actor concurrency has two modes: classes with any
`async def` method run every call as a coroutine on a per-actor event
loop (max_concurrency = an asyncio.Semaphore), and plain classes with
`max_concurrency > 1` use a thread pool.

The worker imports nothing heavy: a CPU worker that runs a plain task
never imports ``torch``. The tracing and telemetry hooks import the
port's `util` modules only when a task carries a trace context or the
module is already loaded. A worker exits at once on `KillWorker` or
when its channel to the node closes.
"""

from __future__ import annotations

import contextvars
import os
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import connection

from ray_tpu_torch._private import constants, protocol, serialization
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch.exceptions import RayTpuError, TaskError

_ASYNC_TASK_ID: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_async_task_id", default=None)


class WorkerRuntime:
    """Per-worker state + the channel back to the node server."""

    def __init__(self, address: str, worker_id: str, authkey: bytes):
        self.worker_id = worker_id
        self.conn = protocol.bound_channel(
            connection.Client(address, family="AF_UNIX", authkey=authkey),
            constants.SEND_TIMEOUT_S)
        self.store = ObjectStore(os.path.dirname(address))
        self.functions: dict[str, object] = {}
        self.actor_instance = None
        self.actor_id: str | None = None
        self.task_queue: queue.Queue = queue.Queue()
        self._req_id = 0
        self._req_lock = threading.Lock()
        self._replies: dict[int, object] = {}
        self._reply_cv = threading.Condition()
        self._send_lock = threading.Lock()
        self._executor: ThreadPoolExecutor | None = None
        self._loop = None                # asyncio actors: per-actor loop
        self._async_sem = None
        self._io_executor: ThreadPoolExecutor | None = None
        self._current_task_ids = threading.local()
        # batched refcount events -> node (hold/release/escape), flushed
        # by a timer so __del__ storms don't become a message storm. An
        # ORDERED (kind, oid) list: bucketing by kind would replay a
        # release-then-re-hold pair inside one flush window in the wrong
        # order and free an object with a live ref.
        self._ref_lock = threading.Lock()
        self._ref_pending: list[tuple[str, str]] = []
        # Pipelined submission state (credit window + replay ring), guarded
        # by `_sub_cv`'s lock: `_sub_next` is the next seq to assign,
        # `_sub_acked` the highest credited seq, `_sub_ring` every spec
        # past the last credit (replayed on a SubmitNack or a stall).
        self._sub_cv = threading.Condition()
        self._sub_ring: dict[int, object] = {}
        self._sub_next = 0
        self._sub_acked = -1
        self._sub_last_progress = time.monotonic()
        threading.Thread(target=self._ref_flush_loop,
                         name="ref-flush", daemon=True).start()

    # ---- channel ----------------------------------------------------------

    def send(self, msg):
        if not protocol.safe_send(self.conn, self._send_lock, msg):
            os._exit(0)       # the node is gone (or stopped reading)

    def _next_req_id(self) -> int:
        with self._req_lock:
            self._req_id += 1
            return self._req_id

    def request(self, make_msg):
        """Send a request carrying a fresh req_id; block for the reply."""
        req_id = self._next_req_id()
        self.send(make_msg(req_id))
        with self._reply_cv:
            while req_id not in self._replies:
                self._reply_cv.wait(1.0)
            return self._replies.pop(req_id)

    def reader_loop(self):
        while True:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError, TypeError):
                os._exit(0)
            if isinstance(msg, protocol.PushTask):
                self.task_queue.put(msg)
            elif isinstance(msg, protocol.FreeObject):
                # all refs gone: drop this process's pins so the arena
                # block can actually be reclaimed
                try:
                    self.store.delete(msg.desc)
                except Exception:
                    pass
            elif isinstance(msg, protocol.KillWorker):
                os._exit(0)
            elif isinstance(msg, protocol.SubmitCredit):
                self._on_submit_credit(msg.ack_seq)
            elif isinstance(msg, protocol.SubmitNack):
                with self._sub_cv:
                    self._replay_submits_locked(msg.expected_seq)
            elif isinstance(msg, (protocol.GetReply, protocol.WaitReply,
                                  protocol.ActorCallReply)):
                with self._reply_cv:
                    self._replies[msg.req_id] = msg
                    self._reply_cv.notify_all()

    # ---- object access (the client API in worker mode) --------------------

    def get_objects(self, object_ids, timeout=None):
        reply = self.request(lambda rid: protocol.GetRequest(
            rid, list(object_ids), timeout))
        if reply.timed_out:
            from ray_tpu_torch.exceptions import GetTimeoutError
            raise GetTimeoutError(f"get() timed out: {object_ids[:3]}")
        if reply.error:
            _raise_named(reply.error)
        return [self.store.get(reply.locations[oid]) for oid in object_ids]

    def put_object(self, value) -> str:
        from ray_tpu_torch._private import ids
        oid = ids.new_object_id()
        desc = self.store.put(oid, value)
        self.send(protocol.PutRequest(oid, desc))
        return oid

    def wait_objects(self, object_ids, num_returns, timeout):
        reply = self.request(lambda rid: protocol.WaitRequest(
            rid, list(object_ids), num_returns, timeout))
        if reply.error:
            _raise_named(reply.error)
        return reply.ready, reply.not_ready

    def submit_spec(self, spec):
        """Assign the next seq, retain the spec for replay, block only when
        the credit window is exhausted. No reply is awaited: submit
        failures surface as error objects stored under the spec's return
        ids."""
        with self._sub_cv:
            while self._sub_next - self._sub_acked > constants.SUBMIT_WINDOW:
                if not self._sub_cv.wait(constants.SUBMIT_RESYNC_S):
                    self._replay_submits_locked(self._sub_acked + 1)
            seq = self._sub_next
            self._sub_next = seq + 1
            self._sub_ring[seq] = spec
        self.send(protocol.SubmitRequest(spec, seq))

    def _replay_submits_locked(self, from_seq: int) -> None:
        """Re-send every retained spec with seq >= from_seq in order
        (caller holds _sub_cv). Duplicates are dropped by the receiver's
        seq dedupe, which re-credits — so replay is idempotent."""
        for seq in sorted(self._sub_ring):
            if seq >= from_seq:
                self.send(protocol.SubmitRequest(self._sub_ring[seq], seq))
        self._sub_last_progress = time.monotonic()

    def _on_submit_credit(self, ack_seq: int) -> None:
        with self._sub_cv:
            if ack_seq > self._sub_acked:
                self._sub_acked = ack_seq
                for seq in [s for s in self._sub_ring if s <= ack_seq]:
                    del self._sub_ring[seq]
                self._sub_last_progress = time.monotonic()
                self._sub_cv.notify_all()

    def _submit_resync(self) -> None:
        """With unacked submissions and no credit progress for
        SUBMIT_RESYNC_S, replay the ring — covers a lost tail message that
        no later gap would reveal."""
        with self._sub_cv:
            if (self._sub_ring
                    and time.monotonic() - self._sub_last_progress
                    > constants.SUBMIT_RESYNC_S):
                self._replay_submits_locked(self._sub_acked + 1)

    def control(self, method, payload=None):
        reply = self.request(lambda rid: protocol.ActorCallRequest(
            rid, method, payload))
        if reply.error is not None:
            raise RayTpuError(reply.error)
        return reply.result

    # ---- refcount event batching -----------------------------------------

    def enqueue_ref_event(self, kind: str, oid: str) -> None:
        with self._ref_lock:
            self._ref_pending.append((kind, oid))

    def _flush_ref_events(self) -> None:
        with self._ref_lock:
            if not self._ref_pending:
                return
            batch, self._ref_pending = self._ref_pending, []
        try:
            self.control("ref_update",
                         {"holder": self.worker_id, "events": batch})
        except Exception:
            pass  # node gone; session over

    def _ref_flush_loop(self) -> None:
        from ray_tpu_torch._private import worker as _worker_mod
        while True:
            time.sleep(constants.REF_FLUSH_INTERVAL_S)
            _worker_mod._drain_decs()
            self._flush_ref_events()
            self._submit_resync()

    # ---- execution --------------------------------------------------------

    def current_task_id(self):
        # async actor methods record their id in a ContextVar (one per
        # asyncio task); sync paths use the thread-local
        tid = _ASYNC_TASK_ID.get()
        if tid is not None:
            return tid
        return getattr(self._current_task_ids, "task_id", None)

    def _resolve_fn(self, spec: protocol.TaskSpec):
        fn = self.functions.get(spec.function_id)
        if fn is None:
            if spec.function_blob is None:
                raise RayTpuError(
                    f"function {spec.function_desc} not cached and no blob")
            fn = serialization.loads_message(spec.function_blob)
            self.functions[spec.function_id] = fn
        return fn

    def _resolve_args(self, spec, arg_locations):
        def one(kind, v):
            if kind == "ref":
                loc = arg_locations.get(v)
                if loc is None:
                    return self.get_objects([v])[0]
                return self.store.get(loc)
            return serialization.loads(v)
        args = [one(k, v) for k, v in spec.args]
        kwargs = {name: one(k, v) for name, (k, v) in spec.kwargs.items()}
        # A dependency that failed short-circuits this task, surfacing the
        # ORIGINAL error (error values poison downstream tasks).
        for v in list(args) + list(kwargs.values()):
            if isinstance(v, RayTpuError):
                raise _DepFailed(v)
        return args, kwargs

    @staticmethod
    def _start_task_span(spec: protocol.TaskSpec):
        """Attach the submitter's trace context and open `task.execute`
        (the tracing module is imported only for a traced task)."""
        if spec.trace_ctx is None:
            return None
        from ray_tpu_torch.util import tracing
        return tracing.start_span(
            "task.execute", {"task_id": spec.task_id,
                             "name": spec.name or spec.function_desc},
            parent=spec.trace_ctx)

    @staticmethod
    def _end_task_span(sp, error: bool) -> None:
        if sp is not None:
            from ray_tpu_torch.util import tracing
            tracing.end_span(sp[0], sp[1],
                             error="task_error" if error else None)

    def run_task(self, push: protocol.PushTask):
        spec = push.spec
        self._current_task_ids.task_id = spec.task_id
        sp = self._start_task_span(spec)
        try:
            is_actor_method = (spec.actor_id is not None
                               and not spec.actor_creation)
            fn = None if is_actor_method else self._resolve_fn(spec)
            args, kwargs = self._resolve_args(spec, push.arg_locations)
            if spec.actor_creation:
                self.actor_instance = fn(*args, **kwargs)
                self.actor_id = spec.actor_id
                values = [None] * spec.num_returns
            elif is_actor_method:
                method = getattr(self.actor_instance, spec.method_name)
                values = _split_returns(method(*args, **kwargs),
                                        spec.num_returns)
            else:
                values = _split_returns(fn(*args, **kwargs),
                                        spec.num_returns)
            error = False
        except _DepFailed as df:
            values = [df.cause] * spec.num_returns
            error = True
        except BaseException as e:
            te = TaskError(type(e).__name__, str(e), traceback.format_exc(),
                           cause=e)
            values = [te] * spec.num_returns
            error = True
        finally:
            self._current_task_ids.task_id = None
        self._end_task_span(sp, error)
        self._seal_and_send(spec, values, error)

    @staticmethod
    def _drain_spans_for_push():
        """Buffered tracing spans (and FlightRecorder spans) of this process,
        to piggyback on the next TaskDone; nothing is imported for it."""
        spans = []
        if "ray_tpu_torch.util.tracing" in sys.modules:
            spans += sys.modules["ray_tpu_torch.util.tracing"].drain_spans()
        if "ray_tpu_torch.util.telemetry" in sys.modules:
            spans += sys.modules[
                "ray_tpu_torch.util.telemetry"].drain_recorder_spans()
        return spans or None

    def _seal_and_send(self, spec, values, error):
        descs = []
        for oid, value in zip(spec.return_ids, values):
            try:
                descs.append(self.store.put(oid, value))
            except BaseException as e:   # unpicklable return, etc.
                te = TaskError(type(e).__name__,
                               f"failed to serialize result: {e}",
                               traceback.format_exc())
                descs.append(self.store.put(oid, te))
                error = True
        self.send(protocol.TaskDone(
            task_id=spec.task_id, return_descs=descs, error=error,
            actor_ready=spec.actor_creation and not error,
            spans=self._drain_spans_for_push()))

    # ---- asyncio actor runtime -------------------------------------------
    # Async actors (any `async def` method) run their methods as
    # coroutines on ONE per-actor event loop with max_concurrency as an
    # asyncio.Semaphore: concurrent slow requests overlap on awaits
    # instead of burning a thread each.

    def _start_actor_event_loop(self, max_concurrency: int):
        import asyncio
        self._loop = asyncio.new_event_loop()
        # blocking work (dependency resolution, result sealing) leaves the
        # loop for this pool so awaits keep flowing
        self._io_executor = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="actor-io")
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self._loop)
            self._async_sem = asyncio.Semaphore(max_concurrency)
            ready.set()
            self._loop.run_forever()
        threading.Thread(target=run, daemon=True,
                         name="actor-eventloop").start()
        ready.wait()

    async def _run_task_async(self, push: protocol.PushTask):
        import asyncio
        import contextlib
        import inspect
        spec = push.spec
        loop = asyncio.get_running_loop()
        # Control-plane exemption (the reference's concurrency groups): a
        # class may declare `_control_plane_methods`, which skip the
        # max_concurrency semaphore, so a stats scrape or a health ping
        # is never queued behind a full window of long-blocking data
        # calls (a serve replica whose every slot is parked in a
        # next_chunks pull must still answer its controller).
        gate = self._async_sem
        if spec.method_name in getattr(type(self.actor_instance),
                                       "_control_plane_methods", ()):
            gate = contextlib.nullcontext()
        async with gate:
            # each asyncio task has its own context, so the current-task
            # id survives interleaving (a thread-local cannot)
            _ASYNC_TASK_ID.set(spec.task_id)
            sp = self._start_task_span(spec)
            try:
                args, kwargs = await loop.run_in_executor(
                    self._io_executor, self._resolve_args, spec,
                    push.arg_locations)
                method = getattr(self.actor_instance, spec.method_name)
                result = method(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
                values = _split_returns(result, spec.num_returns)
                error = False
            except _DepFailed as df:
                values = [df.cause] * spec.num_returns
                error = True
            except BaseException as e:
                te = TaskError(type(e).__name__, str(e),
                               traceback.format_exc(), cause=e)
                values = [te] * spec.num_returns
                error = True
            self._end_task_span(sp, error)
            await loop.run_in_executor(
                self._io_executor, self._seal_and_send, spec, values, error)

    def main_loop(self):
        import asyncio
        while True:
            push = self.task_queue.get()
            spec = push.spec
            if spec.actor_creation:
                max_concurrency = (spec.actor_options or {}).get(
                    "max_concurrency", 1)
                self.run_task(push)      # constructs the instance
                # async-ness is decided from the CLASS with the predicate
                # the driver uses: instance-level getattr would execute
                # property getters
                from ray_tpu_torch.actor import _is_async_class
                if self.actor_instance is not None and \
                        _is_async_class(type(self.actor_instance)):
                    self._start_actor_event_loop(max_concurrency)
                elif max_concurrency > 1:
                    self._executor = ThreadPoolExecutor(
                        max_workers=max_concurrency,
                        thread_name_prefix="actor-method")
            elif self._loop is not None:
                asyncio.run_coroutine_threadsafe(
                    self._run_task_async(push), self._loop)
            elif self._executor is not None:
                self._executor.submit(self.run_task, push)
            else:
                self.run_task(push)


def _split_returns(result, num_returns):
    if num_returns == 1:
        return [result]
    out = list(result)
    if len(out) != num_returns:
        raise ValueError(
            f"task declared num_returns={num_returns} but returned "
            f"{len(out)} values")
    return out


def _raise_named(error: str):
    """Re-raise a node-side terminal error ("ClassName: message") as the
    port's class of that name."""
    from ray_tpu_torch import exceptions
    name, _, detail = error.partition(": ")
    cls = getattr(exceptions, name, None)
    if not (isinstance(cls, type) and issubclass(cls, RayTpuError)):
        cls = exceptions.ObjectLostError
    raise cls(detail or error)


class _DepFailed(Exception):
    def __init__(self, cause):
        self.cause = cause


def run(address: str, worker_id: str):
    """Worker entry, called both from exec (`main`) and from a forkserver
    child, which passes its arguments directly."""
    authkey = bytes.fromhex(os.environ["RAY_TPU_AUTHKEY"])
    rt = WorkerRuntime(address, worker_id, authkey)
    rt.send(protocol.RegisterWorker(worker_id, os.getpid()))
    # This runtime is the process-global client, so user code can call
    # get/put/remote inside tasks (nested submission).
    from ray_tpu_torch._private import worker as worker_mod
    worker_mod.connect_worker_mode(rt)
    threading.Thread(target=rt.reader_loop, daemon=True,
                     name="ray_tpu_torch-worker-reader").start()
    rt.main_loop()


def main():
    run(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
