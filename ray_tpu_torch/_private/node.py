"""The one-machine node: scheduler, worker pool, actors, object directory
and reference counts, copied from `ray_tpu/_private/node.py` and trimmed
to one machine (the port imports nothing of `ray_tpu`).

One `NodeServer` lives in the driver process. Worker processes connect
over a UNIX socket in the session directory; the message set is
`protocol.py`. GPUs are the accelerator resource: a task or actor that
asks for ``num_gpus`` runs in a worker exec'd with
``CUDA_VISIBLE_DEVICES`` set to the ids it was given, every other worker
sees no card (`spawn.py`). A fraction of a GPU shares one card with other
fractions (Ray's rule for GPUs; the reference gives a fraction of a TPU
chip no chip, since a chip opens in one process only).

Not here (ROADMAP A5 (a2); the entry points that would reach them raise
`NotImplementedError` naming it): remote nodes and the TCP listener, the
pull plane, placement groups, spilling and reconstruction, the GCS
snapshot, the log monitor, usage stats, the memory monitor, pubsub,
stack dumps, the tracing broadcast, the autoscaler and dashboard hooks.

`shutdown` has one deadline. It marks the node down, closes the listener,
offers `KillWorker` to every worker without waiting (not for a send lock
that a blocked sender holds, C7 in ROADMAP, nor for room in a full
socket), shuts every channel down (a worker exits at EOF; a thread
blocked writing to it gets EPIPE), waits for all workers together until
`SHUTDOWN_DEADLINE_S`, SIGKILLs whatever is still alive, stops the
forkserver, and removes the session directory and the arena.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import socket
import subprocess
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from multiprocessing import AuthenticationError, connection

from ray_tpu_torch._private import constants, ids, protocol, spawn
from ray_tpu_torch._private.object_store import Descriptor, ObjectStore
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectFreedError,
    RayTpuError,
    TaskCancelledError,
    WorkerCrashedError,
)

logger = logging.getLogger("ray_tpu_torch")


def _fits(avail: dict, req: dict) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in req.items())


def _sub(avail: dict, req: dict) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def _add(avail: dict, req: dict) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v


def _gpu_share(req: dict) -> float:
    """What a request books on each card it is given: a whole card, or
    its fraction of one (``num_gpus=0.5`` shares a card, as in Ray)."""
    g = float(req.get("GPU", 0))
    return 0.0 if g <= 0 else (g if g < 1 else 1.0)


@dataclass
class _TaskState:
    spec: protocol.TaskSpec
    deps: set = field(default_factory=set)   # unresolved object ids
    retries_left: int = 0
    cancelled: bool = False
    gpu_ids: list = field(default_factory=list)


@dataclass
class _WorkerConn:
    worker_id: str
    conn: connection.Connection | None
    proc: object = None                      # Popen | spawn.ForkedProc
    # "generic" (pool) | "actor" | "dedicated" (GPU / env_vars tasks,
    # retire after one task)
    kind: str = "generic"
    idle: bool = True
    current: _TaskState | None = None
    known_functions: set = field(default_factory=set)
    send_lock: threading.Lock = field(default_factory=threading.Lock)
    # resources temporarily released while the worker blocks in get()
    released: dict = field(default_factory=dict)
    alive: bool = True
    # set exactly once when RegisterWorker lands: spawn waiters block on
    # THIS, not the global cv (a notify_all herd under creation bursts)
    reg_event: threading.Event = field(default_factory=threading.Event)
    # True while a pool worker is converted into an actor host; lets a
    # failed constructor hand the (still healthy) worker back to the pool
    pooled_actor: bool = False
    # Pipelined-submission receive state (only the per-worker reader
    # thread touches these): next expected SubmitRequest.seq, and
    # whether a nack for the current gap is already outstanding.
    sub_next: int = 0
    sub_nacked: bool = False

    def send(self, msg) -> bool:
        # conn is None between spawn and registration
        return protocol.safe_send(self.conn, self.send_lock, msg)


@dataclass
class _ActorState:
    actor_id: str
    creation_spec: protocol.TaskSpec
    worker: _WorkerConn | None = None
    ready: bool = False
    dead: bool = False
    death_cause: str = ""
    queue: list = field(default_factory=list)    # pending _TaskState, FIFO
    inflight: list = field(default_factory=list)
    max_concurrency: int = 1
    max_restarts: int = 0
    restarts_used: int = 0
    max_task_retries: int = 0
    name: str | None = None
    resources: dict = field(default_factory=dict)
    gpu_ids: list = field(default_factory=list)
    method_meta: dict = field(default_factory=dict)  # for get_actor handles


class NodeServer:
    """One per session; lives in the driver process."""

    def __init__(self, resources: dict, session_dir: str, num_gpus: int,
                 session_lock: int | None = None):
        self.session_dir = session_dir
        # the descriptor whose flock marks the session live
        # (`ray_tpu_torch._new_session_dir`); closed once the dir is gone
        self._session_lock = session_lock
        self.node_id = ids.new_node_id()
        self.store = ObjectStore(session_dir)
        self.total_resources = dict(resources)
        self.available = dict(resources)
        # the share of each card booked now: 1.0 is a card handed out
        # whole, a fraction is shared by workers asking for fractions
        self.gpu_load = [0.0] * num_gpus

        self.lock = threading.RLock()
        self.cv = threading.Condition(self.lock)   # object-ready notification

        self.directory: dict[str, Descriptor] = {}
        self.obj_waiting_tasks: dict[str, list[_TaskState]] = {}
        # counter-based get() waiters: oid -> [waiter dicts]; each
        # registration decrements instead of every blocked get()
        # rescanning its whole id list per wakeup
        self._get_waiters: dict[str, list] = {}

        # Reference counts. An object is freed when no process holds a
        # live ObjectRef (ref_holders empty), no queued/running task will
        # consume it (task_arg_refs 0), and it never escaped via pickle.
        self.ref_holders: dict[str, set] = {}     # oid -> holder ids
        self.escaped_refs: set = set()
        self.task_arg_refs: dict[str, int] = {}   # oid -> pending consumers
        self.obj_origin: dict[str, str] = {}      # oid -> worker_id|driver
        self.dead_pending: set = set()            # released pre-registration
        # ids freed by refcounting: tombstones so a racing get/wait/submit
        # fails fast instead of waiting forever (bounded FIFO)
        self.freed_refs: "OrderedDict[str, bool]" = OrderedDict()
        # task_ids whose args were already released (exactly-once guard)
        self._args_released: "OrderedDict[str, bool]" = OrderedDict()

        self.pending: "deque[_TaskState]" = deque()
        self.workers: dict[str, _WorkerConn] = {}
        self.actors: dict[str, _ActorState] = {}
        self.named_actors: dict[str, str] = {}
        self._shutdown = False
        self._spawning = 0      # generic workers currently starting up
        self._spawn_failures = 0  # consecutive startup failures
        self._forkserver = spawn.ForkServer(session_dir)
        # every worker process started and not yet seen exit (a retired
        # or dead worker's process is reaped here, not left a zombie)
        self._procs: list = []

        self._authkey = os.urandom(16)
        self._address = os.path.join(session_dir, "node.sock")

        self._sched_event = threading.Event()
        self._threads = [threading.Thread(
            target=self._scheduler_loop, name="ray_tpu_torch-scheduler",
            daemon=True)]
        # free-fanout outbox: _maybe_free_locked runs under self.lock, and
        # O(workers) sends in there would let one full pipe stall the
        # whole node during a release storm — a dedicated thread drains
        # the sends outside the lock
        self._free_outbox: deque = deque()
        self._free_event = threading.Event()
        self._threads.append(threading.Thread(
            target=self._free_fanout_loop, name="ray_tpu_torch-free-fanout",
            daemon=True))
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self._address)
        self._listener.listen(256)
        self._threads.append(threading.Thread(
            target=self._accept_loop, name="ray_tpu_torch-accept",
            daemon=True))
        for t in self._threads:
            t.start()
        atexit.register(self.shutdown)

    # ------------------------------------------------------------------
    # connection plumbing
    # ------------------------------------------------------------------

    def _accept_loop(self):
        while not self._shutdown:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                if self._shutdown:
                    return
                time.sleep(0.05)
                continue
            if self._shutdown:
                sock.close()
                return
            threading.Thread(target=self._serve_conn,
                             args=(connection.Connection(sock.detach()),),
                             daemon=True).start()

    def _wake_accept(self) -> None:
        """End the accept loop: connect once, so a blocked accept() returns
        and sees `_shutdown` (shutting a listening socket down does not
        wake accept() on every kernel), then close the listener."""
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(0.5)
                s.connect(self._address)
        except OSError:
            pass
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()

    def _serve_conn(self, conn):
        try:
            # the listener's side of multiprocessing's HMAC handshake
            connection.deliver_challenge(conn, self._authkey)
            connection.answer_challenge(conn, self._authkey)
            reg = conn.recv()
        except (EOFError, OSError, TypeError, AuthenticationError):
            conn.close()
            return
        if not isinstance(reg, protocol.RegisterWorker):
            conn.close()
            return
        protocol.bound_channel(conn, constants.SEND_TIMEOUT_S)
        with self.lock:
            w = self.workers.get(reg.worker_id)
            if w is None or self._shutdown:
                conn.close()     # not a worker of ours, or too late
                return
            w.conn = conn
            w.alive = True
            w.reg_event.set()
        self._reader_loop(w)

    def _reader_loop(self, w: _WorkerConn):
        while True:
            try:
                msg = w.conn.recv()
            except (EOFError, OSError, TypeError):
                self._on_worker_death(w)
                return
            try:
                self._handle(w, msg)
            except Exception:
                logger.exception("error handling %r from %s", type(msg),
                                 w.worker_id)

    def _handle(self, w: _WorkerConn, msg):
        if isinstance(msg, protocol.TaskDone):
            self._on_task_done(w, msg)
        elif isinstance(msg, protocol.PutRequest):
            # the putting worker certainly holds its new ObjectRef right
            # now, but its batched "hold" report may lag by up to the
            # flush period: record an implicit hold so a fast consumer
            # can't free the object in that window (idempotent with the
            # explicit hold; cleared by the worker's eventual release)
            self.ref_hold(msg.object_id, w.worker_id)
            self.register_object(msg.object_id, msg.desc, origin=w.worker_id)
        elif isinstance(msg, protocol.GetRequest):
            threading.Thread(target=self._serve_get, args=(w, msg),
                             daemon=True).start()
        elif isinstance(msg, protocol.WaitRequest):
            threading.Thread(target=self._serve_wait, args=(w, msg),
                             daemon=True).start()
        elif isinstance(msg, protocol.SubmitRequest):
            self._on_submit(w, msg)
        elif isinstance(msg, protocol.ActorCallRequest):
            try:
                result = self.control(msg.method, msg.payload, w)
                w.send(protocol.ActorCallReply(msg.req_id, result=result))
            except Exception as e:
                w.send(protocol.ActorCallReply(msg.req_id, error=repr(e)))
        else:
            logger.warning("unknown message %r", type(msg))

    # Credit cadence for pipelined submissions: ack every quarter window
    # so the sender's ring stays shallow without an ack per task.
    _SUBMIT_CREDIT_EVERY = max(1, constants.SUBMIT_WINDOW // 4)

    def _on_submit(self, w: _WorkerConn, msg) -> None:
        """Seq state machine for one worker's pipelined submit stream
        (runs on that worker's reader thread, the only writer of
        `sub_next`/`sub_nacked`). In-order: apply + periodic credit.
        Duplicate (replay overlap): drop and re-credit. Gap: nack once
        with the expected seq; the sender replays from there in order."""
        seq = msg.seq
        if seq == w.sub_next:
            w.sub_next = seq + 1
            w.sub_nacked = False
            try:
                self.submit(msg.spec, submitter=w.worker_id)
            except Exception as e:
                if not isinstance(e, RayTpuError):
                    e = RayTpuError(f"submit failed: {e!r}")
                self._store_error(msg.spec.return_ids, e, spec=msg.spec)
            if w.sub_next % self._SUBMIT_CREDIT_EVERY == 0:
                w.send(protocol.SubmitCredit(w.sub_next - 1))
        elif seq < w.sub_next:
            w.send(protocol.SubmitCredit(w.sub_next - 1))
        elif not w.sub_nacked:
            w.sub_nacked = True
            w.send(protocol.SubmitNack(w.sub_next))

    # ------------------------------------------------------------------
    # control-plane RPCs
    # ------------------------------------------------------------------

    def control(self, method: str, payload, w):
        if method == "get_actor":
            return self.get_named_actor(payload)
        if method == "kill_actor":
            return self.kill_actor(payload["actor_id"],
                                   no_restart=payload.get("no_restart", True))
        if method == "cluster_resources":
            with self.lock:
                return dict(self.total_resources)
        if method == "available_resources":
            with self.lock:
                return dict(self.available)
        if method == "cancel":
            return self.cancel(payload["object_id"])
        if method == "free_objects":
            return self.free_objects(payload or [])
        if method == "ref_update":
            # Events are applied in their original order: a worker that
            # releases and then re-holds an oid inside one flush window
            # must not have the hold applied first.
            holder = payload["holder"]
            with self.lock:
                for kind, oid in payload.get("events", ()):
                    if kind == "escape":
                        self.escaped_refs.add(oid)
                    elif kind == "hold":
                        self.ref_holders.setdefault(oid, set()).add(holder)
                    else:  # release
                        holders = self.ref_holders.get(oid)
                        if holders is not None:
                            holders.discard(holder)
                        self._maybe_free_locked(oid)
            return True
        raise ValueError(f"unknown control method {method}")

    # ------------------------------------------------------------------
    # reference counting
    # ------------------------------------------------------------------

    def ref_hold(self, oid: str, holder: str) -> None:
        with self.lock:
            self.ref_holders.setdefault(oid, set()).add(holder)

    def ref_release(self, oid: str, holder: str) -> None:
        with self.lock:
            holders = self.ref_holders.get(oid)
            if holders is not None:
                holders.discard(holder)
            self._maybe_free_locked(oid)

    def ref_escape(self, oid: str) -> None:
        with self.lock:
            self.escaped_refs.add(oid)

    def free_objects(self, oids) -> int:
        """Explicit unconditional release: drops the escape pin and all
        holder records so the normal free path runs. Returns how many
        objects were still live."""
        n = 0
        with self.lock:
            for oid in oids:
                self.escaped_refs.discard(oid)
                self.ref_holders.pop(oid, None)
                if oid in self.directory:
                    n += 1
                self._maybe_free_locked(oid)
        return n

    @staticmethod
    def _ref_args(spec):
        return [v for kind, v in list(spec.args) + list(spec.kwargs.values())
                if kind == "ref"]

    def _release_task_args(self, spec) -> None:
        """Exactly-once per task: its ref args are no longer needed by
        this consumer. Called from every terminal path."""
        with self.lock:
            if spec.task_id in self._args_released:
                return
            self._args_released[spec.task_id] = True
            while len(self._args_released) > constants.ARGS_RELEASED_CAP:
                self._args_released.popitem(last=False)
            for v in self._ref_args(spec):
                n = self.task_arg_refs.get(v, 0) - 1
                if n <= 0:
                    self.task_arg_refs.pop(v, None)
                    self._maybe_free_locked(v)
                else:
                    self.task_arg_refs[v] = n

    def _maybe_free_locked(self, oid: str) -> None:
        """Free the object if nothing can reach it anymore (caller holds
        the lock). After shutdown began nothing is freed one by one: the
        whole arena goes with the session."""
        if (self._shutdown or oid in self.escaped_refs or self.ref_holders.get(oid)
                or self.task_arg_refs.get(oid, 0) > 0):
            return
        desc = self.directory.get(oid)
        if desc is None:
            # released before the producing task finished: free on arrival
            self.dead_pending.add(oid)
            return
        del self.directory[oid]
        self.ref_holders.pop(oid, None)
        self.dead_pending.discard(oid)
        self.freed_refs[oid] = True
        self._poke_get_waiters(oid)
        while len(self.freed_refs) > constants.FREED_REFS_CAP:
            self.freed_refs.popitem(last=False)
        self.obj_origin.pop(oid, None)
        self.store.delete(desc)
        if desc.inline is None:
            # every worker that read the object holds a pinned view (or a
            # cached mmap) and its putter the owner pin; the block can't
            # recycle until they all drop it. Sends ride the outbox
            # thread: O(workers) writes under self.lock would stall the
            # node. Inline objects hold nothing in the store: no fanout.
            targets = [w for w in self.workers.values() if w.alive]
            if targets:
                self._free_outbox.append(
                    (targets, protocol.FreeObject(oid, desc)))
                self._free_event.set()
        self.cv.notify_all()   # wake racing gets so they fail fast

    def _register_locked(self, object_id: str, desc: Descriptor,
                         origin: str):
        """Directory insert + origin + dead_pending + dependent-task wakeup
        (single implementation for put, task returns, and error stores).
        Caller holds the lock; returns True if tasks were unblocked."""
        self.directory[object_id] = desc
        self.obj_origin[object_id] = origin
        if object_id in self.dead_pending:
            self.dead_pending.discard(object_id)
            self._maybe_free_locked(object_id)
        waiting = self.obj_waiting_tasks.pop(object_id, ())
        for t in waiting:
            t.deps.discard(object_id)
        for waiter in self._get_waiters.pop(object_id, ()):
            waiter["n"] -= 1
            if waiter["n"] <= 0:
                waiter["ev"].set()
        self.cv.notify_all()
        return bool(waiting)

    def _free_fanout_loop(self):
        while not self._shutdown:
            self._free_event.wait(timeout=1.0)
            self._free_event.clear()
            while self._free_outbox and not self._shutdown:
                try:
                    targets, msg = self._free_outbox.popleft()
                except IndexError:
                    break
                for w in targets:
                    # bounded: a worker that reads nothing for
                    # SEND_TIMEOUT_S has its channel closed (and dies)
                    w.send(msg)

    def _poke_get_waiters(self, oid: str) -> None:
        """Flag blocked get()s that `oid` was freed so they re-check and
        raise promptly. Caller holds the lock."""
        for waiter in self._get_waiters.get(oid, ()):
            waiter["dirty"] = True
            waiter["ev"].set()
        self.cv.notify_all()

    def register_object(self, object_id: str, desc: Descriptor,
                        origin: str = "driver"):
        with self.lock:
            waiting = self._register_locked(object_id, desc, origin)
        if waiting:
            self._schedule()

    def put_value(self, value) -> str:
        oid = ids.new_object_id()
        desc = self.store.put(oid, value)
        # a FRESH object id cannot have waiters or dependent tasks (its
        # ObjectRef does not exist until this returns): a bare insert
        with self.lock:
            self.directory[oid] = desc
            self.obj_origin[oid] = "driver"
        return oid

    def get_locations(self, object_ids, timeout=None) -> dict:
        """Block until every id has a descriptor. Blocking rides a COUNTER
        waiter that registrations decrement — a get() over 100k refs costs
        O(ids), not O(ids) per wakeup."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self.lock:
                missing = [o for o in object_ids if o not in self.directory]
                freed = [o for o in missing if o in self.freed_refs]
                if freed:
                    raise ObjectFreedError(
                        f"object {freed[0]} was freed by reference "
                        "counting before this get()")
                if not missing:
                    return {o: self.directory[o] for o in object_ids}
                if self._shutdown:
                    raise RayTpuError("the node is shut down")
                waiter = {"n": len(missing), "ev": threading.Event()}
                for o in missing:
                    self._get_waiters.setdefault(o, []).append(waiter)
            try:
                while True:
                    if deadline is not None:
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            raise GetTimeoutError(
                                f"get() timed out waiting for "
                                f"{missing[:3]}...")
                        notified = waiter["ev"].wait(min(rem, 1.0))
                    else:
                        notified = waiter["ev"].wait(1.0)
                    with self.lock:
                        if (waiter["n"] <= 0 or waiter.get("dirty")
                                or self._shutdown):
                            break
                        if not notified and any(
                                o in self.freed_refs for o in missing
                                if o not in self.directory):
                            break
            finally:
                with self.lock:
                    for o in missing:
                        lst = self._get_waiters.get(o)
                        if lst is not None:
                            try:
                                lst.remove(waiter)
                            except ValueError:
                                pass
                            if not lst:
                                self._get_waiters.pop(o, None)
            # loop back: re-verify everything under the lock

    def wait_objects(self, object_ids, num_returns, timeout):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cv:
            while True:
                ready = [o for o in object_ids if o in self.directory]
                freed = [o for o in object_ids
                         if o not in self.directory and o in self.freed_refs]
                if freed:
                    raise ObjectFreedError(
                        f"object {freed[0]} was freed by reference "
                        "counting before this wait()")
                if len(ready) >= num_returns or self._shutdown:
                    break
                if deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    self.cv.wait(min(rem, 1.0))
                else:
                    self.cv.wait(1.0)
            ready_set = set(ready[:max(num_returns, 0)])
            return ([o for o in object_ids if o in ready_set],
                    [o for o in object_ids if o not in ready_set])

    def _serve_get(self, w, msg: protocol.GetRequest):
        # Release the blocked worker's resources so nested tasks can run.
        with self.lock:
            if w.current is not None and not w.released:
                held = dict(w.current.spec.resources)
                if held:
                    _add(self.available, held)
                    w.released = held
        try:
            reply = protocol.GetReply(
                msg.req_id, self.get_locations(msg.object_ids, msg.timeout))
        except GetTimeoutError:
            reply = protocol.GetReply(msg.req_id, {}, timed_out=True)
        except RayTpuError as e:
            reply = protocol.GetReply(msg.req_id, {},
                                      error=f"{type(e).__name__}: {e}")
        with self.lock:
            if w.released:
                _sub(self.available, w.released)  # may dip below zero briefly
                w.released = {}
        w.send(reply)
        self._schedule()

    def _serve_wait(self, w, msg: protocol.WaitRequest):
        try:
            ready, not_ready = self.wait_objects(
                msg.object_ids, msg.num_returns, msg.timeout)
            reply = protocol.WaitReply(msg.req_id, ready, not_ready)
        except RayTpuError as e:
            reply = protocol.WaitReply(msg.req_id, [], [],
                                       error=f"{type(e).__name__}: {e}")
        w.send(reply)

    # ------------------------------------------------------------------
    # submission and scheduling
    # ------------------------------------------------------------------

    def submit(self, spec: protocol.TaskSpec, submitter: str | None = None):
        t = _TaskState(spec=spec, retries_left=spec.max_retries)
        with self.lock:
            if self._shutdown:
                raise RayTpuError("the node is shut down")
            ref_args = self._ref_args(spec)
            for v in ref_args:
                if v not in self.directory and v in self.freed_refs:
                    self._store_error(
                        spec.return_ids,
                        ObjectFreedError(
                            f"task argument {v} was already freed by "
                            "reference counting"),
                        spec=spec)
                    return
            for v in ref_args:
                if v not in self.directory:
                    t.deps.add(v)
                    self.obj_waiting_tasks.setdefault(v, []).append(t)
                self.task_arg_refs[v] = self.task_arg_refs.get(v, 0) + 1
            if submitter is not None:
                # worker-submitted task: the submitter holds the return
                # refs it just minted, but its batched hold report may
                # lag — record implicit holds (see PutRequest handler)
                for oid in spec.return_ids:
                    self.ref_holders.setdefault(oid, set()).add(submitter)
            if spec.actor_creation:
                opts = spec.actor_options or {}
                name = opts.get("name")
                if name and name in self.named_actors:
                    raise ValueError(f"actor name {name!r} already taken")
                a = _ActorState(
                    actor_id=spec.actor_id, creation_spec=spec,
                    max_concurrency=opts.get("max_concurrency", 1),
                    max_restarts=opts.get("max_restarts", 0),
                    max_task_retries=opts.get("max_task_retries", 0),
                    name=name, resources=dict(spec.resources),
                    method_meta=opts.get("method_meta", {}))
                self.actors[spec.actor_id] = a
                if a.name:
                    self.named_actors[a.name] = spec.actor_id
                if t.deps:
                    self.pending.append(t)
            elif spec.actor_id is not None:
                a = self.actors.get(spec.actor_id)
                if a is None or a.dead:
                    cause = a.death_cause if a else "unknown actor"
                    self._store_error(
                        spec.return_ids,
                        ActorDiedError(f"actor {spec.actor_id} is dead: "
                                       f"{cause}"),
                        spec=spec)
                    return
                a.queue.append(t)
            elif t.deps:
                self.pending.append(t)
            had_deps = bool(t.deps)
        if not had_deps:
            self._submit_fastpath(t, spec)

    def _submit_fastpath(self, t: _TaskState, spec) -> None:
        """Dispatch attempt scoped to the JUST-submitted work instead of
        rescanning the whole backlog. Only called for tasks with no deps at
        submit time (the task is NOT in self.pending here, so no racing
        pass can double-dispatch it); full scheduler passes drain the
        backlog on capacity events."""
        to_send = []
        disp = True
        with self.lock:
            if spec.actor_id is not None and not spec.actor_creation:
                a = self.actors.get(spec.actor_id)
                if a is not None:
                    self._pump_actor(a, to_send)
            elif self._shutdown or t.cancelled:
                return
            elif (not spec.actor_creation and
                  len(self.pending) > constants.SUBMIT_INLINE_BACKLOG):
                # Deep backlog: the inline attempt is almost always futile
                # and every completion pulls from the backlog directly.
                # Wake the scheduler only when the task could go somewhere
                # now (the capacity-freeing event fires its own signal).
                self.pending.append(t)
                if _fits(self.available, spec.resources):
                    self._sched_event.set()
                return
            else:
                disp = (self._try_dispatch_actor_creation(t, to_send)
                        if spec.actor_creation
                        else self._try_dispatch_generic(t, to_send))
                if disp is not True:
                    # False: nothing fits, nothing to rescan. None: fits
                    # but no idle worker — the pass owns spawning.
                    self.pending.append(t)
        self._send_all(to_send)
        if disp is None:
            self._schedule()

    def _send_all(self, to_send) -> None:
        for w, msg in to_send:
            if not w.send(msg):
                self._on_worker_death(w)

    def _schedule(self):
        """Signal the scheduler thread: dispatch work soon."""
        self._sched_event.set()

    def _scheduler_loop(self):
        """Run window-bounded passes until the backlog stops yielding
        dispatches. Each pass rotates the examined prefix, so continuation
        passes cover the whole backlog without any pass paying
        O(backlog)."""
        window = constants.SCHEDULER_DISPATCH_WINDOW
        while not self._shutdown:
            self._sched_event.wait(timeout=1.0)   # 1s tick = safety net
            if self._shutdown:
                return
            self._sched_event.clear()
            futile = 0
            while not self._shutdown:
                try:
                    dispatched, tripped = self._schedule_pass()
                except Exception:
                    logger.exception("scheduler pass failed")
                    break
                if self._sched_event.is_set():
                    self._sched_event.clear()
                    futile = 0
                    continue        # new capacity arrived mid-pass
                futile = 0 if dispatched else futile + 1
                if not tripped:
                    break           # whole backlog examined this pass
                with self.lock:
                    n = len(self.pending)
                if futile * window >= n:
                    break           # one full rotation, no progress

    def _schedule_pass(self):
        """One bounded dispatch pass. -> (n_dispatched, window_tripped)."""
        to_send = []   # (worker, message) executed outside the lock
        retired = []   # over-cap idle workers killed outside the lock
        n_dispatched = 0
        with self.lock:
            if self._shutdown:
                return 0, False
            still = []
            want_spawn = 0
            # `sim` tracks how much concurrency the resource pool could
            # absorb, so no more workers spawn than could run at once
            sim = dict(self.available)
            window = constants.SCHEDULER_DISPATCH_WINDOW
            misses = 0
            # Per-pass memo: once a task of resource shape R failed to
            # dispatch, every later R task in the same pass fails the same
            # way (the backlog is usually many copies of one shape).
            unfit: dict = {}
            examined = 0
            n0 = len(self.pending)
            while self.pending and examined < n0 and misses < window:
                t = self.pending.popleft()
                examined += 1
                if t.cancelled:
                    continue
                if t.deps:
                    still.append(t)
                    continue
                if t.spec.actor_creation:
                    disp = self._try_dispatch_actor_creation(t, to_send)
                else:
                    sig = frozenset(t.spec.resources.items())
                    if sig in unfit:
                        disp = unfit[sig]
                    else:
                        disp = self._try_dispatch_generic(t, to_send)
                        if disp is not True:
                            unfit[sig] = disp
                    if disp is None:     # resources fit but no idle worker
                        if _fits(sim, t.spec.resources):
                            _sub(sim, t.spec.resources)
                            want_spawn += 1
                    elif disp is True:
                        _sub(sim, t.spec.resources)
                if disp is True:
                    n_dispatched += 1
                else:
                    still.append(t)
                    misses += 1
            tripped = misses >= window and bool(self.pending)
            if tripped:
                # ROTATE the examined-but-kept prefix to the back so
                # successive passes walk different segments of the backlog
                self.pending.extend(still)
            else:
                self.pending.extendleft(reversed(still))
            for a in self.actors.values():
                self._pump_actor(a, to_send)
            # --- worker pool scale-up ---
            # `_spawning` counts workers from spawn until registration.
            # Workers blocked in get() (w.released) gave their resources
            # back, so they don't count against the cap: a task blocked on
            # an upstream result must never pin the last pool slot.
            n_generic = sum(1 for w in self.workers.values()
                            if w.kind == "generic" and w.alive
                            and not w.released)
            can = constants.MAX_WORKERS_CAP - n_generic - self._spawning
            for _ in range(max(0, min(want_spawn - self._spawning, can))):
                self._spawning += 1
                threading.Thread(target=self._spawn_generic_worker,
                                 daemon=True).start()
            # --- worker pool scale-down: retire idle surplus over the cap
            # once the blocked workers resume (never a busy or blocked
            # worker, and only with an empty backlog)
            if not self.pending:
                alive_generic = [w for w in self.workers.values()
                                 if w.kind == "generic" and w.alive]
                excess = len(alive_generic) - constants.MAX_WORKERS_CAP
                for w in alive_generic:
                    if excess <= 0:
                        break
                    if w.idle and not w.released and w.current is None:
                        w.idle = w.alive = False
                        self.workers.pop(w.worker_id, None)
                        retired.append(w)
                        excess -= 1
        for w in retired:
            w.send(protocol.KillWorker())
        self._send_all(to_send)
        return n_dispatched, tripped

    def _gpu_pick(self, req: dict) -> list | None:
        """The cards a request would be given now ([] if it asks for
        none), or None when they are not free. ``num_gpus`` of 1 or more
        takes ``int(num_gpus)`` idle cards; a fraction takes room on one
        card, the fullest it fits on, so fractions pack and whole cards
        stay whole. Caller holds the lock."""
        share = _gpu_share(req)
        if share == 0:
            return []
        if share < 1:
            fits = [i for i, load in enumerate(self.gpu_load)
                    if load + share <= 1.0 + 1e-9]
            if not fits:
                return None
            return [max(fits, key=lambda i: (self.gpu_load[i], -i))]
        n = int(float(req["GPU"]))
        idle = [i for i, load in enumerate(self.gpu_load) if load == 0]
        return idle[:n] if len(idle) >= n else None

    def _take_gpus(self, req: dict, picked: list) -> list:
        share = _gpu_share(req)
        for i in picked:
            self.gpu_load[i] += share
        return picked

    def _free_gpus(self, req: dict, gpu_ids: list) -> None:
        share = _gpu_share(req)
        for i in gpu_ids:
            left = self.gpu_load[i] - share
            # fractions that summed to 0.9 + a rounding error free to 0
            self.gpu_load[i] = left if left > 1e-9 else 0.0

    def _try_dispatch_generic(self, t: _TaskState, to_send):
        """True=dispatched, False=doesn't fit right now, None=the resources
        fit but no idle worker (caller spawns). Caller holds the lock."""
        req = t.spec.resources
        picked = self._gpu_pick(req)
        if not _fits(self.available, req) or picked is None:
            return False
        if picked or t.spec.runtime_env:
            # GPU tasks need CUDA_VISIBLE_DEVICES in the environment BEFORE
            # the process initializes CUDA; env_vars tasks need theirs at
            # birth. Both run on a fresh exec'd worker that retires after
            # the task.
            _sub(self.available, req)
            t.gpu_ids = self._take_gpus(req, picked)
            threading.Thread(target=self._spawn_dedicated_worker,
                             args=(t,), daemon=True).start()
            return True
        worker = next((w for w in self.workers.values()
                       if w.kind == "generic" and w.idle and w.alive), None)
        if worker is None:
            return None
        _sub(self.available, req)
        worker.idle = False
        worker.current = t
        to_send.append((worker, self._push_msg(worker, t)))
        return True

    def _push_msg(self, worker: _WorkerConn, t: _TaskState):
        spec = t.spec
        if spec.function_id in worker.known_functions:
            spec = protocol.TaskSpec(**{**spec.__dict__,
                                        "function_blob": None})
        else:
            worker.known_functions.add(spec.function_id)
        locs = {v: self.directory[v] for v in self._ref_args(spec)
                if v in self.directory}
        return protocol.PushTask(spec=spec, arg_locations=locs)

    def _try_dispatch_actor_creation(self, t: _TaskState, to_send):
        a = self.actors[t.spec.actor_id]
        req = a.resources
        picked = self._gpu_pick(req)
        if not _fits(self.available, req) or picked is None:
            return False
        _sub(self.available, req)
        a.gpu_ids = self._take_gpus(req, picked)
        if not a.gpu_ids and not t.spec.runtime_env:
            # Serve the creation from an idle pooled worker when one
            # exists — skips the whole spawn + register round. GPU and
            # env_vars actors get a dedicated exec'd worker.
            w = next((w for w in self.workers.values()
                      if w.alive and w.idle and w.kind == "generic"), None)
            if w is not None:
                w.kind = "actor"
                w.pooled_actor = True
                w.idle = False
                w.current = t
                a.worker = w
                a.inflight.append(t)
                to_send.append((w, self._push_msg(w, t)))
                return True
        threading.Thread(target=self._spawn_actor_worker, args=(a, t),
                         daemon=True).start()
        return True

    def _pump_actor(self, a: _ActorState, to_send):
        if a.dead or not a.ready or a.worker is None or not a.worker.alive:
            return
        while a.queue and len(a.inflight) < a.max_concurrency:
            t = a.queue[0]
            if t.deps:
                break   # preserve submission order per actor
            a.queue.pop(0)
            if t.cancelled:
                continue
            a.inflight.append(t)
            to_send.append((a.worker, self._push_msg(a.worker, t)))

    # ------------------------------------------------------------------
    # worker processes
    # ------------------------------------------------------------------

    def _new_worker(self, kind: str) -> _WorkerConn:
        """Record the worker BEFORE spawning it, so a fast-registering
        child finds its slot."""
        w = _WorkerConn(ids.new_worker_id(), None, kind=kind, idle=False,
                        alive=False)
        with self.lock:
            self.workers[w.worker_id] = w
        return w

    def _start_worker(self, w: _WorkerConn, gpu_ids=(),
                      runtime_env=None) -> bool:
        """Spawn and wait for registration; False if the process could not
        start or did not register (the caller cleans up)."""
        try:
            w.proc = spawn.spawn_worker_proc(
                self._address, self._authkey, w.worker_id,
                spawn.worker_env(gpu_ids, runtime_env),
                log_dir=os.path.join(self.session_dir, "logs"),
                forkserver=self._forkserver)
        except OSError:
            logger.exception("spawning worker %s failed", w.worker_id)
            return False
        with self.lock:
            self._procs = [p for p in self._procs if p.poll() is None]
            self._procs.append(w.proc)
        deadline = time.monotonic() + constants.WORKER_REGISTER_TIMEOUT_S
        while not w.alive:
            rem = deadline - time.monotonic()
            if rem <= 0 or self._shutdown or w.proc.poll() is not None:
                return False
            w.reg_event.wait(min(rem, 0.2))
        return True

    def _spawn_generic_worker(self):
        w = self._new_worker("generic")
        ok = self._start_worker(w)
        with self.lock:
            self._spawning -= 1
            if ok:
                w.idle = True
                self._spawn_failures = 0
            else:
                self.workers.pop(w.worker_id, None)
                self._spawn_failures += 1
                if self._spawn_failures >= 3 and not self._shutdown:
                    # Startup is systematically broken (bad env, missing
                    # package): fail queued work instead of a respawn storm.
                    failed, self.pending = self.pending, deque()
                    for t in failed:
                        if not t.spec.actor_creation:
                            self._store_error(
                                t.spec.return_ids,
                                WorkerCrashedError(
                                    "worker processes repeatedly failed to "
                                    "start; check worker logs"),
                                spec=t.spec)
        self._schedule()

    def _spawn_dedicated_worker(self, t: _TaskState):
        """Fresh single-task worker for GPU tasks (card visibility is fixed
        at process birth) and tasks with env_vars."""
        w = self._new_worker("dedicated")
        if not self._start_worker(w, t.gpu_ids, t.spec.runtime_env):
            with self.lock:
                self.workers.pop(w.worker_id, None)
                self._release_task_resources(t)
            self._store_error(
                t.spec.return_ids,
                WorkerCrashedError("dedicated worker failed to start"),
                spec=t.spec)
            return
        with self.lock:
            w.current = t
            msg = self._push_msg(w, t)
        self._send_all([(w, msg)])

    def _spawn_actor_worker(self, a: _ActorState, creation: _TaskState):
        w = self._new_worker("actor")
        if not self._start_worker(w, a.gpu_ids,
                                  a.creation_spec.runtime_env):
            with self.lock:
                self.workers.pop(w.worker_id, None)
            self._fail_actor(a, "actor worker failed to start")
            return
        with self.lock:
            a.worker = w
            w.current = creation
            a.inflight.append(creation)
            msg = self._push_msg(w, creation)
        self._send_all([(w, msg)])

    # ------------------------------------------------------------------
    # completion + failure
    # ------------------------------------------------------------------

    def _on_task_done(self, w: _WorkerConn, msg: protocol.TaskDone):
        if msg.spans:
            from ray_tpu_torch.util import tracing
            tracing.ingest(msg.spans)
        retire = None
        with self.lock:
            t = w.current if (w.current and w.current.spec.task_id ==
                              msg.task_id) else None
            a = None
            if t is None:
                # actor task completing (possibly out of submission order
                # when max_concurrency > 1)
                for cand in self.actors.values():
                    for inf in cand.inflight:
                        if inf.spec.task_id == msg.task_id:
                            a, t = cand, inf
                            break
                    if a:
                        break
            if t is None:
                logger.warning("TaskDone for unknown task %s", msg.task_id)
                return
            spec = t.spec
            if a is None and spec.actor_id is not None:
                a = self.actors.get(spec.actor_id)
            if (msg.error and spec.retry_exceptions and t.retries_left > 0
                    and not spec.actor_creation):
                t.retries_left -= 1
                self._requeue_after_failure(w, t, a)
                return
            self._release_task_args(spec)
            for oid, desc in zip(spec.return_ids, msg.return_descs):
                self._register_locked(oid, desc, origin=w.worker_id)
            if a is not None:
                if t in a.inflight:
                    a.inflight.remove(t)
                if spec.actor_creation:
                    if msg.error:
                        a.dead = True
                        a.death_cause = "constructor raised"
                        self._release_actor_resources(a)
                        failed, a.queue = a.queue, []
                        for qt in failed:
                            self._store_error(
                                qt.spec.return_ids,
                                ActorDiedError(
                                    f"actor {a.actor_id} constructor raised"),
                                spec=qt.spec)
                        if w.pooled_actor:
                            # the worker came from the pool and is still
                            # healthy (only the user constructor raised):
                            # hand it back instead of stranding it
                            w.pooled_actor = False
                            w.kind = "generic"
                            w.idle = True
                            a.worker = None
                            w.current = None
                            self._sched_event.set()
                    else:
                        a.ready = True
                if a.worker is w:
                    w.current = None
            else:
                w.current = None
                if not w.released:
                    self._release_task_resources(t)
                w.released = {}
                if w.kind == "dedicated":
                    # retires with its task: card visibility and env_vars
                    # can't be re-scoped in a live process
                    w.idle = w.alive = False
                    retire = w
                else:
                    w.idle = True
        if retire is not None:
            retire.send(protocol.KillWorker())
            with self.lock:
                self.workers.pop(retire.worker_id, None)
        # Completion fastpath: a completion frees exactly one slot, so fill
        # exactly that slot instead of waking the full scheduler pass.
        if a is not None:
            to_send = []
            with self.lock:
                self._pump_actor(a, to_send)
            self._send_all(to_send)
        elif self._dispatch_freed_fastpath():
            return
        self._schedule()

    def _dispatch_freed_fastpath(self) -> bool:
        """Hand freed slots the head-of-line pending tasks, up to
        SCHEDULER_FREED_BATCH plain tasks under ONE lock acquisition.
        Anything trickier (deps, actors) falls back to the scheduler pass.
        Returns True iff the freed capacity was cleanly consumed (or
        nothing is runnable), so the scheduler event can be skipped."""
        to_send = []
        ok = False
        need_pass = False
        filled = 0
        with self.lock:
            if self._shutdown:
                return True
            for _ in range(64):        # bound: pops + dispatch attempts
                if filled >= constants.SCHEDULER_FREED_BATCH:
                    break
                if not self.pending:
                    ok = True          # nothing queued: slot stays free
                    break
                t = self.pending[0]
                if t.cancelled:
                    self.pending.popleft()
                    continue
                if (t.deps or t.spec.actor_creation
                        or t.spec.actor_id is not None):
                    need_pass = True   # needs the real pass
                    break
                if filled and not _fits(self.available, t.spec.resources):
                    break
                self.pending.popleft()
                n_before = len(to_send)
                if self._try_dispatch_generic(t, to_send) is True:
                    if len(to_send) > n_before:
                        filled += 1
                        ok = True
                else:
                    # no capacity left: if the freed slot(s) were filled,
                    # the next completion continues the chain
                    self.pending.appendleft(t)
                    if filled == 0:
                        need_pass = True
                    break
        for w, msg in to_send:
            if not w.send(msg):
                self._on_worker_death(w)
                ok = False
        return ok and not need_pass

    def _requeue_after_failure(self, w, t, a):
        """Re-run a failed task (called under lock)."""
        if a is not None:
            if t in a.inflight:
                a.inflight.remove(t)
            a.queue.insert(0, t)
            if a.worker is w:
                w.current = None
        else:
            w.idle = w.kind != "dedicated"
            w.current = None
            if not w.released:
                self._release_task_resources(t)
            w.released = {}
            if w.kind == "dedicated":
                w.alive = False
                self.workers.pop(w.worker_id, None)
                threading.Thread(target=w.send, args=(protocol.KillWorker(),),
                                 daemon=True).start()
            self.pending.append(t)

    def _release_task_resources(self, t: _TaskState):
        _add(self.available, t.spec.resources)
        self._free_gpus(t.spec.resources, t.gpu_ids)
        t.gpu_ids = []

    def _release_actor_resources(self, a: _ActorState):
        _add(self.available, a.resources)
        self._free_gpus(a.resources, a.gpu_ids)
        a.gpu_ids = []

    def _store_error(self, return_ids, exc, spec=None):
        """Store `exc` as the value of every return id (under or out of
        lock). `spec` releases the task's pinned args — the chokepoint
        every failure path goes through."""
        if spec is not None:
            self._release_task_args(spec)
        for oid in return_ids:
            desc = self.store.put(oid, exc)
            with self.lock:
                self._register_locked(oid, desc, origin="driver")

    def _on_worker_death(self, w: _WorkerConn):
        with self.lock:
            if self._shutdown or (not w.alive and w.current is None):
                w.alive = False
                return
            w.alive = w.idle = False
            t, w.current = w.current, None
            self.workers.pop(w.worker_id, None)
            actor = next((a for a in self.actors.values()
                          if a.worker is w), None)
            # drop the dead process's ref holds (its ObjectRefs died with
            # it); objects it alone held become freeable
            for oid, holders in list(self.ref_holders.items()):
                if w.worker_id in holders:
                    holders.discard(w.worker_id)
                    self._maybe_free_locked(oid)
            # Reclaim the dead process's arena pins: first adopt the owner
            # pin of every live object it put — so force-release can't
            # leave them evictable — then drop everything the pid still
            # holds (reader pins, condemned pins, unsealed creations).
            pid = getattr(w.proc, "pid", None)
            if pid is not None and not self._shutdown:
                for oid, origin in list(self.obj_origin.items()):
                    if origin != w.worker_id:
                        continue
                    desc = self.directory.get(oid)
                    if desc is not None and desc.arena:
                        self.store.adopt(oid)
                    self.obj_origin[oid] = "driver"
                self.store.release_all_pins(pid)
        if actor is not None:
            self._on_actor_worker_death(actor)
        elif t is not None:
            with self.lock:
                if not w.released:
                    self._release_task_resources(t)
                w.released = {}
                retry = t.retries_left > 0 and not self._shutdown
                if retry:
                    t.retries_left -= 1
                    self.pending.append(t)
            if not retry:
                self._store_error(
                    t.spec.return_ids,
                    WorkerCrashedError(
                        f"worker died while running {t.spec.function_desc}"),
                    spec=t.spec)
        self._schedule()

    def _on_actor_worker_death(self, a: _ActorState):
        with self.lock:
            a.ready = False
            a.worker = None
            inflight, a.inflight = a.inflight, []
            can_restart = (not a.dead and not self._shutdown and
                           (a.max_restarts == -1 or
                            a.restarts_used < a.max_restarts))
            # Return the dead incarnation's resources and cards; a
            # restart's creation task takes them again on dispatch.
            self._release_actor_resources(a)
            if can_restart:
                a.restarts_used += 1
                retry_tasks, fail_tasks = [], []
                for t in inflight:
                    if t.spec.actor_creation:
                        continue
                    if a.max_task_retries != 0:
                        retry_tasks.append(t)
                    else:
                        fail_tasks.append(t)
                a.queue[:0] = retry_tasks
                self.pending.append(_TaskState(spec=a.creation_spec))
            else:
                a.dead = True
                a.death_cause = a.death_cause or "worker process died"
                fail_tasks = [t for t in inflight
                              if not t.spec.actor_creation]
                fail_tasks.extend(a.queue)
                a.queue = []
        for t in fail_tasks:
            self._store_error(
                t.spec.return_ids,
                ActorDiedError(f"actor {a.actor_id} died"
                               f" ({a.death_cause or 'restarting'})"),
                spec=t.spec)
        self._schedule()

    def _fail_actor(self, a: _ActorState, cause: str):
        with self.lock:
            a.dead = True
            a.death_cause = cause
            tasks = list(a.inflight) + list(a.queue)
            a.inflight, a.queue = [], []
            self._release_actor_resources(a)
        for t in tasks:
            self._store_error(t.spec.return_ids, ActorDiedError(cause),
                              spec=t.spec)
        self._store_error(a.creation_spec.return_ids, ActorDiedError(cause),
                          spec=a.creation_spec)

    # ------------------------------------------------------------------
    # actor control
    # ------------------------------------------------------------------

    def get_named_actor(self, name: str):
        with self.lock:
            actor_id = self.named_actors.get(name)
            a = self.actors.get(actor_id) if actor_id else None
            if a is None or a.dead:
                return None
            return {"actor_id": actor_id, "method_meta": a.method_meta,
                    "creation_return": a.creation_spec.return_ids[0]}

    def kill_actor(self, actor_id: str, no_restart=True):
        with self.lock:
            a = self.actors.get(actor_id)
            if a is None:
                return False
            if no_restart:
                a.dead = True
                a.death_cause = "killed via kill()"
                if a.name:
                    self.named_actors.pop(a.name, None)
            w = a.worker
        if w is not None and w.proc is not None:
            try:
                w.proc.terminate()
            except OSError:
                pass
        return True

    def cancel(self, object_id: str):
        """Cancel a task that has not started (a pending task or a queued
        actor call); running tasks are not interrupted."""
        with self.lock:
            queues = [self.pending] + [a.queue for a in self.actors.values()]
            for q in queues:
                for t in q:
                    if object_id in t.spec.return_ids:
                        t.cancelled = True
                        q.remove(t)
                        self._store_error(
                            t.spec.return_ids,
                            TaskCancelledError("task cancelled"),
                            spec=t.spec)
                        return True
        return False

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def pids(self) -> list:
        """Pids of every process this node started that may be alive: its
        workers and its forkserver."""
        with self.lock:
            procs = self._procs + [self._forkserver.proc]
        return [p.pid for p in procs if p is not None]

    def shutdown(self):
        """End the session within one deadline (see the module docstring).
        `shutdown_report` then holds each step's end in seconds from the
        start, the pids that needed SIGKILL and any that outlived it."""
        t0 = time.monotonic()
        with self.lock:
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self.workers.values())
            procs = list(self._procs)
            self.cv.notify_all()          # blocked get/wait calls re-check
            for lst in self._get_waiters.values():
                for waiter in lst:
                    waiter["ev"].set()
        deadline = t0 + constants.SHUTDOWN_DEADLINE_S
        report = self.shutdown_report = {"processes": len(procs)}
        self._sched_event.set()           # release the scheduler thread
        self._free_event.set()
        self._wake_accept()
        for w in workers:
            # never waits: not on a send lock a blocked sender holds (C7),
            # not on room in a full socket
            protocol.try_send(w.conn, w.send_lock, protocol.KillWorker())
        for w in workers:
            if w.conn is not None:
                # a worker exits at EOF; a thread blocked writing to it
                # gets EPIPE
                protocol.close_channel(w.conn)
        report["signalled_s"] = time.monotonic() - t0
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        report["exited_s"] = time.monotonic() - t0
        report["sigkilled"] = [p.pid for p in procs if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        # a SIGKILLed worker is gone once the kernel has reaped it
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline + 1.0):
            time.sleep(0.01)
        report["outlived"] = [p.pid for p in procs if p.poll() is None]
        self._forkserver.stop()
        for p in procs:
            if isinstance(p, subprocess.Popen):
                try:
                    p.wait(timeout=1.0)   # reap: no zombie of ours stays
                except subprocess.TimeoutExpired:
                    pass
        report["reaped_s"] = time.monotonic() - t0
        for t in self._threads:
            t.join(timeout=max(0.0, deadline + 1.0 - time.monotonic()))
        report["threads_alive"] = [t.name for t in self._threads
                                   if t.is_alive()]
        for w in workers:
            if w.conn is not None:
                try:
                    w.conn.close()
                except OSError:
                    pass
        with self.lock:
            self.store.purge_spill()
            self.store.close()
        shutil.rmtree(self.session_dir, ignore_errors=True)
        if self._session_lock is not None:
            os.close(self._session_lock)
            self._session_lock = None
        atexit.unregister(self.shutdown)
        report["total_s"] = time.monotonic() - t0
