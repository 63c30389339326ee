"""Control-plane messages between the driver's node and its worker
processes, copied from `ray_tpu/_private/protocol.py` and trimmed to the
one-machine path (the port imports nothing of `ray_tpu`): the worker,
task, get/put/wait, submit, control-call and free messages. The node,
pull and log messages wait for remote nodes (ROADMAP A5 (a2)).

Plain dataclasses over a length-framed pickle channel
(`multiprocessing.connection` on a UNIX socket).

Every blocking write has a bound (C7 in ROADMAP): `bound_channel` gives a
channel's socket a send timeout (``SO_SNDTIMEO``), so a write into a peer
that reads nothing (stopped, wedged) fails after `SEND_TIMEOUT_S`
instead of blocking for good, and `safe_send` then closes the channel,
since a write cut short leaves a partial frame behind. `try_send` never
waits: not for a send lock another thread holds, and not for room in a
full socket buffer. Shutdown sends with it.
"""

from __future__ import annotations

import os
import select
import socket
import struct
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch._private.object_store import Descriptor


def _socket_of(conn) -> socket.socket:
    """A socket object over a duplicate of the channel's descriptor:
    options and shutdown act on the one underlying socket."""
    return socket.socket(fileno=os.dup(conn.fileno()))


def bound_channel(conn, timeout: float):
    """Give every later write on ``conn`` a bound of ``timeout`` seconds
    (``SO_SNDTIMEO``); returns ``conn``."""
    sec = int(timeout)
    tv = struct.pack("ll", sec, int((timeout - sec) * 1e6))
    with _socket_of(conn) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
    return conn


def close_channel(conn) -> None:
    """Shut the channel down in both directions: a thread blocked in a
    write on it gets EPIPE at once, the peer's reader gets EOF."""
    try:
        with _socket_of(conn) as s:
            s.shutdown(socket.SHUT_RDWR)
    except (OSError, ValueError):
        pass


def safe_send(conn, lock, msg) -> bool:
    """Locked send: False on a dead/absent peer instead of raising. A write
    that fails (its bound passed, the peer gone) closes the channel, since
    it may have left half a frame."""
    if conn is None:
        return False
    with lock:
        try:
            conn.send(msg)
            return True
        except (OSError, ValueError):
            close_channel(conn)
            return False


def try_send(conn, lock, msg) -> bool:
    """Send only if that cannot wait: the send lock is free now and the
    socket has room now. False otherwise (nothing was written)."""
    if conn is None or not lock.acquire(blocking=False):
        return False
    try:
        if not select.select([], [conn.fileno()], [], 0)[1]:
            return False
        conn.send(msg)
        return True
    except (OSError, ValueError):
        return False
    finally:
        lock.release()


@dataclass
class TaskSpec:
    """Everything needed to run one task invocation."""
    task_id: str
    # Function: a cached id (the worker looks up its function table) plus
    # the serialized bytes on first use.
    function_id: str
    function_blob: bytes | None  # cloudpickled callable; None if cached
    function_desc: str           # human-readable "module.fn" for errors/logs
    # Positional/keyword args: values are either ("v", inline_envelope_bytes)
    # or ("ref", object_id) — top-level ObjectRefs are resolved before the
    # task runs.
    args: list = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)
    num_returns: int = 1
    return_ids: list = field(default_factory=list)
    resources: dict = field(default_factory=dict)
    # Actor fields
    actor_id: str | None = None          # target actor for method calls
    actor_creation: bool = False         # this spec constructs the actor
    method_name: str | None = None
    max_retries: int = 0
    retry_exceptions: bool = False
    # The worker's environment overrides: {"env_vars": {...}} only.
    runtime_env: dict | None = None
    # Actor creation options: max_concurrency, max_restarts,
    # max_task_retries, name, method_meta.
    actor_options: dict | None = None
    # Name shown in errors and logs.
    name: str = ""
    # Distributed tracing: the submitter's `util.tracing`
    # propagation_context() — {"trace_id", "span_id"} — stamped by the
    # client submit paths when a trace is active.
    trace_ctx: dict | None = None


# ---- driver -> worker -----------------------------------------------------

@dataclass
class PushTask:
    """Dispatch one task to a worker. `arg_locations` maps object_id ->
    Descriptor for every ref argument, so the worker can map dependencies
    without a round trip."""
    spec: TaskSpec
    arg_locations: dict[str, Descriptor] = field(default_factory=dict)


@dataclass
class KillWorker:
    """Exit now (the worker does not finish its running task)."""


@dataclass
class FreeObject:
    """Driver -> every local worker: all references to this store-backed
    object are gone; drop this process's pins on it."""
    object_id: str
    desc: Descriptor


# ---- worker -> driver -----------------------------------------------------

@dataclass
class RegisterWorker:
    worker_id: str
    pid: int


@dataclass
class TaskDone:
    """Task finished; returns are sealed. An error is a serialized TaskError
    stored as the return value."""
    task_id: str
    return_descs: list  # list[Descriptor], parallel to spec.return_ids
    error: bool = False
    actor_ready: bool = False
    spans: list | None = None    # tracing spans drained from the worker


@dataclass
class PutRequest:
    """Worker already wrote the object into the store; register it."""
    object_id: str
    desc: Descriptor


@dataclass
class GetRequest:
    """Blocking fetch of object locations; the node replies GetReply when
    all are ready (or timeout). The issuing worker's resources are released
    while it blocks."""
    req_id: int
    object_ids: list
    timeout: float | None = None


@dataclass
class GetReply:
    req_id: int
    locations: dict          # object_id -> Descriptor
    timed_out: bool = False
    # "ExceptionClassName: message" when the get failed terminally (object
    # freed by refcounting); the worker re-raises.
    error: str | None = None


@dataclass
class WaitRequest:
    req_id: int
    object_ids: list
    num_returns: int
    timeout: float | None = None


@dataclass
class WaitReply:
    req_id: int
    ready: list
    not_ready: list
    error: str | None = None


@dataclass
class SubmitRequest:
    """Nested task/actor submission from inside a worker, pipelined: the
    worker streams specs without per-task acks under a credit window.
    ``seq`` is the per-channel monotone sequence number; the receiver
    applies in-order arrivals, drops duplicates (replays), nacks gaps
    (SubmitNack), and returns credit (SubmitCredit). Failures surface as
    error objects stored under the spec's return ids."""
    spec: TaskSpec
    seq: int


@dataclass
class SubmitCredit:
    """Node -> worker: every pipelined SubmitRequest with
    ``seq <= ack_seq`` has been applied (or deduped)."""
    ack_seq: int


@dataclass
class SubmitNack:
    """Node -> worker: a pipelined SubmitRequest arrived out of order;
    replay the ring from ``expected_seq`` in order."""
    expected_seq: int


@dataclass
class ActorCallRequest:
    """Generic control-plane RPC: named-actor lookup, kill, resources, ref
    updates. `method` selects a NodeServer handler."""
    req_id: int
    method: str
    payload: Any = None


@dataclass
class ActorCallReply:
    req_id: int
    result: Any = None
    error: str | None = None

