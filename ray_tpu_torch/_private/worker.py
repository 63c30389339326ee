"""Process-global client state + the ObjectRef type, copied from
`ray_tpu/_private/worker.py` (the port imports nothing of `ray_tpu`).

The "core worker" has two concrete shapes sharing one interface:

- `DriverClient`: in-process calls straight into the NodeServer (the driver
  embeds its node, so `get`/`put` skip any socket hop);
- `WorkerClient`: the socket channel of `worker_main.WorkerRuntime`.
"""

from __future__ import annotations

import sys as _sys
import threading
from typing import Sequence

from ray_tpu_torch._private import ids
from ray_tpu_torch.exceptions import RayTpuError, TaskError

# ---------------------------------------------------------------------------
# Reference counting. Each process
# counts its live ObjectRef pythons per object id; the 0→1 and →0
# transitions are reported to the driver ("hold"/"release"), which frees an
# object once no process holds it, no queued/running task consumes it, and
# it never escaped. Escape = the ObjectRef was pickled into an arbitrary
# payload (nested in a value, stored in actor state, written to disk) — the
# pessimistic stand-in for the reference's borrower protocol: escaped
# objects live for the session. RAY_TPU_DISABLE_REFCOUNT=1 restores
# session-lifetime objects everywhere.
# ---------------------------------------------------------------------------

import os as _os

_REFCOUNT_DISABLED = _os.environ.get("RAY_TPU_DISABLE_REFCOUNT") == "1"
_track_lock = threading.Lock()
_local_counts: dict = {}
# __del__ may run re-entrantly mid-GC while _track_lock is held by the
# same thread, so decrements are only ever an atomic deque append; they
# are folded into the counts later from regular threads (_drain_decs).
import collections as _collections

_pending_decs: "_collections.deque[str]" = _collections.deque()


def _notify(kind: str, oid: str) -> None:
    client = _global_client
    if client is None:
        return
    try:
        if client.mode == "driver":
            if kind == "hold":
                client.node.ref_hold(oid, "driver")
            elif kind == "release":
                client.node.ref_release(oid, "driver")
            else:
                client.node.ref_escape(oid)
        elif client.mode == "worker":
            client.rt.enqueue_ref_event(kind, oid)
    except Exception:
        pass  # teardown races: losing a release only delays a free


def _drain_decs() -> None:
    """Fold queued __del__ decrements into the counts; emit releases."""
    if not _pending_decs:
        return
    released = []
    with _track_lock:
        while True:
            try:
                oid = _pending_decs.popleft()
            except IndexError:
                break
            n = _local_counts.get(oid, 0) - 1
            if n <= 0:
                _local_counts.pop(oid, None)
                if n == 0:
                    released.append(oid)
            else:
                _local_counts[oid] = n
    for oid in released:
        _notify("release", oid)


def _track_inc(oid: str) -> None:
    if _REFCOUNT_DISABLED:
        return
    _drain_decs()
    with _track_lock:
        n = _local_counts.get(oid, 0)
        _local_counts[oid] = n + 1
    if n == 0:
        _notify("hold", oid)


def _track_dec(oid: str) -> None:
    if _REFCOUNT_DISABLED:
        return
    try:
        _pending_decs.append(oid)   # GIL-atomic; folded in _drain_decs
    except Exception:
        pass  # interpreter shutdown


def _mark_escaped(oid: str) -> None:
    if _REFCOUNT_DISABLED:
        return
    _notify("escape", oid)


class ObjectRef:
    """A future for a task return or `put` value. Identity is the object id
    string. Instances participate in distributed refcounting (above)."""

    __slots__ = ("_id",)

    def __init__(self, object_id: str):
        self._id = object_id
        _track_inc(object_id)

    def hex(self) -> str:
        return self._id

    def __del__(self):
        _track_dec(self._id)

    def __reduce__(self):
        # Pickling a ref means it may re-materialize anywhere (inside a
        # stored value, actor state, a file): mark it escaped so the
        # driver never frees it. Top-level task args bypass this — they
        # are encoded as ("ref", id) without pickling the ObjectRef.
        _mark_escaped(self._id)
        return (ObjectRef, (self._id,))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id})"

    def future(self):
        """concurrent.futures.Future view of this ref."""
        import concurrent.futures
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _poll():
            try:
                fut.set_result(get(self))
            except BaseException as e:
                fut.set_exception(e)
        threading.Thread(target=_poll, daemon=True).start()
        return fut


def _stamp_trace_ctx(spec) -> None:
    """Stamp the submitter's trace context onto the outgoing TaskSpec.
    Central for BOTH client shapes, so driver submits, nested worker
    submits and every actor-method call propagate the same way. A trace
    can be active only once `util.tracing` is loaded, so the no-trace path
    imports nothing."""
    tracing = _sys.modules.get("ray_tpu_torch.util.tracing")
    if spec.trace_ctx is None and tracing is not None:
        spec.trace_ctx = tracing.propagation_context()


class BaseClient:
    mode = "none"

    def get(self, refs, timeout=None):
        raise NotImplementedError

    def put(self, value) -> str:
        raise NotImplementedError

    def wait(self, object_ids, num_returns, timeout):
        raise NotImplementedError

    def submit(self, spec) -> None:
        raise NotImplementedError

    def control(self, method: str, payload=None):
        raise NotImplementedError


class DriverClient(BaseClient):
    mode = "driver"

    def __init__(self, node):
        self.node = node
        self.job_id = ids.new_job_id()

    def get_values(self, object_ids, timeout=None):
        locs = self.node.get_locations(object_ids, timeout)
        return [self.node.store.get(locs[o]) for o in object_ids]

    def put(self, value):
        return self.node.put_value(value)

    def put_serialized(self, payload: bytes) -> str:
        oid = ids.new_object_id()
        desc = self.node.store.put_serialized(oid, payload)
        self.node.register_object(oid, desc)
        return oid

    def wait(self, object_ids, num_returns, timeout):
        return self.node.wait_objects(object_ids, num_returns, timeout)

    def submit(self, spec):
        _stamp_trace_ctx(spec)
        self.node.submit(spec)

    def control(self, method, payload=None):
        return self.node.control(method, payload, None)


class WorkerClient(BaseClient):
    mode = "worker"

    def __init__(self, runtime):
        self.rt = runtime

    def get_values(self, object_ids, timeout=None):
        return self.rt.get_objects(object_ids, timeout)

    def put(self, value):
        return self.rt.put_object(value)

    def put_serialized(self, payload: bytes) -> str:
        from ray_tpu_torch._private import protocol
        oid = ids.new_object_id()
        desc = self.rt.store.put_serialized(oid, payload)
        self.rt.send(protocol.PutRequest(oid, desc))
        return oid

    def wait(self, object_ids, num_returns, timeout):
        return self.rt.wait_objects(object_ids, num_returns, timeout)

    def submit(self, spec):
        _stamp_trace_ctx(spec)
        self.rt.submit_spec(spec)

    def control(self, method, payload=None):
        return self.rt.control(method, payload)


_global_client: BaseClient | None = None
_init_lock = threading.Lock()


def get_client() -> BaseClient:
    if _global_client is None:
        raise RayTpuError(
            "ray_tpu_torch.init() has not been called in this process")
    if _pending_decs:
        _drain_decs()   # piggyback refcount housekeeping on API activity
    return _global_client


def is_initialized() -> bool:
    return _global_client is not None


def connect_driver_mode(node) -> DriverClient:
    global _global_client
    _global_client = DriverClient(node)
    return _global_client


def connect_worker_mode(runtime) -> WorkerClient:
    global _global_client
    _global_client = WorkerClient(runtime)
    return _global_client


def disconnect():
    global _global_client
    _global_client = None


# ---------------------------------------------------------------------------
# get / put / wait over the global client
# ---------------------------------------------------------------------------

def _raise_if_error(value):
    if isinstance(value, TaskError):
        raise value.as_instanceof_cause()
    if isinstance(value, RayTpuError):
        raise value
    return value


def get(refs, *, timeout: float | None = None):
    client = get_client()
    single = isinstance(refs, ObjectRef)
    ref_list: Sequence[ObjectRef] = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(
                f"get() expects ObjectRef(s), got {type(r).__name__}")
    values = client.get_values([r._id for r in ref_list], timeout)
    values = [_raise_if_error(v) for v in values]
    return values[0] if single else values


def put(value) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return ObjectRef(get_client().put(value))


def wait(refs, *, num_returns: int = 1, timeout: float | None = None,
         fetch_local: bool = True):
    """Block until `num_returns` of `refs` are ready or `timeout` passes;
    returns (ready, not_ready) in the order given. `fetch_local` is
    accepted for the reference's signature: on one machine every object
    is local."""
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    ref_list = list(refs)
    if len(set(r._id for r in ref_list)) != len(ref_list):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(ref_list):
        raise ValueError("num_returns exceeds the number of refs")
    ready, not_ready = get_client().wait(
        [r._id for r in ref_list], num_returns, timeout)
    by_id = {r._id: r for r in ref_list}
    return [by_id[i] for i in ready], [by_id[i] for i in not_ready]
