"""Actor classes and handles, copied from `ray_tpu/actor.py` (the port
imports nothing of `ray_tpu`): `@remote` on a class yields an
`ActorClass`; `.remote(...)` has a worker process construct the instance;
the returned `ActorHandle` routes ordered method calls to it. Handles
pickle into tasks and can be looked up by name via `get_actor`.
"""

from __future__ import annotations

import hashlib
import inspect

import cloudpickle

from ray_tpu_torch._private import ids, protocol
from ray_tpu_torch._private.constants import DEFAULT_ACTOR_LIFETIME_CPUS
from ray_tpu_torch._private.worker import ObjectRef, get_client
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.remote_function import (_encode_args,
                                           _resources_from_options)


def method(**opts):
    """Decorator setting per-method options, e.g. @method(num_returns=2)."""
    def wrap(fn):
        fn.__ray_tpu_method_options__ = opts
        return fn
    return wrap


def _is_async_class(cls) -> bool:
    """An actor is ASYNC iff any of its methods is a coroutine function —
    its methods then run on a per-actor event loop instead of threads."""
    return any(inspect.iscoroutinefunction(fn)
               for _, fn in inspect.getmembers(cls, inspect.isfunction))


def _collect_method_meta(cls) -> dict:
    meta = {}
    for name, fn in inspect.getmembers(cls, inspect.isfunction):
        if name.startswith("__") and name != "__call__":
            continue
        opts = getattr(fn, "__ray_tpu_method_options__", {})
        meta[name] = {"num_returns": int(opts.get("num_returns", 1))}
    return meta


class ActorClass:
    def __init__(self, cls, options: dict | None = None):
        self._cls = cls
        self._options = dict(options or {})
        self._pickled: bytes | None = None
        self._function_id: str | None = None
        self.__name__ = getattr(cls, "__name__", "Actor")

    def _materialize(self):
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._cls, protocol=5)
            self._function_id = ("cls_" +
                                 hashlib.sha1(self._pickled).hexdigest()[:16])
        return self._pickled, self._function_id

    def options(self, **opts) -> "ActorClass":
        new = ActorClass(self._cls, {**self._options, **opts})
        new._pickled, new._function_id = self._materialize()
        return new

    def __call__(self, *a, **kw):
        raise TypeError(
            f"actor class {self.__name__} cannot be instantiated directly; "
            f"use .remote()")

    def remote(self, *args, **kwargs) -> "ActorHandle":
        blob, function_id = self._materialize()
        o = self._options
        resources = _resources_from_options(o, DEFAULT_ACTOR_LIFETIME_CPUS)
        actor_id = ids.new_actor_id()
        task_id = ids.new_task_id()
        creation_return = ids.new_object_id()
        enc_args, enc_kwargs = _encode_args(args, kwargs)
        method_meta = _collect_method_meta(self._cls)
        spec = protocol.TaskSpec(
            task_id=task_id,
            function_id=function_id,
            function_blob=blob,
            function_desc=self.__name__ + ".__init__",
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=1,
            return_ids=[creation_return],
            resources=resources,
            actor_id=actor_id,
            actor_creation=True,
            runtime_env=o.get("runtime_env") or None,
            actor_options={
                # async actors (any `async def` method) default to high
                # concurrency — awaits overlap on one event loop, so
                # serial pumping would defeat their whole point
                "max_concurrency": int(o.get(
                    "max_concurrency",
                    1000 if _is_async_class(self._cls) else 1)),
                "max_restarts": int(o.get("max_restarts", 0)),
                "max_task_retries": int(o.get("max_task_retries", 0)),
                "name": o.get("name"),
                "method_meta": method_meta,
            },
            name=o.get("name") or self.__name__,
        )
        get_client().submit(spec)
        return ActorHandle(actor_id, self.__name__, method_meta,
                           creation_return)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           int(opts.get("num_returns", self._num_returns)))

    def remote(self, *args, **kwargs):
        h = self._handle
        task_id = ids.new_task_id()
        return_ids = [ids.new_object_id() for _ in range(self._num_returns)]
        enc_args, enc_kwargs = _encode_args(args, kwargs)
        spec = protocol.TaskSpec(
            task_id=task_id,
            function_id="method",
            function_blob=None,
            function_desc=f"{h._class_name}.{self._name}",
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=self._num_returns,
            return_ids=return_ids,
            actor_id=h._actor_id,
            method_name=self._name,
            name=f"{h._class_name}.{self._name}",
        )
        get_client().submit(spec)
        refs = [ObjectRef(oid) for oid in return_ids]
        return refs[0] if self._num_returns == 1 else refs


class ActorHandle:
    def __init__(self, actor_id: str, class_name: str, method_meta: dict,
                 creation_return: str | None = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_meta = method_meta
        self._creation_return = creation_return

    def __getattr__(self, name):
        meta = self._method_meta.get(name)
        if meta is None:
            raise AttributeError(
                f"actor {self._class_name} has no method {name!r}")
        return ActorMethod(self, name, meta["num_returns"])

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._method_meta, self._creation_return))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id})"


def get_actor(name: str) -> ActorHandle:
    """Look up a named actor."""
    info = get_client().control("get_actor", name)
    if info is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(info["actor_id"], name, info["method_meta"],
                       info["creation_return"])


def kill(actor: ActorHandle, *, no_restart: bool = True):
    """Forcibly terminate an actor process."""
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    get_client().control(
        "kill_actor", {"actor_id": actor._actor_id, "no_restart": no_restart})


def wait_for_actor_ready(actor: ActorHandle, timeout: float | None = None):
    """Block until the actor constructor has finished (internal utility)."""
    from ray_tpu_torch._private import worker
    if actor._creation_return is None:
        raise RayTpuError("handle has no creation future")
    worker.get(ObjectRef(actor._creation_return), timeout=timeout)
