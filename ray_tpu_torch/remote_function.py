"""@remote functions, copied from `ray_tpu/remote_function.py` (the port
imports nothing of `ray_tpu`): wraps a user callable, carries default
task options, and turns `.remote(...)` calls into TaskSpec submissions.

The accelerator is the GPU: ``num_gpus`` asks for whole cards (the
reference's ``num_tpus``, accepted here as its alias).
"""

from __future__ import annotations

import functools
import hashlib

import cloudpickle

from ray_tpu_torch._private import ids, protocol, serialization
from ray_tpu_torch._private.constants import (
    DEFAULT_TASK_NUM_CPUS,
    INLINE_OBJECT_MAX_BYTES,
)
from ray_tpu_torch._private.worker import ObjectRef, get_client

# The reference's options that need what this slice leaves out.
_A5A2_OPTIONS = ("scheduling_strategy", "placement_group",
                 "placement_group_bundle_index")


def _check_options(o: dict) -> None:
    for name in _A5A2_OPTIONS:
        if o.get(name) is not None:
            raise NotImplementedError(
                f"the {name!r} option needs placement groups and remote "
                "nodes, which the port has not yet (ROADMAP A5 (a2))")
    extra = set(o.get("runtime_env") or {}) - {"env_vars"}
    if extra:
        raise NotImplementedError(
            f"runtime_env keys {sorted(extra)}: the port's workers take "
            "env_vars only (ROADMAP A5 (a2))")


def _resources_from_options(o: dict, default_cpus: float) -> dict:
    _check_options(o)
    res = dict(o.get("resources") or {})
    num_cpus = o.get("num_cpus")
    # num_tpus accepted as an alias, easing reference-API code onto GPUs
    num_gpus = o.get("num_gpus", o.get("num_tpus"))
    res["CPU"] = float(default_cpus if num_cpus is None else num_cpus)
    if num_gpus:
        # a fraction is booked as such and shares one card with other
        # fractions; 1 or more is given int(num_gpus) whole cards (node.py)
        res["GPU"] = float(num_gpus)
    mem = o.get("memory")
    if mem:
        res["memory"] = float(mem)
    return res


def _encode_args(args, kwargs):
    """Top-level ObjectRefs become ("ref", id); other values are serialized
    inline, promoted to the object store above the inline cap."""
    def enc(v):
        if isinstance(v, ObjectRef):
            return ("ref", v._id)
        blob = serialization.dumps(v)
        if len(blob) > INLINE_OBJECT_MAX_BYTES:
            # reuse the envelope just built instead of re-serializing
            return ("ref", get_client().put_serialized(blob))
        return ("v", blob)
    return [enc(a) for a in args], {k: enc(v) for k, v in kwargs.items()}


class RemoteFunction:
    def __init__(self, function, options: dict | None = None):
        self._function = function
        self._options = dict(options or {})
        functools.update_wrapper(self, function)
        self._pickled: bytes | None = None
        self._function_id: str | None = None

    def _materialize(self):
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._function, protocol=5)
            self._function_id = ("fn_" +
                                 hashlib.sha1(self._pickled).hexdigest()[:16])
        return self._pickled, self._function_id

    def options(self, **opts) -> "RemoteFunction":
        new = RemoteFunction(self._function, {**self._options, **opts})
        new._pickled, new._function_id = self._materialize()
        return new

    def __call__(self, *a, **kw):
        raise TypeError(
            f"remote function {self._function.__name__} cannot be called "
            f"directly; use .remote()")

    def remote(self, *args, **kwargs):
        blob, function_id = self._materialize()
        o = self._options
        num_returns = int(o.get("num_returns", 1))
        resources = _resources_from_options(o, DEFAULT_TASK_NUM_CPUS)
        return_ids = [ids.new_object_id() for _ in range(num_returns)]
        enc_args, enc_kwargs = _encode_args(args, kwargs)
        spec = protocol.TaskSpec(
            task_id=ids.new_task_id(),
            function_id=function_id,
            function_blob=blob,
            function_desc=getattr(self._function, "__qualname__",
                                  str(self._function)),
            args=enc_args,
            kwargs=enc_kwargs,
            num_returns=num_returns,
            return_ids=return_ids,
            resources=resources,
            max_retries=int(o.get("max_retries", 0)),
            retry_exceptions=bool(o.get("retry_exceptions", False)),
            runtime_env=o.get("runtime_env") or None,
            name=o.get("name") or getattr(self._function, "__name__", ""),
        )
        get_client().submit(spec)
        refs = [ObjectRef(oid) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs
