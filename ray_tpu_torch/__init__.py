"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside `ray_tpu` (the JAX reference, which it never
imports). Layout mirrors the JAX package so that counterparts are easy
to find: `models.gpt`, `ops.decode_attention` and `ops.flash_attention`
(hand-written CUDA kernels under `ops/csrc/` beside plain PyTorch
versions), `serve.engine` (paged serving), `train.spmd` and `train.loop`
(training on one device). Entry points run on CUDA unless the caller
passes ``device="cpu"``.

The top level is the task and actor runtime on one machine (`init`,
`remote`, `get`, `put`, `wait`, actors), with GPUs as the scheduler's
accelerator resource. Importing it stays light: no ``torch``, so a
worker process that runs a plain task never loads it.
"""

from __future__ import annotations

import glob
import os

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import constants, ids
from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.worker import ObjectRef, get, put, wait
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor, kill, method
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "get_actor", "kill", "cancel", "free", "method", "ObjectRef",
    "ActorHandle", "available_resources", "cluster_resources",
    "get_runtime_context", "exceptions",
]

_A5A2 = "(ROADMAP A5 (a2))"


def _detect_gpus() -> int:
    """Count this machine's cards without importing torch:
    ``RAY_TPU_NUM_GPUS`` if set, else the entries of this process's
    ``CUDA_VISIBLE_DEVICES`` if set, else the ``/dev/nvidia<N>`` device
    nodes this process may open (a node the container's device policy
    refuses, or one with no device behind it, is no card of ours)."""
    env = os.environ.get("RAY_TPU_NUM_GPUS")
    if env is not None:
        return int(env)
    visible = os.environ.get(constants.GPU_VISIBLE_DEVICES_ENV)
    if visible is not None:
        return len([e for e in visible.split(",") if e.strip()])
    n = 0
    for path in glob.glob("/dev/nvidia[0-9]*"):
        try:
            os.close(os.open(path, os.O_RDWR | os.O_CLOEXEC))
            n += 1
        except OSError:
            pass
    return n


def init(num_cpus: int | None = None,
         num_gpus: int | None = None,
         resources: dict | None = None,
         *,
         num_tpus: int | None = None,
         address: str | None = None,
         ignore_reinit_error: bool = False,
         namespace: str | None = None,
         dashboard_port: int | None = None,
         log_to_driver: bool | None = None):
    """Start a session: a node in this process that schedules tasks and
    actors over worker processes of this machine.

    ``num_gpus`` (alias ``num_tpus``, the reference's name) defaults to the
    cards `_detect_gpus` finds; pass 0 to keep every task off the cards.
    Joining a running session (``address=``), the dashboard and streaming
    worker logs to the driver need what the port has not yet (ROADMAP A5
    (a2)) and raise `NotImplementedError`.
    """
    if address is not None:
        raise NotImplementedError(
            f"init(address=...) attaches to a running session, which the "
            f"port cannot yet {_A5A2}")
    if dashboard_port is not None or log_to_driver:
        raise NotImplementedError(
            f"the dashboard and the log monitor are not ported yet {_A5A2}")
    if _worker.is_initialized():
        if ignore_reinit_error:
            return _worker.get_client()
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(pass ignore_reinit_error=True to allow)")
    if num_gpus is None:
        num_gpus = num_tpus
    if num_cpus is None:
        num_cpus = os.cpu_count() or 1
    if num_gpus is None:
        num_gpus = _detect_gpus()
    total = {"CPU": float(num_cpus)}
    if num_gpus:
        total["GPU"] = float(num_gpus)
    for k, v in (resources or {}).items():
        total[k] = float(v)

    from ray_tpu_torch._private.node import NodeServer
    _gc_stale_sessions()
    session_dir, session_lock = _new_session_dir()
    try:
        node = NodeServer(total, session_dir, num_gpus=int(num_gpus or 0),
                          session_lock=session_lock)
    except BaseException:
        import shutil
        shutil.rmtree(session_dir, ignore_errors=True)
        os.close(session_lock)
        raise
    return _worker.connect_driver_mode(node)


def _new_session_dir() -> tuple[str, int]:
    """A session directory and the descriptor of its `driver.pid`, on
    which this process holds an exclusive `flock` for the session's life
    (the node closes it at shutdown; the kernel drops it if the process
    dies). The lock is taken under a name the sweep ignores, before the
    rename that makes the session visible, so another process's
    `_gc_stale_sessions` never takes a session being born."""
    import fcntl
    name = constants.SESSION_PREFIX + ids.new_node_id()
    tmp = os.path.join(constants.SHM_ROOT, "." + name)
    os.makedirs(tmp)
    fd = os.open(os.path.join(tmp, "driver.pid"),
                 os.O_WRONLY | os.O_CREAT, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    os.write(fd, str(os.getpid()).encode())    # for a reader; not checked
    session_dir = os.path.join(constants.SHM_ROOT, name)
    os.rename(tmp, session_dir)
    return session_dir, fd


def _session_is_live(session_dir: str) -> bool:
    """Whether a driver still holds the session's lock. A lock, not a pid:
    drivers in other pid namespaces share the root, and a pid read from
    there names nothing (or another process) here."""
    import fcntl
    try:
        fd = os.open(os.path.join(session_dir, "driver.pid"), os.O_RDONLY)
    except FileNotFoundError:
        return False
    except PermissionError:
        return True               # someone else's session
    try:
        fcntl.flock(fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
        return False
    except BlockingIOError:
        return True
    finally:
        os.close(fd)


def _gc_stale_sessions():
    """Remove the port's session dirs whose driver no longer holds their
    lock (it shut down without cleaning up, or died)."""
    import shutil
    for d in glob.glob(os.path.join(constants.SHM_ROOT,
                                    constants.SESSION_PREFIX + "*")):
        if not _session_is_live(d):
            shutil.rmtree(os.path.join(constants.OBJECT_SPILL_ROOT,
                                       os.path.basename(d)),
                          ignore_errors=True)
            shutil.rmtree(d, ignore_errors=True)


def shutdown():
    """End the session: every worker process exits or is killed within
    one deadline, and the session directory and its arena are removed."""
    if not _worker.is_initialized():
        return
    client = _worker.get_client()
    if client.mode == "driver":
        client.node.shutdown()
    _worker.disconnect()


def is_initialized() -> bool:
    return _worker.is_initialized()


def remote(*args, **kwargs):
    """`@remote` decorator for functions and classes, bare or with options:

        @ray_tpu_torch.remote
        def f(x): ...

        @ray_tpu_torch.remote(num_cpus=2, num_gpus=1)
        class Learner: ...
    """
    import inspect

    def make(target, options):
        if inspect.isclass(target):
            return ActorClass(target, options)
        if not callable(target):
            raise TypeError("@remote target must be a function or class")
        return RemoteFunction(target, options)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make(args[0], {})
    if args:
        raise TypeError("@remote() takes only keyword options")
    return lambda target: make(target, kwargs)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel a task that has not started; returns whether one was found.
    Running tasks are not interrupted."""
    return _worker.get_client().control("cancel", {"object_id": ref._id})


def free(refs) -> int:
    """Unconditionally release objects: the caller asserts nothing will
    read these refs again. Returns how many objects were still live."""
    oids = [r._id if isinstance(r, ObjectRef) else str(r) for r in refs]
    return _worker.get_client().control("free_objects", oids)


def cluster_resources() -> dict:
    return _worker.get_client().control("cluster_resources")


def available_resources() -> dict:
    return _worker.get_client().control("available_resources")
