"""Worker-process spawning for the node, copied from
`ray_tpu/_private/spawn.py` with CUDA's visibility rules in place of the
TPU's (the port imports nothing of `ray_tpu`).

- A worker given GPUs gets ``CUDA_VISIBLE_DEVICES`` set to its ids and
  always execs a fresh interpreter: the CUDA runtime reads the variable
  once, when the process first touches CUDA, and a process forked after
  CUDA was initialised cannot use it.
- A CPU worker gets ``CUDA_VISIBLE_DEVICES=""``. The variable alone hides
  every card from such a worker, so the reference's ``worker_site`` hook
  (which keeps accelerator plugins out of a CPU worker before JAX is
  imported) has no counterpart here.
- Only CPU workers fork, and only from the forkserver (`forkserver.py`),
  an exec'd process that imports the worker's modules and never
  ``torch``. The driver itself is never forked: ``subprocess`` execs.

The GPU ids are indices into the driver's own ``CUDA_VISIBLE_DEVICES``
when it has one (a driver restricted to cards 4 and 6 hands id 1 out as
card 6), and device ordinals otherwise.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from ray_tpu_torch._private import config, constants

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def visible_gpu_ids(gpu_ids) -> str:
    """The ``CUDA_VISIBLE_DEVICES`` value of a worker given ``gpu_ids``."""
    parent = os.environ.get(constants.GPU_VISIBLE_DEVICES_ENV)
    if parent is not None and parent.strip():
        entries = [e.strip() for e in parent.split(",") if e.strip()]
        return ",".join(entries[i] for i in gpu_ids)
    return ",".join(map(str, gpu_ids))


def worker_env(gpu_ids=None, runtime_env=None) -> dict:
    env = dict(os.environ)
    env["RAY_TPU_WORKER"] = "1"
    env.update({str(k): str(v) for k, v in
                ((runtime_env or {}).get("env_vars") or {}).items()})
    # a card is the scheduler's to hand out: a CPU worker sees none, a GPU
    # worker exactly its own, whatever the caller's env_vars say
    env[constants.GPU_VISIBLE_DEVICES_ENV] = (
        visible_gpu_ids(gpu_ids) if gpu_ids else "")
    return env


def propagate_pythonpath(env: dict) -> dict:
    """Make the child resolve the same modules as this process: cloudpickle
    serializes module-level functions by reference, so the full sys.path
    (including the uninstalled checkout and the user's script dir) is
    propagated."""
    entries = [_PKG_ROOT] + [p for p in sys.path if p]
    entries += [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(entries))
    return env


def _log_path(log_dir: str | None, worker_id: str) -> str | None:
    if log_dir is None or not config.get("WORKER_LOG_REDIRECT"):
        return None
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, worker_id + ".log")


def proc_start(pid: int):
    """Kernel start ticks of `pid` (/proc stat field 22, paren-safe), or
    None if it is gone."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return int(f.read().rsplit(b")", 1)[1].split()[19])
    except (OSError, ValueError, IndexError):
        return None


class ForkedProc:
    """Popen-compatible handle for a worker forked by the forkserver.
    The kernel reaps the child at exit (the forkserver ignores SIGCHLD),
    so the bare pid is recyclable the moment the child dies: every probe
    and signal is guarded by the start-ticks identity recorded at fork."""

    def __init__(self, pid: int, start_ticks=None):
        self.pid = pid
        self._start = start_ticks
        self._dead = start_ticks is None

    def poll(self):
        if not self._dead:
            self._dead = proc_start(self.pid) != self._start
        return 0 if self._dead else None

    def send_signal(self, sig):
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except (ProcessLookupError, PermissionError):
                self._dead = True

    def terminate(self):
        import signal
        self.send_signal(signal.SIGTERM)

    def kill(self):
        import signal
        self.send_signal(signal.SIGKILL)


class ForkServer:
    """The node's handle on its forkserver child (`forkserver.py`), started
    at the first CPU worker. Requests are serialized over one connection.
    Its socket lies in the session directory, beside the node's."""

    def __init__(self, session_dir: str):
        self._lock = threading.Lock()
        self.proc = None
        self._conn = None
        self._sock = os.path.join(session_dir,
                                  constants.FORKSERVER_SOCKET.format(
                                      pid=os.getpid()))

    def _ensure(self, authkey: bytes) -> bool:
        from multiprocessing import connection as mpc
        if self._conn is not None and self.proc.poll() is None:
            return True
        self.stop()
        sock = self._sock
        env = propagate_pythonpath(dict(os.environ))
        env["RAY_TPU_AUTHKEY"] = authkey.hex()
        env[constants.GPU_VISIBLE_DEVICES_ENV] = ""
        try:
            # stdio inherited, not piped: a forked child without a log
            # file keeps the spawner's real stdout (a pipe nobody drains
            # would block a chatty worker)
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.forkserver",
                 sock], env=env, stdin=subprocess.DEVNULL)
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    self._conn = mpc.Client(sock, family="AF_UNIX",
                                            authkey=authkey)
                    return True
                except OSError:
                    if (time.monotonic() > deadline
                            or self.proc.poll() is not None):
                        raise
                    time.sleep(0.02)
        except OSError:
            self.stop()
            return False

    def spawn(self, address, authkey, worker_id, env, log_path):
        with self._lock:
            if not self._ensure(authkey):
                return None
            try:
                self._conn.send({"address": address, "worker_id": worker_id,
                                 "env": env, "log_path": log_path})
                reply = self._conn.recv()
            except (OSError, EOFError, ValueError, TypeError):
                self._conn = None
                return None
            if not reply.get("pid"):
                return None
            return ForkedProc(reply["pid"], reply.get("start"))

    def stop(self) -> None:
        """SIGKILL the forkserver (its children live on as their own
        sessions), reap it and remove its socket."""
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
        if self.proc is not None:
            try:
                self.proc.kill()
                self.proc.wait(timeout=5)
            except (OSError, subprocess.TimeoutExpired):
                pass
            self.proc = None
        try:
            os.unlink(self._sock)
        except OSError:
            pass


def spawn_worker_proc(address: str, authkey: bytes, worker_id: str,
                      env: dict, log_dir: str | None = None,
                      forkserver: ForkServer | None = None):
    """Start a worker process that will register at `address`. A CPU
    worker forks from the forkserver (milliseconds instead of an
    interpreter start); a GPU worker, or any worker when the forkserver is
    unavailable, execs a fresh python."""
    env = propagate_pythonpath(dict(env))
    env["RAY_TPU_AUTHKEY"] = authkey.hex()
    log_path = _log_path(log_dir, worker_id)
    if (forkserver is not None
            and env.get(constants.GPU_VISIBLE_DEVICES_ENV) == ""):
        proc = forkserver.spawn(address, authkey, worker_id, env, log_path)
        if proc is not None:
            return proc
    logf = open(log_path, "ab") if log_path else None
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main",
             address, worker_id],
            env=env, stdin=subprocess.DEVNULL, stdout=logf,
            stderr=subprocess.STDOUT if logf else None,
            start_new_session=True)
    finally:
        if logf is not None:
            logf.close()     # the child holds its own fd now
