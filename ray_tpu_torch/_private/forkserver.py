"""Warm-fork worker factory, copied from `ray_tpu/_private/forkserver.py`
(the port imports nothing of `ray_tpu`): pay the interpreter start and
the worker's imports once.

This process is exec'd by the node (``python -m
ray_tpu_torch._private.forkserver SOCKET``), imports the worker's module
tree once, then forks one child per request: a CPU worker is live in
milliseconds. It never imports ``torch`` and never touches CUDA, so its
children start without any CUDA state (a process forked after CUDA was
initialised cannot use CUDA); a task that imports ``torch`` in such a
child finds ``CUDA_VISIBLE_DEVICES=""`` and no card. GPU workers never
come from here: they exec (`spawn.py`).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from multiprocessing import connection


def _spawn_child(req: dict) -> int:
    import warnings
    with warnings.catch_warnings():
        # CPython warns on fork-from-multithreaded generically; the
        # factory's extra threads (parent watcher, the spawner's serve
        # loop) only sleep/recv and hold no locks the child touches
        warnings.simplefilter("ignore", DeprecationWarning)
        pid = os.fork()
    if pid != 0:
        return pid
    # ---- child ----
    try:
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        os.setsid()          # own group: group kills reach no sibling
        devnull = os.open(os.devnull, os.O_RDONLY)
        os.dup2(devnull, 0)
        if req.get("log_path"):
            fd = os.open(req["log_path"],
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            os.dup2(fd, 1)
            os.dup2(fd, 2)
        os.environ.clear()
        os.environ.update(req["env"])
        from ray_tpu_torch._private import ids, worker_main
        ids.reseed()         # siblings must not replay one id stream
        worker_main.run(req["address"], req["worker_id"])
        os._exit(0)
    except BaseException:
        import traceback
        traceback.print_exc()
        os._exit(1)


def _watch_parent(ppid: int, sock_path: str):
    """The factory must not outlive its spawner: orphaned factories would
    leak across sessions."""
    import time
    while os.getppid() == ppid:
        time.sleep(0.5)
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    os._exit(0)


def _serve(conn):
    """One spawner per connection; its requests arrive one at a time."""
    from ray_tpu_torch._private.spawn import proc_start
    while True:
        try:
            req = conn.recv()
        except (EOFError, OSError, TypeError):
            return
        if req is None:      # orderly shutdown
            os._exit(0)
        try:
            pid = _spawn_child(req)
            # start ticks = pid-reuse-proof identity (children are reaped
            # at exit, so a bare pid is recyclable)
            conn.send({"pid": pid, "start": proc_start(pid)})
        except BaseException as e:
            try:
                conn.send({"error": repr(e)})
            except (OSError, ValueError):
                return


def main():
    sock_path = sys.argv[1]
    authkey = bytes.fromhex(os.environ["RAY_TPU_AUTHKEY"])
    # Preload the worker's import tree (the fork dividend); asyncio too,
    # which async actors import.
    import asyncio  # noqa: F401
    from ray_tpu_torch._private import worker_main  # noqa: F401
    # the kernel reaps children at exit: no zombie waits on this process
    # (a SIGCHLD handler would run only when the main thread, blocked in
    # accept(), next runs bytecode)
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    threading.Thread(target=_watch_parent, args=(os.getppid(), sock_path),
                     daemon=True).start()
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    with connection.Listener(family="AF_UNIX", address=sock_path,
                             authkey=authkey) as listener:
        # children must not inherit the listener
        os.set_inheritable(listener._listener._socket.fileno(), False)
        while True:
            try:
                conn = listener.accept()
            except (OSError, EOFError):
                return
            threading.Thread(target=_serve, args=(conn,), daemon=True).start()


if __name__ == "__main__":
    main()
