"""The port's runtime ends within one deadline and leaves nothing behind.

- C7 (ROADMAP): an actor's worker is SIGSTOPped and a backlog of frees
  addressed to it overfills its channel, so the free fanout blocks in a
  write while holding that worker's send lock. `shutdown()` must not wait
  on it: it returns within 3 s with no live process and no session dir.
- `shutdown()` after 1,000 tasks takes under 2 s.
- A CPU worker that ran a plain task has no ``torch`` in `sys.modules`;
  a worker given GPUs was exec'd (not forked), with its
  ``CUDA_VISIBLE_DEVICES`` set; a CPU worker's is empty.
- `init()` twice raises unless ``ignore_reinit_error``; API calls before
  `init()` and after `shutdown()` raise the reference's errors.
- `init()`'s sweep of dead drivers' session dirs never takes a live one,
  nor one being born in another process.

Each test has its own session (2 CPUs; 2 fake GPUs where it needs them)
and every wait here has its own timeout.
"""

import os
import signal
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch as rt


def _alive(pids) -> list:
    out = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            out.append(pid)
        except ProcessLookupError:
            pass
    return out


@pytest.fixture
def session():
    """A session of the test's own; torn down by the test (timed) or here."""
    def start(**kw):
        rt.init(num_cpus=2, **kw)
        return rt._worker.get_client().node
    yield start
    rt.shutdown()


def _timed_shutdown(node) -> tuple[float, list, bool]:
    pids = node.pids()
    assert pids, "the session started no process"
    t0 = time.monotonic()
    rt.shutdown()
    took = time.monotonic() - t0
    return took, _alive(pids), os.path.exists(node.session_dir)


def test_shutdown_is_not_held_by_a_stopped_worker_behind_a_full_pipe(session):
    node = session(num_gpus=0)

    @rt.remote
    class Pid:
        def pid(self):
            return os.getpid()
    a = Pid.remote()
    pid = rt.get(a.pid.remote(), timeout=30)
    os.kill(pid, signal.SIGSTOP)
    try:
        # each freed store-backed object sends every worker a FreeObject;
        # the stopped one reads none of them, so its channel fills and the
        # fanout thread blocks in a write holding its send lock
        for _ in range(6000):
            ref = rt.put(np.zeros(110_000 // 8))   # > inline: store-backed
            del ref
        deadline = time.monotonic() + 10
        while not node._free_outbox and time.monotonic() < deadline:
            rt._worker._drain_decs()
            time.sleep(0.01)
        assert node._free_outbox, "the fanout never blocked on the channel"
        took, alive, left = _timed_shutdown(node)
    finally:
        try:
            os.kill(pid, signal.SIGKILL)       # never leave it stopped
        except ProcessLookupError:
            pass
    assert took < 3.0, f"shutdown took {took:.2f} s"
    assert alive == [] and not left


def test_shutdown_after_1000_tasks_is_quick(session):
    node = session(num_gpus=0)

    @rt.remote
    def f(x):
        return x + 1
    assert sum(rt.get([f.remote(i) for i in range(1000)], timeout=60)) \
        == sum(range(1, 1001))
    took, alive, left = _timed_shutdown(node)
    assert took < 2.0, f"shutdown took {took:.2f} s"
    assert alive == [] and not left
    sock = node._forkserver._sock     # in the session dir, gone with it
    assert os.path.dirname(sock) == node.session_dir
    assert not os.path.exists(sock)


def test_cpu_worker_never_imports_torch(session):
    session(num_gpus=0)

    @rt.remote
    def plain(x):
        return x * 2, "torch" in sys.modules, \
            os.environ.get("CUDA_VISIBLE_DEVICES")
    assert rt.get(plain.remote(21), timeout=30) == (42, False, "")


def test_gpu_worker_is_execd_with_its_devices(session):
    session(num_gpus=2)

    def describe():
        with open("/proc/self/cmdline", "rb") as f:
            argv = f.read().split(b"\0")
        return (os.environ.get("CUDA_VISIBLE_DEVICES"), os.getppid(),
                b"ray_tpu_torch._private.worker_main" in argv)
    gpu = rt.remote(num_gpus=1)(describe)
    cpu = rt.remote(describe)
    assert rt.get(gpu.remote(), timeout=60) == ("0", os.getpid(), True)
    visible, parent, execd = rt.get(cpu.remote(), timeout=30)
    assert visible == "" and parent != os.getpid() and not execd  # forked
    two = rt.remote(num_gpus=2)(describe)
    assert rt.get(two.remote(), timeout=60)[0] == "0,1"
    deadline = time.monotonic() + 10
    while (rt.available_resources().get("GPU") != 2.0
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert rt.available_resources()["GPU"] == 2.0


def test_gpu_ids_map_through_the_drivers_visible_devices(monkeypatch):
    from ray_tpu_torch._private import spawn
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6")
    assert spawn.worker_env([1])["CUDA_VISIBLE_DEVICES"] == "6"
    assert spawn.worker_env([])["CUDA_VISIBLE_DEVICES"] == ""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert spawn.worker_env([0, 1])["CUDA_VISIBLE_DEVICES"] == "0,1"


def test_gpu_detection(monkeypatch):
    monkeypatch.setenv("RAY_TPU_NUM_GPUS", "3")
    assert rt._detect_gpus() == 3
    monkeypatch.delenv("RAY_TPU_NUM_GPUS")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert rt._detect_gpus() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert rt._detect_gpus() == 0


def test_init_twice_raises_unless_ignored(session):
    session(num_gpus=0)
    with pytest.raises(RuntimeError, match="twice"):
        rt.init(num_cpus=1)
    assert rt.init(num_cpus=1, ignore_reinit_error=True) is \
        rt._worker.get_client()


_NO_SESSION_CALLS = (
    "lambda m: m.put(1)", "lambda m: m.cluster_resources()",
    "lambda m: m.get(m.ObjectRef('obj_x'))", "lambda m: m.get_actor('x')",
    "lambda m: m.get_runtime_context()")


def _error_names(mod) -> list:
    out = []
    for call in _NO_SESSION_CALLS:
        try:
            eval(call)(mod)
            out.append(None)
        except Exception as e:  # noqa: BLE001 — the class is the result
            out.append(type(e).__name__)
    return out


def test_api_before_init_and_after_shutdown_matches_the_reference():
    """Without a session every call raises the class the JAX package
    raises. The JAX side runs in a fresh process (this one may hold the
    JAX session other test files share); its check needs no session, so
    no JAX runtime starts."""
    import json
    import subprocess
    code = ("import json, ray_tpu\n"
            "assert not ray_tpu.is_initialized()\n"
            "out = []\n"
            f"for call in {list(_NO_SESSION_CALLS)!r}:\n"
            "    try:\n"
            "        eval(call)(ray_tpu)\n"
            "        out.append(None)\n"
            "    except Exception as e:\n"
            "        out.append(type(e).__name__)\n"
            "print(json.dumps(out))\n")
    ref = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert ref.returncode == 0, ref.stderr
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    assert want == ["RayTpuError"] * 5
    assert not rt.is_initialized()
    assert _error_names(rt) == want
    rt.init(num_cpus=1, num_gpus=0)
    rt.shutdown()
    assert not rt.is_initialized()
    assert _error_names(rt) == want
    rt.shutdown()                      # a second shutdown is a no-op


def test_stale_sessions_are_swept_and_live_ones_kept():
    """`init()` sweeps the session dirs whose driver is gone. A session is
    live while its driver holds the flock on its `driver.pid`, whatever
    pid the file names (a driver in another pid namespace writes a pid
    that names nothing here); a session being born holds the lock from
    before its name can be seen, so another process's sweep (xdist runs
    several) never takes it."""
    import shutil
    import subprocess
    dead = subprocess.run(
        [sys.executable, "-c",
         "import ray_tpu_torch as rt; print(rt._new_session_dir()[0])"],
        capture_output=True, text=True, timeout=60, check=True,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)})
    stale = dead.stdout.strip()
    live, fd = rt._new_session_dir()
    try:
        assert os.path.isdir(stale)
        with open(os.path.join(live, "driver.pid"), "r+") as f:
            assert int(f.read()) == os.getpid()
            f.seek(0)
            f.truncate()
            f.write(str(2 ** 22 + 1))    # above any pid_max: names no process
        rt._gc_stale_sessions()
        assert os.path.isdir(live) and not os.path.exists(stale)
    finally:
        os.close(fd)
        shutil.rmtree(live, ignore_errors=True)
        shutil.rmtree(stale, ignore_errors=True)
