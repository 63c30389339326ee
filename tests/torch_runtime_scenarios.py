"""One table of runtime scenarios, run against the JAX package's runtime
(`ray_tpu`) and the port's (`ray_tpu_torch`) by
`tests/test_torch_runtime.py`.

Each scenario is a function of the runtime module ``rt`` and of ``acc``,
the names of its accelerator (the reference's ``num_tpus`` / ``"TPU"`` /
``TPU_VISIBLE_CHIPS``, the port's ``num_gpus`` / ``"GPU"`` /
``CUDA_VISIBLE_DEVICES``). It returns plain values (numbers, strings,
lists, dicts): what the calls gave, the class names of what they raised,
resource dicts. Both sessions have 2 CPUs and 2 accelerators (fake: the
scheduler counts them, nothing opens them). The cases mirror
`tests/test_core.py`, `tests/test_actor.py` and
`tests/test_refcounting.py`. Every remote function is defined inside its
scenario, so it pickles by value and no worker imports this file.

Run as a script (``python tests/torch_runtime_scenarios.py OUT``), it runs
the whole table against the JAX package in its own session, pickles
``{name: result}`` (and the session's directory) to OUT, and shuts the
session down.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np

# ``fraction_sees``: whether a task given a fraction of an accelerator
# sees a device. A TPU chip opens in one process only, so the reference
# hands a fraction none; a GPU is shared, so the port hands a fraction
# one card (Ray's rule), the one card the two halves below share.
TPU = {"opt": "num_tpus", "res": "TPU", "env": "TPU_VISIBLE_CHIPS",
       "fraction_sees": ""}
GPU = {"opt": "num_gpus", "res": "GPU", "env": "CUDA_VISIBLE_DEVICES",
       "fraction_sees": "0"}
NUM_CPUS = NUM_ACCELERATORS = 2


def error_name(rt, fn) -> str | None:
    """The class name of what ``fn()`` raises (None if nothing). In the
    port, an error named like one of its exception classes must be an
    instance of that class, and a task's error an instance of TaskError
    and of the cause's class."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is the result
        name = type(e).__name__
        if rt.__name__ == "ray_tpu_torch":
            cls = getattr(rt.exceptions, name, None)
            if isinstance(cls, type):
                assert isinstance(e, cls), (name, type(e).__mro__)
            if name.startswith("TaskError_"):
                assert isinstance(e, rt.exceptions.TaskError)
                assert type(e.cause).__name__ == name[len("TaskError_"):]
        return name
    return None


def _node(rt):
    return rt._worker.get_client().node


def _drop(rt):
    gc.collect()
    rt._worker._drain_decs()


def _freed(rt, oid, timeout=15.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        _drop(rt)
        with _node(rt).lock:
            if oid not in _node(rt).directory:
                return True
        time.sleep(0.05)
    return False


def _present(rt, oid) -> bool:
    with _node(rt).lock:
        return oid in _node(rt).directory


# ---- tasks and objects (tests/test_core.py) -------------------------------

def put_get_roundtrip(rt, acc):
    values = [1, "x", None, {"a": [1, 2]}, (1, 2), b"bytes", 3.5, {1, 2, 3}]
    return [rt.get(rt.put(v)) == v for v in values]


def put_get_numpy_zero_copy(rt, acc):
    arr = np.arange(500_000, dtype=np.float64)
    out = rt.get(rt.put(arr))
    return [bool(np.array_equal(arr, out)), bool(out.flags.writeable)]


def simple_task(rt, acc):
    @rt.remote
    def f(x):
        return x * 2
    return rt.get(f.remote(21))


def task_kwargs_and_defaults(rt, acc):
    @rt.remote
    def f(a, b=10, *, c=100):
        return a + b + c
    return [rt.get(f.remote(1)), rt.get(f.remote(1, b=2, c=3))]


def task_dependency_chain(rt, acc):
    @rt.remote
    def inc(x):
        return x + 1
    ref = inc.remote(0)
    for _ in range(10):
        ref = inc.remote(ref)
    return rt.get(ref)


def task_fanout_fanin(rt, acc):
    @rt.remote
    def sq(x):
        return x * x

    @rt.remote
    def total(*xs):
        return sum(xs)
    return rt.get(total.remote(*[sq.remote(i) for i in range(10)]))


def num_returns(rt, acc):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3
    return rt.get(list(three.remote()))


def error_type_preserved(rt, acc):
    @rt.remote
    def boom():
        raise KeyError("missing")
    ref = boom.remote()
    try:
        rt.get(ref)
        caught = False
    except KeyError:                 # the cause's class catches it
        caught = True
    return [error_name(rt, lambda: rt.get(ref)), caught]


def error_poisons_downstream(rt, acc):
    @rt.remote
    def boom():
        raise ValueError("root cause")

    @rt.remote
    def consume(x):
        return x
    ref = consume.remote(boom.remote())
    try:
        rt.get(ref)
    except ValueError as e:
        return [type(e).__name__, "root cause" in str(e)]
    return None


def large_arg_promoted_to_store(rt, acc):
    payload = np.random.default_rng(0).standard_normal(300_000)

    @rt.remote
    def total(x):
        return float(np.sum(x))
    return rt.get(total.remote(payload)) == float(np.sum(payload))


def nested_task_submission(rt, acc):
    @rt.remote
    def child(x):
        return x + 1

    @rt.remote
    def parent(x):
        return rt.get(child.remote(x)) + 100
    return rt.get(parent.remote(1))


def get_timeout(rt, acc):
    @rt.remote
    def slow():
        time.sleep(2)
        return 1
    ref = slow.remote()
    return error_name(rt, lambda: rt.get(ref, timeout=0.2))


def wait_basic(rt, acc):
    @rt.remote
    def fast():
        return 1

    @rt.remote
    def slow():
        time.sleep(3)
        return 2
    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=2)
    return [ready == [f], not_ready == [s]]


def wait_rejects_duplicates(rt, acc):
    r = rt.put(1)
    return error_name(rt, lambda: rt.wait([r, r]))


def max_retries_on_crash(rt, acc):
    @rt.remote(max_retries=2)
    def flaky(marker_dir):
        marker = os.path.join(marker_dir, "attempted")
        if not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
        return "recovered"
    with tempfile.TemporaryDirectory() as d:
        return rt.get(flaky.remote(d), timeout=60)


def retry_exceptions(rt, acc):
    @rt.remote(max_retries=3, retry_exceptions=True)
    def sometimes(marker_dir):
        n = len(os.listdir(marker_dir))
        open(os.path.join(marker_dir, f"n{n}"), "w").close()
        if n < 2:
            raise RuntimeError("transient")
        return n
    with tempfile.TemporaryDirectory() as d:
        return rt.get(sometimes.remote(d), timeout=60)


def cancel_pending(rt, acc):
    @rt.remote
    def blocked(x):
        return x
    ref = blocked.remote(rt.ObjectRef("obj_never_materializes"))
    return [rt.cancel(ref), error_name(rt, lambda: rt.get(ref, timeout=5))]


def cluster_resources(rt, acc):
    return rt.cluster_resources()


def accelerator_ids(rt, acc):
    @rt.remote(**{acc["opt"]: 1})
    def which():
        return os.environ.get(acc["env"])
    ids_ = rt.get(which.remote(), timeout=120)
    deadline = time.time() + 30
    while (time.time() < deadline and
           rt.available_resources().get(acc["res"]) != NUM_ACCELERATORS):
        time.sleep(0.05)
    return [ids_, rt.available_resources()]


def fractional_accelerator(rt, acc):
    """A fraction of an accelerator is booked as such, and two halves run
    side by side: each sees what ``acc["fraction_sees"]`` names (no chip
    in the reference; in the port, both halves the same one card)."""
    @rt.remote(**{acc["opt"]: 0.5})
    def half(marker_dir, i):
        open(os.path.join(marker_dir, str(i)), "w").close()
        deadline = time.time() + 30
        while len(os.listdir(marker_dir)) < 2 and time.time() < deadline:
            time.sleep(0.01)
        return [os.environ.get(acc["env"], "") == acc["fraction_sees"],
                len(os.listdir(marker_dir))]
    with tempfile.TemporaryDirectory() as d:
        out = rt.get([half.remote(d, i) for i in range(2)], timeout=120)
    deadline = time.time() + 30
    while (time.time() < deadline and
           rt.available_resources().get(acc["res"]) != NUM_ACCELERATORS):
        time.sleep(0.05)
    return [out, rt.available_resources().get(acc["res"])]


def object_ref_future(rt, acc):
    @rt.remote
    def v():
        return 7
    return v.remote().future().result(timeout=30)


# ---- actors (tests/test_actor.py) -----------------------------------------

def _counter(rt, **opts):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.x = start

        def incr(self, n=1):
            self.x += n
            return self.x

        def value(self):
            return self.x

        def crash(self):
            os._exit(1)
    return Counter.options(**opts) if opts else Counter


def actor_basic(rt, acc):
    c = _counter(rt).remote(10)
    return [rt.get(c.incr.remote()), rt.get(c.incr.remote(5)),
            rt.get(c.value.remote())]


def actor_method_ordering(rt, acc):
    c = _counter(rt).remote(0)
    return rt.get([c.incr.remote() for _ in range(20)])


def actor_handle_passed_to_task(rt, acc):
    c = _counter(rt).remote(0)

    @rt.remote
    def bump(counter, n):
        return rt.get(counter.incr.remote(n))
    return rt.get(bump.remote(c, 42))


def named_actor(rt, acc):
    _counter(rt, name="the-counter").remote(5)
    return rt.get(rt.get_actor("the-counter").incr.remote())


def get_actor_missing(rt, acc):
    return error_name(rt, lambda: rt.get_actor("no-such-actor"))


def duplicate_actor_name_rejected(rt, acc):
    _counter(rt, name="dup-name").remote()
    return error_name(rt, lambda: _counter(rt, name="dup-name").remote())


def actor_constructor_error(rt, acc):
    @rt.remote
    class Bad:
        def __init__(self):
            raise RuntimeError("ctor fails")

        def ping(self):
            return "pong"
    b = Bad.remote()
    return error_name(rt, lambda: rt.get(b.ping.remote(), timeout=60))


def actor_death_fails_pending(rt, acc):
    c = _counter(rt).remote(0)
    first = rt.get(c.incr.remote())
    c.crash.remote()
    return [first, error_name(rt, lambda: rt.get(c.value.remote(),
                                                 timeout=60))]


def actor_restart(rt, acc):
    # max_task_retries stays 0: the crashing call is not replayed, the
    # call queued behind it runs on the restarted instance
    c = _counter(rt, max_restarts=2).remote(0)
    first = rt.get(c.incr.remote())
    c.crash.remote()
    return [first, rt.get(c.incr.remote(), timeout=60)]


def kill_actor(rt, acc):
    c = _counter(rt).remote(0)
    first = rt.get(c.incr.remote())
    rt.kill(c)
    return [first, error_name(rt, lambda: rt.get(c.incr.remote(),
                                                 timeout=60))]


def actor_max_concurrency(rt, acc):
    @rt.remote
    class Sleeper:
        def nap(self, t):
            time.sleep(t)
            return t
    s = Sleeper.options(max_concurrency=4).remote()
    t0 = time.time()
    out = rt.get([s.nap.remote(1.0) for _ in range(4)], timeout=60)
    return [out, time.time() - t0 < 3.5]


def method_num_returns(rt, acc):
    @rt.remote
    class Splitter:
        @rt.method(num_returns=2)
        def pair(self):
            return "a", "b"
    return rt.get(list(Splitter.remote().pair.remote()))


def async_actor_overlapping_awaits(rt, acc):
    @rt.remote
    class Signal:
        def __init__(self):
            import asyncio
            self.event = asyncio.Event()

        async def wait(self):
            await self.event.wait()
            return "released"

        async def release(self):
            self.event.set()
            return True
    s = Signal.remote()
    r1 = s.wait.remote()
    time.sleep(0.3)
    r2 = s.release.remote()
    return [rt.get(r2, timeout=30), rt.get(r1, timeout=30)]


def async_actor_default_high_concurrency(rt, acc):
    @rt.remote
    class Napper:
        async def nap(self, i):
            import asyncio
            await asyncio.sleep(0.5)
            return i
    n = Napper.remote()
    t0 = time.time()
    out = rt.get([n.nap.remote(i) for i in range(20)], timeout=60)
    return [sorted(out), time.time() - t0 < 4.0]


def async_actor_semaphore_limit(rt, acc):
    @rt.remote(max_concurrency=2)
    class Two:
        async def nap(self):
            import asyncio
            await asyncio.sleep(0.4)
            return 1
    t = Two.remote()
    rt.get(t.nap.remote(), timeout=60)     # the actor is up
    t0 = time.time()
    out = rt.get([t.nap.remote() for _ in range(6)], timeout=60)
    return [out, time.time() - t0 > 1.0]   # 3 waves of 0.4 s


def async_actor_sync_methods_and_errors(rt, acc):
    @rt.remote
    class Mixed:
        async def boom(self):
            raise ValueError("async boom")

        def plain(self):
            return "sync-ok"
    m = Mixed.remote()
    ref = m.boom.remote()
    try:
        rt.get(ref, timeout=30)
        msg = None
    except Exception as e:  # noqa: BLE001
        msg = "async boom" in str(e)
    return [rt.get(m.plain.remote(), timeout=30),
            error_name(rt, lambda: rt.get(ref, timeout=30)), msg]


def failed_constructor_recycles_pooled_worker(rt, acc):
    @rt.remote(num_cpus=0)
    class Broken:
        def __init__(self):
            raise RuntimeError("nope")

        def ping(self):
            return 1

    @rt.remote(num_cpus=0)
    class Fine:
        def ping(self):
            return 1
    names = []
    for _ in range(6):
        b = Broken.remote()
        names.append(error_name(rt, lambda: rt.get(b.ping.remote(),
                                                   timeout=60)))
    f = Fine.remote()
    out = rt.get(f.ping.remote(), timeout=60)
    rt.kill(f)
    return [names, out]


# ---- reference counting (tests/test_refcounting.py) -----------------------

def put_freed_on_ref_drop(rt, acc):
    arr = np.arange(100_000, dtype=np.float32)   # large -> store-backed
    ref = rt.put(arr)
    oid = ref._id
    same = bool(np.array_equal(rt.get(ref), arr))
    present = _present(rt, oid)
    del ref
    return [same, present, _freed(rt, oid)]


def object_survives_while_held(rt, acc):
    ref = rt.put(np.ones(50_000, np.float32))
    _drop(rt)
    time.sleep(1.0)
    return [_present(rt, ref._id), float(rt.get(ref).sum())]


def task_return_freed_after_drop(rt, acc):
    @rt.remote
    def make():
        return np.zeros(200_000, np.uint8)
    ref = make.remote()
    nbytes = rt.get(ref).nbytes
    oid = ref._id
    del ref
    return [nbytes, _freed(rt, oid)]


def arg_pinned_until_consumer_done(rt, acc):
    @rt.remote
    def slow_consume(arr):
        time.sleep(1.0)
        return float(arr.sum())
    data = rt.put(np.ones(150_000, np.float32))
    oid = data._id
    out = slow_consume.remote(data)
    del data                       # only the queued task references it now
    _drop(rt)
    value = rt.get(out, timeout=60)
    del out
    return [value, _freed(rt, oid)]


def chain_intermediates_freed(rt, acc):
    @rt.remote
    def stage(x):
        return x + np.ones(120_000, np.float32)
    a = stage.remote(np.zeros(120_000, np.float32))
    b = stage.remote(a)
    a_id = a._id
    del a
    return [float(rt.get(b)[0]), _freed(rt, a_id)]


def escaped_ref_never_freed(rt, acc):
    inner = rt.put(np.arange(60_000, dtype=np.int32))
    oid = inner._id
    holder = rt.put({"nested": inner})   # pickles the ObjectRef
    del inner
    _drop(rt)
    time.sleep(1.0)
    out = rt.get(holder)
    return [_present(rt, oid),
            bool(np.array_equal(rt.get(out["nested"]),
                                np.arange(60_000, dtype=np.int32)))]


def worker_held_ref_blocks_free(rt, acc):
    @rt.remote
    class Keeper:
        def __init__(self):
            self.ref = None

        def keep(self, boxed):
            self.ref = boxed["r"]
            return True

        def read(self):
            return float(rt.get(self.ref).sum())
    k = Keeper.remote()
    ref = rt.put(np.ones(80_000, np.float32))
    kept = rt.get(k.keep.remote({"r": ref}))   # nested -> escapes
    del ref
    _drop(rt)
    time.sleep(0.5)
    out = rt.get(k.read.remote(), timeout=60)
    rt.kill(k)
    return [kept, out]


def refcount_bookkeeping_bounded(rt, acc):
    node = _node(rt)
    refs = [rt.put(np.zeros(110_000, np.uint8)) for _ in range(8)]
    oids = [r._id for r in refs]
    rt.get(refs)
    del refs
    freed = [_freed(rt, oid) for oid in oids]
    with node.lock:
        residue = [oid for oid in oids
                   if oid in node.obj_origin or node.ref_holders.get(oid)]
    return [freed, residue]


SCENARIOS = {fn.__name__: fn for fn in (
    put_get_roundtrip, put_get_numpy_zero_copy, simple_task,
    task_kwargs_and_defaults, task_dependency_chain, task_fanout_fanin,
    num_returns, error_type_preserved, error_poisons_downstream,
    large_arg_promoted_to_store, nested_task_submission, get_timeout,
    wait_basic, wait_rejects_duplicates, max_retries_on_crash,
    retry_exceptions, cancel_pending, cluster_resources, accelerator_ids,
    fractional_accelerator, object_ref_future, actor_basic,
    actor_method_ordering, actor_handle_passed_to_task, named_actor,
    get_actor_missing, duplicate_actor_name_rejected,
    actor_constructor_error, actor_death_fails_pending, actor_restart,
    kill_actor, actor_max_concurrency, method_num_returns,
    async_actor_overlapping_awaits, async_actor_default_high_concurrency,
    async_actor_semaphore_limit, async_actor_sync_methods_and_errors,
    failed_constructor_recycles_pooled_worker, put_freed_on_ref_drop,
    object_survives_while_held, task_return_freed_after_drop,
    arg_pinned_until_consumer_done, chain_intermediates_freed,
    escaped_ref_never_freed, worker_held_ref_blocks_free,
    refcount_bookkeeping_bounded)}


def run_one(rt, acc, name):
    """{"value": ...} or {"raised": class name, "message": ...}: a
    scenario that raises is a result too (and must raise alike)."""
    try:
        return {"value": SCENARIOS[name](rt, acc)}
    except Exception as e:  # noqa: BLE001
        return {"raised": type(e).__name__, "message": str(e)[:500]}


def _main(out_path: str) -> None:
    import pickle

    import ray_tpu
    ray_tpu.init(num_cpus=NUM_CPUS, num_tpus=NUM_ACCELERATORS)
    results = {name: run_one(ray_tpu, TPU, name) for name in SCENARIOS}
    results["__session_dir__"] = ray_tpu._worker.get_client().node.session_dir
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, out_path)      # the reader sees a whole file or none
    ray_tpu.shutdown()


if __name__ == "__main__":
    import sys
    _main(sys.argv[1])
