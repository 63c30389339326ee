"""Tables of serve control-plane scenarios, run against the JAX package's
`ray_tpu.serve` and the port's `ray_tpu_torch.serve` by
`tests/test_torch_serve.py` (``PLAIN``: plain callables) and
`tests/test_torch_serve_engine.py` (``ENGINE``: engine-backed
deployments on tiny f32 weights).

Each scenario is a function of the runtime module ``rt`` and of ``side``
(`JAX` or `PORT`: the package's name and the keyword its engine takes
for the CPU). It returns plain values: what the calls gave, the class
names of what they raised, HTTP statuses, headers and bodies. Every
deployment class is defined inside its scenario, so it pickles by value
and no worker imports this file for it. Both packages run with the same
serve knobs (`KNOBS`, set through the constants' environment variables
before the session starts): short reconcile, health and refresh periods.

Run as a script (``python tests/torch_serve_scenarios.py TABLE OUT``), it
runs one table against the JAX package in its own session, pickles
``{name: result}`` to OUT, and shuts the session down.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import importlib
import json
import os
import time
import types

import numpy as np

JAX = {"pkg": "ray_tpu", "dev": {}}
PORT = {"pkg": "ray_tpu_torch", "dev": {"device": "cpu"}}
NUM_CPUS = 4

# The serve knobs of both sessions (`_private/constants.py` of each
# package reads them at import; the workers inherit them).
KNOBS = {
    "RAY_TPU_SERVE_RECONCILE_PERIOD_S": "0.2",
    "RAY_TPU_SERVE_HANDLE_REFRESH_S": "0.5",
    "RAY_TPU_SERVE_DRAIN_TIMEOUT_S": "5",
    "RAY_TPU_SERVE_DRAIN_POLL_S": "0.05",
    "RAY_TPU_SERVE_HEALTH_STARTUP_GRACE_S": "60",
}

# import_path targets of the config scenarios (`serve.apply_config`
# resolves ``module:attribute`` in the driver)
config_apps = types.SimpleNamespace()


def set_driver_knobs(rt) -> None:
    """The driver's handle reads its refresh period at import, possibly
    before `KNOBS` were set in this process: set it as the workers see
    it."""
    handle = importlib.import_module(rt.__name__ + ".serve.handle")
    handle._REFRESH_PERIOD_S = float(
        KNOBS["RAY_TPU_SERVE_HANDLE_REFRESH_S"])


def error_name(fn) -> str | None:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is the result
        return type(e).__name__
    return None


def _serve(rt):
    return importlib.import_module(rt.__name__ + ".serve")


def _controller(rt):
    return importlib.import_module(
        rt.__name__ + ".serve.controller").get_controller()


def _replicas(rt, dep, app):
    _, reps = rt.get(_controller(rt).get_replicas.remote(dep, app, -1),
                     timeout=30)
    return reps


def _cstats(rt) -> dict:
    return rt.get(_controller(rt).stats.remote(), timeout=30)


def _proxy_port(rt) -> int:
    proxy = _serve(rt).start(http_options={"port": 0})
    return rt.get(proxy.ready.remote(), timeout=30)["port"]


def http_call(port, method, path, body=None, headers=None,
              timeout=60.0) -> list:
    """[status, Content-Type, Retry-After, Transfer-Encoding, body]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return [r.status, r.getheader("Content-Type"),
                r.getheader("Retry-After"),
                r.getheader("Transfer-Encoding"), r.read()]
    finally:
        conn.close()


def _until(pred, timeout=30.0, poll=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(poll)
    return pred()


# ---- deploy, compose, call (tests/test_serve.py) ---------------------------

def deploy_and_call(rt, side):
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Doubler:
        def __call__(self, x):
            return x * 2

    h = serve.run(Doubler.bind(), name="t_basic")
    out = [h.call(21), rt.get([h.remote(i) for i in range(10)], timeout=60),
           serve.status()["t_basic:Doubler"]["replicas"]]
    serve.delete("t_basic")
    return out


def composition_handles(rt, side):
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Ingress:
        def __init__(self, doubler):
            self.doubler = doubler

        def __call__(self, x):
            return self.doubler.call(x) + 1

    h = serve.run(Ingress.bind(Doubler.bind()), name="t_comp")
    st = serve.status()
    out = [h.call(10), st["t_comp:Ingress"]["status"],
           st["t_comp:Doubler"]["replicas"],
           st["t_comp:Doubler"]["target_replicas"]]
    serve.delete("t_comp")
    return out


def method_calls_and_function_deployment(rt, side):
    serve = _serve(rt)

    @serve.deployment
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, by):
            self.n += by
            return self.n

        def __call__(self, x):
            return x

    h = serve.run(Counter.bind(), name="t_method")
    out = [h.incr.call(5), h.incr.call(3), rt.get(h.incr.remote(1))]

    @serve.deployment
    def square(x):
        return x * x

    out.append(serve.run(square.bind(), name="t_fn").call(7))
    serve.delete("t_method")
    serve.delete("t_fn")
    return out


def unknown_method_and_user_error(rt, side):
    serve = _serve(rt)

    @serve.deployment
    class Picky:
        def __call__(self, x):
            if x < 0:
                raise ValueError("negative")
            return x

    h = serve.run(Picky.bind(), name="t_err")
    out = [error_name(lambda: h.call(-1)),
           error_name(lambda: h.nope.call(1)),
           error_name(lambda: h._private),
           h.call(4)]
    serve.delete("t_err")
    return out


# ---- HTTP ingress ------------------------------------------------------------

def http_statuses_and_bodies(rt, side):
    serve = _serve(rt)

    @serve.deployment
    class Echo:
        def __call__(self, req):
            kind = req.query.get("kind")
            if kind == "str":
                return "plain text"
            if kind == "bytes":
                return b"\x00\x01raw"
            if kind == "none":
                return None
            if kind == "boom":
                raise RuntimeError("boom")
            return {"path": req.path, "q": req.query, "method": req.method,
                    "body": req.json(),
                    "probe": req.headers.get("X-Probe")}

    serve.run(Echo.bind(), name="t_http")
    port = _proxy_port(rt)
    serve.set_route("/echo", "Echo", "t_http")
    out = [
        http_call(port, "POST", "/echo?a=1&a=2&b=&c=x+y%20z",
                  json.dumps({"hi": 5}), {"X-Probe": "p"}),
        http_call(port, "GET", "/echo/sub/path"),
        http_call(port, "PUT", "/echo?kind=str", b"x"),
        http_call(port, "GET", "/echo?kind=bytes"),
        http_call(port, "GET", "/echo?kind=none"),
        http_call(port, "GET", "/nope"),
        http_call(port, "GET", "/echoless"),
    ]
    boom = http_call(port, "GET", "/echo?kind=boom")
    out.append([boom[0], boom[1], b"boom" in boom[4]])
    serve.delete("t_http")
    return out


def priority_rides_the_serve_path(rt, side):
    serve = _serve(rt)

    @serve.deployment(default_priority=1)
    class WhatClass:
        def __call__(self, req):
            return serve.get_request_priority()

    h = serve.run(WhatClass.bind(), name="t_prio")
    out = [h.call(0), h.options(priority=3).call(0), h.call(0)]
    port = _proxy_port(rt)
    serve.set_route("/prio", "WhatClass", "t_prio")
    out += [http_call(port, "POST", "/prio", b"{}",
                      {"X-Serve-Priority": "2"}),
            http_call(port, "POST", "/prio?priority=4", b"{}"),
            http_call(port, "POST", "/prio?priority=4", b"{}",
                      {"X-Serve-Priority": "0"}),
            http_call(port, "POST", "/prio", b"{}",
                      {"X-Serve-Priority": "nope"})]
    serve.delete("t_prio")
    return out


def streaming_response_http(rt, side):
    serve = _serve(rt)

    @serve.deployment
    class Streamer:
        def __call__(self, req):
            n = int(req.query.get("n", 40))

            def gen():
                for i in range(n):
                    yield f"chunk-{i};"
                    if i % 7 == 0:
                        yield b""            # empty chunks are skipped
            return serve.StreamingResponse(gen(), content_type="text/plain")

    @serve.deployment
    class Plain:
        def __call__(self, req):
            def gen():
                for i in range(5):
                    yield {"i": i}
            return gen()

    serve.run(Streamer.bind(), name="streamapp")
    serve.run(Plain.bind(), name="genapp")
    port = _proxy_port(rt)
    serve.set_route("/stream", "Streamer", "streamapp")
    serve.set_route("/gen", "Plain", "genapp")
    out = [http_call(port, "GET", "/stream"),
           http_call(port, "GET", "/stream?n=0"),
           http_call(port, "GET", "/gen")]
    serve.delete("streamapp")
    serve.delete("genapp")
    return out


def streaming_via_handle(rt, side):
    serve = _serve(rt)

    @serve.deployment
    class Gen:
        def __call__(self, n):
            def producer():
                for i in range(n):
                    yield i * i
            return producer()

        def plain(self, x):
            return x + 1

    serve.run(Gen.bind(), name="genapp2")
    h = serve.get_deployment_handle("Gen", "genapp2")
    out = [list(h.stream(5)), list(h.stream(40)), list(h.stream(0))]
    serve.delete("genapp2")
    return out


def proxy_concurrent_requests(rt, side):
    serve = _serve(rt)

    @serve.deployment(num_replicas=2, max_concurrent_queries=4)
    class Slow:
        def __call__(self, req):
            time.sleep(0.4)
            return "ok"

    serve.run(Slow.bind(), name="slowapp")
    port = _proxy_port(rt)
    serve.set_route("/slow", "Slow", "slowapp")
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(
            lambda _: http_call(port, "GET", "/slow")[::4], range(8)))
    elapsed = time.time() - t0
    serve.delete("slowapp")
    return [results, elapsed < 3.0]


def async_replica_soak(rt, side):
    """Several hundred concurrent slow requests overlap on ONE replica's
    event loop."""
    serve = _serve(rt)

    @serve.deployment(max_concurrent_queries=400)
    class Slow:
        async def __call__(self, i):
            import asyncio
            await asyncio.sleep(1.0)
            return i

    h = serve.run(Slow.bind(), name="t_soak")
    warm = rt.get(h.remote(-1), timeout=60)
    t0 = time.time()
    out = rt.get([h.remote(i) for i in range(300)], timeout=120)
    dt = time.time() - t0
    serve.delete("t_soak")
    return [warm, out == list(range(300)), dt < 20]


# ---- batching, multiplexing, config ------------------------------------------

def batching(rt, side):
    serve = _serve(rt)

    @serve.deployment(max_concurrent_queries=16)
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def handle(self, xs):
            self.sizes.append(len(xs))
            return [x + 100 for x in xs]

        def __call__(self, x):
            return self.handle(x)

        def get_sizes(self):
            return self.sizes

    h = serve.run(Batched.bind(), name="t_batch")
    outs = rt.get([h.remote(i) for i in range(8)], timeout=60)
    sizes = h.get_sizes.call()
    serve.delete("t_batch")
    return [sorted(outs), max(sizes) > 1, max(sizes) <= 4, sum(sizes)]


def multiplexed_routing_and_lru(rt, side):
    serve = _serve(rt)

    class Mux:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return {"id": model_id, "pid": os.getpid(),
                    "stamp": time.time()}

        def __call__(self, x):
            model = self.get_model(serve.get_multiplexed_model_id())
            return {"model": model["id"], "pid": model["pid"],
                    "stamp": model["stamp"], "x": x}

    MuxServer = serve.deployment(num_replicas=2, name="MuxServer")(Mux)
    OneMux = serve.deployment(num_replicas=1, name="OneMux")(Mux)

    h = serve.run(MuxServer.bind(), name="mux")
    r1 = h.options(multiplexed_model_id="m1").call(1)
    r2 = h.options(multiplexed_model_id="m1").call(2)
    plain = h.call(42)
    h1 = serve.run(OneMux.bind(), name="mux1")
    first = {m: h1.options(multiplexed_model_id=m).call(0)
             for m in ("a", "b", "c")}
    again_c = h1.options(multiplexed_model_id="c").call(0)
    again_a = h1.options(multiplexed_model_id="a").call(0)
    serve.delete("mux")
    serve.delete("mux1")
    return [[r1["model"], r2["model"]], r1["pid"] == r2["pid"],
            r1["stamp"] == r2["stamp"], [plain["model"], plain["x"]],
            again_c["stamp"] == first["c"]["stamp"],
            again_a["stamp"] != first["a"]["stamp"]]


def apply_config_dict_and_overrides(rt, side):
    serve = _serve(rt)

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Echo:
        def __init__(self, prefix: str = "echo"):
            self.prefix = prefix

        def __call__(self, x):
            return f"{self.prefix}:{x}"

    config_apps.app = Echo.bind("fromcfg")
    cfg = {"applications": [{
        "name": "cfg_app", "route_prefix": "/cfg",
        "import_path": "torch_serve_scenarios:config_apps.app",
        "deployments": [{"name": "Echo", "num_replicas": 2}]}]}
    out = [serve.apply_config(cfg),
           serve.get_deployment_handle("Echo", "cfg_app").call("hi"),
           serve.status()["cfg_app:Echo"]["target_replicas"]]
    name, app, prefix = serve.build_app_from_config(cfg["applications"][0])
    out.append([name, prefix, type(app).__name__,
                app.root.deployment.num_replicas])
    serve.delete("cfg_app")
    return out


def apply_config_rejects_unknown_deployment(rt, side):
    serve = _serve(rt)

    @serve.deployment
    class Echo:
        def __call__(self, x):
            return x

    config_apps.app = Echo.bind()
    bad = {"applications": [{
        "name": "bad", "import_path": "torch_serve_scenarios:config_apps.app",
        "deployments": [{"name": "Nope", "num_replicas": 2}]}]}
    try:
        serve.apply_config(bad)
        return None
    except ValueError as e:
        return [type(e).__name__, "unknown deployments" in str(e)]


# ---- the control plane: scaling, restarts, redeploys ---------------------------

def autoscaling_up(rt, side):
    serve = _serve(rt)

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_num_ongoing_requests_per_replica": 1,
        "downscale_delay_s": 300})
    class Slow:
        def __call__(self, x):
            time.sleep(1.5)
            return x

    h = serve.run(Slow.bind(), name="t_auto")
    refs = [h.remote(i) for i in range(12)]
    grew = _until(lambda: serve.status()["t_auto:Slow"]
                  ["target_replicas"] >= 2, timeout=8, poll=0.2)
    st = serve.status()["t_auto:Slow"]
    out = [sorted(rt.get(refs, timeout=120)), bool(grew),
           st["autoscale_ticks"] > 0, st["peak_demand"] >= 2,
           st["last_autoscale_error"]]
    serve.delete("t_auto")
    return out


def replica_restart_on_death(rt, side):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Svc:
        def __call__(self, x):
            return x + 1

    h = serve.run(Svc.bind(), name="t_restart")
    first = h.call(1)
    before = _cstats(rt)["replicas_restarted"]
    old = _replicas(rt, "Svc", "t_restart")[0]
    rt.kill(old)
    # the handle retries through the death; the controller replaces it
    got = h.call(5, timeout=30)
    back = _until(lambda: [r._actor_id for r in
                           _replicas(rt, "Svc", "t_restart")]
                  not in ([], [old._actor_id]), timeout=30)
    out = [first, got, bool(back),
           len(_replicas(rt, "Svc", "t_restart")),
           _cstats(rt)["replicas_restarted"] - before,
           serve.status()["t_restart:Svc"]["status"]]
    serve.delete("t_restart")
    return out


def redeploy_updates_code(rt, side):
    serve = _serve(rt)

    @serve.deployment
    class V:
        def __call__(self, x):
            return "v1"

    h = serve.run(V.bind(), name="t_upgrade")
    first = h.call(0)

    @serve.deployment(name="V")
    class V2:
        def __call__(self, x):
            return "v2"

    h2 = serve.run(V2.bind(), name="t_upgrade")

    def v2():
        try:
            return h2.call(0, timeout=10) == "v2"
        except Exception:  # noqa: BLE001 — old replica retired mid-call
            return False
    took = _until(v2, timeout=30, poll=0.2)
    serve.delete("t_upgrade")
    gone = _until(lambda: "t_upgrade:V" not in serve.status(), timeout=10)
    return [first, bool(took), bool(gone)]


def stream_abandon_and_timeout_cancel(rt, side):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Leaky:
        def __call__(self, mode):
            if not isinstance(mode, str):
                mode = mode.json()               # an HTTP Request
            def infinite():
                i = 0
                while True:
                    yield i
                    i += 1

            def stall():
                yield 0
                time.sleep(4)
                yield 1
            return infinite() if mode == "infinite" else stall()

    h = serve.run(Leaky.bind(), name="t_leak")

    def streams():
        return sum(rt.get(r.stats.remote(), timeout=30).get("streams", 0)
                   for r in _replicas(rt, "Leaky", "t_leak"))
    s = h.stream("infinite")
    first = next(s)
    s.close()
    abandoned = _until(lambda: streams() == 0, timeout=10, poll=0.2)
    timed_out = error_name(lambda: list(h.stream("stall", timeout=1.0)))
    after = _until(lambda: streams() == 0, timeout=10, poll=0.2)
    # an HTTP client that walks away mid-stream cancels it too
    port = _proxy_port(rt)
    serve.set_route("/leak", "Leaky", "t_leak")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/leak", body=json.dumps("infinite"))
    r = conn.getresponse()
    head = [r.status, r.getheader("Transfer-Encoding"), r.read(8) != b""]
    conn.close()
    dropped = _until(lambda: streams() == 0, timeout=15, poll=0.2)
    serve.delete("t_leak")
    return [first, bool(abandoned), timed_out, bool(after), head,
            bool(dropped)]


# ---- the health plane (tests/test_serve_chaos.py) --------------------------------

def transient_health_failure(rt, side):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Blip:
        def __init__(self):
            self.pings = 0

        def check_health(self):
            self.pings += 1
            if self.pings == 2:
                raise RuntimeError("transient blip")

        def __call__(self, x):
            return x + 1

    h = serve.run(Blip.bind(), name="t_blip")
    first = h.call(1)
    aid = _replicas(rt, "Blip", "t_blip")[0]._actor_id
    base = _cstats(rt)
    struck = _until(lambda: _cstats(rt)["health_check_failures"]
                    >= base["health_check_failures"] + 1, timeout=30)
    time.sleep(0.6)      # a (wrong) replacement would land now
    survivors = [r._actor_id for r in _replicas(rt, "Blip", "t_blip")]
    out = [first, bool(struck), survivors == [aid], h.call(2),
           _cstats(rt)["replicas_restarted"] - base["replicas_restarted"]]
    serve.delete("t_blip")
    return out


def controller_ping_fault_strikes_not_kills(rt, side):
    serve = _serve(rt)
    faults = importlib.import_module(rt.__name__ + ".util.faults")

    @serve.deployment(num_replicas=1)
    class Ok:
        def __call__(self, x):
            return x

    h = serve.run(Ok.bind(), name="t_round")
    first = h.call(7)
    aid = _replicas(rt, "Ok", "t_round")[0]._actor_id
    c = _controller(rt)
    base = _cstats(rt)
    try:
        rt.get(c.inject_faults.remote(
            faults.FaultPlan().fail("controller.health_ping", at=0,
                                    times=1)), timeout=30)
        fired = _until(lambda: _cstats(rt)["health_check_failures"]
                       >= base["health_check_failures"] + 1, timeout=30)
        time.sleep(0.6)
        same = [r._actor_id for r in _replicas(rt, "Ok", "t_round")] == [aid]
        out = [first, bool(fired), same, h.call(8),
               _cstats(rt)["replicas_restarted"]
               - base["replicas_restarted"]]
    finally:
        rt.get(c.inject_faults.remote(None), timeout=30)
    serve.delete("t_round")
    return out


def replica_ping_fault_site(rt, side):
    """``replica.health_ping``: a plan in the replica's process fails its
    pings; strikes reach the threshold and the controller replaces it."""
    serve = _serve(rt)
    faults = importlib.import_module(rt.__name__ + ".util.faults")

    @serve.deployment(num_replicas=1)
    class Pinged:
        def __call__(self, x):
            return x * 3

    h = serve.run(Pinged.bind(), name="t_rping")
    first = h.call(2)
    old = _replicas(rt, "Pinged", "t_rping")[0]
    c = _controller(rt)
    knobs = rt.get(c.configure_fault_tolerance.remote(
        health_failure_threshold=2, health_startup_grace_s=0.0), timeout=30)
    base = _cstats(rt)
    rt.get(old.install_faults.remote(
        faults.FaultPlan().fail("replica.health_ping", at=0, times=100)),
        timeout=30)
    replaced = _until(lambda: [r._actor_id for r in
                               _replicas(rt, "Pinged", "t_rping")]
                      not in ([], [old._actor_id]), timeout=30)
    st = _cstats(rt)
    rt.get(c.configure_fault_tolerance.remote(
        health_failure_threshold=3, health_startup_grace_s=60.0), timeout=30)
    out = [first, knobs["health_failure_threshold"], bool(replaced),
           st["health_check_failures"] - base["health_check_failures"] >= 2,
           st["replicas_restarted"] - base["replicas_restarted"] >= 1,
           h.call(3, timeout=30),
           error_name(lambda: rt.get(c.configure_fault_tolerance.remote(
               nonsense=1), timeout=30))]
    serve.delete("t_rping")
    return out


def breaker_quarantines_crash_loop(rt, side):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class CrashLoop:
        def __init__(self):
            import os
            import threading
            threading.Timer(0.5, lambda: os._exit(1)).start()

        def __call__(self, x):
            return x

    c = _controller(rt)
    rt.get(c.configure_fault_tolerance.remote(
        breaker_threshold=2, breaker_window_s=60.0,
        breaker_cooldown_s=300.0), timeout=30)
    base = _cstats(rt)
    serve.run(CrashLoop.bind(), name="t_loop")
    opened = _until(lambda: serve.status().get("t_loop:CrashLoop", {})
                    .get("breaker") == "open", timeout=30, poll=0.2)
    st = serve.status()["t_loop:CrashLoop"]
    s1 = _cstats(rt)
    time.sleep(1.0)
    s2 = _cstats(rt)
    rt.get(c.configure_fault_tolerance.remote(
        breaker_threshold=3, breaker_window_s=30.0,
        breaker_cooldown_s=10.0), timeout=30)
    serve.delete("t_loop")
    return [bool(opened), st["status"],
            s1["breaker_trips"] - base["breaker_trips"] >= 1,
            s1["quarantined"],
            s2["replicas_restarted"] == s1["replicas_restarted"]]


def overload_429_and_timeout_504(rt, side):
    serve = _serve(rt)
    exc = importlib.import_module(rt.__name__ + ".exceptions")
    proxy_mod = importlib.import_module(rt.__name__ + ".serve.http_proxy")

    @serve.deployment
    class Full:
        def __call__(self, req):
            raise exc.OverloadedError("synthetic: engine full")

    serve.run(Full.bind(), name="t_shed")
    port = _proxy_port(rt)
    serve.set_route("/full", "Full", "t_shed")
    shed = http_call(port, "GET", "/full")
    resp = proxy_mod.HTTPProxy._error_response(
        object.__new__(proxy_mod.HTTPProxy), exc.GetTimeoutError("slow"))
    other = proxy_mod.HTTPProxy._error_response(
        object.__new__(proxy_mod.HTTPProxy), RuntimeError("x"))
    serve.delete("t_shed")
    return [shed[:4], json.loads(shed[4])["error"], resp.status,
            other.status]


def handle_call_retries_and_deadline(rt, side):
    serve = _serve(rt)
    handle_mod = importlib.import_module(rt.__name__ + ".serve.handle")

    @serve.deployment(num_replicas=2)
    class Svc:
        def __call__(self, x):
            return x * 2

        def sleepy(self, t):
            time.sleep(t)
            return t

    h = serve.run(Svc.bind(), name="t_retry")
    h.call(1)
    before = handle_mod.HANDLE_STATS.stats()["retries"]
    killed = {r._actor_id for r in _replicas(rt, "Svc", "t_retry")}
    for r in _replicas(rt, "Svc", "t_retry"):
        rt.kill(r)
    got = h.call(4, timeout=30)
    retried = handle_mod.HANDLE_STATS.stats()["retries"] > before
    # a method call does not retry: send it once both replacements are
    # the deployment's replicas, through a handle that never saw the dead
    _until(lambda: {r._actor_id for r in _replicas(rt, "Svc", "t_retry")}
           .isdisjoint(killed)
           and len(_replicas(rt, "Svc", "t_retry")) == 2, timeout=30)
    h = serve.get_deployment_handle("Svc", "t_retry")
    timeout_name = error_name(lambda: h.sleepy.call(3, timeout=0.5))
    deadline_name = error_name(lambda: h.call(1, deadline_s=1e-9))
    serve.delete("t_retry")
    return [got, retried, timeout_name, deadline_name]


# ---- engine-backed deployments (tests/test_serve_chaos.py,
# tests/test_serve_disagg.py) -------------------------------------------------

ECFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=128, dtype="float32")
PROMPTS = [[5, 9, 3], [7, 2, 11, 4], [1, 2, 3, 4, 5, 6]]
N_TOK = 40                      # > SERVE_STREAM_BATCH (16)
# one prefill bucket: one prefill program per JAX replica to compile
EKW = {"prefill_buckets": (64,)}


def np_params(cfg_kw: dict, seed: int, peak: float = 8.0) -> dict:
    """f32 weights from a seed with numpy, in the layout of both packages'
    `gpt.init_params`, with the embedding scaled by ``peak`` (peaked
    logits: greedy picks that no ulp of either backend can flip)."""
    rng = np.random.default_rng(seed)
    d, f, L = cfg_kw["d_model"], cfg_kw["d_ff"], cfg_kw["n_layers"]
    v, t = cfg_kw["vocab_size"], cfg_kw["max_seq_len"]

    def norm(shape, fan_in):
        return (rng.standard_normal(shape, np.float32)
                / np.float32(np.sqrt(fan_in)))
    layers = {
        "ln1_scale": np.ones((L, d), np.float32),
        "ln2_scale": np.ones((L, d), np.float32),
        "wq": norm((L, d, d), d), "wk": norm((L, d, d), d),
        "wv": norm((L, d, d), d),
        "wo": norm((L, d, d), d) / np.float32(np.sqrt(2 * L)),
        "w_up": norm((L, d, f), d), "w_gate": norm((L, d, f), d),
        "w_down": norm((L, f, d), f) / np.float32(np.sqrt(2 * L)),
    }
    return {"embed": norm((v, d), 1.0) * np.float32(0.02 * peak),
            "pos_embed": norm((t, d), 1.0) * np.float32(0.01),
            "final_ln_scale": np.ones((d,), np.float32),
            "layers": layers}


def _engine_tree(tree: dict, jax_side: bool):
    if not jax_side:
        return tree
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _peaked(rt, side):
    """A subclass of the package's `InferenceReplica` that swaps
    `np_params` in after construction (the swap is ``params_version``
    1)."""
    base = importlib.import_module(rt.__name__ + ".serve.engine")
    dev, jax_side = dict(side["dev"]), side is JAX

    class Peaked(base.InferenceReplica):
        def __init__(self, cfg_kw, tree, **kw):
            super().__init__(cfg_kw, **kw, **dev)
            self.engine.update_params(_engine_tree(tree, jax_side))

        def update_params(self, new_params, *, draft_params=None):
            return super().update_params(_engine_tree(new_params, jax_side),
                                         draft_params=draft_params)
    return Peaked


_APPS: dict = {}


def _llm_app(rt, side):
    """Three peaked `InferenceReplica`s behind an HTTP ingress that streams
    their tokens as text, deployed once per session."""
    if "llm" not in _APPS:
        serve = _serve(rt)
        LLM = serve.deployment(_peaked(rt, side), name="LLM",
                               num_replicas=3)

        @serve.deployment
        class Ingress:
            def __init__(self, llm):
                self.llm = llm

            def __call__(self, req):
                body = req.json()

                def gen():
                    for t in self.llm.stream(body["prompt"],
                                             body["max_new_tokens"]):
                        yield f"{int(t)} "
                return gen()

        serve.run(Ingress.bind(LLM.bind(ECFG, np_params(ECFG, 0), slots=2,
                                        max_len=64, engine_kwargs=EKW)),
                  name="t_llm")
        _proxy_port(rt)          # the proxy on a free port, then the route
        serve.set_route("/llm", "Ingress", "t_llm")
        _APPS["llm"] = serve.get_deployment_handle("LLM", "t_llm")
        _disagg_app(rt, side)    # its replicas start meanwhile
    return _APPS["llm"]


def _live_stats(rt, dep, app) -> list:
    """Stats of the deployment's replicas that answer (a replica killed a
    moment ago stays listed until the controller's next reconcile)."""
    out = []
    for r in _replicas(rt, dep, app):
        try:
            out.append((r, rt.get(r.stats.remote(), timeout=30)))
        except Exception:  # noqa: BLE001 — dead: not serving anything
            pass
    return out


def _serving(rt, dep, app):
    return [r for r, st in _live_stats(rt, dep, app)
            if st.get("streams", 0) > 0]


def greedy_streams_by_handle(rt, side):
    h = _llm_app(rt, side)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        streams = list(pool.map(lambda p: list(h.stream(list(p), N_TOK)),
                                PROMPTS))
    again = list(h.stream(list(PROMPTS[0]), max_new_tokens=N_TOK))
    return [[[int(t) for t in s] for s in streams],
            [int(t) for t in again] == [int(t) for t in streams[0]],
            sorted({t.params_version for s in streams for t in s})]


def greedy_stream_by_http(rt, side):
    _llm_app(rt, side)
    port = _proxy_port(rt)
    got = http_call(port, "POST", "/llm",
                    json.dumps({"prompt": PROMPTS[1],
                                "max_new_tokens": N_TOK}))
    return [got[:4], [int(t) for t in got[4].split()]]


def midstream_kill_failover(rt, side):
    """The serving replica dies (a plan in its process kills it at its
    next emitted token) after 20 tokens; the stream finishes on another
    replica through `token_resume`, token for token."""
    h = _llm_app(rt, side)
    faults = importlib.import_module(rt.__name__ + ".util.faults")
    handle_mod = importlib.import_module(rt.__name__ + ".serve.handle")
    expected = [int(t) for t in h.stream(list(PROMPTS[0]), N_TOK)]
    before = handle_mod.HANDLE_STATS.stats()["failovers"]
    it = h.stream(list(PROMPTS[0]), N_TOK)
    got = [int(next(it)) for _ in range(20)]
    serving = _serving(rt, "LLM", "t_llm")
    rt.get(serving[0].install_faults.remote(
        faults.FaultPlan(seed=13).kill("engine.emit", at=0)), timeout=30)
    got.extend(int(t) for t in it)
    return [len(serving), got == expected, got,
            handle_mod.HANDLE_STATS.stats()["failovers"] - before]


def double_failover(rt, side):
    """Two kills in one stream (the SERVE_STREAM_FAILOVERS budget): the
    stream still completes token for token."""
    h = _llm_app(rt, side)
    faults = importlib.import_module(rt.__name__ + ".util.faults")
    n_tok = 48
    expected = [int(t) for t in h.stream(list(PROMPTS[2]), n_tok)]
    it = h.stream(list(PROMPTS[2]), n_tok)
    got = [int(next(it)) for _ in range(17)]
    for consumed in (17, 34):
        serving = _serving(rt, "LLM", "t_llm")
        rt.get(serving[0].install_faults.remote(
            faults.FaultPlan(seed=consumed).kill("engine.emit", at=0)),
            timeout=30)
        if consumed == 17:
            got.extend(int(next(it)) for _ in range(17))
    got.extend(int(t) for t in it)
    _serve(rt).delete("t_llm")
    _APPS.pop("llm", None)
    return [got == expected, len(got)]


def update_params_through_handle(rt, side):
    """The flywheel's publish hook: `update_params` through the handle
    swaps one replica's weights (the same weights again, so the replicas
    keep serving alike): its ``params_version`` 1 -> 2, the others keep
    theirs."""
    h = _llm_app(rt, side)
    version = h.update_params.call(np_params(ECFG, 0), timeout=60)
    versions = sorted(st["params_version"]
                      for _, st in _live_stats(rt, "LLM", "t_llm"))
    return [version, versions]


def _disagg_app(rt, side):
    """`run_disagg` 2+1 at the seed's weights, the decode pool
    autoscaling on ``streams``, deployed once per session. Its first
    streams (each replica's first programs) and the local colocated
    reference start at once in the background, so they overlap the
    scenarios before the disaggregated ones."""
    if "dz" not in _APPS:
        eng = importlib.import_module(rt.__name__ + ".serve.engine")
        h = _serve(rt).run_disagg(
            ECFG, name="t_dz", prefill_replicas=2, decode_replicas=1,
            slots=4, max_len=64, seed=0, max_concurrent_queries=16,
            engine_kwargs=EKW,
            decode_autoscaling={
                "min_replicas": 1, "max_replicas": 2,
                "target_num_ongoing_requests_per_replica": 1,
                "downscale_delay_s": 30.0},
            **side["dev"])

        def reference():
            local = eng.InferenceReplica(ECFG, slots=2, max_len=64, seed=0,
                                         engine_kwargs=EKW, **side["dev"])
            return [[int(t) for t in local(list(p), max_new_tokens=8)]
                    for p in PROMPTS]
        def warm():       # one stream at a time: no demand to scale on
            for p in PROMPTS + [[4, 4, 4]]:
                h.generate(list(p), max_new_tokens=2)
        pool = concurrent.futures.ThreadPoolExecutor(2)
        _APPS["dz"] = h
        _APPS["dz_ref"] = (pool.submit(reference), pool.submit(warm))
        pool.shutdown(wait=False)
    return _APPS["dz"]


def run_disagg_parity_and_transfer_stats(rt, side):
    """`run_disagg` against a local colocated replica of the same seed
    (per package: the two packages' seeds make different weights), the
    transfer stats of the decode replicas that imported, an abandoned
    stream released on the decode side."""
    h = _disagg_app(rt, side)
    ref, warm = _APPS["dz_ref"]
    warm.result(timeout=120)
    same = []
    for p, want in zip(PROMPTS, ref.result(timeout=120)):
        got = [int(t) for t in h.generate(list(p), max_new_tokens=8)]
        same.append(got == want and len(got) == 8)
    s = h.stream([4, 4, 4], max_new_tokens=8)
    first = next(s) is not None
    s.close()
    released = _until(lambda: sum(
        st.get("streams", 0)
        for _, st in _live_stats(rt, "decode", "t_dz")) == 0, timeout=10)
    ds = [st for _, st in _live_stats(rt, "decode", "t_dz")
          if st["imports"]]
    ps = [st for _, st in _live_stats(rt, "prefill", "t_dz")]
    return [same, first, bool(released),
            sum(d["imports"] for d in ds) >= 3,
            all(d["kv_pulled_bytes"] > 0 and d["kv_transfer_gbps"] > 0
                and d["handoff_pull_ms_p99"] >= d["handoff_pull_ms_p50"] > 0
                for d in ds),
            sum(d["handoff_fallbacks"] for d in ds),
            sum(p["handoffs"] for p in ps) >= 3,
            sum(p["decode_steps"] for p in ps)]


def prefill_kill_mid_handoff(rt, side):
    """One of the two prefill replicas dies at its next engine tick: the
    handle retries the prefill call on the survivor and every stream
    completes, equal to the first."""
    faults = importlib.import_module(rt.__name__ + ".util.faults")
    handle_mod = importlib.import_module(rt.__name__ + ".serve.handle")
    h = _disagg_app(rt, side)
    expected = [int(t) for t in h.generate([5, 9, 3], max_new_tokens=8)]
    reps = _replicas(rt, "prefill", "t_dz")
    rt.get(reps[0].install_faults.remote(
        faults.FaultPlan(seed=20).kill("engine.tick", at=0)), timeout=30)
    before = handle_mod.HANDLE_STATS.stats()["retries"]
    same, hit = [], False
    for _ in range(20):
        same.append([int(t) for t in h.generate([5, 9, 3],
                                                max_new_tokens=8)]
                    == expected)
        if handle_mod.HANDLE_STATS.stats()["retries"] > before:
            hit = True
            break
    _serve(rt).delete("t_dz")
    _APPS.pop("dz", None)
    _APPS.pop("dz_ref", None)
    return [len(reps), all(same), hit]


def decode_pool_autoscales_on_streams(rt, side):
    """Four concurrent streams against the decode pool, its ticks slowed
    by a ``delay`` plan at ``engine.tick``: the controller decides a
    second decode replica on ``demand_signal: "streams"`` (its decision,
    read from the status, not a replica's arrival), no stream is cut,
    and the prefill pool is left alone."""
    serve = _serve(rt)
    faults = importlib.import_module(rt.__name__ + ".util.faults")
    h = _disagg_app(rt, side)
    for r in _replicas(rt, "decode", "t_dz"):
        rt.get(r.install_faults.remote(faults.FaultPlan().delay(
            "engine.tick", 0.05, at=0, times=None)), timeout=30)

    def one(_):
        return [int(t) for t in h.generate([5, 9, 3], max_new_tokens=56)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(one, i) for i in range(4)]
        decided = _until(lambda: serve.status()["t_dz:decode"]
                         ["target_replicas"] >= 2, timeout=30, poll=0.05)
        outs = [f.result(timeout=120) for f in futs]
    st = serve.status()
    for r in _replicas(rt, "decode", "t_dz"):
        try:
            rt.get(r.install_faults.remote(None), timeout=30)
        except Exception:  # noqa: BLE001 — still starting: no plan there
            pass
    return [bool(decided), st["t_dz:decode"]["peak_demand"] >= 2,
            st["t_dz:decode"]["last_autoscale_error"],
            st["t_dz:prefill"]["target_replicas"],
            [len(o) for o in outs], all(o == outs[0] for o in outs)]


ENGINE = {fn.__name__: fn for fn in (
    greedy_streams_by_handle, greedy_stream_by_http,
    update_params_through_handle, midstream_kill_failover, double_failover,
    run_disagg_parity_and_transfer_stats,
    decode_pool_autoscales_on_streams, prefill_kill_mid_handoff)}


PLAIN = {fn.__name__: fn for fn in (
    deploy_and_call, composition_handles,
    method_calls_and_function_deployment, unknown_method_and_user_error,
    http_statuses_and_bodies, priority_rides_the_serve_path,
    streaming_response_http, streaming_via_handle,
    proxy_concurrent_requests, async_replica_soak, batching,
    multiplexed_routing_and_lru, apply_config_dict_and_overrides,
    apply_config_rejects_unknown_deployment, autoscaling_up,
    replica_restart_on_death, redeploy_updates_code,
    stream_abandon_and_timeout_cancel, transient_health_failure,
    controller_ping_fault_strikes_not_kills, replica_ping_fault_site,
    breaker_quarantines_crash_loop, overload_429_and_timeout_504,
    handle_call_retries_and_deadline)}

TABLES = {"plain": PLAIN, "engine": ENGINE}


class JaxSide:
    """The JAX side of a table: a child process of its own session
    (``start_new_session=True``) that runs the table under one deadline
    and pickles its results before its own slow shutdown; `results`
    waits for them, `close` gives the child a second to finish and then
    kills its process group and removes its shm root.

    The child's sessions live under a shm root of their own
    (``RAY_TPU_SHM_ROOT``): the reference sweeps every session dir of its
    root whose ``driver.pid`` it cannot read, a session being born
    included, so JAX sessions starting at once in one root can remove
    each other's."""

    def __init__(self, table: str, out, deadline_s: float):
        import subprocess
        import sys
        import tempfile
        here = os.path.dirname(os.path.abspath(__file__))
        self.out = str(out)
        self.root = tempfile.mkdtemp(
            prefix="rtps_", dir="/dev/shm" if os.path.isdir("/dev/shm")
            else None)
        env = dict(os.environ, JAX_PLATFORMS="cpu", **KNOBS,
                   RAY_TPU_SHM_ROOT=self.root,
                   PYTHONPATH=os.pathsep.join(
                       [os.path.dirname(here), here]
                       + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        env.pop("XLA_FLAGS", None)
        self.log = open(self.out + ".log", "wb")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "torch_serve_scenarios.py"),
             table, self.out],
            cwd=os.path.dirname(here), env=env, stdout=self.log,
            stderr=subprocess.STDOUT, start_new_session=True)
        self.deadline = time.monotonic() + deadline_s
        self._results = None

    def results(self) -> dict:
        import pickle
        if self._results is None:
            while not os.path.exists(self.out):
                if self.proc.poll() is not None or \
                        time.monotonic() > self.deadline:
                    with open(self.out + ".log", "rb") as f:
                        tail = f.read()[-4000:].decode(errors="replace")
                    raise RuntimeError(
                        "the JAX serve table did not finish "
                        f"(rc {self.proc.poll()}):\n{tail}")
                time.sleep(0.05)
            with open(self.out, "rb") as f:
                self._results = pickle.load(f)
        return self._results

    def close(self) -> None:
        import shutil
        import signal
        import subprocess
        try:
            self.proc.wait(timeout=1.0)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=10)
        self.log.close()
        # the session dir and the killed group's forkserver socket
        shutil.rmtree(self.root, ignore_errors=True)


def run_one(rt, side, table, name):
    """{"value": ...} or {"raised": class name, "message": ...}."""
    try:
        return {"value": TABLES[table][name](rt, side)}
    except Exception as e:  # noqa: BLE001
        return {"raised": type(e).__name__, "message": str(e)[:500]}


def _main(table: str, out_path: str) -> None:
    import pickle
    import sys
    sys.modules.setdefault("torch_serve_scenarios", sys.modules[__name__])
    os.environ.update(KNOBS)
    import ray_tpu
    from ray_tpu import serve
    ray_tpu.init(num_cpus=NUM_CPUS, num_tpus=0)
    set_driver_knobs(ray_tpu)
    results = {name: run_one(ray_tpu, JAX, table, name)
               for name in TABLES[table]}
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, out_path)      # the reader sees a whole file or none
    serve.shutdown()
    ray_tpu.shutdown()


if __name__ == "__main__":
    import sys
    _main(sys.argv[1], sys.argv[2])
