"""In-process units of the port's serve control plane against the JAX
package's modules: each case runs the same code on ``ray_tpu.serve`` and
``ray_tpu_torch.serve`` and the results (values, raised class names,
HTTP statuses) must be equal. The batcher and multiplex cases mirror
`tests/test_serve_batching.py`; then `token_resume` and `disagg_resume`,
`Request.json`, `build_app_from_config`, the proxy's route match, its
error mapping, and raw HTTP/1.1 the two proxies answer alike (the port's
on the standard library, the reference's on aiohttp)."""

import importlib
import socket
import threading
import time
import types

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.serve.{name}")


def _run_threads(n, fn):
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def _both(case):
    """The case's result in each package; they must be equal."""
    out = {pkg: case(pkg) for pkg in PKGS}
    assert out["ray_tpu"] == out["ray_tpu_torch"], out
    return out["ray_tpu_torch"]


# ---- @serve.batch ---------------------------------------------------------

def test_batch_full_batch_returns_without_waiting_out_timeout():
    def case(pkg):
        batch = _mod(pkg, "batching").batch

        @batch(max_batch_size=4, batch_wait_timeout_s=5.0)
        def double(xs):
            return [x * 2 for x in xs]

        outs = {}
        t0 = time.monotonic()
        _run_threads(4, lambda i: outs.__setitem__(i, double(i)))
        return [time.monotonic() - t0 < 2.0, outs]
    assert _both(case) == [True, {i: i * 2 for i in range(4)}]


def test_batch_partial_batch_respects_deadline():
    def case(pkg):
        batch = _mod(pkg, "batching").batch

        @batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def ident(xs):
            return list(xs)

        t0 = time.monotonic()
        v = ident(7)
        dt = time.monotonic() - t0
        return [v, 0.15 <= dt < 2.0]
    assert _both(case) == [7, True]


def test_batch_error_propagates_and_thread_survives():
    def case(pkg):
        batch = _mod(pkg, "batching").batch
        calls = []

        @batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def flaky(xs):
            calls.append(len(xs))
            if len(calls) == 1:
                raise RuntimeError("boom")
            return [x + 1 for x in xs]

        errs, oks = [], []

        def one(i):
            try:
                oks.append(flaky(i))
            except RuntimeError as e:
                errs.append(str(e))
        _run_threads(3, one)
        after = flaky(10)
        return [len(errs) >= 1, set(errs) <= {"boom"}, after]
    assert _both(case) == [True, True, 11]


def test_batch_sizes_seen_and_bound_methods():
    def case(pkg):
        batch = _mod(pkg, "batching").batch

        class Model:
            def __init__(self):
                self.sizes = []

            @batch(max_batch_size=3, batch_wait_timeout_s=0.1)
            def run(self, xs):
                self.sizes.append(len(xs))
                return [x * 10 for x in xs]

        m = Model()
        outs = {}
        _run_threads(6, lambda i: outs.__setitem__(i, m.run(i)))
        return [outs, max(m.sizes) <= 3, sum(m.sizes), max(m.sizes) > 1]
    assert _both(case) == [{i: i * 10 for i in range(6)}, True, 6, True]


def test_batch_wrong_result_count_raises_for_callers():
    def case(pkg):
        batch = _mod(pkg, "batching").batch

        @batch(max_batch_size=2, batch_wait_timeout_s=0.05)
        def short(xs):
            return xs[:1]

        errs = []

        def one(i):
            try:
                short(i)
            except ValueError as e:
                errs.append("results for" in str(e))
        _run_threads(2, one)
        return errs
    assert all(_both(case))


# ---- @serve.multiplexed -----------------------------------------------------

def test_multiplex_loaded_once_under_concurrency():
    def case(pkg):
        multiplexed = _mod(pkg, "multiplex").multiplexed
        loads = []

        class Server:
            @multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                loads.append(model_id)
                time.sleep(0.1)
                return f"model:{model_id}"

        srv = Server()
        got = []
        _run_threads(8, lambda i: got.append(srv.get_model("m1")))
        return [loads, got]
    assert _both(case) == [["m1"], ["model:m1"] * 8]


def test_multiplex_distinct_ids_and_lru_eviction_closes():
    def case(pkg):
        multiplexed = _mod(pkg, "multiplex").multiplexed
        closed = []

        class Model:
            def __init__(self, mid):
                self.mid = mid

            def close(self):
                closed.append(self.mid)

        class Server:
            @multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                return Model(model_id)

        srv = Server()
        ids = [srv.get_model(m).mid for m in ("a", "b", "a", "c", "b")]
        return [ids, closed]
    assert _both(case) == [["a", "b", "a", "c", "b"], ["b", "a"]]


def test_multiplex_failed_load_lets_waiter_retry_and_caches_after():
    def case(pkg):
        multiplexed = _mod(pkg, "multiplex").multiplexed
        attempts = []

        class Server:
            @multiplexed
            def get_model(self, model_id):
                attempts.append(model_id)
                if len(attempts) == 1:
                    time.sleep(0.05)
                    raise RuntimeError("load failed")
                return "ok"

        srv = Server()
        results = []

        def call(i):
            try:
                results.append(srv.get_model("x"))
            except RuntimeError:
                results.append("err")
        _run_threads(3, call)
        return [sorted(results), len(attempts), srv.get_model("x"),
                len(attempts)]
    assert _both(case) == [["err", "ok", "ok"], 2, "ok", 2]


def test_multiplexed_model_id_context_var():
    def case(pkg):
        mux = _mod(pkg, "multiplex")
        prio = _mod(pkg, "priority")
        outside = [mux.get_multiplexed_model_id(),
                   prio.get_request_priority()]
        box = {}

        def inside():
            mux._set_model_id("m7")
            prio._set_priority(2)
            box["v"] = [mux.get_multiplexed_model_id(),
                        prio.get_request_priority()]
        import contextvars
        contextvars.copy_context().run(inside)
        return [outside, box["v"], mux.get_multiplexed_model_id()]
    assert _both(case) == [["", 0], ["m7", 2], ""]


# ---- failover policies --------------------------------------------------------

RESUME_CASES = [
    (([5, 9, 3],), {"max_new_tokens": 8}, (1, 2)),
    (([5, 9, 3],), {"max_new_tokens": 2}, (1, 2)),
    (([5, 9, 3], 8), {}, (4,)),
    (([5, 9, 3], 1), {"temperature": 0.0}, (4,)),
    (([5],), {}, (7, 8)),
    ((), {}, ()),
    (([5],), {"max_new_tokens": 4}, ("x",)),
]


@pytest.mark.parametrize("i", range(len(RESUME_CASES)))
def test_token_resume(i):
    args, kwargs, emitted = RESUME_CASES[i]

    def case(pkg):
        fn = _mod(pkg, "handle").token_resume
        try:
            return fn(args, dict(kwargs), emitted)
        except Exception as e:  # noqa: BLE001 — the class is the result
            return type(e).__name__
    _both(case)


def test_disagg_resume():
    desc = {"prompt": [5, 9, 3], "max_new_tokens": 6, "temperature": 0.0,
            "priority": 1, "handoff_id": 3}

    def case(pkg):
        fn = _mod(pkg, "disagg").disagg_resume
        out = [fn((desc,), {}, (4, 5)), fn((desc,), {}, tuple(range(6)))]
        try:
            fn(([1, 2],), {}, ())
        except TypeError as e:
            out.append(type(e).__name__)
        return out
    _both(case)


# ---- the HTTP surface -------------------------------------------------------

@pytest.mark.parametrize("body", [b"", b"null", b'{"a": [1, 2]}', b"7",
                                  b'"s"', b"{bad"])
def test_request_json(body):
    def case(pkg):
        req = _mod(pkg, "http_proxy").Request("POST", "/x", body=body)
        try:
            return req.json()
        except Exception as e:  # noqa: BLE001
            return type(e).__name__
    _both(case)


def test_route_match_is_longest_prefix():
    routes = {"/": ("Root", "a"), "/api": ("Api", "a"),
              "/api/v2": ("V2", "a"), "/apix": ("X", "a")}
    paths = ["/", "/api", "/api/", "/api/v2/x", "/api/v22", "/apix",
             "/apixy", "/other"]

    def case(pkg):
        cls = _mod(pkg, "http_proxy").HTTPProxy
        fake = types.SimpleNamespace(_routes=dict(routes))
        return [cls._match(fake, p) for p in paths]
    _both(case)


def test_error_response_mapping():
    def case(pkg):
        cls = _mod(pkg, "http_proxy").HTTPProxy
        exc = importlib.import_module(f"{pkg}.exceptions")
        out = []
        for e in (exc.OverloadedError("full"), exc.GetTimeoutError("slow"),
                  TimeoutError("t"), RuntimeError("x")):
            r = cls._error_response(object.__new__(cls), e)
            out.append([r.status, r.headers.get("Retry-After")])
        return out
    assert _both(case) == [[429, "1"], [504, None], [504, None],
                           [500, None]]


RAW = [
    b"GET /nothing HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /nothing HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n"
    b"\r\n3\r\nabc\r\n0\r\n\r\n",
    b"GET /nothing HTTP/1.0\r\n\r\n",
    b"GARBAGE\r\n\r\n",
]


@pytest.mark.parametrize("i", range(len(RAW)))
def test_raw_requests_answered_alike(i):
    """The two proxies, constructed in this process with no routes (no
    runtime is needed for a 404), answer the same raw bytes with the same
    status."""
    def case(pkg):
        proxy = _mod(pkg, "http_proxy").HTTPProxy("127.0.0.1", 0)
        try:
            with socket.create_connection(("127.0.0.1", proxy.port),
                                          timeout=10) as s:
                s.sendall(RAW[i])
                data = b""
                while b"\r\n" not in data:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    data += chunk
            return data.split(b"\r\n", 1)[0].split(b" ")[1]
        finally:
            proxy.stop()
    _both(case)


# ---- declarative config -----------------------------------------------------

config_apps = types.SimpleNamespace()


def test_build_app_from_config():
    def case(pkg):
        serve = importlib.import_module(f"{pkg}.serve")

        @serve.deployment(num_replicas=1)
        class Inner:
            def __call__(self, x):
                return x

        @serve.deployment
        class Outer:
            def __init__(self, inner):
                self.inner = inner

        setattr(config_apps, pkg, Outer.bind(Inner.bind()))
        path = f"test_torch_serve_units:config_apps.{pkg}"
        cfg = {"name": "cfg", "route_prefix": "/c", "import_path": path,
               "deployments": [{"name": "Inner", "num_replicas": 3,
                                "max_concurrent_queries": 5}]}
        name, app, prefix = serve.build_app_from_config(cfg)
        nodes = {n.name: n.deployment for n in app._collect()}
        out = [name, prefix, type(app).__name__, sorted(nodes),
               nodes["Inner"].num_replicas,
               nodes["Inner"].max_concurrent_queries,
               nodes["Outer"].num_replicas]
        for bad in ({"import_path": path,
                     "deployments": [{"name": "Nope"}]},
                    {"import_path": "test_torch_serve_units"},
                    {"import_path": "test_torch_serve_units:RAW"}):
            try:
                serve.build_app_from_config(bad)
                out.append(None)
            except Exception as e:  # noqa: BLE001
                out.append(type(e).__name__)
        out.append(build_defaults(serve, path))
        return out
    assert _both(case)[:7] == ["cfg", "/c", "Application",
                               ["Inner", "Outer"], 3, 5, 1]


def build_defaults(serve, path):
    name, _, prefix = serve.build_app_from_config({"import_path": path})
    return [name, prefix]


def test_deployment_options_and_direct_call():
    def case(pkg):
        serve = importlib.import_module(f"{pkg}.serve")

        @serve.deployment(name="D", num_replicas=2, default_priority=1)
        def f(x):
            return x

        g = f.options(num_replicas=4, route_prefix="/g")
        spec = g.to_spec((1,), {"k": 2}, "/g")
        out = [f.name, f.num_replicas, g.num_replicas, g.route_prefix,
               g.default_priority,
               sorted(k for k in spec if k != "callable"),
               spec["init_args"], spec["init_kwargs"]]
        try:
            f(1)
        except RuntimeError as e:
            out.append(type(e).__name__)
        return out
    _both(case)
