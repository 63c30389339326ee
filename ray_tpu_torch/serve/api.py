"""Public Serve API; a copy of `ray_tpu/serve/api.py` over the port's
runtime (the port imports nothing of `ray_tpu`).

Counterpart of the reference's `serve/api.py` (`@serve.deployment` :242,
`serve.run` :414, `serve.start` :62) and the `.bind()` application graph
(`serve/deployment.py`, `_private/deployment_graph_build.py`): bound
deployments referenced in another deployment's init args are delivered
as DeploymentHandles at replica construction (model composition).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.replica import Sealed


@dataclass
class Application:
    """A bound deployment graph rooted at an ingress deployment."""
    root: "BoundDeployment"

    def _collect(self) -> list:
        seen: dict = {}

        def walk(node: "BoundDeployment"):
            if id(node) in seen:
                return
            for a in list(node.init_args) + list(
                    node.init_kwargs.values()):
                if isinstance(a, BoundDeployment):
                    walk(a)
            seen[id(node)] = node

        walk(self.root)
        return list(seen.values())


class BoundDeployment:
    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs

    @property
    def name(self) -> str:
        return self.deployment.name


class Deployment:
    """The declarative unit (reference: serve/deployment.py Deployment)."""

    def __init__(self, target: Callable, name: str,
                 num_replicas: int = 1,
                 ray_actor_options: Optional[dict] = None,
                 max_concurrent_queries: int = 8,
                 autoscaling_config: Optional[dict] = None,
                 route_prefix: Optional[str] = None,
                 default_priority: int = 0):
        self._target = target
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = dict(ray_actor_options or {})
        self.max_concurrent_queries = max_concurrent_queries
        self.autoscaling_config = autoscaling_config
        self.route_prefix = route_prefix
        self.default_priority = default_priority

    def options(self, **opts) -> "Deployment":
        merged = {
            "name": self.name,
            "num_replicas": self.num_replicas,
            "ray_actor_options": self.ray_actor_options,
            "max_concurrent_queries": self.max_concurrent_queries,
            "autoscaling_config": self.autoscaling_config,
            "route_prefix": self.route_prefix,
            "default_priority": self.default_priority,
        }
        merged.update(opts)
        return Deployment(self._target, **merged)

    def bind(self, *args, **kwargs) -> "BoundDeployment":
        """Returns a graph node: pass it to serve.run as the app root, or
        as an init arg of another bind (it arrives as a handle)."""
        return BoundDeployment(self, args, kwargs)

    def to_spec(self, init_args: tuple, init_kwargs: dict,
                route_prefix: Optional[str]) -> dict:
        return {
            "name": self.name,
            "callable": self._target,
            "init_args": init_args,
            "init_kwargs": init_kwargs,
            "num_replicas": self.num_replicas,
            "ray_actor_options": self.ray_actor_options,
            "max_concurrent_queries": self.max_concurrent_queries,
            "autoscaling_config": self.autoscaling_config,
            "route_prefix": route_prefix,
            "default_priority": self.default_priority,
        }

    def __call__(self, *a, **kw):
        raise RuntimeError(
            "deployments are not called directly; use .bind() + serve.run, "
            "then handle.remote()")


def deployment(target=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               ray_actor_options: Optional[dict] = None,
               max_concurrent_queries: int = 8,
               autoscaling_config: Optional[dict] = None,
               route_prefix: Optional[str] = None,
               default_priority: int = 0):
    """`@serve.deployment` decorator (bare or with options).

    `default_priority` is the priority class stamped on requests that
    don't carry one of their own (serve/priority.py)."""

    def wrap(t):
        return Deployment(t, name or t.__name__,
                          num_replicas=num_replicas,
                          ray_actor_options=ray_actor_options,
                          max_concurrent_queries=max_concurrent_queries,
                          autoscaling_config=autoscaling_config,
                          route_prefix=route_prefix,
                          default_priority=default_priority)

    if target is not None:
        return wrap(target)
    return wrap


# ---------------------------------------------------------------------------
# run / start / shutdown
# ---------------------------------------------------------------------------

def _sealed(spec: dict) -> dict:
    """The spec as the controller gets it: the callable and its init
    arguments sealed (`replica.Sealed`), the rest as it is."""
    spec = dict(spec)
    spec["callable"] = Sealed((spec["callable"], spec.pop("init_args"),
                               spec.pop("init_kwargs")))
    return spec


_http_proxy = None


def run(app: Application, *, name: str = "default",
        route_prefix: str = "/", _blocking: bool = False
        ) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment
    (reference: serve.run, api.py:414)."""
    from ray_tpu_torch.serve.controller import get_controller
    if isinstance(app, BoundDeployment):
        app = Application(app)
    controller = get_controller()

    nodes = app._collect()
    specs = []
    for node in nodes:
        # bound-deployment init args become handles (composition)
        init_args = tuple(
            DeploymentHandle(a.name, name) if isinstance(a, BoundDeployment)
            else a for a in node.init_args)
        init_kwargs = {
            k: (DeploymentHandle(v.name, name)
                if isinstance(v, BoundDeployment) else v)
            for k, v in node.init_kwargs.items()}
        prefix = route_prefix if node is app.root else \
            node.deployment.route_prefix
        specs.append(_sealed(node.deployment.to_spec(init_args, init_kwargs,
                                                     prefix)))

    ray_tpu_torch.get(controller.deploy_application.remote(name, specs),
                      timeout=120)
    handle = DeploymentHandle(app.root.name, name)
    # wait for the ingress to be live
    handle._pick_replica()
    return handle


def run_disagg(cfg_kwargs: Optional[dict] = None, *,
               name: str = "default",
               prefill_replicas: int = 1, decode_replicas: int = 1,
               slots: int = 4, max_len: int = 64, seed: int = 0,
               engine_kwargs: Optional[dict] = None,
               prefill_autoscaling: Optional[dict] = None,
               decode_autoscaling: Optional[dict] = None,
               max_concurrent_queries: int = 8,
               ray_actor_options: Optional[dict] = None,
               device=None):
    """Deploy a disaggregated prefill/decode inference fleet: one
    `PrefillReplica` pool (chunked prefill + KV-block export) and one
    `DecodeReplica` pool (KV import + token streaming), paired behind a
    `DisaggHandle` — `handle.stream(prompt, n)` is greedy token-identical
    to a colocated `InferenceReplica` deployment of the same seed.

    The two pools autoscale independently on their own demand signals
    (see `ServeController`): prefill on queue depth (prompts waiting to
    be absorbed), decode on stream occupancy (live token streams) — pass
    `prefill_autoscaling` / `decode_autoscaling` dicts to enable; each
    gets the role's natural `demand_signal` unless overridden.

    The port's own: ``ray_actor_options`` (e.g. ``{"num_gpus": 0.5}``)
    places both pools' replicas, and ``device`` reaches their engines
    (the replicas build on the card unless it names another device)."""
    from ray_tpu_torch.serve.controller import get_controller
    from ray_tpu_torch.serve.disagg import (
        DecodeReplica,
        DisaggHandle,
        PrefillReplica,
    )
    if prefill_autoscaling is not None:
        prefill_autoscaling = {"demand_signal": "queue_depth",
                               **prefill_autoscaling}
    if decode_autoscaling is not None:
        decode_autoscaling = {"demand_signal": "streams",
                              **decode_autoscaling}
    init_kwargs = {"slots": slots, "max_len": max_len, "seed": seed,
                   "engine_kwargs": engine_kwargs}
    if device is not None:
        init_kwargs["device"] = str(device)
    specs = [_sealed(s) for s in (
        Deployment(PrefillReplica, "prefill",
                   num_replicas=prefill_replicas,
                   ray_actor_options=ray_actor_options,
                   max_concurrent_queries=max_concurrent_queries,
                   autoscaling_config=prefill_autoscaling).to_spec(
            (cfg_kwargs,), init_kwargs, None),
        Deployment(DecodeReplica, "decode",
                   num_replicas=decode_replicas,
                   ray_actor_options=ray_actor_options,
                   max_concurrent_queries=max_concurrent_queries,
                   autoscaling_config=decode_autoscaling).to_spec(
            (cfg_kwargs,), init_kwargs, None))]
    controller = get_controller()
    ray_tpu_torch.get(controller.deploy_application.remote(name, specs),
                      timeout=120)
    prefill = DeploymentHandle("prefill", name)
    decode = DeploymentHandle("decode", name)
    prefill._pick_replica()      # block until both pools are live
    decode._pick_replica()
    return DisaggHandle(prefill, decode)


def start(*, http_options: Optional[dict] = None):
    """Start HTTP ingress (reference: serve.start, api.py:62): one proxy
    actor on this machine ("HeadOnly"). The reference's
    ``http_options={"location": "EveryNode"}`` runs one proxy on every
    node of a cluster, which needs the remote nodes the port has not yet
    and raises `NotImplementedError` (ROADMAP A5 (a2))."""
    global _http_proxy
    from ray_tpu_torch.serve.controller import get_controller
    from ray_tpu_torch.serve.http_proxy import HTTPProxy
    opts = dict(http_options or {})
    if opts.get("location", "HeadOnly") != "HeadOnly":
        raise NotImplementedError(
            f"http_options location {opts['location']!r} needs remote "
            "nodes, which the port has not yet (ROADMAP A5 (a2))")
    get_controller()
    from ray_tpu_torch._private.constants import (SERVE_HTTP_HOST,
                                                  SERVE_HTTP_PORT)
    host = opts.get("host", SERVE_HTTP_HOST)
    port = opts.get("port", SERVE_HTTP_PORT)
    if _http_proxy is None:
        actor_cls = ray_tpu_torch.remote(
            num_cpus=0.1, max_concurrency=32,
            name="SERVE_HTTP_PROXY")(HTTPProxy)
        _http_proxy = actor_cls.remote(host, port)
        ray_tpu_torch.get(_http_proxy.ready.remote(), timeout=60)
    return _http_proxy


def proxy_endpoints() -> dict:
    """{node_id: {"host", "port"}} for every running proxy (the list a
    load balancer would front): here the one proxy, under ``"head"``."""
    out = {}
    if _http_proxy is not None:
        out["head"] = ray_tpu_torch.get(_http_proxy.ready.remote(),
                                        timeout=30)
    return out


def set_route(route_prefix: str, deployment_name: str,
              app_name: str = "default"):
    """Register an HTTP route on every running proxy."""
    proxy = start()
    ray_tpu_torch.get(proxy.set_route.remote(route_prefix, deployment_name,
                                             app_name), timeout=30)


def status() -> dict:
    from ray_tpu_torch.serve.controller import get_controller
    return ray_tpu_torch.get(get_controller().status.remote(), timeout=30)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def delete(name: str = "default"):
    from ray_tpu_torch.serve.controller import get_controller
    ray_tpu_torch.get(get_controller().delete_application.remote(name),
                      timeout=60)


def shutdown():
    global _http_proxy
    from ray_tpu_torch import exceptions as _exc
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    if _http_proxy is not None:
        try:
            ray_tpu_torch.get(_http_proxy.stop.remote(), timeout=10)
            ray_tpu_torch.kill(_http_proxy)
        except _exc.RayTpuError:
            pass
        _http_proxy = None
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=60)
        ray_tpu_torch.kill(controller)
    except (KeyError, ValueError, _exc.RayTpuError):
        pass
