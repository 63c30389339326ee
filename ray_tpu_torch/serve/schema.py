"""Declarative Serve config: YAML/dict -> running applications; a copy of
`ray_tpu/serve/schema.py` (the port imports nothing of `ray_tpu`).

Counterpart of the reference's `serve/schema.py`
(ServeDeploySchema/ServeApplicationSchema) + the `serve deploy`/REST
apply path (`dashboard/modules/serve/`): a config names applications by
import path and overrides per-deployment options; applying it is
idempotent reconciliation — the controller rolls replicas toward the new
spec. Schema (YAML or dict)::

    applications:
      - name: text_app
        route_prefix: /text
        import_path: my_module:app        # module attr holding a bound
                                          # Application / BoundDeployment
        deployments:                      # optional per-deployment
          - name: Summarizer              # overrides
            num_replicas: 3
            max_concurrent_queries: 16
            autoscaling_config: {min_replicas: 1, max_replicas: 5}

The reference's CLI (``serve apply -f serve.yaml``) and the dashboard's
REST apply are not ported yet (ROADMAP A14, A13); call `apply_config`.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict


def _load_import_path(path: str):
    """'pkg.module:attr' -> the attribute (reference: common import_path
    convention in serve/schema.py)."""
    module_name, _, attr = path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {path!r} must look like 'module:attribute'")
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def build_app_from_config(app_cfg: Dict[str, Any]):
    """One application entry -> (name, Application, route_prefix)."""
    from ray_tpu_torch.serve.api import Application, BoundDeployment

    name = app_cfg.get("name", "default")
    route_prefix = app_cfg.get("route_prefix", "/")
    app = _load_import_path(app_cfg["import_path"])
    if isinstance(app, BoundDeployment):
        app = Application(app)
    if not isinstance(app, Application):
        raise TypeError(
            f"{app_cfg['import_path']} resolved to {type(app).__name__}, "
            "expected a bound deployment / Application")

    overrides = {d["name"]: d for d in app_cfg.get("deployments", [])}
    if overrides:
        known = {}
        for node in app._collect():
            known[node.name] = node
        unknown = set(overrides) - set(known)
        if unknown:
            raise ValueError(
                f"config overrides unknown deployments {sorted(unknown)} "
                f"(app has {sorted(known)})")
        for dep_name, od in overrides.items():
            node = known[dep_name]
            opts = {k: v for k, v in od.items() if k != "name"}
            node.deployment = node.deployment.options(**opts)
    return name, app, route_prefix


def apply_config(config) -> Dict[str, str]:
    """Apply a declarative config (dict, YAML string, or path to a YAML
    file). Returns {app_name: "deployed"}. Idempotent: re-applying rolls
    deployments toward the new spec (controller reconciliation)."""
    import os

    from ray_tpu_torch.serve import api

    if isinstance(config, str):
        import yaml
        if os.path.exists(config):
            with open(config) as f:
                config = yaml.safe_load(f)
        else:
            config = yaml.safe_load(config)
    if not isinstance(config, dict) or "applications" not in config:
        raise ValueError("config must carry an 'applications' list")

    out = {}
    for app_cfg in config["applications"]:
        name, app, route_prefix = build_app_from_config(app_cfg)
        api.run(app, name=name, route_prefix=route_prefix)
        out[name] = "deployed"
    return out
