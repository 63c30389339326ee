"""ray_tpu_torch.serve — model serving; the port of `ray_tpu/serve`.

Counterpart of the reference's `python/ray/serve/`: controller-reconciled
deployments, replica actors, HTTP ingress, deployment handles with
power-of-two-choices routing, queue-depth autoscaling, request batching,
and `.bind()` model composition, over the port's runtime
(`ray_tpu_torch.init`). Importing it loads no ``torch``: the controller
and the HTTP proxy run in CPU workers that never load it.
"""

from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_deployment_handle,
    proxy_endpoints,
    run,
    run_disagg,
    set_route,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.events import TokenEvent
from ray_tpu_torch.serve.handle import DeploymentHandle, token_resume
from ray_tpu_torch.serve.http_proxy import Request
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.priority import get_request_priority
from ray_tpu_torch.serve.replica import StreamingResponse
from ray_tpu_torch.serve.schema import apply_config, build_app_from_config

__all__ = [
    "deployment", "Deployment", "Application", "run", "start", "status",
    "shutdown", "delete", "set_route", "get_deployment_handle",
    "proxy_endpoints",
    "DeploymentHandle", "batch", "Request", "StreamingResponse",
    "multiplexed", "get_multiplexed_model_id", "get_request_priority",
    "apply_config",
    "build_app_from_config", "OverloadedError", "token_resume",
    "InferenceEngine", "InferenceReplica", "TokenEvent",
    "run_disagg", "DisaggHandle", "PrefillReplica", "DecodeReplica",
    "disagg_resume",
]

# The inference engine pulls in torch; the control plane's workers never
# touch it, so it loads lazily (PEP 562) instead of taxing every import.
_LAZY = {"InferenceEngine": "ray_tpu_torch.serve.engine",
         "InferenceReplica": "ray_tpu_torch.serve.engine",
         "DisaggHandle": "ray_tpu_torch.serve.disagg",
         "PrefillReplica": "ray_tpu_torch.serve.disagg",
         "DecodeReplica": "ray_tpu_torch.serve.disagg",
         "disagg_resume": "ray_tpu_torch.serve.disagg"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
