"""Runtime context, copied from `ray_tpu/runtime_context.py` (the port
imports nothing of `ray_tpu`)."""

from __future__ import annotations

from ray_tpu_torch._private import worker as _worker


class RuntimeContext:
    def __init__(self, client):
        self._client = client

    @property
    def is_initialized(self) -> bool:
        return _worker.is_initialized()

    def get_task_id(self) -> str | None:
        if self._client.mode == "worker":
            return self._client.rt.current_task_id()
        return None

    def get_actor_id(self) -> str | None:
        if self._client.mode == "worker":
            return self._client.rt.actor_id
        return None

    def get_worker_id(self) -> str | None:
        if self._client.mode == "worker":
            return self._client.rt.worker_id
        return "driver"

    def get_node_id(self) -> str:
        return "node_local"

    def get_assigned_resources(self) -> dict:
        return {}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_worker.get_client())
