"""Request priority-class propagation for the serve path: a copy of
`ray_tpu/serve/priority.py` (the port imports nothing of `ray_tpu`).

A request's priority class is an int in ``[0, priority_classes)`` —
higher is more important (class ``c+1`` outranks class ``c``). Clients
set it with ``handle.options(priority=2).remote(...)`` (or the
``X-Serve-Priority`` header / ``priority`` query param on the HTTP
proxy); the handle injects it as a reserved ``__serve_priority__``
kwarg, the replica pops it into a ContextVar before invoking user code,
and `InferenceReplica.__call__` reads it back when no explicit
``priority=`` kwarg was given — so the class rides the whole serve path
without threading a parameter through every hop. Deployments can set a
baseline with ``@serve.deployment(default_priority=...)``. Outside the
serve path a caller sets the class with `_set_priority` or passes
``priority=`` itself.

Inside the engine the class drives weighted-share admission ordering
(with aging so low classes never starve), class-ordered shedding, and
block-pressure preemption — see `engine.InferenceEngine`.
"""

from __future__ import annotations

import contextvars

# ContextVar, not threading.local: replica requests run as asyncio tasks
# interleaved on ONE event-loop thread, and each task carries its own
# context (the replica's sync-callable executor propagates it with
# copy_context) — same reasoning as multiplex._MODEL_ID.
_PRIORITY: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_priority", default=0)


def get_request_priority() -> int:
    """The priority class of the request being handled (0 — the lowest
    class — outside a serve request or when the caller didn't set one)."""
    return _PRIORITY.get()


def _set_priority(priority: int) -> None:
    _PRIORITY.set(int(priority))
