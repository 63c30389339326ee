"""Exceptions of the port, copied from `ray_tpu/exceptions.py` (the port
imports nothing of `ray_tpu`)."""


class RayTpuError(Exception):
    """Base class for all framework errors."""


class OverloadedError(RayTpuError):
    """The serving layer shed this request under overload (queue bound
    or block-pool high-water mark) instead of queueing it unboundedly.
    Back off and retry later — the HTTP proxy maps it to 429."""


class MeshDivergenceError(RayTpuError):
    """The ranks of an engine's mesh disagree on a tick's scheduler state
    or a step's host inputs (the port's own: one process per rank runs
    the same scheduler, where the reference is one controller). Raised on
    every rank at the same collective, naming the fields that differ."""
