"""Exceptions of the port, copied from `ray_tpu/exceptions.py` (the port
imports nothing of `ray_tpu`)."""


class RayTpuError(Exception):
    """Base class for all framework errors."""


class OverloadedError(RayTpuError):
    """The serving layer shed this request under overload (queue bound
    or block-pool high-water mark) instead of queueing it unboundedly.
    Back off and retry later — the HTTP proxy maps it to 429."""
