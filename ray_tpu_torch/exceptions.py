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


# --- the task and actor runtime (`ray_tpu/exceptions.py:14-99`) ---------


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at the `get` callsite.

    Carries the remote traceback text so users see where the failure
    happened, and the original exception as `cause`."""

    def __init__(self, exc_type_name: str, message: str, remote_traceback: str,
                 cause: BaseException | None = None):
        self.exc_type_name = exc_type_name
        self.message = message
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(
            f"{exc_type_name}: {message}\n\n"
            f"--- remote traceback ---\n{remote_traceback}")

    def __reduce__(self):
        # Exception's default reduce would replay only the formatted message;
        # rebuild from the real fields.
        return (TaskError, (self.exc_type_name, self.message,
                            self.remote_traceback, self.cause))

    def as_instanceof_cause(self):
        """Return an exception that is also an instance of the original type,
        so `except OriginalError:` works across the process boundary."""
        if self.cause is not None and isinstance(self.cause, Exception):
            cls = type(self.cause)
            try:
                derived = type(
                    "TaskError_" + cls.__name__, (TaskError, cls), {})
                err = derived.__new__(derived)
                TaskError.__init__(err, self.exc_type_name, self.message,
                                   self.remote_traceback, self.cause)
                return err
            except TypeError:
                pass
        return self


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor is dead (crashed, killed, or out of restarts)."""


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unavailable (restarting)."""


class ObjectLostError(RayTpuError):
    """An object's value could not be found in the store."""


class ObjectFreedError(ObjectLostError):
    """The object was freed by reference counting before this access."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get(..., timeout=)` expired before the object was ready."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before it ran."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing a task/actor runtime environment failed."""


class SchedulingError(RayTpuError):
    """The task can never be scheduled."""
