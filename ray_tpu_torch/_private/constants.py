"""The port's tunables, copied from `ray_tpu/_private/constants.py` (the
port imports nothing of `ray_tpu`). Each is defined through
`ray_tpu_torch._private.config.define`: read once at import and
overridable by the same environment variable the reference reads,
``RAY_TPU_<NAME>``."""

from ray_tpu_torch._private.config import define

# --- multi-tenant inference: priority classes + preemption ---

ENGINE_PRIORITY_CLASSES = define(
    "ENGINE_PRIORITY_CLASSES", int, 3,
    "Number of request priority classes the inference engine admits "
    "(0 = lowest .. N-1 = highest). submit(priority=) must be in "
    "range; the admission queue weights, sheds, and preempts by "
    "class.")

ENGINE_PRIORITY_AGING_S = define(
    "ENGINE_PRIORITY_AGING_S", float, 2.0,
    "Admission aging quantum: a pending request older than "
    "(priority_classes - its class) * this jumps the weighted-share "
    "order entirely (FIFO among the escalated), bounding how long a "
    "low class can wait behind sustained high-class load.")

ENGINE_PRIORITY_WEIGHT_BASE = define(
    "ENGINE_PRIORITY_WEIGHT_BASE", float, 4.0,
    "Weighted-share base for class admission: class c gets stride "
    "weight base**c, so each step up the class ladder gets base x the "
    "admission share of the class below while every backlogged class "
    "keeps a nonzero guaranteed share (no starvation even before "
    "aging kicks in).")

# --- the serve control plane (`serve.controller`, `serve.handle`,
# `serve.replica`, `serve.http_proxy`): cadences ---

SERVE_RECONCILE_PERIOD_S = define(
    "SERVE_RECONCILE_PERIOD_S", float, 1.0,
    "Serve controller reconcile loop period (deployment_state.py "
    "analog).")

SERVE_HANDLE_REFRESH_S = define(
    "SERVE_HANDLE_REFRESH_S", float, 2.0,
    "How often a ServeHandle refreshes its replica set from the "
    "controller (long-poll refresh analog).")

SERVE_STREAM_BATCH = define(
    "SERVE_STREAM_BATCH", int, 16,
    "Streaming responses ship this many chunks per proxy round-trip.")

SERVE_STREAM_IDLE_TTL_S = define(
    "SERVE_STREAM_IDLE_TTL_S", float, 300.0,
    "Undrained response streams are reaped after this idle time.")

SERVE_DOWNSCALE_DELAY_S = define(
    "SERVE_DOWNSCALE_DELAY_S", float, 30.0,
    "Default delay before the Serve autoscaler honors a downscale "
    "decision (reference: downscale_delay_s).")

SERVE_STATS_TIMEOUT_S = define(
    "SERVE_STATS_TIMEOUT_S", float, 10.0,
    "Timeout for the controller's replica stats fan-out each "
    "autoscaling tick.")

SERVE_DRAIN_TIMEOUT_S = define(
    "SERVE_DRAIN_TIMEOUT_S", float, 30.0,
    "On scale-down, how long the controller waits for a victim "
    "replica's in-flight requests and response streams to drain "
    "before it is killed anyway.")

SERVE_DRAIN_POLL_S = define(
    "SERVE_DRAIN_POLL_S", float, 0.1,
    "Poll period for the scale-down drain loop's replica stats checks.")

# --- the serve control plane's fault tolerance (health plane, retries,
# breaker) ---

SERVE_HEALTH_FAILURE_THRESHOLD = define(
    "SERVE_HEALTH_FAILURE_THRESHOLD", int, 3,
    "Consecutive failed health pings before the controller declares a "
    "replica dead (an ActorDiedError is authoritative immediately). "
    "Reference: health_check_failure_threshold, deployment_state.py.")

SERVE_HEALTH_STARTUP_GRACE_S = define(
    "SERVE_HEALTH_STARTUP_GRACE_S", float, 60.0,
    "Startup probation: ping failures of a replica that has never yet "
    "passed a health check don't count as strikes for this long after "
    "creation (slow engine construction is not flapping). Real deaths "
    "still replace immediately.")

SERVE_BREAKER_THRESHOLD = define(
    "SERVE_BREAKER_THRESHOLD", int, 3,
    "Replica deaths within SERVE_BREAKER_WINDOW_S that trip a "
    "deployment's circuit breaker from closed to open.")

SERVE_BREAKER_WINDOW_S = define(
    "SERVE_BREAKER_WINDOW_S", float, 30.0,
    "Sliding window over replica deaths for the breaker trip decision.")

SERVE_BREAKER_COOLDOWN_S = define(
    "SERVE_BREAKER_COOLDOWN_S", float, 10.0,
    "How long an open breaker quarantines a deployment (no replica "
    "restarts) before moving to half-open and allowing one probe.")

SERVE_BREAKER_PROBE_S = define(
    "SERVE_BREAKER_PROBE_S", float, 5.0,
    "How long a half-open breaker's single probe replica must stay "
    "healthy before the breaker closes and normal restarts resume.")

SERVE_RETRY_MAX_ATTEMPTS = define(
    "SERVE_RETRY_MAX_ATTEMPTS", int, 3,
    "Default attempt budget for handle-level request retries through "
    "replica death (capped exponential backoff between attempts).")

SERVE_RETRY_BASE_S = define(
    "SERVE_RETRY_BASE_S", float, 0.05,
    "Base delay of the handle retry backoff; attempt n sleeps "
    "min(cap, base * 2**n) with jitter.")

SERVE_RETRY_CAP_S = define(
    "SERVE_RETRY_CAP_S", float, 2.0,
    "Cap on a single handle retry backoff sleep.")

SERVE_STREAM_FAILOVERS = define(
    "SERVE_STREAM_FAILOVERS", int, 2,
    "How many mid-stream failovers one streaming call may ride before "
    "the replica-death error propagates to the consumer.")

SERVE_HTTP_HOST = define(
    "SERVE_HTTP_HOST", str, "127.0.0.1",
    "Default bind host for the Serve HTTP proxy.")

SERVE_HTTP_PORT = define(
    "SERVE_HTTP_PORT", int, 8000,
    "Default port for the Serve HTTP proxy (reference: "
    "serve.start(http_options).")

# --- channels (netaddr): addressing ---

NODE_IP = define(
    "NODE_IP", str, "",
    "Advertised IP of this machine for cross-host dials; empty = "
    "autodetect via the outbound interface (reference: "
    "node_ip_address detection, services.py:1353).")

# --- the task and actor runtime on one machine (`ray_tpu/_private/
# constants.py`'s runtime options; the session, socket and spill names
# are the port's own, so the two packages' sessions never meet) ---

import os as _os
import tempfile as _tempfile

INLINE_OBJECT_MAX_BYTES = define(
    "INLINE_OBJECT_MAX_BYTES", int, 100 * 1024,
    "Objects at most this many serialized bytes ride inline in control "
    "messages instead of the shared-memory store.")

SHM_ROOT = define(
    "SHM_ROOT", str, "/dev/shm" if _os.path.isdir("/dev/shm") else "/tmp",
    "Root for session directories (object arena + sockets); tmpfs.")

SESSION_PREFIX = "ray_tpu_torch_session_"

# the forkserver's socket, inside the session directory
FORKSERVER_SOCKET = "ray_tpu_torch_fs_{pid}.sock"

MAX_WORKERS_CAP = define(
    "MAX_WORKERS_CAP", int, 32,
    "Hard cap on generic (pool) worker processes per node.")

WORKER_REGISTER_TIMEOUT_S = define(
    "WORKER_REGISTER_TIMEOUT_S", float, 60.0,
    "Seconds to wait for a spawned worker to phone home before declaring "
    "startup failure.")

DEFAULT_TASK_NUM_CPUS = define(
    "DEFAULT_TASK_NUM_CPUS", float, 1.0,
    "CPUs a task holds when @remote doesn't say.")

DEFAULT_ACTOR_LIFETIME_CPUS = define(
    "DEFAULT_ACTOR_LIFETIME_CPUS", float, 0.0,
    "CPUs an actor holds for its lifetime when @remote doesn't say.")

BUFFER_ALIGNMENT = define(
    "BUFFER_ALIGNMENT", int, 64,
    "Byte alignment of buffers inside serialized envelopes so zero-copy "
    "numpy views land 64-byte aligned.")

# Env var handed to workers that were allocated GPUs (the reference's
# TPU_VISIBLE_CHIPS); a CPU worker gets it empty, which hides every card.
GPU_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"

OBJECT_SPILL_ROOT = define(
    "TORCH_OBJECT_SPILL_ROOT", str,
    _os.path.join(_tempfile.gettempdir(), "ray_tpu_torch_spill"),
    "Real-disk root for objects that do not fit the shared-memory arena "
    "(or all store-backed objects when the native arena is switched off "
    "with RAY_TPU_DISABLE_NATIVE=1).")

OBJECT_STORE_BYTES = define(
    "OBJECT_STORE_BYTES", int, 0,
    "Shared-memory arena capacity per node. 0 = auto: 20% of system "
    "memory, min 512 MiB (the arena file is sparse, so unused capacity "
    "costs nothing).")

SUBMIT_INLINE_BACKLOG = define(
    "SUBMIT_INLINE_BACKLOG", int, 32,
    "Pending-queue depth beyond which task submission skips its inline "
    "dispatch attempt and becomes a pure enqueue.")

SCHEDULER_DISPATCH_WINDOW = define(
    "SCHEDULER_DISPATCH_WINDOW", int, 64,
    "Max non-dispatchable tasks one schedule pass examines before "
    "leaving the rest queued.")

SCHEDULER_FREED_BATCH = define(
    "SCHEDULER_FREED_BATCH", int, 16,
    "How many queued plain tasks the completion fast path may dispatch "
    "under ONE scheduler-lock acquisition when workers free up.")

FREED_REFS_CAP = define(
    "FREED_REFS_CAP", int, 100_000,
    "Bounded FIFO of freed object ids kept as tombstones so racing "
    "get/wait calls fail fast instead of hanging.")

ARGS_RELEASED_CAP = define(
    "ARGS_RELEASED_CAP", int, 200_000,
    "Bounded FIFO of task ids whose args were already released "
    "(exactly-once guard on the refcount decrement).")

REF_FLUSH_INTERVAL_S = define(
    "REF_FLUSH_INTERVAL_S", float, 0.5,
    "Workers batch ObjectRef hold/release events and flush them to the "
    "node at this cadence.")

WORKER_LOG_REDIRECT = define(
    "WORKER_LOG_REDIRECT", bool, True,
    "Write each worker process's stdout+stderr to its own file under the "
    "session's logs dir instead of inheriting the driver's terminal.")

SUBMIT_WINDOW = define(
    "SUBMIT_WINDOW", int, 1024,
    "Max unacknowledged pipelined submissions per worker channel before "
    "submit blocks waiting for credit.")

SUBMIT_RESYNC_S = define(
    "SUBMIT_RESYNC_S", float, 1.0,
    "With unacked pipelined submissions and no credit progress for this "
    "long, the worker replays its unacked ring.")

# Bound on one write to a worker's channel (SO_SNDTIMEO). A worker that
# reads nothing for this long (stopped, wedged) has its channel closed and
# is treated as dead; no sender waits on it longer.
SEND_TIMEOUT_S = 30.0

# shutdown() waits this long, once for all workers together, for them to
# exit after KillWorker and the closed channels; whatever is still alive
# then is SIGKILLed.
SHUTDOWN_DEADLINE_S = 2.0
