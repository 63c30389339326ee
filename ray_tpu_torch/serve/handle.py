"""DeploymentHandle — the RPC path to a deployment's replicas; a copy of
`ray_tpu/serve/handle.py` (the port imports nothing of `ray_tpu`).

Counterpart of the reference's `serve/handle.py` (RayServeHandle) +
`_private/router.py:875` (Router with power-of-two-choices replica
assignment, `_try_assign_replica` :747). The handle keeps a local view of
the replica set (refreshed from the controller, the reference's long-poll
`LongPollClient` :69) and routes each call to the less-loaded of two
random replicas, tracking in-flight counts client-side.

Fault tolerance (see README "Serve fault tolerance"): `call` retries
replica-death failures with capped exponential backoff + jitter under an
optional cross-attempt deadline budget, and `stream` can fail over
mid-stream — on replica loss it resubmits the prompt plus the
already-emitted tokens to a healthy replica as a fresh prefill
(`token_resume`) and splices the continuation, so a greedy decode stream
completes token-identical to an unkilled run.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as _exc

from ray_tpu_torch._private.constants import (
    SERVE_HANDLE_REFRESH_S as _REFRESH_PERIOD_S,
    SERVE_RETRY_BASE_S,
    SERVE_RETRY_CAP_S,
    SERVE_RETRY_MAX_ATTEMPTS,
    SERVE_STREAM_FAILOVERS,
)


class _HandleStats:
    """Process-wide resilience counters for every handle in this process,
    published through the stats->Prometheus bridge as `serve_handle_*`
    series (util/telemetry.py)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._retries = 0
        self._failovers = 0
        from ray_tpu_torch.util import telemetry as _telemetry
        _telemetry.register_stats_source(
            _telemetry.next_name("serve_handle#"), self,
            kind="serve_handle")

    def bump(self, key: str) -> None:
        with self._mu:
            setattr(self, f"_{key}", getattr(self, f"_{key}") + 1)

    def stats(self) -> dict:
        """Resilience counters: ``retries`` is replica-death call
        reattempts, ``failovers`` is mid-stream replica replacements."""
        with self._mu:
            return {"retries": self._retries,
                    "failovers": self._failovers}


HANDLE_STATS = _HandleStats()


def token_resume(args, kwargs, emitted):
    """Default `DeploymentHandle.stream` failover policy for token
    generation: rebuild the submission so a fresh replica prefills
    `prompt + emitted` and decodes only the remainder. Greedy decode over
    replicas with identical weights makes the spliced stream
    token-identical to an unkilled run.

    Returns `(args, kwargs)` for the resubmission, or None when the
    token budget is already exhausted (the stream is simply complete).
    Raises TypeError/ValueError when the stream's chunks are not token
    ids — the caller then re-raises the original replica death, since a
    generic byte stream cannot be replayed safely."""
    if not args:
        raise TypeError("token_resume needs the prompt as args[0]")
    prompt = list(args[0]) + [int(t) for t in emitted]
    if "max_new_tokens" in kwargs:
        remaining = int(kwargs["max_new_tokens"]) - len(emitted)
        if remaining <= 0:
            return None
        return (prompt, *args[1:]), {**kwargs, "max_new_tokens": remaining}
    if len(args) >= 2:
        remaining = int(args[1]) - len(emitted)
        if remaining <= 0:
            return None
        return (prompt, remaining, *args[2:]), kwargs
    return (prompt,), kwargs


class _RouterState:
    """Replica view + client-side load tracking, shared by a handle and
    every option-carrying view derived from it (options() must not fork
    the counters, or power-of-two routing runs on partial loads)."""

    def __init__(self):
        self.replicas: List = []
        # actor_id -> list of outstanding ObjectRefs (pruned at pick)
        self.outstanding: dict = {}
        self.last_refresh = 0.0
        self.lock = threading.Lock()
        # serializes controller round-trips; the router lock above must
        # stay block-free (routing hot path), so the RPC happens here
        self.refresh_lock = threading.Lock()
        self.version = -1


class DeploymentHandle:
    # outstanding refs tracked per replica, capped so a caller that never
    # resolves its ObjectRefs can't grow the per-replica list unboundedly
    _MAX_TRACKED = 64

    def __init__(self, deployment_name: str, app_name: str = "default",
                 multiplexed_model_id: str = "", priority: int | None = None,
                 _router=None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._model_id = multiplexed_model_id
        self._priority = priority
        self._router = _router or _RouterState()

    # delegate routing state to the SHARED router object
    @property
    def _replicas(self):
        return self._router.replicas

    @_replicas.setter
    def _replicas(self, v):
        self._router.replicas = v

    @property
    def _outstanding(self):
        return self._router.outstanding

    @_outstanding.setter
    def _outstanding(self, v):
        self._router.outstanding = v

    @property
    def _last_refresh(self):
        return self._router.last_refresh

    @_last_refresh.setter
    def _last_refresh(self, v):
        self._router.last_refresh = v

    @property
    def _lock(self):
        return self._router.lock

    @property
    def _version(self):
        return self._router.version

    @_version.setter
    def _version(self, v):
        self._router.version = v

    # handles must survive pickling into replicas/proxies (composition)
    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self._model_id,
                 self._priority))

    def options(self, *, multiplexed_model_id: str | None = None,
                priority: int | None = None) -> "DeploymentHandle":
        """Per-call options (reference: handle.options(
        multiplexed_model_id=...) routes to the replica already serving
        that model, serve/multiplex.py; `priority=` stamps a priority
        class on every call made through the view — see
        serve/priority.py). The view SHARES the parent's router state
        (replica cache + load counters)."""
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._model_id,
            priority if priority is not None else self._priority,
            _router=self._router)

    def _controller(self):
        from ray_tpu_torch.serve.controller import get_controller
        return get_controller()

    def _refresh(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last_refresh < _REFRESH_PERIOD_S:
            return
        # Controller RPC under the dedicated (blocking-ok) refresh lock;
        # the router lock only brackets the snapshot and the commit, so
        # routing never stalls behind a slow controller round-trip.
        with self._router.refresh_lock:
            with self._lock:
                if not force and \
                        now - self._last_refresh < _REFRESH_PERIOD_S:
                    return
                known = self._version
            info = ray_tpu_torch.get(
                self._controller().get_replicas.remote(
                    self.deployment_name, self.app_name, known),
                timeout=30)
            with self._lock:
                if info is not None:
                    version, replicas = info
                    self._version = version
                    self._replicas = list(replicas)
                    live_ids = {r._actor_id for r in replicas}
                    self._outstanding = {
                        aid: refs
                        for aid, refs in self._outstanding.items()
                        if aid in live_ids}
                self._last_refresh = now

    def _load(self, actor_id) -> int:
        """In-flight count for one replica: prune completed refs
        (non-blocking wait) and return how many are still outstanding.
        Pruning filters the live list in place rather than overwriting it,
        so refs appended by a concurrent _record are never dropped."""
        with self._lock:
            refs = list(self._outstanding.get(actor_id, ()))
        if not refs:
            return 0
        try:
            ready, _ = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=0, fetch_local=False)
        except Exception:
            ready = []
        done = {r._id for r in ready}
        with self._lock:
            cur = self._outstanding.get(actor_id)
            if cur is None:
                return 0
            cur[:] = [r for r in cur if r._id not in done]
            return len(cur)

    def _record(self, actor_id, ref) -> None:
        """Track an in-flight call so routing sees its load (shared by
        __call__-style and method calls; mutations hold the lock so a
        concurrent _refresh prune can't drop updates)."""
        with self._lock:
            refs = self._outstanding.setdefault(actor_id, [])
            refs.append(ref)
            if len(refs) > self._MAX_TRACKED:
                del refs[:-self._MAX_TRACKED]

    def _pick_replica(self, exclude: frozenset = frozenset()):
        """Power-of-two-choices on client-side in-flight counts
        (reference: router.py _try_assign_replica). `exclude` drops
        replicas known-dead to this caller (mid-stream failover must not
        resubmit to the corpse before the controller notices it)."""
        self._refresh()
        replicas = [r for r in self._replicas
                    if r._actor_id not in exclude]
        if not replicas:
            # cold start (or every replica excluded): block until the
            # deployment has a usable replica
            deadline = time.time() + 60
            while time.time() < deadline:
                self._refresh(force=True)
                replicas = [r for r in self._replicas
                            if r._actor_id not in exclude]
                if replicas:
                    break
                time.sleep(0.1)
            else:
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} has no replicas")
        if len(replicas) == 1:
            return replicas[0]
        if self._model_id:
            # multiplexing: rendezvous (HRW) hash keeps one model id on
            # one stable replica so its LRU cache keeps hitting, with
            # minimal reshuffle when the replica set changes (reference:
            # model-id-aware routing, serve/multiplex.py)
            import hashlib

            def score(r):
                key = f"{self._model_id}:{r._actor_id}".encode()
                return hashlib.md5(key).digest()
            return max(replicas, key=score)
        a, b = random.sample(replicas, 2)
        return a if self._load(a._actor_id) <= self._load(b._actor_id) else b

    def remote(self, *args, **kwargs):
        """-> ObjectRef of the user callable's result."""
        return self.remote_detailed(*args, **kwargs)[0]

    def remote_detailed(self, *args, _exclude: frozenset = frozenset(),
                        **kwargs):
        """-> (ObjectRef, replica_handle). The replica identity lets a
        caller continue a replica-side streaming session (the proxy's
        chunk drain) against the replica that holds the generator."""
        replica = self._pick_replica(_exclude)
        if self._model_id:
            kwargs = {**kwargs,
                      "__multiplexed_model_id__": self._model_id}
        if self._priority is not None:
            kwargs = {**kwargs, "__serve_priority__": self._priority}
        from ray_tpu_torch.util import tracing as _tracing
        with _tracing.span("handle.call",
                           {"deployment": self.deployment_name,
                            "app": self.app_name}):
            # the submit inside nests under this span, so the replica's
            # task.execute span attributes the handle hop
            ref = replica.handle_request.remote(args, kwargs)
        self._record(replica._actor_id, ref)
        return ref, replica

    def stream(self, *args, timeout: Optional[float] = 120.0,
               deadline_s: Optional[float] = None,
               failover=token_resume,
               max_failovers: Optional[int] = None, **kwargs):
        """Python-side streaming consumption: yields chunks of a
        generator/StreamingResponse deployment result.

        Resilience: when the serving replica dies mid-stream and a
        `failover` policy is set (default `token_resume`), the handle
        resubmits `failover(args, kwargs, emitted_chunks)` to a healthy
        replica (the dead one excluded) and splices the continuation —
        up to `max_failovers` times. Chunks the policy can't replay
        (non-token streams) re-raise the original death. On ANY abnormal
        exit — abandoned generator, timeout, error — the replica-side
        stream is cancelled so its generator can't leak until the idle
        TTL. `deadline_s` caps total wall time across failovers."""
        from ray_tpu_torch.exceptions import GetTimeoutError
        from ray_tpu_torch.serve.replica import STREAM_MARKER
        if max_failovers is None:
            max_failovers = SERVE_STREAM_FAILOVERS
        deadline = (time.monotonic() + deadline_s) if deadline_s else None

        def left():
            if deadline is None:
                return timeout
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise GetTimeoutError(
                    f"stream deadline of {deadline_s}s exhausted")
            return rem if timeout is None else min(timeout, rem)

        emitted: list = []
        failovers = 0
        cur_args, cur_kwargs = args, kwargs
        exclude: set = set()
        while True:     # one iteration per (re)submission
            ref, replica = self.remote_detailed(
                *cur_args, _exclude=frozenset(exclude), **cur_kwargs)
            sid = None
            finished = False
            try:
                result = ray_tpu_torch.get(ref, timeout=left())
                if not (isinstance(result, dict)
                        and STREAM_MARKER in result):
                    finished = True
                    yield result
                    return
                sid = result[STREAM_MARKER]
                while True:
                    chunks, done = ray_tpu_torch.get(
                        replica.next_chunks.remote(sid), timeout=left())
                    if chunks is None:
                        raise RuntimeError(
                            f"stream {sid} expired on the replica "
                            "(idle TTL)")
                    for c in chunks:
                        emitted.append(c)
                        yield c
                    if done:
                        finished = True
                        return
            except (_exc.ActorDiedError, _exc.WorkerCrashedError) as death:
                sid = None      # replica gone: nothing left to cancel
                if failover is None or failovers >= max_failovers:
                    raise
                try:
                    resume = failover(args, kwargs, tuple(emitted))
                except (TypeError, ValueError):
                    raise death from None    # chunks aren't replayable
                failovers += 1
                HANDLE_STATS.bump("failovers")
                exclude.add(replica._actor_id)
                self._refresh(force=True)
                if resume is None:
                    return      # budget exhausted at death: complete
                cur_args, cur_kwargs = resume
            finally:
                # leak fix: cancel the replica-side stream on ANY
                # abnormal exit (GeneratorExit from an abandoning
                # caller, timeouts, errors) — not just GeneratorExit
                if sid is not None and not finished:
                    try:
                        replica.cancel_stream.remote(sid)
                    except Exception:
                        pass

    def call(self, *args, timeout: Optional[float] = 60.0,
             deadline_s: Optional[float] = None,
             max_retries: Optional[int] = None, **kwargs):
        """Synchronous convenience: remote + get, with bounded retry.

        Only replica-death failures are retried (the result can never
        materialize; resubmission is the only way forward), with capped
        exponential backoff + jitter between attempts. `deadline_s` is a
        total wall-time budget ACROSS attempts — each retry's get
        timeout and backoff shrink to fit what remains."""
        if max_retries is None:
            max_retries = SERVE_RETRY_MAX_ATTEMPTS
        attempts = max(1, max_retries)
        deadline = (time.monotonic() + deadline_s) if deadline_s else None
        last_err = None
        exclude: set = set()
        for attempt in range(attempts):
            t = timeout
            if deadline is not None:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                t = rem if timeout is None else min(timeout, rem)
            replica = None
            try:
                # exclusion: the router snapshot keeps a corpse listed
                # until the controller's next reconcile — a retry must
                # not land on a replica this caller just saw die
                ref, replica = self.remote_detailed(
                    *args, _exclude=frozenset(exclude), **kwargs)
                return ray_tpu_torch.get(ref, timeout=t)
            except (_exc.ActorDiedError, _exc.WorkerCrashedError) as e:
                last_err = e
                if replica is not None:
                    exclude.add(replica._actor_id)
                if attempt + 1 >= attempts:
                    break
                HANDLE_STATS.bump("retries")
                self._refresh(force=True)
                backoff = min(SERVE_RETRY_CAP_S,
                              SERVE_RETRY_BASE_S * (2 ** attempt))
                backoff *= 0.5 + random.random() / 2    # jitter
                if deadline is not None:
                    backoff = min(backoff,
                                  max(0.0, deadline - time.monotonic()))
                time.sleep(backoff)
        if last_err is None:
            from ray_tpu_torch.exceptions import GetTimeoutError
            raise GetTimeoutError(
                f"call() deadline of {deadline_s}s exhausted")
        raise last_err

    # reference-API sugar: handle.method.remote(...)
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        replica = self._handle._pick_replica()
        if self._handle._model_id:
            kwargs = {**kwargs,
                      "__multiplexed_model_id__": self._handle._model_id}
        if self._handle._priority is not None:
            kwargs = {**kwargs,
                      "__serve_priority__": self._handle._priority}
        ref = replica.handle_method.remote(self._method, args, kwargs)
        self._handle._record(replica._actor_id, ref)
        return ref

    def call(self, *args, timeout: Optional[float] = 60.0, **kwargs):
        return ray_tpu_torch.get(self.remote(*args, **kwargs), timeout=timeout)
