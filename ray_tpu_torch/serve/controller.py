"""ServeController — the control plane; a copy of
`ray_tpu/serve/controller.py` over the port's runtime (the port imports
nothing of `ray_tpu`).

Counterpart of the reference's `ServeController`
(`serve/controller.py:82`) with its `DeploymentStateManager`
(`_private/deployment_state.py:2127`): a detached named actor that
reconciles desired deployment specs into replica actors, runs health
checks, and autoscales on queue depth. Replica-set changes are versioned;
handles poll `get_replicas` with their last seen version (the pull
analogue of the reference's long-poll push, `_private/long_poll.py:187`).

Concurrency model: control RPCs (running on the actor's thread pool) only
record desired state under the lock; ALL replica actor creation/teardown
happens on the single reconcile thread, so replica sets cannot be
mutated concurrently and a mid-flight redeploy cannot leak actors.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

import ray_tpu_torch
from ray_tpu_torch import exceptions as _exc

logger = logging.getLogger("ray_tpu_torch.serve")

CONTROLLER_NAME = "SERVE_CONTROLLER"
from ray_tpu_torch._private.constants import (
    SERVE_BREAKER_COOLDOWN_S,
    SERVE_BREAKER_PROBE_S,
    SERVE_BREAKER_THRESHOLD,
    SERVE_BREAKER_WINDOW_S,
    SERVE_DOWNSCALE_DELAY_S,
    SERVE_DRAIN_POLL_S,
    SERVE_DRAIN_TIMEOUT_S,
    SERVE_HEALTH_FAILURE_THRESHOLD,
    SERVE_HEALTH_STARTUP_GRACE_S,
    SERVE_RECONCILE_PERIOD_S as _RECONCILE_PERIOD_S,
    SERVE_STATS_TIMEOUT_S,
)


class _DeploymentState:
    def __init__(self, name: str, app_name: str, spec: dict):
        self.name = name
        self.app_name = app_name
        self.spec = spec
        self.replicas: list = []
        self.version = 0
        self.target_num = spec.get("num_replicas", 1)
        self.autoscaling = spec.get("autoscaling_config")
        self.status = "UPDATING"
        self.message = ""
        # set by deploy_application on redeploy; consumed by reconcile
        self.pending_spec: dict | None = None
        # autoscaling smoothing (reference: autoscaling_policy.py
        # downscale_delay_s): scale down only after sustained low demand.
        self._downscale_candidate_since: float | None = None
        # autoscaler observability: the demand the last reconcile tick
        # computed (None = never scraped) and the error that aborted the
        # last scrape (None = the scrape worked) — surfaced in status()
        # so "never scaled up" is diagnosable from the outside.
        self.last_demand: float | None = None
        self.peak_demand: float = 0.0
        self.last_autoscale_error: str | None = None
        self.autoscale_ticks: int = 0
        # live latency view for SLO-aware admission (http_proxy): the
        # worst replica's TTFT/TPOT p99 from the last stats scrape,
        # None until engine-backed replicas report them.
        self.slo_snapshot: dict | None = None
        # circuit breaker over replica deaths: closed (normal restarts)
        # -> open (quarantine: deaths stop triggering restarts) ->
        # half_open (one probe replica) -> closed on probe survival.
        self.breaker = "closed"
        self.breaker_opened_at = 0.0
        self.death_times: collections.deque = collections.deque(maxlen=64)
        self.probe_id = None
        self.probe_since = 0.0


class ServeController:
    def __init__(self):
        self._deployments: dict = {}      # (app, name) -> _DeploymentState
        self._graveyard: list = []        # replica lists awaiting drain
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        # health plane knobs — instance state (seeded from constants) so
        # configure_fault_tolerance can tune a live controller
        self.health_failure_threshold = SERVE_HEALTH_FAILURE_THRESHOLD
        self.health_startup_grace_s = SERVE_HEALTH_STARTUP_GRACE_S
        self.breaker_threshold = SERVE_BREAKER_THRESHOLD
        self.breaker_window_s = SERVE_BREAKER_WINDOW_S
        self.breaker_cooldown_s = SERVE_BREAKER_COOLDOWN_S
        self.breaker_probe_s = SERVE_BREAKER_PROBE_S
        # per-replica health records (reconcile thread is sole writer)
        self._strikes: dict = {}          # actor_id -> consecutive fails
        self._born: dict = {}             # actor_id -> creation ts
        self._healthy: set = set()        # actor_ids that ever passed
        # fault-tolerance counters (stats() -> Prometheus bridge)
        self._breaker_trips = 0
        self._replicas_restarted = 0
        self._health_check_failures = 0
        from ray_tpu_torch.util import telemetry as _telemetry
        self._telemetry_name = _telemetry.register_stats_source(
            _telemetry.next_name("serve_controller#"), self,
            kind="serve_controller")
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile")
        self._thread.start()

    # -- control RPCs (record desired state only) -------------------------

    def deploy_application(self, app_name: str, deployments: list) -> bool:
        with self._lock:
            new_names = {d["name"] for d in deployments}
            for key in [k for k in self._deployments
                        if k[0] == app_name and k[1] not in new_names]:
                st = self._deployments.pop(key)
                self._graveyard.append(st.replicas)
                st.replicas = []
            for spec in deployments:
                key = (app_name, spec["name"])
                cur = self._deployments.get(key)
                if cur is None:
                    self._deployments[key] = _DeploymentState(
                        spec["name"], app_name, spec)
                else:
                    cur.pending_spec = spec
                    cur.status = "UPDATING"
        return True

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            for key in [k for k in self._deployments if k[0] == app_name]:
                st = self._deployments.pop(key)
                self._graveyard.append(st.replicas)
                st.replicas = []
        return True

    def get_replicas(self, deployment_name: str, app_name: str,
                     known_version: int):
        with self._lock:
            st = self._deployments.get((app_name, deployment_name))
            if st is None:
                return (0, [])
            if st.version == known_version:
                return None
            return (st.version, list(st.replicas))

    def get_routes(self) -> dict:
        """route_prefix -> (deployment, app) for every routed deployment."""
        with self._lock:
            out = {}
            for (app, name), st in self._deployments.items():
                prefix = st.spec.get("route_prefix")
                if prefix:
                    out[prefix] = (name, app)
            return out

    def status(self) -> dict:
        with self._lock:
            return {
                f"{app}:{name}": {
                    "status": st.status,
                    "message": st.message,
                    "replicas": len(st.replicas),
                    "target_replicas": st.target_num,
                    "breaker": st.breaker,
                    "last_demand": st.last_demand,
                    "peak_demand": st.peak_demand,
                    "autoscale_ticks": st.autoscale_ticks,
                    "last_autoscale_error": st.last_autoscale_error,
                }
                for (app, name), st in self._deployments.items()
            }

    @staticmethod
    def _update_slo_snapshot(st: _DeploymentState,
                             replica_stats: list) -> None:
        """Fold one stats scrape into the deployment's live latency view
        (the proxy's SLO-admission input). Worst replica wins — an SLO
        the slowest replica can't meet isn't met, since the router may
        pick any of them."""
        ttft = [s["ttft_ms_p99"] for s in replica_stats
                if isinstance(s.get("ttft_ms_p99"), (int, float))]
        tpot = [s["p99_token_latency_ms"] for s in replica_stats
                if isinstance(s.get("p99_token_latency_ms"),
                              (int, float))]
        if not ttft and not tpot:
            return
        st.slo_snapshot = {
            "ttft_ms_p99": max(ttft) if ttft else 0.0,
            "tpot_ms_p99": max(tpot) if tpot else 0.0,
            "queue_depth": sum(s.get("queue_depth", 0)
                               for s in replica_stats),
            "replicas": len(replica_stats),
        }

    def get_slo_snapshot(self) -> dict:
        """`"app:deployment" -> {ttft_ms_p99, tpot_ms_p99, queue_depth,
        replicas}` for every deployment whose replicas report latency
        histograms (engine-backed ones do). The HTTP proxy caches this
        briefly and admits/sheds per-request SLO targets against it."""
        with self._lock:
            return {f"{app}:{name}": dict(st.slo_snapshot)
                    for (app, name), st in self._deployments.items()
                    if st.slo_snapshot is not None}

    def stats(self) -> dict:
        """Serve-plane fault-tolerance counters, published to /metrics
        through the stats->Prometheus bridge as ``serve_controller_*``
        series (see util/telemetry.py).

        - ``breaker_trips``: circuit-breaker open transitions across all
          deployments (closed->open and half_open->open both count).
        - ``replicas_restarted``: crashed/struck-out replicas replaced
          by reconcile (quarantined deaths are NOT restarted, so they
          don't count).
        - ``health_check_failures``: individual failed health pings,
          including transient strikes that did not kill the replica.
        - ``quarantined``: deployments whose breaker is currently open.
        - ``deployments``: deployments under management.
        """
        with self._lock:
            return {
                "breaker_trips": self._breaker_trips,
                "replicas_restarted": self._replicas_restarted,
                "health_check_failures": self._health_check_failures,
                "quarantined": sum(
                    1 for st in self._deployments.values()
                    if st.breaker == "open"),
                "deployments": len(self._deployments),
            }

    def configure_fault_tolerance(self, **knobs) -> dict:
        """Tune the live health plane (tests shrink windows; the
        RAY_TPU_SERVE_* env constants are read at import time, so a
        per-test override needs this RPC). Accepts any of:
        health_failure_threshold, health_startup_grace_s,
        breaker_threshold, breaker_window_s, breaker_cooldown_s,
        breaker_probe_s. Returns the effective settings."""
        allowed = ("health_failure_threshold", "health_startup_grace_s",
                   "breaker_threshold", "breaker_window_s",
                   "breaker_cooldown_s", "breaker_probe_s")
        for k, v in knobs.items():
            if k not in allowed:
                raise ValueError(f"unknown fault-tolerance knob: {k!r}")
            setattr(self, k, type(getattr(self, k))(v))
        return {k: getattr(self, k) for k in allowed}

    def inject_faults(self, plan) -> bool:
        """Install a `util.faults.FaultPlan` in the CONTROLLER process
        (sites like ``controller.health_ping``); None clears it."""
        from ray_tpu_torch.util import faults
        if plan is None:
            faults.clear()
        else:
            faults.install(plan)
        return True

    def graceful_shutdown(self) -> bool:
        self._shutdown.set()
        # Snapshot-and-clear under the lock, kill outside it:
        # _kill_replicas blocks up to the prepare_shutdown timeout per
        # batch, and status()/route_table() RPCs must not stall behind
        # the teardown (graftlint R004 pins this).
        doomed: list[list] = []
        with self._lock:
            for st in self._deployments.values():
                doomed.append(st.replicas)
                st.replicas = []
            self._deployments.clear()
            doomed.extend(self._graveyard)
            self._graveyard.clear()
        for replicas in doomed:
            self._kill_replicas(replicas)
        return True

    def ping(self) -> bool:
        return True

    # -- reconciliation (sole mutator of replica sets) --------------------

    def _kill_replicas(self, replicas: list) -> None:
        # Best-effort graceful teardown, then kill (reference: replicas
        # get a graceful_shutdown call before force-kill,
        # deployment_state.py).
        pending = []
        for r in replicas:
            try:
                pending.append(r.prepare_shutdown.remote())
            except _exc.RayTpuError:
                pass
        if pending:
            try:
                ray_tpu_torch.wait(pending, num_returns=len(pending),
                                   timeout=5)
            except _exc.RayTpuError:
                pass
        for r in replicas:
            try:
                ray_tpu_torch.kill(r)
            except _exc.RayTpuError:
                pass

    def _drain_replicas(self, replicas: list) -> None:
        """Block until every victim reports zero in-flight requests AND
        zero live response streams (or the drain deadline passes). Only
        called after the shrunk replica set was published, so no new
        work can arrive at a victim while it drains."""
        deadline = time.time() + SERVE_DRAIN_TIMEOUT_S
        remaining = list(replicas)
        while remaining and time.time() < deadline:
            busy = []
            for r in remaining:
                try:
                    s = ray_tpu_torch.get(r.stats.remote(),
                                          timeout=SERVE_STATS_TIMEOUT_S)
                    if s.get("inflight", 0) > 0 or \
                            s.get("streams", 0) > 0:
                        busy.append(r)
                except _exc.RayTpuError:
                    pass   # dead/unreachable — nothing left to drain
            remaining = busy
            if remaining:
                time.sleep(SERVE_DRAIN_POLL_S)
        if remaining:
            logger.warning("%d replica(s) still busy at drain deadline",
                           len(remaining))

    def _make_replica(self, st: _DeploymentState):
        from ray_tpu_torch.serve.replica import Replica
        opts = dict(st.spec.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 0.1)
        opts["max_concurrency"] = st.spec.get("max_concurrent_queries", 8)
        actor_cls = ray_tpu_torch.remote(**opts)(Replica)
        r = actor_cls.remote({
            "callable": st.spec["callable"],
            "init_args": st.spec.get("init_args", ()),
            "init_kwargs": st.spec.get("init_kwargs", {}),
            "deployment_name": st.name,
            "max_concurrent_queries":
                st.spec.get("max_concurrent_queries", 8),
            "default_priority": st.spec.get("default_priority", 0),
        })
        self._born[r._actor_id] = time.time()
        return r

    def _health_check(self, replicas: list) -> tuple[list, list]:
        """Parallel, strike-based health checks.

        Returns ``(alive, deaths)``. A replica only moves to ``deaths``
        when its death is authoritative (the actor table says so:
        ActorDiedError / WorkerCrashedError) or it has failed
        ``health_failure_threshold`` CONSECUTIVE pings — one transient
        blip (GC pause, long engine tick) no longer kills a warm
        replica. Replicas that never passed a ping get a startup grace
        window (``health_startup_grace_s``) during which soft failures
        don't strike; real crashes still count immediately.
        """
        from ray_tpu_torch.util import faults
        now = time.time()
        round_down = False
        try:
            # fault site: the CONTROLLER's probe fan-out fails this round
            # (e.g. a partitioned control plane) — every replica looks
            # unreachable at once; strikes must absorb it.
            faults.check("controller.health_ping")
        except faults.FaultInjected:
            round_down = True
        futs, dead, soft = {}, [], []
        if not round_down:
            for r in replicas:
                try:
                    futs[r.check_health.remote()] = r
                except _exc.RayTpuError:
                    dead.append(r)     # can't even submit: authoritative
        alive = []
        if futs:
            ready, not_ready = ray_tpu_torch.wait(
                list(futs), num_returns=len(futs), timeout=10)
            for fut in ready:
                r = futs[fut]
                try:
                    ray_tpu_torch.get(fut)
                    aid = r._actor_id
                    self._strikes.pop(aid, None)
                    self._healthy.add(aid)
                    alive.append(r)
                except (_exc.ActorDiedError, _exc.WorkerCrashedError):
                    dead.append(r)     # actor table: authoritative
                except _exc.RayTpuError:
                    soft.append(r)     # user check_health raised: strike
            for fut in not_ready:
                soft.append(futs[fut])  # ping timed out: strike
        else:
            soft.extend(replicas)
        for r in soft:
            aid = r._actor_id
            self._health_check_failures += 1
            if aid not in self._healthy and \
                    now - self._born.get(aid, now) < \
                    self.health_startup_grace_s:
                alive.append(r)        # still starting up: probation
                continue
            strikes = self._strikes.get(aid, 0) + 1
            self._strikes[aid] = strikes
            if strikes >= self.health_failure_threshold:
                logger.warning(
                    "replica %s failed %d consecutive health checks",
                    aid, strikes)
                dead.append(r)
            else:
                logger.warning(
                    "replica %s failed health check (strike %d/%d)",
                    aid, strikes, self.health_failure_threshold)
                alive.append(r)
        for r in dead:
            aid = r._actor_id
            self._strikes.pop(aid, None)
            self._born.pop(aid, None)
            self._healthy.discard(aid)
        return alive, dead

    def _trip_breaker(self, st: _DeploymentState, now: float) -> None:
        with self._lock:
            st.breaker = "open"
            st.breaker_opened_at = now
            st.probe_id = None
            st.probe_since = 0.0
            self._breaker_trips += 1
            st.message = (f"circuit breaker open: {len(st.death_times)} "
                          f"replica deaths within {self.breaker_window_s}s")
        logger.warning("deployment %s:%s quarantined (%s)",
                       st.app_name, st.name, st.message)

    def _update_breaker(self, st: _DeploymentState, deaths: list,
                        now: float) -> None:
        """Advance the per-deployment circuit breaker.

        closed: deaths within ``breaker_window_s`` accumulate; at
        ``breaker_threshold`` the breaker opens (replacements stop — a
        crash-looping deployment must not burn the cluster respawning).
        open: after ``breaker_cooldown_s`` move to half_open.
        half_open: reconcile creates exactly ONE probe replica; if it
        stays healthy for ``breaker_probe_s`` the breaker closes and the
        death history clears, if it dies the breaker re-opens.
        """
        probe_died = st.probe_id is not None and any(
            r._actor_id == st.probe_id for r in deaths)
        if st.breaker == "closed":
            recent = [t for t in st.death_times
                      if now - t <= self.breaker_window_s]
            if len(recent) >= self.breaker_threshold:
                self._trip_breaker(st, now)
        elif st.breaker == "open":
            if now - st.breaker_opened_at >= self.breaker_cooldown_s:
                with self._lock:
                    st.breaker = "half_open"
                    st.probe_id = None
                    st.probe_since = 0.0
        elif st.breaker == "half_open":
            if probe_died:
                self._trip_breaker(st, now)
            elif (st.probe_id is not None and st.probe_since
                  and st.probe_id in self._healthy
                  and now - st.probe_since >= self.breaker_probe_s):
                with self._lock:
                    st.breaker = "closed"
                    st.death_times.clear()
                    st.probe_id = None
                    st.probe_since = 0.0
                    st.message = ""
                logger.info("deployment %s:%s breaker closed after "
                            "healthy probe", st.app_name, st.name)

    def _reconcile_one(self, st: _DeploymentState) -> None:
        # adopt a pending redeploy: retire every old replica
        pending = None
        with self._lock:
            if st.pending_spec is not None:
                pending = st.pending_spec
                st.pending_spec = None
        if pending is not None:
            old = st.replicas
            st.spec = pending
            st.target_num = pending.get("num_replicas", 1)
            st.autoscaling = pending.get("autoscaling_config")
            self._kill_replicas(old)
            with self._lock:
                st.replicas = []
                st.version += 1

        alive, deaths = self._health_check(st.replicas)
        changed = len(alive) != len(st.replicas)
        now = time.time()
        if deaths:
            st.death_times.extend(now for _ in deaths)
            # struck-out replicas may still be live processes wedged in a
            # bad state — reap them so they can't linger half-attached
            # (authoritative-dead ones make this a fast no-op)
            self._kill_replicas(deaths)
        self._update_breaker(st, deaths, now)

        replica_stats = None
        if alive:
            # Scrape every deployment, not just autoscaled ones: the
            # stats feed BOTH the autoscaler's demand signal and the
            # SLO-admission latency snapshot the proxy routes against.
            try:
                replica_stats = ray_tpu_torch.get(
                    [r.stats.remote() for r in alive],
                    timeout=SERVE_STATS_TIMEOUT_S)
                self._update_slo_snapshot(st, replica_stats)
            except _exc.RayTpuError as e:
                if st.autoscaling:
                    st.last_autoscale_error = f"{type(e).__name__}: {e}"
        if st.autoscaling and replica_stats:
            # Demand signal is role-aware (disaggregated serving):
            #   "queue_depth" (default) = requests being served +
            #     requests queued behind them — the prefill pool's
            #     signal (queue pressure scales up BEFORE latency
            #     collapses, not after);
            #   "streams" = live response streams + queue — the decode
            #     pool's signal (a decode replica's load is its resident
            #     token streams, which stay open long after the
            #     admitting request returned).
            if st.autoscaling.get("demand_signal") == "streams":
                demand = sum(s.get("streams", 0)
                             + s.get("queue_depth", 0)
                             for s in replica_stats)
            else:
                demand = sum(s["inflight"] + s.get("queue_depth", 0)
                             for s in replica_stats)
            st.last_demand = demand
            st.peak_demand = max(st.peak_demand, demand)
            st.autoscale_ticks += 1
            st.last_autoscale_error = None
            target_per = st.autoscaling.get(
                "target_num_ongoing_requests_per_replica", 1.0)
            desired = int(max(
                st.autoscaling.get("min_replicas", 1),
                min(st.autoscaling.get("max_replicas", 8),
                    -(-demand // max(target_per, 1e-6))
                    or st.autoscaling.get("min_replicas", 1))))
            if desired >= len(alive):
                st.target_num = desired
                st._downscale_candidate_since = None
            else:
                delay = st.autoscaling.get("downscale_delay_s",
                                           SERVE_DOWNSCALE_DELAY_S)
                now = time.time()
                if st._downscale_candidate_since is None:
                    st._downscale_candidate_since = now
                elif now - st._downscale_candidate_since >= delay:
                    st.target_num = desired
                    st._downscale_candidate_since = None

        # breaker gates replacement: open = no new replicas at all
        # (quarantine), half_open = at most one probe beyond survivors
        allow = st.target_num
        if st.breaker == "open":
            allow = len(alive)
        elif st.breaker == "half_open":
            allow = min(st.target_num,
                        len(alive) + (0 if st.probe_id is not None else 1))
        n_created = 0
        while len(alive) < allow:
            r = self._make_replica(st)
            alive.append(r)
            changed = True
            n_created += 1
            if st.breaker == "half_open" and st.probe_id is None:
                with self._lock:
                    st.probe_id = r._actor_id
                    st.probe_since = time.time()
        if deaths and n_created:
            with self._lock:
                self._replicas_restarted += min(len(deaths), n_created)
        if len(alive) > st.target_num:
            if replica_stats and len(replica_stats) == len(alive):
                order = sorted(range(len(alive)),
                               key=lambda i: replica_stats[i]["inflight"])
                alive = [alive[i] for i in order]
            victims = alive[st.target_num:] if replica_stats is None \
                else alive[:len(alive) - st.target_num]
            alive = [r for r in alive if r not in victims]
            changed = True
            # Publish the shrunk replica set BEFORE touching the
            # victims: handles refresh off the bumped version and stop
            # routing to them, then the drain loop waits for their
            # in-flight requests and response streams to finish —
            # scale-down never truncates a token stream.
            with self._lock:
                if self._deployments.get((st.app_name, st.name)) is st:
                    st.replicas = list(alive)
                    st.version += 1
            self._drain_replicas(victims)
            self._kill_replicas(victims)

        with self._lock:
            # a concurrent delete/redeploy moved this state aside: retire
            # whatever we just created instead of leaking it
            if self._deployments.get((st.app_name, st.name)) is not st:
                self._graveyard.append(alive)
                return
            st.replicas = alive
            if changed:
                st.version += 1
            st.status = ("QUARANTINED" if st.breaker == "open"
                         else "RUNNING" if len(alive) == st.target_num
                         else "UPDATING")

    def _reconcile_once(self) -> None:
        with self._lock:
            states = list(self._deployments.values())
            graveyard, self._graveyard = self._graveyard, []
        for replicas in graveyard:
            self._kill_replicas(replicas)
        for st in states:
            try:
                self._reconcile_one(st)
            except Exception:
                logger.exception("reconcile of %s failed", st.name)
        # drop health records for replicas retired by scale-down/redeploy
        # (death-path records are cleaned inline by _health_check)
        with self._lock:
            live = {r._actor_id for s in self._deployments.values()
                    for r in s.replicas}
        for rec in (self._strikes, self._born):
            for aid in [a for a in rec if a not in live]:
                rec.pop(aid, None)
        self._healthy &= live

    def _reconcile_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                self._reconcile_once()
            except Exception:
                logger.exception("reconcile step failed")
            self._shutdown.wait(_RECONCILE_PERIOD_S)


def get_controller():
    """Look up (or lazily create) the controller actor."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except (KeyError, ValueError, _exc.RayTpuError):
        return start_controller()


def start_controller():
    actor_cls = ray_tpu_torch.remote(
        num_cpus=0.1, name=CONTROLLER_NAME, max_concurrency=16,
        lifetime="detached")(ServeController)
    controller = actor_cls.remote()
    ray_tpu_torch.get(controller.ping.remote(), timeout=60)
    return controller
