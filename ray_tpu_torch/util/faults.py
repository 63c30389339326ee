"""Deterministic fault injection for the serve plane: a copy of
`ray_tpu/util/faults.py` (the port imports nothing of `ray_tpu`).

Chaos tests need failures that happen at the *same* place on every run:
"the replica dies on its 21st emitted token", "the 2nd control message
is dropped", "tick 5 stalls for 600ms". This module provides that as a
declarative, picklable `FaultPlan` — a list of specs keyed by *site*
strings that production code consults at its fault points via
`check(site)`:

  * ``engine.tick``   — top of `InferenceEngine.step` (fail/delay;
    a `delay` spec here IS the "tick stall" chaos site — the watchdog
    and per-token latency series see it)
  * ``engine.emit``   — per emitted token (kill = die at step N)
  * ``engine.alloc``  — per admission attempt inside the scheduler
    (fail = simulated allocator exhaustion: the admit is refused as if
    the block pool had no room, driving the preemption path for
    higher-class requests exactly where real block pressure would)
  * ``engine.preempt`` — per scheduler tick (fail = force-preempt the
    lowest-class active stream this tick, real pressure or not)
  * ``netaddr.send`` / ``netaddr.recv`` — channel messages (wrapped onto
    every `ray_tpu_torch._private.netaddr.client()` connection while a
    plan with those sites is active; the disaggregated serving path's
    KV-block pulls ride them)
  * ``replica.health_ping`` — a serve replica's health check (fail = a
    missed ping the controller strikes, kill = the replica dies in it)
  * ``controller.health_ping`` — the serve controller's health-probe
    round (fail = every replica looks unreachable this round)

Determinism: each site carries a visit counter and, for probabilistic
specs, its own `random.Random` seeded from `(plan.seed, site)` — so a
fixed plan replays the identical fire sequence on every install,
independent of wall clock, thread timing, or other sites. Installed
state is process-global (`install`/`clear`); plans pickle cleanly.

When no plan is active `check()` is a single global read — cheap enough
to sit on the engine's per-token path.
"""

from __future__ import annotations

import os
import threading
import time

from ray_tpu_torch.exceptions import RayTpuError

__all__ = [
    "FaultInjected", "FaultPlan", "install", "clear", "active",
    "check", "fired", "maybe_wrap_connection",
]


class FaultInjected(RayTpuError):
    """An injected fault fired (action='fail'). Typed so tests and the
    health plane can tell deliberate chaos from organic failures."""


class _Spec:
    """One declared fault. Fires on visits ``at <= visit < at + times``
    of its site (``times=None`` = forever), or — when ``p`` is set —
    on visits its seeded coin lands heads for."""

    __slots__ = ("site", "action", "at", "times", "p", "delay_s")

    def __init__(self, site: str, action: str, at: int = 0,
                 times: int | None = 1, p: float | None = None,
                 delay_s: float = 0.0):
        if action not in ("fail", "delay", "drop", "kill"):
            raise ValueError(f"unknown fault action {action!r}")
        self.site = site
        self.action = action
        self.at = int(at)
        self.times = times
        self.p = p
        self.delay_s = float(delay_s)

    def matches(self, visit: int, coin) -> bool:
        if self.p is not None:
            # the coin is advanced exactly once per (spec, visit) by the
            # caller; deciding here keeps count-gating composable with it
            return coin < self.p
        if visit < self.at:
            return False
        return self.times is None or visit < self.at + self.times

    def __repr__(self):
        return (f"_Spec({self.site!r}, {self.action!r}, at={self.at}, "
                f"times={self.times}, p={self.p}, "
                f"delay_s={self.delay_s})")


class FaultPlan:
    """A picklable, seeded set of fault specs. Build with the fluent
    helpers (each returns self so plans chain):

        plan = (FaultPlan(seed=7)
                .kill("engine.emit", at=20)
                .delay("netaddr.send", delay_s=0.3, p=0.5))
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.specs: list[_Spec] = []

    def _add(self, *a, **kw) -> "FaultPlan":
        self.specs.append(_Spec(*a, **kw))
        return self

    def fail(self, site: str, at: int = 0, times: int | None = 1,
             p: float | None = None) -> "FaultPlan":
        """Raise FaultInjected at the site."""
        return self._add(site, "fail", at=at, times=times, p=p)

    def delay(self, site: str, delay_s: float, at: int = 0,
              times: int | None = 1, p: float | None = None
              ) -> "FaultPlan":
        """Sleep delay_s at the site before proceeding."""
        return self._add(site, "delay", at=at, times=times, p=p,
                         delay_s=delay_s)

    def drop(self, site: str, at: int = 0, times: int | None = 1,
             p: float | None = None) -> "FaultPlan":
        """Silently discard the message at the site (netaddr sites;
        elsewhere it reads as a no-op skip)."""
        return self._add(site, "drop", at=at, times=times, p=p)

    def kill(self, site: str, at: int = 0, times: int | None = 1,
             p: float | None = None) -> "FaultPlan":
        """os._exit(1) the whole process at the site — the SIGKILL-shaped
        death mid-stream failover is built to survive."""
        return self._add(site, "kill", at=at, times=times, p=p)

    def sites(self) -> frozenset:
        return frozenset(s.site for s in self.specs)

    def __reduce__(self):
        return (_rebuild_plan, (self.seed, [
            (s.site, s.action, s.at, s.times, s.p, s.delay_s)
            for s in self.specs]))


def _rebuild_plan(seed, rows) -> FaultPlan:
    plan = FaultPlan(seed)
    for site, action, at, times, p, delay_s in rows:
        plan._add(site, action, at=at, times=times, p=p, delay_s=delay_s)
    return plan


class _Active:
    """Runtime state of the installed plan: per-site visit counters and
    seeded coins, plus a log of fired events for test assertions."""

    def __init__(self, plan: FaultPlan):
        import random
        self.plan = plan
        self.visits: dict[str, int] = {}
        self.coins = {
            site: random.Random(f"{plan.seed}:{site}")
            for site in plan.sites()}
        self.log: list[tuple[str, int, str]] = []


_lock = threading.Lock()
_active: _Active | None = None


def install(plan: FaultPlan) -> None:
    """Make `plan` the process's active plan (resetting all counters)."""
    global _active
    with _lock:
        _active = _Active(plan)


def clear() -> None:
    global _active
    with _lock:
        _active = None


def active() -> FaultPlan | None:
    st = _active
    return st.plan if st is not None else None


def fired() -> list[tuple[str, int, str]]:
    """(site, visit, action) tuples of every fault that has fired since
    install — the replay-determinism oracle for tests."""
    st = _active
    if st is None:
        return []
    with _lock:
        return list(st.log)


def check(site: str) -> str | None:
    """Consult the active plan at a fault point. Counts one visit of
    `site`; if a spec fires: 'fail' raises FaultInjected, 'delay' sleeps
    then returns, 'kill' exits the process, 'drop' returns "drop" (the
    caller discards its message). Returns None when nothing fired."""
    st = _active
    if st is None:
        return None
    delay_s = 0.0
    verdict: str | None = None
    with _lock:
        if _active is not st:      # cleared/replaced concurrently
            return None
        visit = st.visits.get(site, 0)
        st.visits[site] = visit + 1
        for spec in st.plan.specs:
            if spec.site != site:
                continue
            coin = (st.coins[site].random() if spec.p is not None
                    else None)
            if not spec.matches(visit, coin):
                continue
            st.log.append((site, visit, spec.action))
            if spec.action == "delay":
                delay_s = max(delay_s, spec.delay_s)
            elif verdict is None:
                verdict = spec.action
    # act OUTSIDE the registry lock: the sleep may be long, and 'fail'
    # must not unwind through it
    if delay_s > 0.0:
        time.sleep(delay_s)
    if verdict == "fail":
        raise FaultInjected(f"injected fault at {site!r}")
    if verdict == "kill":
        os._exit(1)
    return verdict


class _FaultyConnection:
    """Proxy over a `multiprocessing.connection.Connection` consulting
    `<label>.send` / `<label>.recv` per message. Drop on send discards
    the payload; drop on recv reads and discards, then keeps waiting —
    both present to the peer exactly as a lost message does."""

    def __init__(self, conn, label: str):
        self._conn = conn
        self._site_send = label + ".send"
        self._site_recv = label + ".recv"

    def send(self, obj):
        if check(self._site_send) != "drop":
            self._conn.send(obj)

    def send_bytes(self, buf, *a, **kw):
        if check(self._site_send) != "drop":
            self._conn.send_bytes(buf, *a, **kw)

    def recv(self):
        while True:
            obj = self._conn.recv()
            if check(self._site_recv) != "drop":
                return obj

    def recv_bytes(self, *a, **kw):
        while True:
            buf = self._conn.recv_bytes(*a, **kw)
            if check(self._site_recv) != "drop":
                return buf

    def recv_bytes_into(self, buf, *a, **kw):
        while True:
            n = self._conn.recv_bytes_into(buf, *a, **kw)
            if check(self._site_recv) != "drop":
                return n

    def __getattr__(self, name):
        # fileno/poll/close/closed/... delegate untouched
        return getattr(self._conn, name)


def maybe_wrap_connection(conn, label: str):
    """Wrap `conn` when the active plan declares `<label>.*` sites;
    otherwise hand it back untouched (the common, zero-overhead case).
    Wrapping is decided at connection time — install the plan before
    dialing."""
    st = _active
    if st is None:
        return conn
    prefix = label + "."
    if any(site.startswith(prefix) for site in st.plan.sites()):
        return _FaultyConnection(conn, label)
    return conn
