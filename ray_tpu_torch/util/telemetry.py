"""Runtime telemetry of the port: the counterpart of the compile-once
watch in `ray_tpu/util/telemetry.py` (`RetraceSentinel`, `next_name`).

The serving engine builds each static-shaped step once (a CUDA graph
captured at first use on the card; the port's counterpart of one jit
trace) and counts the builds under the reference's trace counters. The
sentinel holds those counters to their allowances at run time.

Left out against the reference: the `util.metrics` counter that
`check` bumps (the metrics layer is not ported) and the lint registry
that ``registered=True`` looks a path up in; here it looks in
`RETRACE_WATCHES`, the port's own inventory of compile-once paths.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time

logger = logging.getLogger(__name__)

# The compile-once paths of the port's serving engine (its trace
# counters, without the ``_traces`` suffix).
RETRACE_WATCHES = ("decode", "prefill", "verify", "draft", "draft_prefill",
                   "quantize", "kv_gather", "kv_scatter")

_lock = threading.Lock()
_ids: dict = {}


def next_name(kind: str) -> str:
    """Process-unique instance name per kind: engine0, engine1, ..."""
    with _lock:
        counter = _ids.setdefault(kind, itertools.count())
        return f"{kind}{next(counter)}"


class RetraceSentinel:
    """Runtime watcher over compile-once trace counters.

    Two watch flavors: a `cap` watch is armed from construction with a
    hard allowance (decode must build exactly once, ever); a dynamic
    watch (cap=None) has no allowance until `arm()` snapshots its current
    count as the baseline, the shape for bucket-dependent paths like
    chunked prefill, where "warmed up" is workload-defined. `check()` is
    a handful of int compares, cheap enough for every scheduler tick; the
    first violation per path logs ONE warning and every excess build
    increments `retraces_unexpected`.
    """

    def __init__(self, name: str | None = None):
        self.name = name or next_name("sentinel")
        self._watches: dict[str, dict] = {}
        self.retraces_unexpected = 0
        self.armed = False
        self.events: collections.deque = collections.deque(maxlen=64)

    def watch(self, path: str, getter, cap: int | None = None,
              *, registered: bool = False) -> None:
        """`registered=True` asserts `path` is in `RETRACE_WATCHES`, the
        port's compile-once inventory; ad-hoc and test watches keep the
        default."""
        if registered and path not in RETRACE_WATCHES:
            raise ValueError(
                f"sentinel watch {path!r} is not a registered compile-once "
                "path: add it to RETRACE_WATCHES in "
                "ray_tpu_torch/util/telemetry.py")
        self._watches[path] = {
            "getter": getter,
            "cap": None if cap is None else int(cap),
            "limit": None if cap is None else int(cap),
            "counted": 0, "warned": False}

    def arm(self) -> None:
        """Declare warmup over: baseline every dynamic watch at its
        current count, so any further build on it is unexpected. Cap
        watches are unaffected (they were armed from construction)."""
        self.armed = True
        for w in self._watches.values():
            if w["cap"] is None:
                try:
                    w["limit"] = int(w["getter"]())
                except Exception:
                    continue
                w["counted"] = w["limit"]

    def check(self) -> int:
        """Compare every watched counter against its allowance; count
        and warn on new excess builds. Returns newly-counted excess."""
        new = 0
        for path, w in self._watches.items():
            limit = w["limit"]
            if limit is None:
                continue
            try:
                cur = int(w["getter"]())
            except Exception:
                continue
            base = max(limit, w["counted"])
            if cur > base:
                delta = cur - base
                w["counted"] = cur
                self.retraces_unexpected += delta
                new += delta
                self.events.append({
                    "ts": time.time(), "sentinel": self.name,
                    "path": path, "traces": cur, "allowed": limit})
                if not w["warned"]:
                    w["warned"] = True
                    logger.warning(
                        "retrace sentinel [%s]: pinned path %r "
                        "re-traced at runtime (traces=%d, allowed=%d) — "
                        "a compile-once guarantee broke; expect a "
                        "latency spike and check for changing input "
                        "shapes/dtypes", self.name, path, cur, limit)
        return new

    def watching(self) -> bool:
        return any(w["limit"] is not None
                   for w in self._watches.values())

    def reset(self) -> None:
        self.retraces_unexpected = 0
        self.events.clear()
        for w in self._watches.values():
            w["counted"] = 0
            w["warned"] = False
            if w["cap"] is None:
                w["limit"] = None
        self.armed = False
