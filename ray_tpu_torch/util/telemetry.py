"""Hot-path flight recorder: one observability plane over the engine,
trainer and flywheel telemetry islands. The counterpart of
`ray_tpu/util/telemetry.py` (the port imports nothing of `ray_tpu`),
built from the same four pieces:

  * `FlightRecorder`: per-request lifecycle tracing for an engine:
    submit -> queue wait -> each prefill chunk (prefix-hit/COW
    annotated) -> decode -> first token -> finish/cancel/preempt/
    swap-crossing, and the disaggregated handoff's export, import and
    end-to-end spans, recorded as `util.tracing`-shaped span dicts in a
    bounded ring (evictions counted, never silent). Sampled per request
    (``RAY_TPU_TELEMETRY_SAMPLE``, default 1.0): the per-token hook is
    one dict lookup and an int increment, and an unsampled request costs
    a single failed lookup per hook. Every hook is host-side and reads
    no tensor. TTFT, TPOT and queue wait go into `util.metrics`
    histograms.

  * the stats-dict metrics bridge: `register_stats_source(name, obj)`
    holds a weakref to anything with a ``stats() -> dict`` (engines,
    train loops, flywheels) and a collect hook
    (`metrics.add_collect_hook`) republishes every numeric stat as a
    Gauge or, for the monotone keys in `COUNTER_KEYS`, a delta-tracked
    Counter that reads a decrease as ``reset_stats()``, tagged by
    source.

  * `RetraceSentinel`: runtime watcher over compile-once counters. The
    engine builds each static-shaped step once (a CUDA graph captured at
    first use on the card; the port's counterpart of one jit trace) and
    counts the builds under the reference's trace counters; the
    `TrainLoop` counts its fused dispatch per input signature. Pinned
    paths carry a hard cap from construction; bucket-dependent paths
    (prefill) are baselined by `arm()` after warm-up. Every excess build
    increments ``retraces_unexpected`` and the ``retraces_unexpected``
    counter of `util.metrics`, with ONE warning per path.

  * `chrome_trace_events()` / `summary()` / `check_invariants()`:
    recorder and `util.tracing` spans as chrome://tracing events, a JSON
    health summary, and the plane's self-test.

`device_peak_flops` reads the card's dense bf16 peak from `PEAK_FLOPS`,
the port's one table of it, for `mfu`.

Left out against the reference: the lint registry that
``registered=True`` looks a path up in; here it looks in
`RETRACE_WATCHES`, the port's own inventory of compile-once paths.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import random
import re
import threading
import time
import uuid
import weakref

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)

DEFAULT_SAMPLE = float(os.environ.get("RAY_TPU_TELEMETRY_SAMPLE", "1.0"))
DEFAULT_MAX_SPANS = int(os.environ.get("RAY_TPU_TELEMETRY_MAX_SPANS",
                                       "4096"))
# Per-request chunk-span bound: a pathological prompt chunked a thousand
# times must not make one live trace unbounded.
MAX_CHUNKS_PER_REQUEST = 256

# The compile-once paths of the port (the engine's trace counters and
# the train loop's fused dispatch, without the ``_traces`` suffix).
RETRACE_WATCHES = ("decode", "prefill", "verify", "draft", "draft_prefill",
                   "quantize", "kv_gather", "kv_scatter", "dispatch")

_lock = threading.Lock()
_ids: dict[str, itertools.count] = {}
_recorders: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_sentinels: "weakref.WeakSet[RetraceSentinel]" = weakref.WeakSet()


def next_name(kind: str) -> str:
    """Process-unique instance name per kind: engine0, engine1, train0...
    Used to tag each source's metric series."""
    with _lock:
        counter = _ids.setdefault(kind, itertools.count())
        return f"{kind}{next(counter)}"


def _now_ns() -> int:
    return time.time_ns()


# ---------------------------------------------------------------------------
# latency histograms (module-level, tagged by source)
# ---------------------------------------------------------------------------

_MS_BOUNDARIES = [0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000, 5000]
_metric_cache: dict[tuple[type, str], "_metrics.Metric"] = {}


def _metric(cls, name: str, desc: str = "", boundaries=None,
            tag_keys=("source",)):
    """Lazily create/reuse one tagged metric; returns None when the name
    is already registered as a conflicting type (the scrape must not
    break because two subsystems picked one name)."""
    key = (cls, name)
    with _lock:
        m = _metric_cache.get(key)
        if m is not None:
            return m
        try:
            if cls is _metrics.Histogram:
                m = cls(name, desc, boundaries=boundaries,
                        tag_keys=tag_keys)
            else:
                m = cls(name, desc, tag_keys=tag_keys)
        except (ValueError, TypeError):
            return None
        _metric_cache[key] = m
        return m


# ---------------------------------------------------------------------------
# flight recorder: per-request engine tracing
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Sampled per-request lifecycle tracer for one engine.

    The engine calls the `on_*` hooks from inside its scheduler (under
    its own lock, between device steps); every hook for an unsampled
    request is one dict miss. Spans use the `util.tracing` dict shape
    (epoch-ns timestamps) and land in a bounded ring on finish;
    `dropped_spans` counts ring evictions so truncation is observable.
    """

    def __init__(self, name: str | None = None, *,
                 sample: float | None = None,
                 max_spans: int | None = None):
        self.name = name or next_name("recorder")
        self.sample = (DEFAULT_SAMPLE if sample is None
                       else max(0.0, min(1.0, float(sample))))
        self.max_spans = max(1, int(DEFAULT_MAX_SPANS if max_spans is None
                                    else max_spans))
        self._spans: collections.deque = collections.deque()
        self._live: dict[int, dict] = {}
        self._rng = random.Random(0x5EED ^ hash(self.name))
        self.dropped_spans = 0
        self.requests_seen = 0
        self.requests_traced = 0
        _recorders.add(self)

    # -- engine hooks (hot path) --------------------------------------

    def on_submit(self, rid: int, prompt_len: int) -> None:
        self.requests_seen += 1
        if self.sample <= 0.0 or (self.sample < 1.0
                                  and self._rng.random() >= self.sample):
            return
        now = _now_ns()
        # Join the trace of the submitting context when it carries one,
        # else start a fresh trace.
        parent = _tracing.capture_context()
        if parent is not None:
            trace_id = parent["trace_id"]
            parent_sid = parent["span_id"]
        else:
            trace_id = uuid.uuid4().hex
            parent_sid = None
        root = self._span("engine.request", trace_id, parent_sid, now,
                          {"rid": rid, "engine": self.name,
                           "prompt_len": int(prompt_len)})
        queue = self._span("queue_wait", trace_id, root["span_id"], now,
                           {"rid": rid})
        self._live[rid] = {"root": root, "queue": queue, "extra": [],
                           "first_ns": None, "tokens": 0}
        self.requests_traced += 1

    def on_admit(self, rid: int, prefix_hit_tokens: int,
                 cow: bool) -> None:
        tr = self._live.get(rid)
        if tr is None:
            return
        now = _now_ns()
        tr["queue"]["end_ns"] = now
        tr["root"]["attributes"].update(
            prefix_hit_tokens=int(prefix_hit_tokens), cow=bool(cow))
        h = _metric(_metrics.Histogram, "engine_queue_wait_ms",
                    "submit -> slot admission, ms",
                    boundaries=_MS_BOUNDARIES)
        if h is not None:
            h.observe((now - tr["queue"]["start_ns"]) / 1e6,
                      tags={"source": self.name})

    def on_prefill_chunk(self, rid: int, tokens: int, bucket: int,
                         dur_s: float) -> None:
        tr = self._live.get(rid)
        if tr is None or len(tr["extra"]) >= MAX_CHUNKS_PER_REQUEST:
            return
        end = _now_ns()
        root = tr["root"]
        s = self._span("prefill_chunk", root["trace_id"],
                       root["span_id"], end - int(dur_s * 1e9),
                       {"rid": rid, "tokens": int(tokens),
                        "bucket": int(bucket)})
        s["end_ns"] = end
        tr["extra"].append(s)

    def on_first_token(self, rid: int, wait_s: float) -> None:
        tr = self._live.get(rid)
        if tr is None:
            return
        tr["first_ns"] = _now_ns()
        tr["extra"].append(self._instant(tr, "first_token", rid))
        h = _metric(_metrics.Histogram, "engine_ttft_ms",
                    "submit -> first token, ms",
                    boundaries=_MS_BOUNDARIES)
        if h is not None:
            h.observe(wait_s * 1e3, tags={"source": self.name})

    def on_token(self, rid: int) -> None:
        tr = self._live.get(rid)
        if tr is not None:
            tr["tokens"] += 1

    def on_swap_crossing(self, rid: int) -> None:
        tr = self._live.get(rid)
        if tr is not None:
            tr["extra"].append(self._instant(tr, "swap_crossing", rid))

    def _on_kv_transfer(self, name: str, metric: str, rid: int,
                        blocks: int, nbytes: int, dur_s: float) -> None:
        """Shared body for the disaggregation transfer hooks: one
        `kv_export`/`kv_import` span under the request root plus a
        tagged latency histogram."""
        h = _metric(_metrics.Histogram, metric,
                    "paged KV block transfer (one handoff side), ms",
                    boundaries=_MS_BOUNDARIES)
        if h is not None:
            h.observe(dur_s * 1e3, tags={"source": self.name})
        tr = self._live.get(rid)
        if tr is None or len(tr["extra"]) >= MAX_CHUNKS_PER_REQUEST:
            return
        end = _now_ns()
        root = tr["root"]
        s = self._span(name, root["trace_id"], root["span_id"],
                       end - int(dur_s * 1e9),
                       {"rid": rid, "blocks": int(blocks),
                        "bytes": int(nbytes)})
        s["end_ns"] = end
        tr["extra"].append(s)

    def on_kv_export(self, rid: int, blocks: int, nbytes: int,
                     dur_s: float) -> None:
        """Prefill-role engine gathered `blocks` KV blocks to host for a
        handoff (device -> host side of the transfer)."""
        self._on_kv_transfer("kv_export", "engine_kv_export_ms", rid,
                             blocks, nbytes, dur_s)

    def on_kv_import(self, rid: int, blocks: int, nbytes: int,
                     dur_s: float) -> None:
        """Decode-role engine scattered a handoff's blocks into its pool
        (host -> device side of the transfer)."""
        self._on_kv_transfer("kv_import", "engine_kv_import_ms", rid,
                             blocks, nbytes, dur_s)

    def on_handoff(self, rid: int, dur_s: float) -> None:
        """End-to-end prefill -> decode handoff latency (export + wire +
        import), recorded by whichever layer drove the transfer
        (`serve.disagg.DecodeReplica`'s pull, or a harness)."""
        h = _metric(_metrics.Histogram, "serve_handoff_ms",
                    "prefill->decode handoff, end to end, ms",
                    boundaries=_MS_BOUNDARIES)
        if h is not None:
            h.observe(dur_s * 1e3, tags={"source": self.name})
        tr = self._live.get(rid)
        if tr is not None:
            tr["extra"].append(self._instant(tr, "handoff", rid))

    def on_finish(self, rid: int, outcome: str) -> None:
        tr = self._live.pop(rid, None)
        if tr is None:
            return
        now = _now_ns()
        root, queue = tr["root"], tr["queue"]
        if queue["end_ns"] is None:     # cancelled while still pending
            queue["end_ns"] = now
        root["end_ns"] = now
        root["attributes"]["outcome"] = outcome
        root["attributes"]["tokens"] = tr["tokens"]
        spans = [root, queue] + tr["extra"]
        first = tr["first_ns"]
        if first is not None:
            dec = self._span("decode", root["trace_id"],
                             root["span_id"], first,
                             {"rid": rid, "tokens": tr["tokens"]})
            dec["end_ns"] = now
            spans.append(dec)
            if tr["tokens"] > 1:
                h = _metric(_metrics.Histogram, "engine_tpot_ms",
                            "inter-token latency after first token, ms",
                            boundaries=_MS_BOUNDARIES)
                if h is not None:
                    h.observe((now - first) / 1e6 / (tr["tokens"] - 1),
                              tags={"source": self.name})
        for s in spans:
            if len(self._spans) >= self.max_spans:
                self._spans.popleft()
                self.dropped_spans += 1
            self._spans.append(s)

    # -- internals ----------------------------------------------------

    def _span(self, name, trace_id, parent, start_ns, attrs) -> dict:
        return {"name": name, "trace_id": trace_id,
                "span_id": uuid.uuid4().hex[:16],
                "parent_span_id": parent, "start_ns": start_ns,
                "end_ns": None, "attributes": attrs, "status": "OK",
                "process": os.getpid()}

    def _instant(self, tr, name, rid) -> dict:
        now = _now_ns()
        root = tr["root"]
        s = self._span(name, root["trace_id"], root["span_id"], now,
                       {"rid": rid})
        s["end_ns"] = now
        return s

    # -- export -------------------------------------------------------

    def get_spans(self) -> list[dict]:
        return list(self._spans)

    def drain_spans(self) -> list[dict]:
        """Atomically pop the ring. Spans are tagged with this recorder's
        category, lane and process so a merged chrome view keeps the
        per-request lanes."""
        out = []
        while True:
            try:
                s = self._spans.popleft()
            except IndexError:
                break
            rid = s["attributes"].get("rid", 0)
            s.setdefault("cat", "request")
            s.setdefault("lane", f"{self.name}/r{rid}")
            s.setdefault("proc", _tracing.process_label())
            out.append(s)
        return out

    def live_requests(self) -> int:
        return len(self._live)

    def chrome_events(self) -> list[dict]:
        """Recorder spans as chrome://tracing events, cat="request".
        Instant markers (first_token / swap_crossing / handoff) become
        "i" events."""
        out = []
        for s in self.get_spans():
            rid = s["attributes"].get("rid", 0)
            base = {"name": s["name"], "cat": "request",
                    "pid": s["process"], "tid": f"{self.name}/r{rid}",
                    "args": s["attributes"]}
            end = s["end_ns"] or _now_ns()
            if end == s["start_ns"]:
                out.append({**base, "ph": "i", "ts": s["start_ns"] / 1e3,
                            "s": "t"})
            else:
                out.append({**base, "ph": "X", "ts": s["start_ns"] / 1e3,
                            "dur": (end - s["start_ns"]) / 1e3})
        return out

    def clear(self) -> None:
        self._spans.clear()
        self.dropped_spans = 0

    def check_invariants(self) -> None:
        assert len(self._spans) <= self.max_spans, \
            f"{self.name}: span ring {len(self._spans)} > cap " \
            f"{self.max_spans}"
        assert 0.0 <= self.sample <= 1.0, self.sample
        assert self.requests_traced <= self.requests_seen
        for tr in self._live.values():
            assert len(tr["extra"]) <= MAX_CHUNKS_PER_REQUEST + 8


# ---------------------------------------------------------------------------
# retrace sentinel
# ---------------------------------------------------------------------------

class RetraceSentinel:
    """Runtime watcher over compile-once build counters.

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
        _sentinels.add(self)

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
        if new:
            c = _metric(_metrics.Counter, "retraces_unexpected",
                        "traces of pinned compile-once paths beyond "
                        "their allowance")
            if c is not None:
                c.inc(new, tags={"source": self.name})
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


# ---------------------------------------------------------------------------
# stats-dict -> metrics bridge
# ---------------------------------------------------------------------------

# Monotone-while-not-reset stats keys published as Counters with delta
# tracking (a decrease means reset_stats(); the post-reset count re-adds
# from zero). Everything else numeric is a Gauge.
COUNTER_KEYS = frozenset({
    "decode_steps", "prefill_tokens", "decode_tokens", "prefill_chunks",
    "prefix_hit_tokens", "cow_copies", "evicted_blocks", "cancelled",
    "swaps", "spec_steps", "total", "snapshots", "commits", "stalls",
    "fetches", "iterations",
    # serve-plane fault tolerance (handle/engine/controller stats)
    "retries", "failovers", "sheds", "watchdog_stalls",
    "breaker_trips", "replicas_restarted", "health_check_failures",
    # task-event recorder (stage-attribution observations)
    "stage_samples",
    # priority/preemption plane (engine + per_class sub-dicts)
    "preemptions", "reprefill_blocks", "aging_promotions",
    "submitted", "completed",
    # disaggregated prefill/decode (engine handoff plane + the proxy's
    # SLO admission verdicts)
    "handoffs", "imports", "handoffs_abandoned",
    "kv_blocks_exported", "kv_blocks_imported",
    "kv_export_bytes", "kv_import_bytes",
    "slo_sheds", "slo_queued",
})

_sources: dict[str, tuple] = {}          # name -> (weakref, kind)
# (name, metric) or (name, metric, class_tag) -> last published count
_last_counts: dict[tuple, float] = {}
_hook_installed = False


def register_stats_source(name: str, obj, kind: str = "engine") -> str:
    """Publish `obj.stats()` into the metrics registry at every
    snapshot, as `<kind>_<key>` series tagged source=<name>. Holds only a
    weakref: a garbage-collected source drops out (its gauges keep their
    last value). Returns the (possibly uniquified) registered name."""
    global _hook_installed
    with _lock:
        final = name
        i = 2
        while final in _sources and _sources[final][0]() is not None \
                and _sources[final][0]() is not obj:
            final = f"{name}-{i}"
            i += 1
        _sources[final] = (weakref.ref(obj), kind)
        if not _hook_installed:
            _metrics.add_collect_hook(_collect)
            _hook_installed = True
    return final


def unregister_stats_source(name: str) -> None:
    with _lock:
        _sources.pop(name, None)
        for key in [k for k in _last_counts if k[0] == name]:
            del _last_counts[key]


def _collect() -> None:
    """The metrics collect hook: refresh every live source's series.
    Runs BEFORE the registry lock (the `metrics.snapshot` contract), so
    it may freely create metrics; a broken source never breaks the
    scrape."""
    with _lock:
        items = list(_sources.items())
    dead = []
    for name, (ref, kind) in items:
        obj = ref()
        if obj is None:
            dead.append(name)
            continue
        try:
            stats = obj.stats()
        except Exception:
            continue
        if isinstance(stats, dict):
            _publish_stats(kind, name, stats)
    for name in dead:
        unregister_stats_source(name)


def _publish_stats(kind: str, name: str, stats: dict) -> None:
    for key, val in stats.items():
        if isinstance(val, bool) or isinstance(val, str):
            continue
        if isinstance(val, dict):
            # One level of nesting fans out as tagged series: a stats key
            # like ``per_class: {"0": {"sheds": 2, ...}, ...}`` becomes
            # `<kind>_<key>_<metric>{source=..., class="0"}`.
            for tag, sub in val.items():
                if not isinstance(sub, dict):
                    continue
                for skey, sval in sub.items():
                    if isinstance(sval, (bool, str)):
                        continue
                    try:
                        num = float(sval)
                    except (TypeError, ValueError):
                        continue
                    _publish_one(name, f"{kind}_{key}_{skey}", skey, num,
                                 {"source": name, "class": str(tag)},
                                 (name, f"{kind}_{key}_{skey}", str(tag)))
            continue
        try:
            num = float(val)
        except (TypeError, ValueError):
            continue
        mname = f"{kind}_{key}"
        _publish_one(name, mname, key, num, {"source": name},
                     (name, mname))


def _publish_one(name: str, mname: str, key: str, num: float,
                 tags: dict, ckey: tuple) -> None:
    """Publish one numeric sample: delta-tracked Counter when `key` is in
    COUNTER_KEYS, Gauge otherwise. `ckey` keys the delta state; the
    metric's tag_keys come from `tags`."""
    tag_keys = tuple(tags)
    if key in COUNTER_KEYS:
        c = _metric(_metrics.Counter, mname, tag_keys=tag_keys)
        if c is None:
            return
        last = _last_counts.get(ckey, 0.0)
        if num < last:          # stats reset upstream
            last = 0.0
        if num > last:
            c.inc(num - last, tags=tags)
        _last_counts[ckey] = num
    else:
        g = _metric(_metrics.Gauge, mname, tag_keys=tag_keys)
        if g is not None:
            g.set(num, tags=tags)


# ---------------------------------------------------------------------------
# MFU helpers
# ---------------------------------------------------------------------------

# Dense bf16 tensor-core peak FLOP/s per device, by name substring
# (NVIDIA's data sheets, SXM parts; first match wins).
PEAK_FLOPS = (("H100", 989e12), ("H200", 989e12))


def device_peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of ``device`` (default: the current CUDA
    device when there is one). A device not in `PEAK_FLOPS` (the CPU
    among them) reads as the port's target card, the H100, as the
    reference reads an unknown device as its default chip."""
    import torch
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    name = ""
    if device is not None and torch.device(device).type == "cuda":
        name = torch.cuda.get_device_name(torch.device(device))
    for key, val in PEAK_FLOPS:
        if key in name:
            return val
    return PEAK_FLOPS[0][1]


def mfu(flops_per_sec: float, n_devices: int | None = None,
        device=None) -> float:
    """Model FLOPs utilization: achieved model FLOPs/s over the devices'
    aggregate peak (``n_devices`` default: the CUDA devices, else 1)."""
    if n_devices is None:
        import torch
        n_devices = torch.cuda.device_count() or 1
    return flops_per_sec / (device_peak_flops(device)
                            * max(1, int(n_devices)))


# ---------------------------------------------------------------------------
# exports / self-test
# ---------------------------------------------------------------------------

def chrome_trace_events() -> list[dict]:
    """This process's recorder spans + application tracing spans as
    chrome://tracing events (cat = request | span)."""
    out = []
    for rec in list(_recorders):
        out.extend(rec.chrome_events())
    out.extend(_tracing.spans_to_chrome_trace())
    return out


def drain_recorder_spans() -> list[dict]:
    """Pop every live recorder's span ring (the worker side of span
    collection)."""
    out = []
    for rec in list(_recorders):
        out.extend(rec.drain_spans())
    return out


def _tracing_gauges() -> None:
    """Collect hook: surface the tracing ring's drop counter in the
    scrape, so a truncated trace is observable."""
    g = _metric(_metrics.Gauge, "tracing_dropped_spans",
                "spans evicted from the in-process tracing ring")
    if g is not None:
        g.set(_tracing.dropped_spans(), tags={"source": "tracing"})


_metrics.add_collect_hook(_tracing_gauges)


def summary() -> dict:
    """JSON health summary of the plane."""
    return {
        "recorders": [{
            "name": r.name, "sample": r.sample,
            "requests_seen": r.requests_seen,
            "requests_traced": r.requests_traced,
            "live_requests": r.live_requests(),
            "spans": len(r.get_spans()),
            "dropped_spans": r.dropped_spans,
        } for r in list(_recorders)],
        "sentinels": [{
            "name": s.name, "armed": s.armed,
            "watching": s.watching(),
            "retraces_unexpected": s.retraces_unexpected,
            "events": list(s.events),
        } for s in list(_sentinels)],
        "tracing": {
            "enabled": _tracing.tracing_enabled(),
            "spans": len(_tracing.get_spans()),
            "max_spans": _tracing.max_spans(),
            "dropped_spans": _tracing.dropped_spans(),
        },
        "stats_sources": sorted(_sources.keys()),
    }


_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(?:\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' (\S+)$')


def check_invariants() -> None:
    """Telemetry-plane self-test: every rendered metric sample parses
    under the Prometheus exposition grammar, the tracing and recorder
    rings honor their bounds, and every sentinel still watches its
    pinned paths."""
    text = _metrics.render_prometheus(_metrics.snapshot())
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        float(m.group(1))           # value must be a number
    assert len(_tracing.get_spans()) <= _tracing.max_spans(), \
        "tracing span ring exceeded its cap"
    for rec in list(_recorders):
        rec.check_invariants()
    for s in list(_sentinels):
        assert s.watching() or not s._watches, \
            f"sentinel {s.name} has watches but none armed"
