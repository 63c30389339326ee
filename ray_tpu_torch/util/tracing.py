"""Opt-in tracing spans (OpenTelemetry-shaped, dependency-free): the
counterpart of `ray_tpu/util/tracing.py` (the port imports nothing of
`ray_tpu`).

Spans are recorded in-process with the OTel span shape (name, trace and
span ids, start/end ns, attributes, parent) into a bounded ring whose
evictions are counted, and exported as JSON or chrome://tracing events.
The active-span slot is a `contextvars.ContextVar`, so it flows into
asyncio tasks and, through `capture_context` / `attach_context`, into
another thread: the engine's `FlightRecorder` parents its request spans
under the submitting context's span.

Left out against the reference (ROADMAP A5): `enable_tracing` turns
recording on in this process and, through the ``RAY_TPU_TRACING``
environment variable, in processes it starts later; the cluster-wide
control call to live workers and the receiving end of it need the
runtime's control channel.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional

# Enablement is a cached process-local flag, read from RAY_TPU_TRACING
# once at import and refreshed by enable_tracing(): the off path of
# span() must stay a couple of attribute reads.
_enabled = os.environ.get("RAY_TPU_TRACING") == "1"
_lock = threading.Lock()
_current: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_active_span", default=None)

# Retention: the span store is a ring (a deque, so eviction is O(1)); a
# long-running engine must not grow memory without bound. Overflow
# evictions are counted so a truncated export is observable.
DEFAULT_MAX_SPANS = 10_000
_max_spans = int(os.environ.get("RAY_TPU_TRACING_MAX_SPANS",
                                DEFAULT_MAX_SPANS))
_spans: "collections.deque[dict]" = collections.deque(maxlen=_max_spans)
_dropped = 0

# Human-readable lane for this process in merged chrome traces; falls
# back to the pid.
_proc_label: Optional[str] = None


def set_process_label(label: str) -> None:
    """Name this process's lane in merged chrome-trace exports."""
    global _proc_label
    _proc_label = label


def process_label() -> str:
    return _proc_label or f"pid-{os.getpid()}"


def set_max_spans(cap: int) -> None:
    """Configure the span ring's capacity (evicting oldest if needed)."""
    global _max_spans, _spans, _dropped
    with _lock:
        _max_spans = max(1, int(cap))
        old = _spans
        _spans = collections.deque(maxlen=_max_spans)
        while len(old) > _max_spans:
            old.popleft()
            _dropped += 1
        _spans.extend(old)


def max_spans() -> int:
    return _max_spans


def dropped_spans() -> int:
    """Spans evicted from the ring since process start (or clear)."""
    return _dropped


def _record(s: dict) -> None:
    global _dropped
    with _lock:
        if len(_spans) == _max_spans:
            _dropped += 1        # deque(maxlen) evicts silently; count it
        _spans.append(s)


def enable_tracing() -> None:
    """Turn span recording on in this process and in processes started
    from it later (they inherit the RAY_TPU_TRACING env var)."""
    global _enabled
    _enabled = True
    os.environ["RAY_TPU_TRACING"] = "1"


def tracing_enabled() -> bool:
    """True when span recording is on in this process."""
    return _enabled


def _new_id(nbytes: int) -> str:
    return uuid.uuid4().hex[:nbytes * 2]


def _make_span(name: str, parent: Optional[dict],
               attributes: Optional[Dict]) -> dict:
    return {
        "name": name,
        "trace_id": parent["trace_id"] if parent else _new_id(16),
        "span_id": _new_id(8),
        "parent_span_id": parent["span_id"] if parent else None,
        "start_ns": time.time_ns(),
        "end_ns": None,
        "attributes": dict(attributes or {}),
        "status": "OK",
        "process": os.getpid(),
        "proc": process_label(),
        "thread": threading.current_thread().name,
    }


class _NullSpan:
    """Reusable no-op context manager: the tracing-off fast path of
    `span()` (a contextlib generator costs microseconds per call even
    when it yields immediately)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, attributes: Optional[Dict] = None):
    """Record one span; nests under the active span of this context.
    With tracing off this is a flag read + a shared null context."""
    if not _enabled:
        return _NULL_SPAN
    return _live_span(name, attributes)


@contextlib.contextmanager
def _live_span(name: str, attributes: Optional[Dict]):
    parent = _current.get()
    s = _make_span(name, parent, attributes)
    _current.set(s)
    try:
        yield s
    except BaseException as e:
        s["status"] = "ERROR"
        s["attributes"]["exception"] = repr(e)
        raise
    finally:
        s["end_ns"] = time.time_ns()
        _current.set(parent)
        _record(s)


def start_span(name: str, attributes: Optional[Dict] = None,
               parent: Optional[dict] = None):
    """Manual span start for code that can't wrap its body in a `with`
    (cross-thread hops). Unlike `span()` this does NOT gate on
    `tracing_enabled()`. Returns (span, token) for `end_span`."""
    s = _make_span(name, parent if parent is not None else _current.get(),
                   attributes)
    token = _current.get()
    _current.set(s)
    return s, token


def end_span(s: dict, token, error: Optional[str] = None) -> None:
    """Close a span from `start_span` and restore the prior context."""
    if error:
        s["status"] = "ERROR"
        s["attributes"]["exception"] = error
    s["end_ns"] = time.time_ns()
    _current.set(token)
    _record(s)


def capture_context() -> Optional[dict]:
    """The active span (or attached remote context) of this execution
    context, for handing to another thread explicitly."""
    return _current.get()


def propagation_context(span_dict: Optional[dict] = None) -> Optional[dict]:
    """Minimal wire-format context, ``{"trace_id", "span_id"}``, of
    `span_dict` or of the active span; None when no trace is active."""
    s = span_dict if span_dict is not None else _current.get()
    if s is None:
        return None
    return {"trace_id": s["trace_id"], "span_id": s["span_id"]}


def attach_context(ctx: Optional[dict]):
    """Make `ctx` (a span or a `propagation_context()` dict) the calling
    context's active span, so spans opened here nest under it. Returns a
    token for `detach_context`."""
    prev = _current.get()
    _current.set(ctx)
    return prev


def detach_context(token) -> None:
    """Restore the context that was active before `attach_context`."""
    _current.set(token)


def get_spans() -> List[dict]:
    with _lock:
        return list(_spans)


def drain_spans() -> List[dict]:
    """Atomically remove and return all buffered spans."""
    with _lock:
        if not _spans:
            return []
        out = list(_spans)
        _spans.clear()
        return out


def ingest(spans: List[dict]) -> int:
    """Append spans produced elsewhere into this ring (same cap and
    dropped accounting). Returns the count."""
    global _dropped
    if not spans:
        return 0
    with _lock:
        for s in spans:
            if isinstance(s, dict):
                if len(_spans) == _max_spans:
                    _dropped += 1
                _spans.append(s)
    return len(spans)


def clear_spans() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def export_json(path: str) -> int:
    """Write this process's spans as a JSON list; returns the count."""
    spans = get_spans()
    with open(path, "w") as f:
        json.dump(spans, f)
    return len(spans)


def probe_disabled_overhead_ns(iters: int = 20_000) -> float:
    """Per-call cost (ns) of the tracing-OFF hot path: `span()` with
    recording disabled."""
    global _enabled
    prev_enabled, prev_env = _enabled, os.environ.pop("RAY_TPU_TRACING",
                                                      None)
    _enabled = False
    try:
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            with span("overhead-probe"):
                pass
        dt = time.perf_counter_ns() - t0
    finally:
        _enabled = prev_enabled
        if prev_env is not None:
            os.environ["RAY_TPU_TRACING"] = prev_env
    return dt / max(1, iters)


def spans_to_chrome_trace(spans: Optional[List[dict]] = None) -> List[dict]:
    """Convert to chrome://tracing 'X' events. Lanes are process
    identities (pid = the producing process's label, tid = the producing
    thread or a span-supplied lane); the trace id rides in args."""
    out = []
    for s in (spans if spans is not None else get_spans()):
        end = s["end_ns"] or time.time_ns()
        out.append({
            "name": s["name"], "cat": s.get("cat", "span"), "ph": "X",
            "ts": s["start_ns"] / 1e3, "dur": (end - s["start_ns"]) / 1e3,
            "pid": s.get("proc") or s["process"],
            "tid": s.get("lane") or s.get("thread") or "main",
            "args": {**s["attributes"], "trace_id": s["trace_id"],
                     "span_id": s["span_id"]},
        })
    return out
