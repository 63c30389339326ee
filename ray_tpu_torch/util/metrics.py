"""Application metrics API: Counter / Gauge / Histogram, the counterpart
of `ray_tpu/util/metrics.py` (the port imports nothing of `ray_tpu`).

Each process keeps a registry; `snapshot` runs the pull-style collect
hooks (`util.telemetry` republishes engine, train-loop and flywheel
stats through one) and returns every metric's series; `merge_snapshots`
aggregates per-process snapshots and `render_prometheus` emits the text
exposition format. Same names, tags, bucket rules and rendering as the
reference, so the two packages' scrapes read alike.

Left out against the reference (ROADMAP A5): the worker -> driver flush
(`_ensure_flusher`, `flush_now`, `_push_spans`, `flush`,
`ensure_flusher`) and the dashboard's /metrics endpoint, which need the
runtime's control channel.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Optional, Tuple

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000]


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.metrics: dict[str, "Metric"] = {}

    def register(self, metric: "Metric"):
        with self.lock:
            existing = self.metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{type(existing).__name__}")
            self.metrics[metric.name] = metric

    def snapshot(self) -> list[dict]:
        with self.lock:
            return [m._snapshot() for m in self.metrics.values()]


_registry = _Registry()


def _check_tags(declared: Tuple[str, ...], given: Optional[Dict[str, str]],
                default: Optional[Dict[str, str]]):
    tags = dict(default or {})
    if given:
        tags.update(given)
    extra = set(tags) - set(declared)
    missing = set(declared) - set(tags)
    if extra or missing:
        raise ValueError(
            f"tag keys mismatch: declared {declared}, got {sorted(tags)}")
    return tuple(sorted(tags.items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        if not name:
            raise ValueError("metric name is required")
        if isinstance(tag_keys, str) or not all(
                isinstance(k, str) for k in tag_keys):
            raise TypeError("tag_keys must be a tuple of strings")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: dict = {}
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "type": type(self).__name__.lower(),
                    "description": self.description,
                    "series": dict(self._series)}


class Counter(Metric):
    """Monotonically increasing value."""

    def inc(self, value: float = 1.0, tags: Optional[Dict] = None):
        if value <= 0:
            raise ValueError("Counter.inc requires value > 0")
        key = _check_tags(self.tag_keys, tags, self._default_tags)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    """Last-set value."""

    def set(self, value: float, tags: Optional[Dict] = None):
        key = _check_tags(self.tag_keys, tags, self._default_tags)
        with self._lock:
            self._series[key] = float(value)


class Histogram(Metric):
    """Bucketed observations."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[list] = None,
                 tag_keys: Tuple[str, ...] = ()):
        self.boundaries = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[Dict] = None):
        key = _check_tags(self.tag_keys, tags, self._default_tags)
        with self._lock:
            buckets, total, count = self._series.get(
                key, ([0] * (len(self.boundaries) + 1), 0.0, 0))
            buckets = list(buckets)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._series[key] = (buckets, total + value, count + 1)

    def _snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "type": "histogram",
                    "description": self.description,
                    "boundaries": list(self.boundaries),
                    "series": {k: (list(v[0]), v[1], v[2])
                               for k, v in self._series.items()}}


# Pull-style collectors: hooks run at the top of every snapshot, BEFORE
# the registry lock is taken, so a hook may freely create, register and
# set metrics. util.telemetry uses this to refresh engine/train gauges
# from their stats() dicts at scrape time.
_collect_hooks: list[Callable[[], None]] = []


def add_collect_hook(fn: Callable[[], None]) -> None:
    if fn not in _collect_hooks:
        _collect_hooks.append(fn)


def remove_collect_hook(fn: Callable[[], None]) -> None:
    if fn in _collect_hooks:
        _collect_hooks.remove(fn)


def snapshot() -> list[dict]:
    """This process's metrics."""
    for hook in list(_collect_hooks):
        try:
            hook()
        except Exception:
            pass   # a broken collector must not break the scrape
    return _registry.snapshot()


def merge_snapshots(snapshots: list[list[dict]]) -> list[dict]:
    """Aggregate per-process snapshots: counters and histograms sum
    across processes; gauges keep the last writer."""
    out: dict[str, dict] = {}
    for snap in snapshots:
        for m in snap:
            cur = out.get(m["name"])
            if cur is None:
                out[m["name"]] = {**m, "series": dict(m["series"])}
                continue
            for key, val in m["series"].items():
                if m["type"] == "counter":
                    cur["series"][key] = cur["series"].get(key, 0.0) + val
                elif m["type"] == "histogram":
                    prev = cur["series"].get(key)
                    if prev is None:
                        cur["series"][key] = val
                    else:
                        cur["series"][key] = (
                            [a + b for a, b in zip(prev[0], val[0])],
                            prev[1] + val[1], prev[2] + val[2])
                else:
                    cur["series"][key] = val
    return list(out.values())


def _esc(value) -> str:
    """Escape a label value per the prometheus exposition format."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def sanitize_name(name: str, label: bool = False) -> str:
    """Map an arbitrary string onto the Prometheus metric-name charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (labels additionally exclude ':'), so a
    metric named 'engine0/ttft ms' still renders a scrapeable line."""
    ok = _LABEL_OK if label else _NAME_OK
    if name and ok.match(name):
        return name
    bad = r"[^a-zA-Z0-9_]" if label else r"[^a-zA-Z0-9_:]"
    out = re.sub(bad, "_", name or "_")
    if not re.match(r"[a-zA-Z_]" if label else r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def format_float(v) -> str:
    """Canonical float formatting for `le` bucket labels and values, Go
    strconv style ('0.001', '1.0', '+Inf'), round-trippable with
    float(); never repr() of a numpy scalar or an int."""
    v = float(v)
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return f"{int(v)}.0"
    return repr(v)


def _labels(pairs) -> str:
    if not pairs:
        return ""
    return ("{" + ",".join(
        f'{sanitize_name(str(k), label=True)}="{_esc(v)}"'
        for k, v in pairs) + "}")


def render_prometheus(metrics: list[dict]) -> str:
    """Prometheus text exposition of an aggregated snapshot."""
    lines = []
    for m in metrics:
        name = sanitize_name("ray_tpu_" + m["name"])
        lines.append(f"# HELP {name} {_esc(m['description'])}")
        lines.append(f"# TYPE {name} {m['type']}")
        for key, val in m["series"].items():
            label = _labels(key)
            if m["type"] == "histogram":
                buckets, total, count = val
                cum = 0
                for i, b in enumerate(m["boundaries"]):
                    cum += buckets[i]
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels(key + (('le', format_float(b)),))}"
                        f" {cum}")
                cum += buckets[-1]
                lines.append(
                    f"{name}_bucket{_labels(key + (('le', '+Inf'),))} {cum}")
                lines.append(f"{name}_sum{label} {total}")
                lines.append(f"{name}_count{label} {count}")
            else:
                lines.append(f"{name}{label} {val}")
    return "\n".join(lines) + "\n"
