"""The telemetry plane of the port (`ray_tpu_torch.util.metrics`,
`.tracing`, `.telemetry`, the engine's flight recorder and the train
loop's telemetry) against the JAX package's, on the CPU. It follows
`tests/test_telemetry.py` with the port beside the reference, less the
dashboard endpoints (ROADMAP A5):

- the Prometheus text: `sanitize_name`, `format_float`, histogram `le`
  labels and `render_prometheus` give equal strings on equal inputs;
- the tracing ring's cap and eviction count, and a context attached
  across a thread, in both modules;
- one hook sequence fed to both `FlightRecorder`s gives the same spans
  (names, parents and attributes; ids and times aside), the ring bound
  and its dropped counter, sample 0, and a cancel that closes the queue
  span;
- the stats bridge: counter deltas, a decrease read as a reset, weakref
  pruning, duplicate names, and `mfu`;
- the same greedy traffic through the JAX engine and the port's at
  ``telemetry_sample=1.0``, with preemption, shedding, a cancel and a
  disaggregated handoff among it: per request the same span sequence and
  attributes (prefix-hit tokens, chunk tokens and buckets, outcome);
  ``telemetry_sample=0.0`` records nothing; a `DecodeReplica`'s pull
  records the handoff;
- the retrace sentinel's counter in the metrics registry;
- `TrainLoop.stats()`'s key set against the JAX loop's, the loop's
  registration and its ``dispatch`` watch;
- `check_invariants` after traffic, and on an overflowed ring.

Both engine modules run on one frozen fake clock (their ``time``
replaced), as in `tests/test_torch_priority.py`: admission order reads
queue ages, and the JAX engine's first ticks compile."""

import gc
import logging
import re
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import engine as jengine
from ray_tpu.train import loop as jloop
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import telemetry as jtel
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch._private import config
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import DecodeReplica, PrefillReplica
from ray_tpu_torch.serve import engine as tengine
from ray_tpu_torch.train import loop as tloop
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import telemetry as ttel
from ray_tpu_torch.util import tracing as ttracing

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64, dtype="float32")
ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=4)
PKG = {"jax": (jmetrics, jtracing, jtel), "port": (tmetrics, ttracing, ttel)}


def _parses(tel, text):
    """Every sample line matches the exposition grammar with a float
    value (the property `check_invariants` pins)."""
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = tel._PROM_SAMPLE.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        float(m.group(1))


def _series(metrics, name):
    for m in metrics.snapshot():
        if m["name"] == name:
            return m["series"]
    return {}


# ---------------------------------------------------------------------------
# prometheus rendering
# ---------------------------------------------------------------------------

NAMES = ["engine0/ttft ms", "0starts_bad", "fine_name:sub", "a:b", "",
         "ok_name", "x y\nz"]


@pytest.mark.parametrize("label", [False, True])
def test_sanitize_name_matches_jax(label):
    for n in NAMES:
        assert tmetrics.sanitize_name(n, label=label) == \
            jmetrics.sanitize_name(n, label=label)
    assert tmetrics.sanitize_name("engine0/ttft ms") == "engine0_ttft_ms"
    assert tmetrics.sanitize_name("a:b", label=True) == "a_b"


def test_format_float_matches_jax():
    for v in (2, 0.001, 0.5, 1e-9, 123456.75, float("inf"), float("-inf"),
              np.float32(1.0), np.float64(0.1), 1e15, 1e16, -3):
        got = tmetrics.format_float(v)
        assert got == jmetrics.format_float(v)
        assert float(got) == float(v)


def _fill(metrics, prefix):
    """The same metrics in one registry: a tagged histogram, a counter
    and a gauge with label values that need escaping."""
    h = metrics.Histogram(f"{prefix}_hist", "round trip",
                          boundaries=[0.1, 0.5, 1, 5], tag_keys=("source",))
    for v in (0.05, 0.3, 2.0, 100.0):
        h.observe(v, tags={"source": "t"})
    c = metrics.Counter(f"{prefix} weird/name", 'say "hi"\n',
                        tag_keys=("k",))
    c.inc(2, tags={"k": 'a"b\\c'})
    metrics.Gauge(f"{prefix}_gauge", "g").set(np.float32(0.25))
    names = {f"{prefix}_hist", f"{prefix} weird/name", f"{prefix}_gauge"}
    return [m for m in metrics.snapshot() if m["name"] in names]


def test_render_prometheus_matches_jax():
    jt = jmetrics.render_prometheus(_fill(jmetrics, "tele_rt"))
    tt = tmetrics.render_prometheus(_fill(tmetrics, "tele_rt"))
    assert tt == jt
    _parses(ttel, tt)
    pat = re.compile(r'^ray_tpu_tele_rt_hist_bucket\{.*le="([^"]+)".* (\d+)$')
    les = [float(m.group(1)) for m in map(pat.match, tt.splitlines()) if m]
    assert les == [0.1, 0.5, 1.0, 5.0, float("inf")]
    assert 'ray_tpu_tele_rt_hist_count{source="t"} 4' in tt
    # merged per-process snapshots render alike too
    snaps = [_fill(tmetrics, "tele_rt"), _fill(tmetrics, "tele_rt")]
    assert tmetrics.render_prometheus(tmetrics.merge_snapshots(snaps)) == \
        jmetrics.render_prometheus(jmetrics.merge_snapshots(snaps))


def test_metric_type_conflict_and_tag_checks():
    tmetrics.Counter("tele_conflict", "c")
    with pytest.raises(ValueError, match="already registered"):
        tmetrics.Gauge("tele_conflict", "g")
    g = tmetrics.Gauge("tele_tags", "g", tag_keys=("a",))
    with pytest.raises(ValueError, match="tag keys"):
        g.set(1.0, tags={"b": "x"})
    with pytest.raises(ValueError, match="value > 0"):
        tmetrics.Counter("tele_pos", "c").inc(0)


# ---------------------------------------------------------------------------
# tracing ring + context propagation
# ---------------------------------------------------------------------------

@pytest.fixture(params=["jax", "port"])
def tracing(request, monkeypatch):
    mod = PKG[request.param][1]
    monkeypatch.setattr(mod, "_enabled", True)
    prev_cap = mod.max_spans()
    mod.clear_spans()
    yield mod
    mod.set_max_spans(prev_cap)
    mod.clear_spans()


def test_tracing_ring_cap_counts_evictions(tracing):
    tracing.set_max_spans(4)
    for i in range(10):
        with tracing.span(f"ring{i}"):
            pass
    assert [s["name"] for s in tracing.get_spans()] == \
        ["ring6", "ring7", "ring8", "ring9"]
    assert tracing.dropped_spans() == 6
    assert tracing.ingest([{"name": "x"}] * 3) == 3
    assert tracing.dropped_spans() == 9
    assert len(tracing.drain_spans()) == 4 and tracing.get_spans() == []


def test_tracing_context_attached_across_a_thread(tracing):
    got = {}

    def worker(ctx):
        token = tracing.attach_context(ctx)
        try:
            with tracing.span("child") as c:
                got["child"] = c
        finally:
            tracing.detach_context(token)

    with tracing.span("parent") as p:
        t = threading.Thread(target=worker,
                             args=(tracing.capture_context(),))
        t.start()
        t.join()
    assert got["child"]["parent_span_id"] == p["span_id"]
    assert got["child"]["trace_id"] == p["trace_id"]
    assert tracing.propagation_context(p) == {"trace_id": p["trace_id"],
                                              "span_id": p["span_id"]}
    got.clear()
    t = threading.Thread(target=worker, args=(None,))
    t.start()
    t.join()
    assert got["child"]["parent_span_id"] is None
    events = tracing.spans_to_chrome_trace()
    assert {e["name"] for e in events} == {"parent", "child"}
    assert all(e["ph"] == "X" for e in events)


def test_tracing_off_path_and_manual_spans():
    assert ttracing.probe_disabled_overhead_ns(1000) > 0
    ttracing.clear_spans()
    s, tok = ttracing.start_span("manual", {"a": 1})
    ttracing.end_span(s, tok, error="boom")
    (got,) = ttracing.get_spans()
    assert got["status"] == "ERROR" and got["attributes"]["exception"] == \
        "boom"
    ttracing.clear_spans()


# ---------------------------------------------------------------------------
# flight recorder (hooks driven directly)
# ---------------------------------------------------------------------------

def _hooks(rec, rid, outcome="finished", tokens=3):
    rec.on_submit(rid, 5)
    rec.on_admit(rid, 4, True)
    rec.on_prefill_chunk(rid, 8, 8, 1e-4)
    rec.on_kv_import(rid, 2, 1024, 2e-4)
    rec.on_first_token(rid, 2e-3)
    for _ in range(tokens):
        rec.on_token(rid)
    rec.on_swap_crossing(rid)
    rec.on_handoff(rid, 3e-3)
    rec.on_finish(rid, outcome)


def _shape(spans):
    """Spans as (name, parent: "root" | None | "outside", attributes)
    without ids and times; the root's engine name dropped."""
    roots = {s["span_id"] for s in spans if s["name"] == "engine.request"}
    out = []
    for s in spans:
        attrs = {k: v for k, v in s["attributes"].items() if k != "engine"}
        par = s["parent_span_id"]
        out.append((s["name"], "root" if par in roots else par, attrs))
    return out


def test_recorder_spans_match_jax():
    recs = {w: PKG[w][2].FlightRecorder(f"recunit-{w}", sample=1.0,
                                        max_spans=64) for w in PKG}
    for rec in recs.values():
        _hooks(rec, 1)
        rec.on_submit(2, 3)
        rec.on_kv_export(2, 1, 512, 1e-4)
        rec.on_finish(2, "handoff")
    assert _shape(recs["port"].get_spans()) == _shape(recs["jax"].get_spans())
    spans = recs["port"].get_spans()
    root = next(s for s in spans if s["name"] == "engine.request")
    assert root["attributes"]["outcome"] == "finished"
    assert root["attributes"]["tokens"] == 3
    for s in spans:
        assert s["end_ns"] >= s["start_ns"]
    events = recs["port"].chrome_events()
    assert {e["ph"] for e in events} == {"X", "i"}
    inst = next(e for e in events if e["name"] == "first_token")
    assert inst["s"] == "t" and inst["tid"] == "recunit-port/r1"
    drained = recs["port"].drain_spans()
    assert len(drained) == len(spans) and recs["port"].get_spans() == []
    assert drained[0]["lane"] == "recunit-port/r1"
    recs["port"].check_invariants()


def test_recorder_ring_bound_sampling_and_cancel():
    rec = ttel.FlightRecorder("recunit-b", sample=1.0, max_spans=8)
    for rid in range(5):
        _hooks(rec, rid)
    assert len(rec.get_spans()) == 8 and rec.dropped_spans > 0
    rec.check_invariants()
    rec.clear()
    assert rec.get_spans() == [] and rec.dropped_spans == 0
    off = ttel.FlightRecorder("recunit-c", sample=0.0)
    _hooks(off, 1)
    assert off.requests_seen == 1 and off.requests_traced == 0
    assert off.get_spans() == [] and off.live_requests() == 0
    rec = ttel.FlightRecorder("recunit-d", sample=1.0)
    rec.on_submit(7, 3)
    rec.on_finish(7, "cancelled")           # cancelled while still queued
    spans = rec.get_spans()
    queue = next(s for s in spans if s["name"] == "queue_wait")
    assert queue["end_ns"] is not None
    assert "decode" not in {s["name"] for s in spans}
    jrec = jtel.FlightRecorder("recunit-dj", sample=1.0)
    jrec.on_submit(7, 3)
    jrec.on_finish(7, "cancelled")
    assert _shape(spans) == _shape(jrec.get_spans())


def test_recorder_histograms_reach_the_registry():
    rec = ttel.FlightRecorder("recunit-h", sample=1.0)
    _hooks(rec, 1, tokens=4)
    for name in ("engine_queue_wait_ms", "engine_ttft_ms", "engine_tpot_ms",
                 "engine_kv_import_ms", "serve_handoff_ms"):
        assert (("source", "recunit-h"),) in _series(tmetrics, name), name


# ---------------------------------------------------------------------------
# retrace sentinel
# ---------------------------------------------------------------------------

def test_sentinel_counts_into_the_registry(caplog):
    count = [1]
    s = ttel.RetraceSentinel("sentunit-a")
    s.watch("decode", lambda: count[0], cap=1, registered=True)
    with pytest.raises(ValueError, match="RETRACE_WATCHES"):
        s.watch("nope", lambda: 0, registered=True)
    with caplog.at_level(logging.WARNING,
                         logger="ray_tpu_torch.util.telemetry"):
        count[0] = 3
        assert s.check() == 2
        count[0] = 4
        assert s.check() == 1
    assert len([r for r in caplog.records
                if "retrace sentinel" in r.message]) == 1
    assert _series(tmetrics, "retraces_unexpected")[
        (("source", "sentunit-a"),)] == 3.0
    sent = next(x for x in ttel.summary()["sentinels"]
                if x["name"] == "sentunit-a")
    assert sent["retraces_unexpected"] == 3 and sent["watching"]


# ---------------------------------------------------------------------------
# stats() -> metrics bridge
# ---------------------------------------------------------------------------

class _Source:
    def __init__(self):
        self.d = {"decode_tokens": 5, "occupancy": 0.5,
                  "spec": "off-string-skipped", "flag": True,
                  "per_class": {"0": {"sheds": 2, "queue_wait_ms_p50": 1.5}}}

    def stats(self):
        return dict(self.d)


def _bridge_trace(metrics, tel, name):
    """Counter deltas across a reset, gauges and a class-tagged row
    through one package's bridge."""
    src = _Source()
    final = tel.register_stats_source(name, src, kind="bridge")
    key = (("source", final),)
    seen = [_series(metrics, "bridge_decode_tokens")[key]]
    src.d["decode_tokens"] = 8
    seen.append(_series(metrics, "bridge_decode_tokens")[key])
    src.d["decode_tokens"] = 2              # upstream reset_stats()
    seen.append(_series(metrics, "bridge_decode_tokens")[key])
    ckey = (("class", "0"), ("source", final))
    out = {"counter": seen,
           "gauge": _series(metrics, "bridge_occupancy")[key],
           "skipped": (key in _series(metrics, "bridge_spec"),
                       key in _series(metrics, "bridge_flag")),
           "class": (_series(metrics, "bridge_per_class_sheds")[ckey],
                     _series(metrics, "bridge_per_class_queue_wait_ms_p50")[
                         ckey]),
           "listed": final in tel.summary()["stats_sources"]}
    del src
    gc.collect()
    metrics.snapshot()                      # the collect prunes the weakref
    out["pruned"] = final not in tel.summary()["stats_sources"]
    return out


def test_stats_bridge_matches_jax():
    # a source name no other test registers: the reference's counters
    # live for the process, and `tests/test_telemetry.py` registers
    # "bridgeunit" in the JAX package's plane, which would carry its
    # totals into this trace when both files share a test process
    got = _bridge_trace(tmetrics, ttel, "bridgeparity")
    assert got == _bridge_trace(jmetrics, jtel, "bridgeparity")
    assert got["counter"] == [5.0, 8.0, 10.0] and got["gauge"] == 0.5
    assert got["skipped"] == (False, False) and got["pruned"]


def test_duplicate_source_names_uniquified():
    a, b = _Source(), _Source()
    na = ttel.register_stats_source("bridgedup", a, kind="bridge")
    nb = ttel.register_stats_source("bridgedup", b, kind="bridge")
    try:
        assert (na, nb) == ("bridgedup", "bridgedup-2")
        assert ttel.register_stats_source("bridgedup", a) == "bridgedup"
    finally:
        ttel.unregister_stats_source(na)
        ttel.unregister_stats_source(nb)
    assert "bridgedup" not in ttel.summary()["stats_sources"]


def test_mfu_helpers():
    peak = ttel.device_peak_flops()
    assert peak == ttel.device_peak_flops("cpu") == 989e12
    assert ttel.mfu(peak * 4, n_devices=4) == pytest.approx(1.0)
    assert ttel.mfu(0.0) == 0.0
    # the same helper contract as the reference's
    jpeak = jtel.device_peak_flops()
    assert jtel.mfu(jpeak * 4, n_devices=4) == pytest.approx(1.0)
    assert ttel.COUNTER_KEYS == jtel.COUNTER_KEYS


# ---------------------------------------------------------------------------
# engines: the same traffic through both, recorders compared
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    p = jgpt.init_params(jax.random.PRNGKey(0), jgpt.GPTConfig(**CFG))
    return {**p, "embed": p["embed"] * 8}


@pytest.fixture
def fake_clock(monkeypatch):
    ns = types.SimpleNamespace(perf_counter=lambda: 1000.0,
                               sleep=time.sleep)
    for mod in (jengine, tengine):
        monkeypatch.setattr(mod, "time", ns)


def _make(which, params, **kw):
    kw = {**ENGINE, **kw}
    if which == "jax":
        return jengine.InferenceEngine(params, jgpt.GPTConfig(**CFG), **kw)
    cfg = tgpt.GPTConfig(**CFG)
    return tengine.InferenceEngine(
        tgpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                               device="cpu"), cfg, device="cpu", **kw)


def _drain(eng, rid):
    return [int(t) for t in eng.tokens_for(rid)]


def _traffic(which, params):
    """Greedy traffic with every recorder outcome: a shared prefix (a
    prefix hit and a copy-on-write), a chunked prompt, a class-2 arrival
    that preempts a decoding class-0 stream, a class-1 submit that sheds
    a queued class-0 request, a cancel, and a prefill -> decode handoff.
    Returns the engines (recorders) and the token streams."""
    eng = _make(which, params, cache_blocks=9, priority_classes=3,
                max_queue=2, prefill_chunk=8)
    shared = list(range(1, 11))
    outs = [_drain(eng, eng.submit(shared + [20, 21], max_new_tokens=3)),
            _drain(eng, eng.submit(shared + [30], max_new_tokens=3))]
    ra = eng.submit(np.arange(40, 52, dtype=np.int32), max_new_tokens=6)
    for _ in range(4):
        eng.step()
    rb = eng.submit(np.full(12, 9, np.int32), max_new_tokens=6, priority=2)
    rc = eng.submit([1, 2, 3], max_new_tokens=2)
    rd = eng.submit([4, 5, 6], max_new_tokens=2, priority=1)   # sheds rc
    eng.cancel(rd)                           # cancelled while queued
    outs += [_drain(eng, r) for r in (ra, rb)]
    with pytest.raises(Exception, match="overloaded"):
        _drain(eng, rc)
    eng.check_invariants()
    pre = _make(which, params, role="prefill")
    dec = _make(which, params, role="decode")
    blob = pre.handoff_for(pre.submit(shared + [50, 51], max_new_tokens=4))
    rid = dec.import_handoff(blob)
    dec._recorder.on_handoff(rid, 1e-3)      # the harness drives it
    outs.append(_drain(dec, rid))
    return (eng, pre, dec), outs


@pytest.fixture(scope="module")
def jax_traffic(params):
    mp = pytest.MonkeyPatch()
    mp.setattr(jengine, "time", types.SimpleNamespace(
        perf_counter=lambda: 1000.0, sleep=time.sleep))
    try:
        engines, outs = _traffic("jax", params)
    finally:
        mp.undo()
    return [_shape(e._recorder.get_spans()) for e in engines], outs, \
        engines[0].stats()


def test_engine_recorder_matches_jax(params, jax_traffic, fake_clock):
    jshapes, jouts, jstats = jax_traffic
    engines, outs = _traffic("port", params)
    assert outs == jouts
    st = engines[0].stats()
    for k in ("preemptions", "sheds", "cancelled", "prefix_hit_tokens",
              "cow_copies", "prefill_chunks"):
        assert st[k] == jstats[k], k
    assert st["preemptions"] >= 1 and st["sheds"] == 1
    assert st["cancelled"] == 1 and st["cow_copies"] >= 1
    for eng, want in zip(engines, jshapes):
        assert _shape(eng._recorder.get_spans()) == want
        eng._recorder.check_invariants()
    outcomes = [a["outcome"] for e in engines
                for n, _, a in _shape(e._recorder.get_spans())
                if n == "engine.request"]
    assert {"finished", "shed", "cancelled", "handoff",
            "preempted:block-pressure"} <= set(outcomes)
    names = {n for e in engines for n, _, _ in _shape(e._recorder.get_spans())}
    assert {"prefill_chunk", "first_token", "decode", "queue_wait",
            "kv_export", "kv_import", "handoff"} <= names
    ttel.check_invariants()


def test_telemetry_sample_zero_records_nothing(params):
    eng = _make("port", params, telemetry_sample=0.0)
    _drain(eng, eng.submit([4, 2], max_new_tokens=3))
    rec = eng._recorder
    assert rec.requests_seen == 1 and rec.requests_traced == 0
    assert rec.get_spans() == [] and eng.stats()["ttft_ms_p50"] > 0
    # on a mesh of one rank the engine records as on one card (on a
    # mesh of more, the first rank records: tests/test_torch_serve_mesh.py)
    from ray_tpu_torch.parallel import single_device_mesh
    one = _make("port", params, telemetry_sample=0.0,
                mesh=single_device_mesh())
    _drain(one, one.submit([4, 2], max_new_tokens=3))
    assert one._recorder.requests_seen == 1
    assert one._recorder.get_spans() == []


def test_swap_crossing_and_engine_series(params):
    eng = _make("port", params)
    _drain(eng, eng.submit([1, 2, 3], max_new_tokens=2))
    eng.update_params(jax.tree.map(np.asarray, params))
    _drain(eng, eng.submit([1, 2, 3], max_new_tokens=2))
    assert "swap_crossing" in {s["name"] for s in eng._recorder.get_spans()}
    key = (("source", eng.name),)
    assert _series(tmetrics, "engine_decode_tokens")[key] == \
        eng.stats()["decode_tokens"]
    assert _series(tmetrics, "engine_swaps")[key] == 1.0
    assert key in _series(tmetrics, "engine_ttft_ms")
    text = tmetrics.render_prometheus(tmetrics.snapshot())
    assert f'ray_tpu_engine_decode_tokens{{source="{eng.name}"}}' in text
    _parses(ttel, text)
    events = ttel.chrome_trace_events()
    assert any(e["cat"] == "request" and e["name"] == "engine.request"
               for e in events)


def test_decode_replica_pull_records_the_handoff(monkeypatch):
    monkeypatch.setenv("RAY_TPU_NODE_IP", "127.0.0.1")
    config.reset_caches()
    kw = dict(cfg_kwargs=CFG, slots=2, max_len=64, seed=0, device="cpu")
    pre, dec = PrefillReplica(**kw), DecodeReplica(**kw)
    try:
        toks = list(dec.resume_from(pre([5, 9, 3, 17, 2, 88, 41, 7, 19],
                                        max_new_tokens=4)))
        assert len(toks) == 4
        spans = dec.engine._recorder.get_spans()
        assert {"kv_import", "handoff"} <= {s["name"] for s in spans}
        assert "kv_export" in {s["name"]
                               for s in pre.engine._recorder.get_spans()}
        assert (("source", dec.engine.name),) in _series(
            tmetrics, "serve_handoff_ms")
    finally:
        pre.close()
        dec.close()
        config.reset_caches()


# ---------------------------------------------------------------------------
# train loop
# ---------------------------------------------------------------------------

def _loop_stats(loop_mod, step_fn, batches, unroll=1):
    tl = loop_mod.TrainLoop(step_fn, unroll=unroll, metrics_interval=2,
                            flops_per_step=1e9)
    tl.run(0, iter(batches), num_steps=4)
    return tl


def test_train_loop_stats_match_jax():
    def tstep(state, batch):
        return state + 1, {"loss": torch.tensor(0.5)}

    def jstep(state, batch):
        return state + 1, {"loss": np.float32(0.5)}

    tl = _loop_stats(tloop, tstep, [{"x": torch.zeros(2)}] * 4)
    jl = _loop_stats(jloop, jstep, [{"x": np.zeros(2)}] * 4)
    st = tl.stats()
    assert set(st) == set(jl.stats())
    assert st["steps"] == 4 and st["retraces_unexpected"] == 0
    assert st["mfu"] == tl.last_mfu > 0 and st["dispatch_traces"] == 0
    key = (("source", tl.name),)
    assert _series(tmetrics, "train_goodput")[key] == tl.last_goodput
    assert tl.name.startswith("train")


def test_fused_dispatch_watch_counts_new_signatures():
    def step(state, batch):
        return state + 1, {"loss": batch["x"].sum()}

    tl = tloop.TrainLoop(step, unroll=2, metrics_interval=2)
    tl.run(0, iter([{"x": torch.zeros(2, 3)}] * 3), num_steps=6)
    assert tl.stats()["dispatch_traces"] == 1
    assert tl.stats()["retraces_unexpected"] == 0
    tl.run(0, iter([{"x": torch.zeros(2, 5)}]), num_steps=2)
    st = tl.stats()
    assert st["dispatch_traces"] == 2 and st["retraces_unexpected"] == 1


# ---------------------------------------------------------------------------
# self-test
# ---------------------------------------------------------------------------

def test_check_invariants_passes_after_traffic(params):
    eng = _make("port", params)
    _drain(eng, eng.submit([5, 9, 3], max_new_tokens=4))
    ttel.check_invariants()
    s = ttel.summary()
    rec = next(r for r in s["recorders"] if r["name"] == eng.name)
    assert rec["requests_traced"] == 1 and rec["spans"] >= 5
    assert next(x for x in s["sentinels"] if x["name"] == eng.name)[
        "watching"]


def test_check_invariants_catches_an_overflowed_ring():
    rec = ttel.FlightRecorder("selftest-neg", max_spans=2)
    rec._spans.extend({"name": "x"} for _ in range(5))
    with pytest.raises(AssertionError):
        ttel.check_invariants()
    del rec
    gc.collect()
    ttel.check_invariants()
