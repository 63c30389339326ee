"""Scheduling under pressure in the port (`ray_tpu_torch.serve.engine`)
against the JAX engine, on the CPU: priority classes, block-pressure and
forced preemption with resume, class-ordered shedding, the tick watchdog
and the engine's fault sites. It follows `tests/test_priority_preempt.py`
and `tests/test_serve_chaos.py`'s engine cases with the port beside the
reference: the same tiny config on peaked params (embed x 8, so greedy
argmaxes are decisive), the same traffic, and the same `FaultPlan`
installed in each package's own `faults` module.

Held equal to the JAX engine: greedy tokens (logprobs within 1e-4, f32
summation order), `faults.fired()` logs, the pressure counters
(``preemptions``, ``reprefill_blocks``, ``evicted_blocks``, ``sheds``,
``aging_promotions``, ``per_class``), the requests shed at `submit` and
through `tokens_for`, the admission order (stride shares, and aging under
one fake clock that drives both modules), the validation errors and the
`stats()` key set. A preempted greedy stream resumes with the tokens of
its unpressured run (logprobs within 1e-4). Two of the reference's own
resume tests fail on the CPU by a last-bit logprob (ROADMAP C, oracle
caveats): for those two cases (copy-on-write and mid-prefill) the port is
held to its own unpressured run, and to the reference's counters only.

Also two faults the port had against the reference, repaired: a prefill
that spans `update_params` publishes no blocks, and a parked first token
keeps the version it was computed under."""

import gc
import threading
import time
import types

import jax
import numpy as np
import pytest

from ray_tpu.exceptions import OverloadedError as JaxOverloadedError
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import engine as jengine
from ray_tpu.util import faults as jfaults
from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import InferenceReplica
from ray_tpu_torch.serve import engine as tengine
from ray_tpu_torch.serve import priority as tpriority
from ray_tpu_torch.util import faults as tfaults

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64, dtype="float32")
ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=4)
PROMPT = np.arange(1, 9, dtype=np.int32)          # 8 tokens = 2 blocks
FAULTS = {"jax": jfaults, "port": tfaults}
OVERLOADED = {"jax": JaxOverloadedError, "port": OverloadedError}
COUNTERS = ("preemptions", "reprefill_blocks", "evicted_blocks", "sheds",
            "aging_promotions", "prefix_hit_tokens", "decode_steps")
# Requests shed by the burst scenarios: (at submit, through tokens_for).
# chip_smoke.py phase 14 (c) runs the same shapes at full width and
# asserts these counts.
SHED_COUNTS = {"max_queue": (4, 4), "high_water": (1, 2)}


@pytest.fixture(scope="module")
def params():
    p = jgpt.init_params(jax.random.PRNGKey(0), jgpt.GPTConfig(**CFG))
    return {**p, "embed": p["embed"] * 8}


class _FakeClock:
    """One clock for both engines' modules (their ``time`` replaced by a
    namespace whose ``perf_counter`` reads it): admission order depends
    on queue ages, and the JAX engine's first ticks compile."""

    def __init__(self):
        self.now = 1000.0

    def install(self, monkeypatch):
        ns = types.SimpleNamespace(perf_counter=lambda: self.now,
                                   sleep=time.sleep)
        for mod in (jengine, tengine):
            monkeypatch.setattr(mod, "time", ns)


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """Every test runs on one frozen fake clock, advanced by the tests of
    aging; the tests of real stalls (the watchdog's) restore the real
    clock with ``monkeypatch.undo()``."""
    c = _FakeClock()
    c.install(monkeypatch)
    return c


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in FAULTS.values():
        f.clear()
    yield
    for f in FAULTS.values():
        f.clear()


def _cfg(which, **kw):
    return (jgpt if which == "jax" else tgpt).GPTConfig(**{**CFG, **kw})


def _make(which, params, **kw):
    """An engine of ``which`` ("jax" or "port") over ``params`` (the JAX
    tree, carried to the port as numpy), with ENGINE's defaults."""
    kw = {**ENGINE, **kw}
    if which == "jax":
        return jengine.InferenceEngine(params, _cfg("jax"), **kw)
    if "draft_params" in kw:
        dcfg = _cfg("port", n_layers=1)
        kw["draft_params"] = tgpt.params_from_numpy(
            jax.tree.map(np.asarray, kw["draft_params"]), dcfg, device="cpu")
        kw["draft_cfg"] = dcfg
    cfg = _cfg("port")
    return tengine.InferenceEngine(
        tgpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                               device="cpu"), cfg, device="cpu", **kw)


def _draft_kw(params):
    """A 1-layer draft model: the target's first layer."""
    return dict(spec="draft", spec_k=3, draft_cfg=_cfg("jax", n_layers=1),
                draft_params={**params, "layers": jax.tree.map(
                    lambda x: x[:1], params["layers"])})


def _drain(eng, rid):
    return [(int(t), t.logprob, t.params_version)
            for t in eng.tokens_for(rid)]


def _run_all(eng, steps=2000, audit=False):
    for _ in range(steps):
        alive = eng.step()
        if audit:
            eng.check_invariants()
        if not alive:
            return
    raise AssertionError("engine did not go idle")


def _assert_same(got, want):
    """Per request: identical tokens and versions, logprobs to 1e-4."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(t, v) for t, _, v in g] == [(t, v) for t, _, v in w]
        np.testing.assert_allclose([lp for _, lp, _ in g],
                                   [lp for _, lp, _ in w], atol=1e-4, rtol=0)


def _counters(st):
    out = {k: st[k] for k in COUNTERS}
    out["per_class"] = {c: {k: v for k, v in row.items()
                            if not k.startswith("queue_wait")}
                        for c, row in st["per_class"].items()}
    return out


def _both(params, scenario):
    """``scenario(make, faults)`` run on the JAX engine with JAX's faults
    module, then on the port with the port's; each returns a dict."""
    out = {}
    for which in ("jax", "port"):
        FAULTS[which].clear()
        out[which] = scenario(
            lambda **kw: _make(which, params, **kw), FAULTS[which])
        FAULTS[which].clear()
    return out["jax"], out["port"]


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------

def _block_pressure(make, faults):
    """cache_blocks=7 leaves 6 usable blocks, 4 a request: a class-2
    arrival is served only by preempting the decoding class-0 stream."""
    eng = make(cache_blocks=7)
    ra = eng.submit(PROMPT, max_new_tokens=6, priority=0)
    for _ in range(4):
        eng.step()
    rb = eng.submit(np.full(8, 9, np.int32), max_new_tokens=6, priority=2)
    _run_all(eng, audit=True)
    return eng, [ra, rb]


def _forced(at, kw=None, prompt=PROMPT, new=6):
    def scenario(make, faults):
        faults.install(faults.FaultPlan(seed=3).fail("engine.preempt", at=at,
                                                      times=1))
        eng = make(cache_blocks=32, **(kw or {}))
        rid = eng.submit(prompt, max_new_tokens=new, priority=0)
        _run_all(eng, audit=True)
        return eng, [rid]
    return scenario


def _cow(make, faults):
    """The victim shares two prefix blocks with a class-1 sibling."""
    shared = np.arange(1, 9, dtype=np.int32)
    eng = make(cache_blocks=64)
    rids = [eng.submit(np.concatenate([shared, tail]).astype(np.int32),
                       max_new_tokens=6, priority=c)
            for c, tail in enumerate(([20, 21, 22, 23], [30, 31, 32, 33]))]
    for _ in range(2):
        eng.step()
    faults.install(faults.FaultPlan(seed=5).fail("engine.preempt", at=0,
                                                  times=1))
    _run_all(eng, audit=True)
    return eng, rids


def _mid_prefill(make, faults):
    """The victim is caught mid-prefill, before its first token."""
    faults.install(faults.FaultPlan(seed=2).fail("engine.preempt", at=1,
                                                  times=1))
    eng = make(cache_blocks=32, prefill_chunk=4)
    rid = eng.submit(np.arange(1, 17, dtype=np.int32), max_new_tokens=4)
    _run_all(eng, audit=True)
    return eng, [rid]


def _with_outputs(scenario):
    def run(make, faults):
        eng, rids = scenario(make, faults)
        outs = [_drain(eng, r) for r in rids]
        eng.check_invariants()
        return {"outs": outs, "fired": faults.fired(),
                "stats": _counters(eng.stats())}
    return run


def _unpressured(make, requests, **kw):
    """The same requests one at a time through a roomy engine."""
    eng = make(cache_blocks=64, **kw)
    return [_drain(eng, eng.submit(p, max_new_tokens=n)) for p, n in requests]


MOTIF = np.tile([5, 6, 7, 8], 2).astype(np.int32)


@pytest.mark.parametrize("case", ["block_pressure", "forced", "ngram",
                                  "draft"])
def test_preempted_stream_resumes_like_jax(params, case):
    """Real block pressure, the ``engine.preempt`` site, and both spec
    backends under it: the port's tokens, fault log and pressure counters
    (re-prefilled blocks among them) equal the JAX engine's, and each
    preempted greedy stream equals its own unpressured run."""
    kw, requests = {}, [(PROMPT, 6)]
    if case == "block_pressure":
        scenario = _block_pressure
        requests.append((np.full(8, 9, np.int32), 6))
    elif case == "forced":
        scenario = _forced(at=2)
    else:
        kw = ({"spec": "ngram", "spec_k": 3} if case == "ngram"
              else _draft_kw(params))
        scenario = _forced(at=1, kw=kw, prompt=MOTIF, new=8)
        requests = [(MOTIF, 8)]
    j, t = _both(params, _with_outputs(scenario))
    _assert_same(t["outs"], j["outs"])
    assert t["fired"] == j["fired"]
    assert t["stats"] == j["stats"]
    assert t["stats"]["preemptions"] >= 1
    assert t["stats"]["per_class"]["0"]["preemptions"] >= 1
    if case == "block_pressure":
        assert t["fired"] == []
    if case == "forced":
        # the victim's written blocks went into the radix tree, so its
        # resume prefills again at most the 2 trailing blocks
        assert 0 <= t["stats"]["reprefill_blocks"] <= 2
        assert t["stats"]["prefix_hit_tokens"] > 0
    _assert_same(t["outs"], _unpressured(
        lambda **k: _make("port", params, **k), requests, **kw))


@pytest.mark.parametrize("case", ["cow", "mid_prefill"])
def test_preempted_stream_resumes_like_its_unpressured_run(params, case):
    """The two cases whose reference tests are oracle caveats: the port
    against its own run without the plan (tokens identical, logprobs to
    1e-4), and against the JAX engine's fault log and counters."""
    scenario = _with_outputs(_cow if case == "cow" else _mid_prefill)
    j, t = _both(params, scenario)
    assert t["fired"] == j["fired"] and len(t["fired"]) == 1
    assert t["stats"] == j["stats"]
    assert t["stats"]["preemptions"] == 1

    no_plan = types.SimpleNamespace(FaultPlan=tfaults.FaultPlan,
                                    install=lambda plan: None,
                                    fired=tfaults.fired)
    calm = scenario(lambda **kw: _make("port", params, **kw), no_plan)
    assert calm["stats"]["preemptions"] == 0
    _assert_same(t["outs"], calm["outs"])


def test_preemption_fuzz_matches_jax(params):
    """Probabilistic forced preemption over six requests in three
    classes, invariants checked after every tick: the port's streams, log
    and counters equal the JAX engine's, every stream equals its
    unpressured run, and no block leaks."""
    prompts = [(PROMPT + i, 4 + (i % 3)) for i in range(6)]

    def scenario(make, faults):
        faults.install(faults.FaultPlan(seed=21).fail(
            "engine.preempt", p=0.3, times=None))
        eng = make(cache_blocks=64, priority_classes=3)
        rids = [eng.submit(p, max_new_tokens=n, priority=i % 3)
                for i, (p, n) in enumerate(prompts)]
        _run_all(eng, audit=True)
        outs = [_drain(eng, r) for r in rids]
        eng.check_invariants()
        eng._tree.flush()
        return {"outs": outs, "fired": faults.fired(),
                "stats": _counters(eng.stats()), "free": eng._alloc.free}

    j, t = _both(params, scenario)
    _assert_same(t["outs"], j["outs"])
    assert t["fired"] == j["fired"] and t["stats"] == j["stats"]
    assert t["stats"]["preemptions"] >= 1
    assert t["free"] == j["free"] == 64
    _assert_same(t["outs"], _unpressured(
        lambda **k: _make("port", params, **k), prompts))


# ---------------------------------------------------------------------------
# admission order: stride shares and aging
# ---------------------------------------------------------------------------

def _admission_sequence(eng, rids, steps=400):
    """The class of each request in the order it was admitted (slots=1:
    a request may be admitted and finish within one tick, so the done set
    is read too)."""
    seen, order = set(), []
    for _ in range(steps):
        alive = eng.step()
        for rid in [s.rid for s in eng._slots if s.active] + sorted(
                eng._done):
            if rid not in seen:
                seen.add(rid)
                order.append(rids[rid])
        if not alive:
            break
    return order


def test_weighted_shares_match_jax(params):
    """slots=1, classes 0 and 1 backlogged, weight base 2, aging off:
    the port admits in the JAX engine's stride order, about two class-1
    admissions to each class-0 one, never a starved run."""
    def scenario(make, faults):
        eng = make(slots=1, cache_blocks=64, priority_classes=2,
                   priority_weight_base=2.0, priority_aging_s=3600.0)
        rids = {}
        for i in range(6):
            rids[eng.submit(PROMPT + i, max_new_tokens=2, priority=0)] = 0
            rids[eng.submit(PROMPT + 10 + i, max_new_tokens=2,
                            priority=1)] = 1
        order = _admission_sequence(eng, rids)
        eng.check_invariants()
        return {"order": order, "stats": _counters(eng.stats())}

    j, t = _both(params, scenario)
    assert t == j
    order = t["order"]
    assert len(order) == 12 and sorted(order[:3]) == [0, 1, 1], order
    for k in range(1, 13):
        if order[:k].count(1) < 6:
            assert order[:k].count(1) >= (2 * k) // 3 - 1, (k, order)


def test_aging_under_one_fake_clock(params, clock):
    """A class-0 request past its aging bound is admitted ahead of fresher
    class-1 traffic; then sustained class-2 traffic (two requests a tick
    for 30 ticks, the clock advancing 20 ms a tick) cannot starve three
    class-0 requests. One fake clock
    drives both engines: identical admission orders, promotions and
    per-class counters."""

    def aged_first(make, faults):
        eng = make(slots=1, cache_blocks=64, priority_classes=2,
                   priority_aging_s=0.01)
        rids = {eng.submit(PROMPT, max_new_tokens=2, priority=0): 0}
        clock.now += 0.05                # > (2 - 0) * 0.01
        for i in range(3):
            rids[eng.submit(PROMPT + 10 + i, max_new_tokens=2,
                            priority=1)] = 1
        return {"order": _admission_sequence(eng, rids),
                "stats": _counters(eng.stats())}

    def sustained(make, faults):
        # weight base 64: class 0's stride share is 1/4096 of class 2's,
        # so only aging admits it while class 2 is backlogged
        eng = make(slots=1, cache_blocks=64, priority_classes=3,
                   priority_aging_s=0.2, priority_weight_base=64.0)
        rids = {eng.submit(PROMPT + i, max_new_tokens=2, priority=0): 0
                for i in range(3)}
        order, seen = [], set()
        for fed in range(3000):
            alive = eng.step()
            clock.now += 0.02
            for _ in range(2 if fed < 30 else 0):
                rids[eng.submit(PROMPT + 40 + fed % 8, max_new_tokens=2,
                                priority=2)] = 2
            for rid in [s.rid for s in eng._slots if s.active] + sorted(
                    eng._done):
                if rid not in seen:
                    seen.add(rid)
                    order.append(rids[rid])
            if not alive and fed >= 30:
                break
        eng.check_invariants()
        return {"order": order, "stats": _counters(eng.stats())}

    j, t = _both(params, aged_first)
    assert t == j and t["order"][0] == 0, t["order"]
    assert t["stats"]["aging_promotions"] >= 1
    j, t = _both(params, sustained)
    assert t == j
    assert t["stats"]["per_class"]["0"]["completed"] == 3
    assert t["stats"]["per_class"]["2"]["completed"] == 60
    assert t["stats"]["aging_promotions"] >= 1


# ---------------------------------------------------------------------------
# class-ordered shedding
# ---------------------------------------------------------------------------

def _shedding(kw, submits, ticks_between=()):
    """``submits``: (prompt offset, max_new_tokens, class) in order, with
    a tick before the indices in ``ticks_between``. Records which were
    refused at submit and which raised through `tokens_for`, and every
    other request's tokens."""
    def scenario(make, faults):
        eng = make(**kw)
        rids, at_submit = [], []
        which = "jax" if faults is jfaults else "port"
        for i, (off, new, c) in enumerate(submits):
            if i in ticks_between:
                eng.step()
            try:
                rids.append(eng.submit(PROMPT + off, max_new_tokens=new,
                                       priority=c))
            except OVERLOADED[which]:
                rids.append(None)
                at_submit.append(i)
        _run_all(eng, audit=True)
        via_tokens, outs = [], {}
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            try:
                outs[i] = _drain(eng, rid)
            except OVERLOADED[which]:
                via_tokens.append(i)
                assert _drain(eng, rid) == []     # raised once
        eng.check_invariants()
        return {"at_submit": at_submit, "via_tokens": via_tokens,
                "outs": outs, "stats": _counters(eng.stats())}
    return scenario


SHED_CASES = {
    # queue full: a class-2 submit sheds the newest queued class-0 one
    "high_evicts_lowest": (dict(slots=1, cache_blocks=64, priority_classes=3,
                                max_queue=2),
                           [(0, 8, 0), (1, 2, 0), (2, 2, 0), (3, 2, 2)], (1,)),
    # one class: nothing queued ranks below, so the submit itself raises
    "same_class_incoming": (dict(slots=1, cache_blocks=64, max_queue=1),
                            [(0, 8, 0), (1, 2, 0), (2, 2, 0)], (1,)),
    # phase 14 (c)'s shapes: 8 class-0 then 4 class-1 before any tick
    "max_queue": (dict(cache_blocks=64, priority_classes=2, max_queue=4),
                  [(i, 6, 0) for i in range(8)]
                  + [(8 + i, 6, 1) for i in range(4)], ()),
    # two 4-block footprints fill half of 16 blocks: 3 class-0 then 2
    # class-1 on a high-water mark of 0.5
    "high_water": (dict(cache_blocks=16, priority_classes=2,
                        shed_high_water=0.5),
                   [(i, 6, 0) for i in range(3)]
                   + [(3 + i, 6, 1) for i in range(2)], ()),
}


@pytest.mark.parametrize("case", list(SHED_CASES))
def test_shedding_matches_jax(params, case):
    """The same requests shed at `submit` and through `tokens_for` (each
    error raised once), the same tokens for the others, the same shed
    counters, as the JAX engine."""
    kw, submits, ticks = SHED_CASES[case]
    j, t = _both(params, _shedding(kw, submits, ticks))
    assert (t["at_submit"], t["via_tokens"]) == (j["at_submit"],
                                                 j["via_tokens"])
    assert t["outs"].keys() == j["outs"].keys()
    _assert_same([t["outs"][i] for i in t["outs"]],
                 [j["outs"][i] for i in j["outs"]])
    assert t["stats"] == j["stats"]
    assert t["stats"]["sheds"] == len(t["at_submit"]) + len(t["via_tokens"])
    if case in SHED_COUNTS:
        assert (len(t["at_submit"]), len(t["via_tokens"])) == \
            SHED_COUNTS[case]


def test_resumed_stream_is_never_shed(params):
    """A preempted stream's queued resume has delivered tokens: a
    higher-class submit on a full queue sheds it not, and raises."""
    eng = _make("port", params, cache_blocks=7, priority_classes=3,
                max_queue=1)
    rid = eng.submit(PROMPT, max_new_tokens=6, priority=0)
    for _ in range(2):
        eng.step()
    rh = eng.submit(PROMPT + 1, max_new_tokens=6, priority=2)
    eng.step()
    assert [q.resumed for q in eng._pending] == [True]
    with pytest.raises(OverloadedError, match="queue full"):
        eng.submit(PROMPT + 2, max_new_tokens=2, priority=2)
    _run_all(eng, audit=True)
    assert len(_drain(eng, rid)) == len(_drain(eng, rh)) == 6


# ---------------------------------------------------------------------------
# the engine's fault sites and the watchdog
# ---------------------------------------------------------------------------

def _chaos(seed):
    def scenario(make, faults):
        faults.install(faults.FaultPlan(seed=seed)
                       .fail("engine.preempt", p=0.25, times=None)
                       .fail("engine.alloc", p=0.2, times=None))
        eng = make(cache_blocks=32, priority_classes=2)
        ra = eng.submit(PROMPT, max_new_tokens=4, priority=0)
        rb = eng.submit(PROMPT + 2, max_new_tokens=4, priority=1)
        _run_all(eng, audit=True)
        return {"outs": [_drain(eng, ra), _drain(eng, rb)],
                "fired": faults.fired(), "stats": _counters(eng.stats())}
    return scenario


def test_same_seed_replays_the_same_faults(params):
    """One seeded plan fires at the same (site, visit, action) sequence in
    both packages and again on a second port run, with the same streams;
    another seed fires elsewhere."""
    j, t = _both(params, _chaos(11))
    assert t["fired"] and t["fired"] == j["fired"]
    assert t["stats"] == j["stats"]
    _assert_same(t["outs"], j["outs"])
    port = lambda **kw: _make("port", params, **kw)   # noqa: E731
    again = _chaos(11)(port, tfaults)
    tfaults.clear()
    assert again["fired"] == t["fired"] and again["outs"] == t["outs"]
    other = _chaos(12)(port, tfaults)
    assert other["fired"] != t["fired"]


def test_alloc_exhaustion_preempts_exactly_as_planned(params):
    """``engine.alloc`` fails at visits 2 and 3, the class-2 admission's
    first two attempts: each preempts one class-0 stream, so exactly two
    preemptions, in both packages."""
    def scenario(make, faults):
        faults.install(faults.FaultPlan(seed=1).fail("engine.alloc", at=2,
                                                      times=2))
        eng = make(slots=3, cache_blocks=64, priority_classes=3)
        ra = eng.submit(PROMPT, max_new_tokens=16, priority=0)
        rb = eng.submit(PROMPT + 1, max_new_tokens=16, priority=0)
        for _ in range(3):
            eng.step()
        rh = eng.submit(PROMPT + 2, max_new_tokens=4, priority=2)
        _run_all(eng, audit=True)
        return {"outs": [_drain(eng, r) for r in (ra, rb, rh)],
                "fired": faults.fired(), "stats": _counters(eng.stats())}

    j, t = _both(params, scenario)
    assert t["fired"] == j["fired"]
    assert [v for site, v, _ in t["fired"] if site == "engine.alloc"] == \
        [2, 3]
    assert t["stats"] == j["stats"] and t["stats"]["preemptions"] == 2
    assert t["stats"]["per_class"]["0"]["preemptions"] == 2
    _assert_same(t["outs"], j["outs"])
    assert [len(o) for o in t["outs"]] == [16, 16, 4]


def test_alloc_fault_without_victim_defers(params):
    """Exhaustion with no lower class active: the request waits a tick,
    nothing is preempted, nothing reaches the consumer."""
    tfaults.install(tfaults.FaultPlan(seed=1).fail("engine.alloc", at=0,
                                                   times=1))
    eng = _make("port", params, cache_blocks=32)
    rid = eng.submit(PROMPT, max_new_tokens=4)
    _run_all(eng, audit=True)
    assert eng.stats()["preemptions"] == 0
    assert len(_drain(eng, rid)) == 4
    assert tfaults.fired() == [("engine.alloc", 0, "fail")]


def test_tick_stall_feeds_the_watchdog(params, monkeypatch):
    """A 0.25 s ``engine.tick`` delay against a 0.05 s watchdog: at least
    one stall counted, and the same tokens as without the plan."""
    monkeypatch.undo()                 # the real clock
    calm = _make("port", params, cache_blocks=32)
    want = _drain(calm, calm.submit(PROMPT, max_new_tokens=4))
    assert calm.stats()["watchdog_stalls"] == 0
    tfaults.install(tfaults.FaultPlan(seed=1).delay(
        "engine.tick", delay_s=0.25, at=1, times=1))
    eng = _make("port", params, cache_blocks=32, watchdog_s=0.05)
    got = _drain(eng, eng.submit(PROMPT, max_new_tokens=4))
    assert got == want
    assert eng.stats()["watchdog_stalls"] >= 1
    assert ("engine.tick", 1, "delay") in tfaults.fired()
    eng.check_invariants()


def test_tick_fault_reaches_the_consumer(params):
    """``engine.tick`` 'fail' is not absorbed: the pumping consumer gets
    `FaultInjected` (the request is then cancelled, as an abandoned
    stream), and the engine serves the next request. The same happens in
    the reference."""
    for which, exc in (("jax", jfaults.FaultInjected),
                       ("port", tfaults.FaultInjected)):
        FAULTS[which].install(FAULTS[which].FaultPlan(seed=1).fail(
            "engine.tick", at=2, times=1))
        eng = _make(which, params, cache_blocks=32)
        rid = eng.submit(PROMPT, max_new_tokens=4)
        with pytest.raises(exc, match="engine.tick"):
            _drain(eng, rid)
        eng.check_invariants()
        assert eng.stats()["active"] == 0 and eng._tick_started is None
        assert len(_drain(eng, eng.submit(PROMPT, max_new_tokens=4))) == 4
        FAULTS[which].clear()


def test_watchdog_thread_ends_with_its_engine(params, monkeypatch):
    """The watchdog holds its engine only by weakref: dropping the engine
    frees it, and the thread ends."""
    monkeypatch.undo()                 # the real clock
    before = {t for t in threading.enumerate() if t.name == "engine-watchdog"}
    eng = _make("port", params, cache_blocks=8, watchdog_s=0.02)
    thread, = [t for t in threading.enumerate()
               if t.name == "engine-watchdog" and t not in before]
    del eng
    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# preempt / resume / cancel interleavings
# ---------------------------------------------------------------------------

def _free_blocks(eng):
    eng._tree.flush()
    return eng._alloc.free


@pytest.mark.parametrize("when", ["resume_queued", "resume_admitted"])
def test_cancel_of_a_preempted_stream_releases_everything(params, when):
    """Cancel lands while the preempted stream's resume is queued (real
    block pressure keeps it out) or after it was admitted again: every
    block, refcount and output queue is released."""
    if when == "resume_queued":
        eng = _make("port", params, cache_blocks=7, priority_classes=3)
        total = _free_blocks(eng)
        rid = eng.submit(PROMPT, max_new_tokens=6, priority=0)
        for _ in range(2):
            eng.step()
        rh = eng.submit(PROMPT + 1, max_new_tokens=6, priority=2)
        eng.step()
        assert any(q.rid == rid and q.resumed for q in eng._pending)
    else:
        tfaults.install(tfaults.FaultPlan(seed=4).fail("engine.preempt",
                                                       at=2, times=1))
        eng = _make("port", params, cache_blocks=32)
        total = _free_blocks(eng)
        rid, rh = eng.submit(PROMPT, max_new_tokens=8), None
        for _ in range(5):
            eng.step()
        assert any(s.rid == rid and s.resumed for s in eng._slots)
    assert eng.stats()["preemptions"] == 1
    assert eng.cancel(rid) and not eng.cancel(rid)
    eng.check_invariants()
    _run_all(eng, audit=True)
    assert rid not in eng._out
    if rh is not None:
        assert len(_drain(eng, rh)) == 6
    assert _free_blocks(eng) == total


def test_preempted_stream_reads_as_one_stream(params):
    """Tokens emitted before the preemption are already queued; the
    resume's land in the same queue, pumped by one consumer."""
    tfaults.install(tfaults.FaultPlan(seed=6).fail("engine.preempt", at=3,
                                                   times=1))
    eng = _make("port", params, cache_blocks=32)
    got = _drain(eng, eng.submit(PROMPT, max_new_tokens=6))
    assert len(got) == 6 and eng.stats()["preemptions"] == 1
    eng.check_invariants()


def test_cancel_drops_an_undelivered_shed_error(params):
    eng = _make("port", params, slots=1, cache_blocks=64, priority_classes=2,
                max_queue=1)
    eng.submit(PROMPT, max_new_tokens=8, priority=0)
    eng.step()
    rv = eng.submit(PROMPT + 1, max_new_tokens=2, priority=0)
    eng.submit(PROMPT + 2, max_new_tokens=2, priority=1)
    assert rv in eng._errors
    eng.check_invariants()
    assert eng.cancel(rv)
    assert rv not in eng._errors and rv not in eng._out
    _run_all(eng, audit=True)


# ---------------------------------------------------------------------------
# the repairs: a weight swap during a prefill
# ---------------------------------------------------------------------------

def _swapped(params):
    p = jgpt.init_params(jax.random.PRNGKey(1), jgpt.GPTConfig(**CFG))
    return {**p, "embed": p["embed"] * 8}


def test_prefill_across_a_swap_publishes_no_blocks(params):
    """A 20-token prompt takes one 8-token chunk (another stream decodes,
    so one chunk a tick), then `update_params`, then it completes: its
    K/V mixes two weight versions and must not enter the radix tree. The
    same prompt again hits nothing and is computed on the new weights, as
    in the JAX engine."""
    new = _swapped(params)
    prompt = np.random.default_rng(0).integers(0, 128, 20).astype(np.int32)

    def scenario(make, faults):
        eng = make(block_size=8, prefill_chunk=8)
        other = eng.submit(PROMPT, max_new_tokens=16)
        eng.step()
        rid = eng.submit(prompt, max_new_tokens=4)
        eng.step()
        assert [s.filled for s in eng._slots if s.rid == rid] == [8]
        eng.update_params(new if faults is jfaults else
                          jax.tree.map(np.asarray, new))
        first = _drain(eng, rid)
        _drain(eng, other)
        hits = eng.stats()["prefix_hit_tokens"]
        again = _drain(eng, eng.submit(prompt, max_new_tokens=4))
        eng.check_invariants()
        return {"first": first, "again": again,
                "hits": eng.stats()["prefix_hit_tokens"] - hits}

    j, t = _both(params, scenario)
    assert t["hits"] == j["hits"] == 0
    _assert_same([t["first"], t["again"]], [j["first"], j["again"]])
    assert {v for _, _, v in t["again"]} == {1}


def test_parked_first_token_keeps_its_version(params):
    """A draft engine whose main prefill finishes in one chunk on a
    prefix hit while its draft pool (no prefix sharing) still needs two
    more: a swap in between. The first token was computed under version
    0 and says so, as in the JAX engine."""
    new = _swapped(params)
    prompt = np.random.default_rng(1).integers(0, 128, 20).astype(np.int32)

    def scenario(make, faults):
        eng = make(block_size=8, prefill_chunk=8, **_draft_kw(params))
        _drain(eng, eng.submit(prompt, max_new_tokens=2))   # warm the tree
        other = eng.submit(PROMPT, max_new_tokens=16)
        eng.step()
        rid = eng.submit(prompt, max_new_tokens=4)
        eng.step()
        s, = [s for s in eng._slots if s.rid == rid]
        assert s.filled == 20 and s.draft_filled == 8 and s.phase == "prefill"
        eng.update_params(new if faults is jfaults else
                          jax.tree.map(np.asarray, new))
        out = _drain(eng, rid)
        _drain(eng, other)
        eng.check_invariants()
        return {"out": out, "hits": eng.stats()["prefix_hit_tokens"]}

    j, t = _both(params, scenario)
    assert t["hits"] == j["hits"] == 16
    assert [v for _, _, v in t["out"]] == [v for _, _, v in j["out"]]
    assert t["out"][0][2] == 0 and {v for _, _, v in t["out"][1:]} == {1}
    _assert_same([t["out"]], [j["out"]])


# ---------------------------------------------------------------------------
# stats, validation, the replica
# ---------------------------------------------------------------------------

# Reference stats keys the port leaves out, and why: the port's weight
# swap is an in-place copy_ with nothing to trace.
NOT_IN_PORT = {"swap_traces"}
# The port's own keys: its prefill rate, its CUDA graphs' pool, its
# kernels' launches, whether its steps replay graphs, and its mesh.
PORT_ONLY = {"prefill_tok_s", "graph_pool_bytes", "kernel_launches",
             "captured", "mesh"}


def test_stats_keys_and_per_class_rows_match_jax(params):
    """`stats()` has the reference's keys less NOT_IN_PORT (plus the
    port's own), the per-class rows the same keys and counts, and
    `reset_stats` zeroes the pressure counters in place."""
    def scenario(make, faults):
        eng = make(cache_blocks=64, priority_classes=3)
        ra = eng.submit(PROMPT, max_new_tokens=3, priority=0)
        rb = eng.submit(PROMPT + 1, max_new_tokens=3, priority=2)
        _run_all(eng)
        _drain(eng, ra), _drain(eng, rb)
        st = eng.stats()
        eng.reset_stats()
        return {"keys": set(st), "row_keys": set(st["per_class"]["0"]),
                "stats": _counters(st), "reset": _counters(eng.stats()),
                "classes": st["priority_classes"], "shape": {
                    k: st[k] for k in ("slots", "pending", "queue_depth",
                                       "block_size", "cache_blocks",
                                       "blocks_free", "prefix_hit_rate")}}

    j, t = _both(params, scenario)
    assert t["keys"] == (j["keys"] - NOT_IN_PORT) | PORT_ONLY
    assert NOT_IN_PORT <= j["keys"] and not PORT_ONLY & j["keys"]
    for k in ("row_keys", "stats", "reset", "classes", "shape"):
        assert t[k] == j[k], k
    for c in ("0", "2"):
        row = t["stats"]["per_class"][c]
        assert row["submitted"] == row["completed"] == 1
        assert row["decode_tokens"] == 3
    assert all(v == 0 for row in t["reset"]["per_class"].values()
               for v in row.values())
    assert t["reset"]["preemptions"] == t["reset"]["sheds"] == 0


@pytest.mark.parametrize("kw", [
    dict(priority_classes=0), dict(priority_aging_s=0.0),
    dict(priority_weight_base=0.5), dict(max_queue=0),
    dict(shed_high_water=0.0), dict(shed_high_water=1.5),
    dict(watchdog_s=0.0)])
def test_bad_knobs_raise_like_jax(params, kw):
    errs = []
    for which in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            _make(which, params, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_bad_priority_raises_like_jax(params):
    for prio in (2, -1):
        errs = []
        for which in ("jax", "port"):
            eng = _make(which, params, priority_classes=2)
            with pytest.raises(ValueError) as e:
                eng.submit(PROMPT, max_new_tokens=2, priority=prio)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_replica_reads_the_request_priority():
    """`InferenceReplica.__call__` takes the class from the request's
    context when the caller gives none; an explicit one wins."""
    import contextvars
    rep = InferenceReplica({"vocab_size": 128, "d_model": 32, "n_layers": 1,
                            "n_heads": 2, "d_ff": 64, "max_seq_len": 32,
                            "dtype": "float32"}, slots=2, max_len=32,
                           device="cpu",
                           engine_kwargs=dict(priority_classes=3))

    def call(**kw):
        tpriority._set_priority(2)
        return rep(PROMPT, max_new_tokens=2, **kw)

    gens = [contextvars.copy_context().run(call),
            contextvars.copy_context().run(call, priority=1)]
    pc = rep.stats()["per_class"]
    assert pc["2"]["submitted"] == pc["1"]["submitted"] == 1
    assert [len(list(g)) for g in gens] == [2, 2]
    assert tpriority.get_request_priority() == 0
