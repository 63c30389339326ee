"""Compile-once serving in the port (`ray_tpu_torch.serve.engine`'s static
steps) against the JAX engine's jitted steps, on the CPU, at
`models.gpt.small`'s widths with JAX-initialised params carried across.

On the CPU no CUDA graph exists: each static step runs eagerly on its
persistent input buffers, and a build (the port's counterpart of one
trace) is counted when the step is first made, as a capture is on the
card. The same request sequences go through both engines: greedy,
sampled, mixed temperatures, a late join, slot reuse, a second chunk
bucket, n-gram and draft speculation, int8 KV and weights, and a weight
swap. Greedy tokens must be identical (logprobs within 1e-4, f32
summation order); sampled requests match only in distribution (threefry
is not torch's generator), so only their lengths and vocabulary are
checked. The trace counters (``decode_traces``, ``prefill_traces``,
``verify_traces``, ``draft_traces``, ``draft_prefill_traces``) must equal
the reference's: decode, verify and draft once, prefill once per chunk
bucket. The retrace sentinel is held to the reference's on the same
counter sequence, and counts a forced rebuild after
`arm_retrace_sentinel` once, with one warning.

Params are peaked (embed x 8, `tests/test_paged_cache.py::_peaked`) so
greedy argmaxes are decisive."""

import logging

import jax
import numpy as np
import pytest

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.engine import InferenceEngine as JaxEngine
from ray_tpu.util import telemetry as jtel
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import InferenceEngine
from ray_tpu_torch.util import telemetry as ttel

CFG = dict(dtype="float32")                   # gpt.small's widths
ENGINE = dict(slots=2, max_len=48, prefill_buckets=(8, 16), block_size=8,
              prefill_chunk=16)
TRACES = ("decode_traces", "prefill_traces", "verify_traces",
          "draft_traces", "draft_prefill_traces")


@pytest.fixture(scope="module")
def tree():
    p = jgpt.init_params(jax.random.PRNGKey(0), jgpt.small(**CFG))
    return jax.tree.map(np.asarray, {**p, "embed": p["embed"] * 8})


def _engines(tree, cfg_kw=None, **kw):
    cfg_kw = {**CFG, **(cfg_kw or {})}
    jcfg, tcfg = jgpt.small(**cfg_kw), tgpt.small(**cfg_kw)
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    extra = {}
    jextra = {}
    if kw.get("spec") == "draft":
        extra = dict(draft_params=model, draft_cfg=tcfg)
        jextra = dict(draft_params=jax.tree.map(jax.numpy.asarray, tree),
                      draft_cfg=jcfg)
    jeng = JaxEngine(jax.tree.map(jax.numpy.asarray, tree), jcfg,
                     **ENGINE, **kw, **jextra)
    teng = InferenceEngine(model, tcfg, device="cpu", **ENGINE, **kw,
                           **extra)
    return jeng, teng


def _prompts(n, lo=5, hi=14, seed=0, motif=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(lo, hi))
        if motif:
            m = rng.integers(1, 512, 4)
            out.append(np.tile(m, -(-size // 4))[:size].astype(np.int32))
        else:
            out.append(rng.integers(0, 512, size).astype(np.int32))
    return out


def _run(eng, reqs):
    """``reqs``: [(prompt, max_new, temperature, joins_after_ticks)];
    a request joins once the engine has ticked that many times."""
    rids, ticks = {}, 0
    pending = sorted(range(len(reqs)), key=lambda i: reqs[i][3])
    while pending or any(s.active for s in eng._slots) or eng._pending:
        while pending and reqs[pending[0]][3] <= ticks:
            i = pending.pop(0)
            p, n, t, _ = reqs[i]
            rids[i] = eng.submit(p, max_new_tokens=n, temperature=t)
        eng.step()
        ticks += 1
    outs = [list(eng.tokens_for(rids[i])) for i in range(len(reqs))]
    eng.check_invariants()
    return outs


def _scenario(name):
    """The request sequence of a scenario: [(prompt, max_new,
    temperature, join tick)] and the engine kwargs."""
    p = _prompts(6, seed=len(name))
    if name == "greedy":
        return [(x, 6, 0.0, 0) for x in p[:4]], {}
    if name == "sampled":
        return [(x, 6, 0.8, 0) for x in p[:3]], {}
    if name == "mixed_temperatures":
        return [(x, 6, t, 0) for x, t in zip(p[:4], (0.0, 0.7, 0.0, 1.3))], {}
    if name == "late_join":
        return [(p[0], 10, 0.0, 0), (p[1], 6, 0.0, 4), (p[2], 4, 0.0, 7)], {}
    if name == "slot_reuse":   # 5 requests through 2 slots
        return [(x, 4, 0.0, 0) for x in p[:5]], {}
    if name == "second_bucket":   # 20-30 tokens: chunks of 16 and of 8
        q = _prompts(3, lo=20, hi=31, seed=7)
        return [(x, 5, 0.0, 0) for x in q] + [(p[0], 5, 0.0, 2)], {}
    if name in ("ngram", "draft"):
        q = _prompts(3, lo=10, hi=20, seed=3, motif=True)
        return ([(x, 8, 0.0, i) for i, x in enumerate(q)],
                dict(spec=name, spec_k=3))
    if name == "int8":
        return ([(x, 6, 0.0, 0) for x in p[:3]],
                dict(cfg_kw=dict(kv_dtype="int8", weight_dtype="int8")))
    raise ValueError(name)


SCENARIOS = ("greedy", "sampled", "mixed_temperatures", "late_join",
             "slot_reuse", "second_bucket", "ngram", "draft", "int8")


def _check_same(jouts, touts, reqs):
    for (p, n, temp, _), j, t in zip(reqs, jouts, touts):
        assert len(t) == len(j) == n
        assert all(0 <= int(x) < 512 for x in t)
        if temp == 0.0:
            assert [int(x) for x in t] == [int(x) for x in j]
            np.testing.assert_allclose([x.logprob for x in t],
                                       [x.logprob for x in j], atol=1e-4,
                                       rtol=0)


@pytest.mark.parametrize("name", SCENARIOS)
def test_traffic_and_trace_counts_match_jax_engine(tree, name):
    reqs, kw = _scenario(name)
    jeng, teng = _engines(tree, **kw)
    _check_same(_run(jeng, reqs), _run(teng, reqs), reqs)
    js, ts = jeng.stats(), teng.stats()
    for key in TRACES:
        assert getattr(teng, key) == getattr(jeng, key), key
        assert ts[key] == getattr(teng, key), key
    # decode (or, under speculation, verify and draft) once; prefill once
    # per chunk bucket the traffic used
    assert teng.decode_traces <= 1 and teng.verify_traces <= 1
    assert teng.draft_traces <= 1
    buckets = {k[1] for k in teng._steps if k[0] == "prefill"}
    assert teng.prefill_traces == len(buckets) >= 1
    if name == "second_bucket":
        assert buckets == {8, 16}
    if name in ("ngram", "draft"):
        assert teng.verify_traces == 1 and ts["spec_steps"] > 0
        assert ts["spec_steps"] == js["spec_steps"]
        assert teng.draft_traces == int(name == "draft")
        assert teng.draft_prefill_traces == (len(buckets)
                                             if name == "draft" else 0)
    else:
        assert teng.decode_traces == 1
    if name == "int8":
        assert ts["quantize_traces"] == js["quantize_traces"] == 1
    assert ts["retraces_unexpected"] == 0 and ts["graph_pool_bytes"] == 0
    assert ts["decode_steps"] == js["decode_steps"]


def test_update_params_keeps_the_steps(tree):
    """A weight swap copies in place: the steps built before it serve the
    new weights (no rebuild, as the reference's swap causes no decode
    retrace), and the tokens after it are the JAX engine's on the same
    new weights."""
    reqs = [(x, 5, 0.0, 0) for x in _prompts(3, seed=11)]
    jeng, teng = _engines(tree)
    _check_same(_run(jeng, reqs), _run(teng, reqs), reqs)
    steps = dict(teng._steps)
    new = jax.tree.map(lambda x: x * 0.5, tree)
    new["embed"] = tree["embed"]
    jeng.update_params(jax.tree.map(jax.numpy.asarray, new))
    assert teng.update_params(new) == 1
    _check_same(_run(jeng, reqs), _run(teng, reqs), reqs)
    assert teng._steps == steps
    for key in TRACES:
        assert getattr(teng, key) == getattr(jeng, key), key


def test_steps_read_persistent_inputs(tree):
    """Every tick of a step reads the same input buffers (what a graph
    captured at the first tick replays on), refilled from the host in
    one copy a tick."""
    _, teng = _engines(tree)
    teng.generate(_prompts(1)[0], max_new_tokens=3)
    step = teng._steps[("decode", None)]
    ptrs = {k: v.data_ptr() for k, v in step.inputs.dev.items()}
    teng.generate(_prompts(1, seed=1)[0], max_new_tokens=3)
    assert teng._steps[("decode", None)] is step
    assert {k: v.data_ptr() for k, v in step.inputs.dev.items()} == ptrs
    assert teng.decode_traces == 1


def test_sentinel_counts_a_forced_rebuild_after_arming(tree, caplog):
    _, teng = _engines(tree)

    def run(seed):   # 6-token prompts: every chunk in bucket 8
        teng.generate(_prompts(1, lo=6, hi=7, seed=seed)[0],
                      max_new_tokens=3)

    run(0)
    teng.arm_retrace_sentinel()
    run(1)
    assert teng.stats()["retraces_unexpected"] == 0
    # the bucket's prefill step built again: over the armed baseline
    del teng._steps[("prefill", 8)]
    with caplog.at_level(logging.WARNING,
                         logger="ray_tpu_torch.util.telemetry"):
        run(2)
        run(3)
    st = teng.stats()
    assert st["prefill_traces"] == 2 and st["retraces_unexpected"] == 1
    assert len([r for r in caplog.records
                if "retrace sentinel" in r.getMessage()]) == 1
    # decode is capped at one build from construction, armed or not
    del teng._steps[("decode", None)]
    run(4)
    assert teng.stats()["retraces_unexpected"] == 2


def test_sentinel_matches_the_reference():
    """The port's copy of `RetraceSentinel` against the reference's on the
    same watches and counter sequence: the same excess counts, events and
    arming behaviour; a registered watch outside the inventory raises."""
    counts = {"decode": 0, "prefill": 0}
    sentinels = [ttel.RetraceSentinel("t"), jtel.RetraceSentinel("j")]
    for s in sentinels:
        s.watch("decode", lambda: counts["decode"], cap=1)
        s.watch("prefill", lambda: counts["prefill"])
    seen = [[], []]
    for step in [("decode", 1), ("prefill", 2), ("arm", 0), ("prefill", 1),
                 ("decode", 2), ("prefill", 1), ("reset", 0),
                 ("decode", 1)]:
        for i, s in enumerate(sentinels):
            if step[0] == "arm":
                s.arm()
            elif step[0] == "reset":
                s.reset()
        if step[0] in counts:
            counts[step[0]] += step[1]
        for i, s in enumerate(sentinels):
            seen[i].append((s.check(), s.retraces_unexpected, s.armed,
                            s.watching(),
                            [(e["path"], e["traces"], e["allowed"])
                             for e in s.events]))
    assert seen[0] == seen[1]
    with pytest.raises(ValueError, match="registered"):
        ttel.RetraceSentinel().watch("swap", lambda: 0, registered=True)
    for path in ("kv_gather", "kv_scatter"):
        ttel.RetraceSentinel().watch(path, lambda: 0, registered=True)
    assert ttel.next_name("probe") != ttel.next_name("probe")
