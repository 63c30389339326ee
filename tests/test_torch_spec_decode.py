"""Speculative decoding in the port (`ray_tpu_torch`) against the JAX
package's, on the CPU: the same numpy inputs, made from a seed, through
both.

- `models.gpt.verify_step_paged` against JAX's on the same prefilled pool,
  tables and window (f32 and int8 pools; JAX's verify attention both as
  its plain path and as its Pallas kernel in interpret mode): logits
  within 1e-4 (f32, summation order), pools as JAX leaves them (f32
  values within 1e-5, int8 payloads byte for byte), writes
  past the table dropped.
- The port's verify against W sequential port `decode_step_paged` calls:
  logits within 1e-4, not bit for bit (the reference's bitwise claim is
  an oracle caveat, ROADMAP C).
- The engine with ``spec="ngram"`` and ``"draft"`` at k 1, 2 and 4
  against the JAX engine on shared-prefix / copy-on-write traffic with a
  mid-flight join: identical greedy tokens, logprobs within 1e-4, the
  same acceptance rate and tick counts.
- `_ngram_propose` against the reference's on random histories.
- `accept_drafts`: greedy accepts exactly the argmax run; under sampling
  the first emitted token follows the tempered target softmax for a good
  and for a junk draft (chi-square over 20,000 draws).
- Stats and `reset_stats`, refusals, cancellation mid-speculation, the
  draft model's swap, `InferenceReplica`'s draft convenience.

Params are peaked (embed x 8, `tests/test_paged_cache.py::_peaked`) so
greedy argmaxes are decisive."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.engine import InferenceEngine as JaxEngine
from ray_tpu.serve.engine import _Slot as JaxSlot
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import InferenceEngine, InferenceReplica
from ray_tpu_torch.serve.engine import _Slot, accept_drafts

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64, dtype="float32")
ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=8,
              prefill_chunk=8)
BS, MB, NB = 8, 4, 13


@pytest.fixture(scope="module")
def params():
    p = jgpt.init_params(jax.random.PRNGKey(0), jgpt.GPTConfig(**CFG))
    return {**p, "embed": p["embed"] * 8}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _model(params, **cfg_kw):
    cfg = tgpt.GPTConfig(**{**CFG, **cfg_kw})
    return tgpt.params_from_numpy(_np_tree(params), cfg, device="cpu"), cfg


def _motif(rng, n, motif_len=4):
    motif = rng.integers(1, CFG["vocab_size"], motif_len)
    return np.tile(motif, -(-n // motif_len))[:n].astype(np.int32)


# ---------------------------------------------------------------------------
# verify_step_paged
# ---------------------------------------------------------------------------

def _prefilled_pools(params, kv_dtype):
    """JAX and port pools, each prefilled by its own `prefill_paged` with
    rows 0 and 1's prompts (13 and 6 tokens) through their tables."""
    jcfg = jgpt.GPTConfig(**CFG, kv_dtype=kv_dtype)
    model, tcfg = _model(params, kv_dtype=kv_dtype)
    rng = np.random.default_rng(1)
    tables = (rng.permutation(NB - 1)[:3 * MB] + 1).reshape(3, MB) \
        .astype(np.int32)
    jpool = jgpt.init_kv_pool(jcfg, NB, BS)
    tpool = tgpt.init_kv_pool(tcfg, NB, BS, device="cpu")
    lens = (13, 6)
    for row, n in enumerate(lens):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = rng.integers(0, CFG["vocab_size"], n)
        _, jpool = jgpt.prefill_paged(
            params, jnp.asarray(toks), jpool, jcfg,
            block_table=jnp.asarray(tables[row]), start=0, length=n)
        tgpt.prefill_paged(model, torch.from_numpy(toks), tpool, tcfg,
                           block_table=torch.from_numpy(tables[row]),
                           start=0, length=n)
    # row 2's window runs past its table (positions 30..33 of 32)
    pos = np.asarray([lens[0], lens[1], MB * BS - 2], np.int32)
    return jcfg, jpool, model, tcfg, tpool, tables, pos


def _assert_pools_close(tpool, jpool):
    for name, jarr in jpool.items():
        got, want = tpool[name].numpy(), np.asarray(jarr)
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_dtype,jax_impl", [("f32", "jax"),
                                               ("f32", "pallas"),
                                               ("int8", "jax"),
                                               ("int8", "pallas")])
def test_verify_step_matches_jax(params, kv_dtype, jax_impl):
    """W 4 windows at each row's pos: logits within 1e-4 of JAX's verify
    forward (its attention on its plain path or its Pallas kernel in
    interpret mode), the pools as JAX leaves them (int8 payloads byte for
    byte), and row 2's writes past the table dropped (they land in the
    port's sink row, outside the blocks)."""
    jcfg, jpool, model, tcfg, tpool, tables, pos = _prefilled_pools(
        params, kv_dtype)
    jcfg = jgpt.GPTConfig(**{**CFG, "kv_dtype": kv_dtype,
                             "decode_attn_impl": jax_impl})
    window = np.random.default_rng(2).integers(
        0, CFG["vocab_size"], (3, 4)).astype(np.int32)
    jl, jpool = jax.jit(jgpt.verify_step_paged, static_argnums=(5,))(
        params, jnp.asarray(window), jpool, jnp.asarray(pos),
        jnp.asarray(tables), jcfg)
    tl, _ = tgpt.verify_step_paged(model, torch.from_numpy(window), tpool,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(tables), tcfg)
    assert tl.shape == (3, 4, CFG["vocab_size"]) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _assert_pools_close({k: v for k, v in tpool.items()
                         if not k.endswith("_rows")}, jpool)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_verify_matches_sequential_decode(params, kv_dtype):
    """One W-token verify forward against W sequential `decode_step_paged`
    calls of the port on copies of the same pool: logits within 1e-4 and
    the pools within f32 summation order (int8 payloads within one
    quantization step, scales to 1e-5), not bit for bit."""
    _, _, model, tcfg, pool, tables, pos = _prefilled_pools(params,
                                                            kv_dtype)
    seq_pool = tgpt.init_kv_pool(tcfg, NB, BS, device="cpu")
    for name in seq_pool:
        if name.endswith("_rows"):
            seq_pool[name].copy_(pool[name])
    window = np.random.default_rng(3).integers(
        0, CFG["vocab_size"], (3, 4)).astype(np.int32)
    tables_t, pos_t = torch.from_numpy(tables), torch.from_numpy(pos)
    vl, _ = tgpt.verify_step_paged(model, torch.from_numpy(window), pool,
                                   pos_t, tables_t, tcfg)
    seq = [tgpt.decode_step_paged(model, torch.from_numpy(window[:, j]),
                                  seq_pool, pos_t + j, tables_t, tcfg)[0]
           for j in range(4)]
    np.testing.assert_allclose(vl.numpy(), torch.stack(seq, 1).numpy(),
                               atol=1e-4, rtol=0)
    for name in ("k", "v"):
        a, b = pool[name], seq_pool[name]
        if kv_dtype == "int8":
            assert (a.int() - b.int()).abs().max() <= 1
            np.testing.assert_allclose(pool[name + "_scale"].numpy(),
                                       seq_pool[name + "_scale"].numpy(),
                                       rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=0)


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

def _traffic():
    """B shares A's first 12 tokens (a match ending mid-block: B admits by
    reference with a copy-on-write); C and D arrive while A and B
    decode and join as slots free."""
    rng = np.random.default_rng(4)
    a = np.concatenate([_motif(rng, 12), rng.integers(1, 128, 4)])
    b = np.concatenate([a[:12], rng.integers(1, 128, 6)])
    return [(a, 12), (b, 9), (_motif(rng, 9, 3), 10),
            (rng.integers(1, 128, 10).astype(np.int32), 7)]


def _drive(eng, traffic):
    rids = [eng.submit(p, max_new_tokens=n) for p, n in traffic[:2]]
    for _ in range(6):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=n) for p, n in traffic[2:]]
    eng.run_until_idle()
    outs = [list(eng.tokens_for(r)) for r in rids]
    eng.check_invariants()
    return outs, eng.stats()


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("backend", ["ngram", "draft"])
def test_spec_engine_matches_jax(params, backend, k):
    jkw, tkw = dict(spec=backend, spec_k=k), dict(spec=backend, spec_k=k)
    model, tcfg = _model(params)
    if backend == "draft":
        # a 1-layer draft: the target's first layer
        dparams = {**params, "layers": jax.tree.map(lambda x: x[:1],
                                                    params["layers"])}
        jkw.update(draft_params=dparams,
                   draft_cfg=jgpt.GPTConfig(**{**CFG, "n_layers": 1}))
        dmodel, dcfg = _model(dparams, n_layers=1)
        tkw.update(draft_params=dmodel, draft_cfg=dcfg)
    jouts, js = _drive(JaxEngine(params, jgpt.GPTConfig(**CFG), **ENGINE,
                                 **jkw), _traffic())
    touts, ts = _drive(InferenceEngine(model, tcfg, device="cpu", **ENGINE,
                                       **tkw), _traffic())
    for j, t in zip(jouts, touts):
        assert [int(x) for x in t] == [int(x) for x in j]
        np.testing.assert_allclose([x.logprob for x in t],
                                   [x.logprob for x in j], atol=1e-4,
                                   rtol=0)
    assert ts["spec_steps"] > 0 and ts["cow_copies"] > 0
    assert ts["acceptance_rate"] == pytest.approx(js["acceptance_rate"])
    assert ts["tokens_per_step"] == pytest.approx(js["tokens_per_step"])
    for key in ("spec", "spec_k", "spec_steps", "decode_steps",
                "decode_tokens", "prefill_chunks", "prefix_hit_tokens",
                "cow_copies"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("ngram_max,ngram_min,k", [(3, 1, 4), (2, 2, 3),
                                                   (4, 1, 1)])
def test_ngram_propose_matches_reference(params, ngram_max, ngram_min, k):
    kw = dict(spec="ngram", spec_k=k, ngram_max=ngram_max,
              ngram_min=ngram_min)
    jeng = JaxEngine(params, jgpt.GPTConfig(**CFG), **ENGINE, **kw)
    model, tcfg = _model(params)
    teng = InferenceEngine(model, tcfg, device="cpu", **ENGINE, **kw)
    rng = np.random.default_rng(ngram_max * 10 + k)
    found = 0
    for _ in range(300):
        h = rng.integers(0, 4, int(rng.integers(0, 20))).tolist()
        want = jeng._ngram_propose(JaxSlot(history=list(h)))
        assert teng._ngram_propose(_Slot(history=list(h))) == want
        found += want is not None
    assert 0 < found < 300


# ---------------------------------------------------------------------------
# the accept/correct rule
# ---------------------------------------------------------------------------

def test_accept_drafts_greedy():
    """Temperature 0: the accepted count is the run of drafts equal to
    the previous column's argmax; the next token is that column's argmax
    (the bonus column's after a full run); logprobs are the untempered
    log-softmax of each emitted token."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 4, 16), generator=g)
    am = logits.argmax(-1)
    window = torch.zeros((4, 4), dtype=torch.long)
    window[:, 1:] = am[:, :-1]
    window[1, 2] = (am[1, 1] + 1) % 16     # rejects at draft 2
    window[2, 1] = (am[2, 0] + 1) % 16     # rejects at draft 1
    window[3, 3] = (am[3, 2] + 1) % 16     # rejects at draft 3
    out, out_lp, acc = accept_drafts(logits, window, torch.zeros(4), g)
    assert acc.tolist() == [3, 1, 0, 2]
    torch.testing.assert_close(out[0], am[0])
    for row in (1, 2, 3):
        a = int(acc[row])
        assert out[row, :a].tolist() == window[row, 1:a + 1].tolist()
        assert int(out[row, a]) == int(am[row, a])
    want_lp = torch.log_softmax(logits, -1).gather(-1, out[..., None])[..., 0]
    torch.testing.assert_close(out_lp, want_lp)


@pytest.mark.parametrize("draft", ["good", "junk"])
def test_accept_drafts_sampling_is_distribution_exact(draft):
    """At temperature 0.7, with the draft the target's likeliest token
    (accepted often) or its least likely one (rejected almost always),
    the first emitted token over 20,000 rows follows softmax(logits /
    0.7) (chi-square, p > 1e-3), and the first draft is accepted at the
    rate of its target probability."""
    n, v, t = 20000, 8, 0.7
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2])
    p = torch.softmax(logits / t, -1)
    d = int(p.argmax() if draft == "good" else p.argmin())
    window = torch.full((n, 3), d, dtype=torch.long)
    out, _, acc = accept_drafts(logits.expand(n, 3, v).contiguous(), window,
                                torch.full((n,), t),
                                torch.Generator().manual_seed(7))
    counts = torch.bincount(out[:, 0], minlength=v).double()
    assert sps.chisquare(counts.numpy(), (p.double() * n).numpy()).pvalue \
        > 1e-3
    rate = float((acc >= 1).double().mean())
    sd = float((p[d] * (1 - p[d]) / n).sqrt())
    assert abs(rate - float(p[d])) < 4 * sd + 1e-9


# ---------------------------------------------------------------------------
# stats, refusals, cancellation, swaps, the replica
# ---------------------------------------------------------------------------

def _draft_engine(params, **kw):
    model, tcfg = _model(params)
    return InferenceEngine(model, tcfg, device="cpu", **{
        **ENGINE, "spec": "draft", "spec_k": 3, "draft_params": model,
        "draft_cfg": tcfg, **kw})


def test_stats_and_reset(params):
    model, tcfg = _model(params)
    eng = InferenceEngine(model, tcfg, device="cpu", **ENGINE, spec="ngram",
                          spec_k=3)
    eng.generate(_motif(np.random.default_rng(5), 12), max_new_tokens=12)
    st = eng.stats()
    assert st["spec"] == "ngram" and st["spec_k"] == 3
    assert st["spec_steps"] > 0 and 0 < st["acceptance_rate"] <= 1
    assert st["tokens_per_step"] > 1.0
    # one verify step, built once; the CPU runs its plain path, so no
    # verify-kernel launch is counted
    assert st["verify_traces"] == 1
    assert st["kernel_launches"]["paged_verify_attention"] == 0
    eng.reset_stats()
    st = eng.stats()
    assert st["spec_steps"] == 0 and st["acceptance_rate"] == 0.0
    assert st["tokens_per_step"] == 0.0 and st["decode_tok_s"] == 0.0
    off = InferenceEngine(model, tcfg, device="cpu", **ENGINE)
    off.generate([1, 2, 3, 4], max_new_tokens=6)
    st = off.stats()
    assert st["tokens_per_step"] == 1.0 and st["spec"] == ""
    assert st["spec_k"] == 0 and st["acceptance_rate"] == 0.0
    # self-drafting accepts everything under greedy
    eng = _draft_engine(params)
    eng.generate(np.random.default_rng(6).integers(1, 128, 10),
                 max_new_tokens=13)
    st = eng.stats()
    assert st["acceptance_rate"] == 1.0 and st["tokens_per_step"] > 2.0
    assert st["pool_bytes"] == 2 * off.stats()["pool_bytes"]


@pytest.mark.parametrize("kw,err", [
    (dict(spec="bogus"), "unknown spec"),
    (dict(spec="ngram", spec_k=0), "spec_k"),
    (dict(spec="draft"), "draft_params"),
    (dict(spec="draft", draft_params={},
          draft_cfg=tgpt.GPTConfig(**{**CFG, "vocab_size": 64})),
     "tokenizer"),
    (dict(spec="draft", draft_params={}, draft_cfg=tgpt.GPTConfig(**CFG)),
     "models.gpt.GPT"),
])
def test_bad_spec_configs_raise(params, kw, err):
    model, tcfg = _model(params)
    with pytest.raises((ValueError, TypeError), match=err):
        InferenceEngine(model, tcfg, device="cpu", **ENGINE, **kw)


def test_cancel_mid_spec_frees_draft_blocks(params):
    eng = _draft_engine(params)
    rng = np.random.default_rng(7)
    keep = eng.submit(rng.integers(1, 128, 9), max_new_tokens=12)
    drop = eng.submit(rng.integers(1, 128, 14), max_new_tokens=12)
    while eng.stats()["spec_steps"] < 2:
        eng.step()
    held = list(eng._slots[1].draft_blocks)
    assert held and all(eng._draft_alloc.refcount(b) == 1 for b in held)
    assert eng.cancel(drop)
    eng.check_invariants()
    assert all(eng._draft_alloc.refcount(b) == 0 for b in held)
    assert len(list(eng.tokens_for(keep))) == 12
    eng.check_invariants()
    assert eng._draft_alloc.used == 0
    with pytest.raises(ValueError, match="draft cache"):
        _draft_engine(params, draft_cache_blocks=2).submit(
            np.arange(20), max_new_tokens=4)


def test_draft_swap(params):
    """`update_params(..., draft_params=...)` copies the draft in place
    (an int8 draft quantized first); the same weights leave the tokens
    as they were; a draft tree of the wrong shape raises before anything
    is copied."""
    model, tcfg = _model(params)
    dcfg = tgpt.GPTConfig(**{**CFG, "weight_dtype": "int8"})
    eng = InferenceEngine(model, tcfg, device="cpu", **ENGINE, spec="draft",
                          spec_k=2, draft_params=_model(params)[0],
                          draft_cfg=dcfg)
    assert eng.quantize_traces == 1
    wq = eng.draft_model.layers["wq"]
    assert wq.dtype == torch.int8
    prompt = np.random.default_rng(8).integers(1, 128, 11)
    first = eng.generate(prompt, max_new_tokens=8)
    assert eng.update_params(_np_tree(params),
                             draft_params=_np_tree(params)) == 1
    assert eng.draft_model.layers["wq"] is wq
    again = eng.generate(prompt, max_new_tokens=8)
    assert [int(t) for t in again] == [int(t) for t in first]
    assert all(t.params_version == 1 for t in again)
    bad = _np_tree(params)
    bad["layers"] = {**bad["layers"], "wo": bad["layers"]["wo"][:, :8]}
    before = eng.model.layers["wq"].clone()
    with pytest.raises(ValueError, match="layers.wo"):
        eng.update_params(jax.tree.map(lambda x: x * 2, _np_tree(params)),
                          draft_params=bad)
    assert torch.equal(eng.model.layers["wq"], before)
    assert eng.params_version == 1 and eng.quantize_traces == 1
    eng.check_invariants()


@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_sampled_spec_is_seeded_and_scored(params, spec):
    """Temperature sampling through the accept rule draws from the
    engine's generator: the same seed gives the same tokens, each in the
    vocabulary and carrying its natural logprob."""
    prompt = _motif(np.random.default_rng(9), 12)
    runs = []
    for _ in range(2):
        model, tcfg = _model(params)
        extra = (dict(draft_params=model, draft_cfg=tcfg)
                 if spec == "draft" else {})
        eng = InferenceEngine(model, tcfg, device="cpu", **ENGINE, spec=spec,
                              spec_k=3, seed=3, **extra)
        runs.append(eng.generate(prompt, max_new_tokens=16, temperature=0.5))
        eng.check_invariants()
        assert eng.stats()["spec_steps"] > 0
    assert [int(t) for t in runs[0]] == [int(t) for t in runs[1]]
    assert len(runs[0]) == 16
    assert all(0 <= t < CFG["vocab_size"] for t in runs[0])
    lps = [t.logprob for t in runs[0]]
    assert all(np.isfinite(lps)) and max(lps) <= 0.0


def test_replica_builds_a_draft():
    kw = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
              max_seq_len=64, dtype="float32")
    rep = InferenceReplica(kw, slots=2, max_len=32, seed=4, device="cpu",
                           engine_kwargs={"spec": "draft", "spec_k": 2,
                                          "block_size": 8})
    eng = rep.engine
    assert eng.spec == "draft" and eng.draft_cfg.n_layers == 1
    want = tgpt.init_params(5, eng.draft_cfg, "cpu")
    torch.testing.assert_close(eng.draft_model.embed, want["embed"])
    out = list(rep(np.arange(1, 9), max_new_tokens=6))
    assert len(out) == 6 and rep.stats()["spec_steps"] > 0
    eng.check_invariants()
