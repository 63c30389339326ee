"""Int8 serving in the port (`ray_tpu_torch`) against the JAX package's,
on the CPU: the same numpy inputs, made from a seed, through both.

- `ops.quant`: byte-identical int8 payloads and f32 scales (random rows,
  zero rows, exact .5 ties).
- The int8 paged attention wrappers' plain path against JAX's Pallas
  int8 kernels in interpret mode, f32, atol = rtol = 2e-5 (the
  reference's own bounds, `tests/test_paged_cache.py`); the split-K plain
  versions with scales against them at 1e-5 (summation order); the
  tensor-core kernel's walk (p * v_scale rounded to bf16) against JAX on
  bf16 q within 1e-5 + 2**-7 |ref| + 2**-8 P|V|.
- `prefill_paged` + `decode_step_paged` on an int8 pool, with and without
  int8 weights, on peaked params (embed x 8): greedy tokens identical,
  logits within 1e-4 (f32, summation order), payloads byte-identical.
- `quantize_params`, a quantized JAX tree carried across, the refusals of
  a quantized model outside the paged forwards.
- The engine on an int8 pool (and int8 weights) token-identical to JAX's
  across a shared prefix and a copy-on-write split, `check_invariants`
  auditing the scales, the pool gauges, `update_params`, and a short
  admit/cancel fuzz on an int8 pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.ops import decode_attention as jda
from ray_tpu.ops import quant as jquant
from ray_tpu.serve.engine import InferenceEngine as JaxEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import decode_attention as tda
from ray_tpu_torch.ops import quant as tquant
from ray_tpu_torch.serve import InferenceEngine

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64, dtype="float32")
ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=8)
ATOL = 2e-5


@pytest.fixture(scope="module")
def params():
    """Peaked JAX params (embed x 8): the tiny model's greedy argmax gaps
    are otherwise below int8 noise (`tests/test_paged_cache.py::_peaked`)."""
    p = jgpt.init_params(jax.random.PRNGKey(0), jgpt.GPTConfig(**CFG))
    return {**p, "embed": p["embed"] * 8}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# ops.quant
# ---------------------------------------------------------------------------

def _quant_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 5, 16))
         * rng.uniform(1e-3, 1e3, (6, 5, 1))).astype(np.float32)
    x[0, 0] = 0.0                    # a zero row: scale 0, payload 0
    x[1, :, 0] = 0.0                 # a zero channel
    # exact ties: with amax 127 the scale is 1, so x / scale = k + 0.5
    x[2, 0] = np.arange(16) - 7.5
    x[2, 0, -1] = 127.0
    return x


@pytest.mark.parametrize("kind", ["rows", "channels"])
def test_quantize_is_byte_identical_to_jax(kind):
    x = _quant_inputs()
    jfn, tfn = ((jquant.quantize_rows, tquant.quantize_rows) if kind == "rows"
                else (jquant.quantize_channels, tquant.quantize_channels))
    jq, js = (np.asarray(a) for a in jfn(jnp.asarray(x)))
    tq, ts = tfn(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))
    if kind == "rows":
        assert ts[0, 0] == 0 and torch.all(tq[0, 0] == 0)
        # round half to even, as jnp.round
        np.testing.assert_array_equal(tq[2, 0, :4].numpy(), [-8, -6, -6, -4])
        deq = tquant.dequantize_rows(tq, ts).numpy()
        np.testing.assert_array_equal(
            deq, np.asarray(jquant.dequantize_rows(jq, js)))
    else:
        deq = tquant.dequantize_channels(tq, ts).numpy()
        np.testing.assert_array_equal(
            deq, np.asarray(jquant.dequantize_channels(jq, js)))
    # the same input twice: the same bytes (the determinism contract)
    tq2, ts2 = tfn(torch.from_numpy(x.copy()))
    assert torch.equal(tq, tq2) and torch.equal(ts, ts2)


# ---------------------------------------------------------------------------
# the int8 paged attention wrappers and their split-K plain versions
# ---------------------------------------------------------------------------

def _int8_pool(rng, nb, bs, h, d):
    """An int8 pool quantized from normal rows, through JAX's quantize
    (so both sides read the same bytes)."""
    out = []
    for _ in range(2):
        q, s = jquant.quantize_rows(jnp.asarray(
            rng.standard_normal((nb, bs, h, d)).astype(np.float32)))
        out += [np.array(q), np.array(s)]
    return out                                        # kq, ks, vq, vs


def _tables(rng, b, mb, nb):
    return (rng.permutation(nb - 1)[:b * mb] + 1).reshape(b, mb) \
        .astype(np.int32)


def _case(kind, seed, bs=8, d=16, mb=4, b=3):
    """numpy (q, kq, vq, tables, pos, ks, vs) for decode ([B, H, D]),
    verify ([B, 3, H, D]) or prefill ([C, H, D] through row 0's table,
    pos = start)."""
    rng = np.random.default_rng(seed)
    h = 2
    kq, ks, vq, vs = _int8_pool(rng, b * mb + 1, bs, h, d)
    tables = _tables(rng, b, mb, b * mb + 1)
    span = mb * bs
    if kind == "prefill":
        c = bs + 3
        return (rng.standard_normal((c, h, d)).astype(np.float32), kq, vq,
                tables[0], span - c - 2, ks, vs)
    pos = np.asarray([0, bs - 1, span - 3], np.int32)
    shape = (b, h, d) if kind == "decode" else (b, 3, h, d)
    return (rng.standard_normal(shape).astype(np.float32), kq, vq, tables,
            pos, ks, vs)


_WRAPPERS = {"decode": "paged_decode_attention",
             "verify": "paged_verify_attention",
             "prefill": "paged_prefill_attention"}


@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_int8_wrappers_match_jax_pallas(kind):
    q, kq, vq, tbl, pos, ks, vs = _case(kind, seed=len(kind))
    name = _WRAPPERS[kind]
    j = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
         for a in (q, kq, vq, tbl, pos)]
    want = np.asarray(getattr(jda, name)(
        *j, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        impl="pallas"))
    t = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
         for a in (q, kq, vq, tbl, pos)]
    before = tda.kernel_launches()
    got = getattr(tda, name)(*t, k_scale=torch.from_numpy(ks),
                             v_scale=torch.from_numpy(vs))
    assert tda.kernel_launches() == before      # CPU: the plain path
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def _split_case(kind, bs, d, seed):
    """Tables past 320 positions (3 splits of 128): rows that see KS - 1,
    KS and KS + 1 positions (decode: across a split boundary above
    `_ONE_CTA`), a 64-row chunk across the first boundary."""
    rng = np.random.default_rng(seed)
    h = 2
    mb = -(-(tda._ONE_CTA + 300 if kind == "decode" else 320) // bs)
    span = mb * bs
    ks_, _ = tda.split_geometry(span)
    b = 3
    kq, ks, vq, vs = _int8_pool(rng, b * mb + 1, bs, h, d)
    tables = _tables(rng, b, mb, b * mb + 1)
    if kind == "prefill64":
        pos, tables, w = np.asarray([ks_ - 33], np.int32), tables[:1], 64
    elif kind == "decode":
        edge = tda._ONE_CTA + ks_
        pos, w = np.asarray([edge - 2, edge - 1, edge], np.int32), 1
    else:
        pos, w = np.asarray([0, ks_ - 4, span - 4], np.int32), 4
    shape = (len(pos), h, d) if kind == "decode" else (len(pos), w, h, d)
    return (rng.standard_normal(shape).astype(np.float32), kq, vq, tables,
            pos, ks, vs)


def _jax_pallas(kind, q, kq, vq, tables, pos, ks, vs):
    j = [jnp.asarray(a) for a in (q, kq, vq, tables, pos)]
    sc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
              impl="pallas")
    if kind == "decode":
        return np.asarray(jda.paged_decode_attention(*j, **sc))
    if kind == "prefill64":
        return np.asarray(jda.paged_prefill_attention(
            j[0][0], j[1], j[2], j[3][0], int(pos[0]), **sc))[None]
    return np.asarray(jda.paged_verify_attention(*j, **sc))


@pytest.mark.parametrize("kind", ["decode", "verify4", "prefill64"])
def test_int8_split_partials_match_jax(kind):
    """The int8 kernels' split-K arithmetic in plain PyTorch (per-split
    states of the dequantized rows, merged in split order) against JAX's
    Pallas int8 kernels in interpret mode, f32 1e-5: summation order."""
    q, kq, vq, tables, pos, ks, vs = _split_case(kind, 16, 64, seed=9)
    want = _jax_pallas(kind, q, kq, vq, tables, pos, ks, vs)
    t = [torch.from_numpy(a) for a in (q, kq, vq, tables, pos)]
    sc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    cut, n_split = tda.split_geometry(tables.shape[1] * 16)
    if kind == "decode":
        m, l, acc = tda.paged_decode_partials_reference(*t, n_split, **sc)
    else:
        m, l, acc = tda.paged_mq_partials_reference(*t, cut, **sc)
    assert (m > -1e29).sum(dim=0).max() > 1            # it did split
    got = tda.paged_merge_reference(m, l, acc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind,bs,d", [("prefill64", 16, 64),
                                       ("verify4", 24, 96)])
def test_int8_tensor_core_walk_within_bf16_of_jax(kind, bs, d):
    """The bf16 multi-query kernel on an int8 pool folds v_scale into p
    and rounds p * v_scale to bf16 before its product with the int8 value
    row. Its walk (`paged_mq_partials_reference` with ``tile``), rounded
    to bf16, against JAX's Pallas int8 kernel on the same bf16 q (f32 p,
    dequantized f32 V): within 1e-5 + 2**-7 |ref| + 2**-8 P|V|. Against
    the plain version it differs by the rounding term alone (+ 1e-6),
    and the term is not vacuous."""
    q, kq, vq, tables, pos, ks, vs = _split_case(kind, bs, d, seed=d)
    qb = torch.from_numpy(q).bfloat16()
    tt, tp = torch.from_numpy(tables), torch.from_numpy(pos)
    tk, tv = torch.from_numpy(kq), torch.from_numpy(vq)
    sc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    cut, _ = tda.split_geometry(tables.shape[1] * bs)
    walk = tda.paged_merge_reference(*tda.paged_mq_partials_reference(
        qb, tk, tv, tt, tp, cut, tile=64, **sc))
    want = _jax_pallas(kind, qb.float().numpy(), kq, vq, tables, pos, ks, vs)
    vdeq = tquant.dequantize_rows(tv, sc["v_scale"])
    pv = tda.reference_paged_verify_attention(
        qb.float(), tquant.dequantize_rows(tk, sc["k_scale"]), vdeq.abs(),
        tt, tp)
    limit = 1e-5 + 2 ** -7 * np.abs(want) + 2 ** -8 * pv.numpy()
    assert np.all(np.abs(walk.bfloat16().float().numpy() - want) <= limit)
    plain = tda.reference_paged_verify_attention(qb.float(), tk, tv, tt, tp,
                                                 **sc)
    err = (walk - plain).abs()
    assert err.max() > 0
    assert torch.all(err <= 2 ** -8 * pv + 1e-6)


def test_split_blocks_re_views_the_scales():
    """A block-64 int8 pool seen as blocks of 32: payload and scales
    re-viewed alike, so the plain versions agree bit for bit."""
    q, kq, vq, tables, pos, ks, vs = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _case("verify", seed=64, bs=64, mb=3))
    k2, v2, t2, ks2, vs2 = tda.split_blocks(kq, vq, tables, ks, vs)
    assert ks2.shape == (ks.shape[0] * 2, 32, ks.shape[2])
    assert ks2.data_ptr() == ks.data_ptr() and vs2.shape == ks2.shape
    want = tda.reference_paged_verify_attention(q, kq, vq, tables, pos,
                                                k_scale=ks, v_scale=vs)
    got = tda.reference_paged_verify_attention(q, k2, v2, t2, pos,
                                               k_scale=ks2, v_scale=vs2)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the model: int8 pool, int8 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
def test_int8_prefill_then_decode_match_jax(params, weight_dtype):
    """Chunked prefill (8, then 4 of an 8-wide bucket) and 6 greedy decode
    steps through an int8 pool (the reference's
    `test_prefill_decode_greedy_matches_f32`), against JAX's."""
    kw = dict(kv_dtype="int8", weight_dtype=weight_dtype)
    jcfg, tcfg = jgpt.GPTConfig(**CFG, **kw), tgpt.GPTConfig(**CFG, **kw)
    model = tgpt.params_from_numpy(_np_tree(params), tcfg, device="cpu")
    jp = params
    if weight_dtype == "int8":
        model, jp = tgpt.quantize_params(model), jgpt.quantize_params(params)
    prompt = np.random.default_rng(0).integers(0, 128, 12)
    table = np.array([5, 2, 7, 1], np.int32)
    jpool = jgpt.init_kv_pool(jcfg, 8, 8)
    tpool = tgpt.init_kv_pool(tcfg, 8, 8, device="cpu")
    assert tpool["k"].dtype == torch.int8
    assert tpool["k_scale"].shape == tpool["k"].shape[:-1]
    jprefill = jax.jit(jgpt.prefill_paged, static_argnums=(3,))
    jdecode = jax.jit(jgpt.decode_step_paged, static_argnums=(5,))
    start = 0
    for clen in (8, 4):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :clen] = prompt[start:start + clen]
        jl, jpool = jprefill(
            jp, jnp.asarray(toks), jpool, jcfg, block_table=jnp.asarray(table),
            start=start, length=jnp.int32(clen))
        tl, _ = tgpt.prefill_paged(
            model, torch.from_numpy(toks), tpool, tcfg,
            block_table=torch.from_numpy(table), start=start, length=clen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        start += clen
    cur = int(np.argmax(np.asarray(jl)[0]))
    for t in range(12, 18):
        jl, jpool = jdecode(
            jp, jnp.asarray([cur], jnp.int32), jpool,
            jnp.asarray([t], jnp.int32), jnp.asarray(table)[None], jcfg)
        tl, _ = tgpt.decode_step_paged(
            model, torch.tensor([cur], dtype=torch.int32), tpool,
            torch.tensor([t], dtype=torch.int32),
            torch.from_numpy(table)[None], tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        assert int(tl[0].argmax()) == int(np.argmax(np.asarray(jl)[0]))
        cur = int(tl[0].argmax())
    for name in ("k", "v"):
        np.testing.assert_array_equal(tpool[name].numpy(),
                                      np.asarray(jpool[name]))
        np.testing.assert_allclose(tpool[name + "_scale"].numpy(),
                                   np.asarray(jpool[name + "_scale"]),
                                   rtol=1e-5, atol=0)


def test_quantize_params_layout_and_a_jax_tree_carried_across(params):
    """Every matmul weight becomes int8 beside its f32 [L, Out] scale, the
    rest keeps its dtype and the source model is untouched; a tree from
    JAX's `quantize_params` carried across holds the same bytes."""
    tcfg = tgpt.GPTConfig(**CFG, weight_dtype="int8")
    model = tgpt.params_from_numpy(_np_tree(params), tcfg, device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    qm = tgpt.quantize_params(model)
    assert qm.quantized and not model.quantized
    for name in tgpt.QUANTIZED_WEIGHTS:
        w, s = qm.layers[name], qm.layers[name + "_scale"]
        assert w.dtype == torch.int8 and s.dtype == torch.float32
        assert s.shape == w.shape[:-2] + w.shape[-1:]
    assert qm.layers["ln1_scale"].dtype == torch.float32
    assert qm.embed.data_ptr() != model.embed.data_ptr()
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n])
    carried = tgpt.params_from_numpy(_np_tree(jgpt.quantize_params(params)),
                                     tcfg, device="cpu")
    assert carried.quantized
    for (n, a), (m, b) in zip(qm.named_parameters(),
                              carried.named_parameters()):
        assert n == m and a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tgpt.params_to_numpy(qm)["layers"]["wq"].dtype == np.int8
    with pytest.raises(ValueError, match="already"):
        tgpt.quantize_params(qm)
    # a quantized model serves the paged forwards only
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="full-precision"):
        tgpt.forward(qm, toks)
    with pytest.raises(ValueError, match="full-precision"):
        tgpt.loss_fn(qm, {"tokens": toks})
    with pytest.raises(ValueError, match="full-precision"):
        tgpt.prefill(qm, toks, tgpt.init_kv_cache(tcfg, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match="cannot be trained"):
        tgpt.params_from_numpy(_np_tree(jgpt.quantize_params(params)), tcfg,
                               device="cpu", dtype=torch.float32,
                               trainable=True)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engines(params, **kw):
    jcfg, tcfg = jgpt.GPTConfig(**CFG, **kw), tgpt.GPTConfig(**CFG, **kw)
    jeng = JaxEngine(params, jcfg, **ENGINE)
    model = tgpt.params_from_numpy(_np_tree(params), tcfg, device="cpu")
    return jeng, InferenceEngine(model, tcfg, device="cpu", **ENGINE), model


def _prompts():
    """The reference's `TestQuantizedEngine` traffic: x, y sharing x's
    first 12 tokens (a copy-on-write split mid-block), z extending x
    (an aligned shared prefix)."""
    rng = np.random.default_rng(21)
    x = list(rng.integers(0, 128, 16))
    return [x, x[:12] + list(rng.integers(0, 128, 4)),
            x + list(rng.integers(0, 128, 4))]


@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
def test_int8_engine_token_identical_to_jax(params, weight_dtype):
    jeng, teng, model = _engines(params, kv_dtype="int8",
                                 weight_dtype=weight_dtype)
    assert (teng.model is model) == (weight_dtype == "f32")
    jouts = [jeng.generate(p, max_new_tokens=6) for p in _prompts()]
    touts = [teng.generate(p, max_new_tokens=6) for p in _prompts()]
    teng.check_invariants()                 # audits the scale arrays
    for j, t in zip(jouts, touts):
        assert [int(x) for x in t] == [int(x) for x in j]
        np.testing.assert_allclose([x.logprob for x in t],
                                   [x.logprob for x in j], atol=1e-4, rtol=0)
    st = teng.stats()
    assert st["cow_copies"] >= 1 and st["prefix_hit_tokens"] > 0
    assert st["quantize_traces"] == jeng.stats()["quantize_traces"] == \
        int(weight_dtype == "int8")
    assert st["kv_bytes_per_token"] == jeng.stats()["kv_bytes_per_token"]
    # the f32 pool's gauge against the int8 one: 4 hd / (hd + 4)
    f32 = InferenceEngine(model, tgpt.GPTConfig(**CFG), device="cpu",
                          **ENGINE).stats()
    hd = CFG["d_model"] // CFG["n_heads"]
    assert f32["kv_bytes_per_token"] / st["kv_bytes_per_token"] == \
        pytest.approx(4 * hd / (hd + 4))
    assert 0 < st["pool_bytes"] < f32["pool_bytes"]
    # the audit catches a scale array that lost its geometry
    teng.cache["k_scale"] = teng.cache["k_scale"][..., :1]
    with pytest.raises(AssertionError, match="k_scale"):
        teng.check_invariants()


def test_update_params_under_int8_weights(params):
    """A swap of f32 masters on an int8-weight engine: quantized on the
    way (no second quantize of the same tree), copied in place, the radix
    tree flushed, params_version stamped on later tokens; the same
    weights give the same tokens."""
    _, teng, _ = _engines(params, kv_dtype="int8", weight_dtype="int8")
    x = _prompts()[0]
    first = teng.generate(x, max_new_tokens=6)
    assert teng.stats()["cached_prefix_blocks"] > 0
    assert all(t.params_version == 0 for t in first)
    wq = teng.model.layers["wq"]
    assert teng.update_params(_np_tree(params)) == 1
    assert teng.model.layers["wq"] is wq and wq.dtype == torch.int8
    st = teng.stats()
    assert st["cached_prefix_blocks"] == 0 and st["blocks_in_use"] == 0
    assert st["quantize_traces"] == teng.quantize_traces == 1
    assert st["params_version"] == teng.params_version == 1
    assert st["swaps"] == 1
    again = teng.generate(x, max_new_tokens=6)
    assert [int(t) for t in again] == [int(t) for t in first]
    assert all(t.params_version == 1 for t in again)
    assert teng.stats()["weight_swap_ms"] > 0
    teng.check_invariants()
    bad = _np_tree(params)
    bad["layers"] = {**bad["layers"], "wq": bad["layers"]["wq"][:, :, :8]}
    with pytest.raises(ValueError, match="wq"):
        teng.update_params(bad)
    with pytest.raises(NotImplementedError, match="draft"):
        teng.update_params(_np_tree(params), draft_params={})
    assert teng.params_version == 1


def test_fuzz_small_int8(params):
    """A seeded admit/cancel/step storm on an int8 pool over a small
    alphabet (radix collisions, splits, COW, eviction) with
    `check_invariants` auditing allocator, tree and scale arrays after
    every operation (the reference's `test_fuzz_small_quantized`)."""
    tcfg = tgpt.GPTConfig(**CFG, kv_dtype="int8")
    model = tgpt.params_from_numpy(_np_tree(params), tcfg, device="cpu")
    eng = InferenceEngine(model, tcfg, device="cpu",
                          **{**ENGINE, "slots": 3}, cache_blocks=9)
    rng = np.random.default_rng(0)
    live = []
    for _ in range(40):
        op = rng.integers(0, 10)
        if op < 4:
            p = list(rng.integers(1, 5, int(rng.integers(1, 25))))
            live.append(eng.submit(p, max_new_tokens=int(rng.integers(1, 6))))
        elif op < 6 and live:
            eng.cancel(live.pop(int(rng.integers(0, len(live)))))
        else:
            eng.step()
        eng.check_invariants()
    eng.run_until_idle()
    for rid in live:
        list(eng.tokens_for(rid))
    eng.check_invariants()
    assert eng.stats()["active"] == 0
