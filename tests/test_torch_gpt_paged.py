"""Parity of the port's paged GPT forwards (`ray_tpu_torch.models.gpt`)
with the JAX package's on the CPU, with JAX-initialised params carried
across by `params_from_numpy`: chunked `prefill_paged` followed by
`decode_step_paged` (logits and pool contents), the dense plain-attention
`forward`, and the out-of-bounds writes JAX drops (padded chunk rows,
positions past the block table), which must leave the pool bit-unchanged.

Tolerances: f32 atol 1e-4 on logits (same math, different summation
order through ~10 matmuls); bf16 atol 5e-2, the JAX package's own bf16
serving tolerance (`tests/test_infer.py`) — the two frameworks round
bf16 intermediates at different places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64)
BS, MB, NB = 8, 8, 20


@pytest.fixture(scope="module")
def tree():
    """JAX params as the nested dict of numpy arrays the port loads."""
    cfg = jgpt.GPTConfig(**CFG, dtype="float32")
    return jax.tree.map(np.asarray,
                        jgpt.init_params(jax.random.PRNGKey(0), cfg))


def _j(tree):
    """The same params as JAX arrays, so out-of-range reads clamp as
    they do under jit (numpy indexing would raise)."""
    return jax.tree.map(jnp.asarray, tree)


def _cfgs(dtype):
    return (jgpt.GPTConfig(**CFG, dtype=dtype),
            tgpt.GPTConfig(**CFG, dtype=dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _tables(rng, b):
    return (rng.permutation(NB - 1)[:b * MB] + 1).reshape(b, MB) \
        .astype(np.int32)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 5e-2)])
def test_prefill_then_decode_matches_jax(tree, dtype, atol):
    jcfg, tcfg = _cfgs(dtype)
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    tables = _tables(rng, 2)
    prompt = rng.integers(0, CFG["vocab_size"], 13).astype(np.int32)
    jpool = jgpt.init_kv_pool(jcfg, NB, BS)
    tpool = tgpt.init_kv_pool(tcfg, NB, BS, device="cpu")

    # two chunks of an 8-wide bucket: 8 real rows, then 5 + 3 padded
    for start, length in ((0, 8), (8, 5)):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :length] = prompt[start:start + length]
        jl, jpool = jgpt.prefill_paged(
            _j(tree), jnp.asarray(toks), jpool, jcfg,
            block_table=jnp.asarray(tables[0]), start=start, length=length)
        tl, _ = tgpt.prefill_paged(
            model, torch.from_numpy(toks), tpool, tcfg,
            block_table=torch.from_numpy(tables[0]), start=start,
            length=length)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)
    # row 1 idles on the trash block at pos 0, as the engine's idle rows
    tok = int(np.argmax(_np(jl)[0]))
    dec_tables = np.stack([tables[0], np.zeros(MB, np.int32)])
    for step in range(3):
        pos = np.asarray([13 + step, 0], np.int32)
        toks = np.asarray([tok, 0], np.int32)
        jl, jpool = jgpt.decode_step_paged(
            _j(tree), jnp.asarray(toks), jpool, jnp.asarray(pos),
            jnp.asarray(dec_tables), jcfg)
        tl, _ = tgpt.decode_step_paged(
            model, torch.from_numpy(toks), tpool, torch.from_numpy(pos),
            torch.from_numpy(dec_tables), tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)
        tok = int(np.argmax(_np(jl)[0]))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tpool[name]), _np(jpool[name]),
                                   atol=atol, rtol=0)


def test_dense_forward_matches_jax(tree):
    jcfg = jgpt.GPTConfig(**CFG, dtype="float32", attn_impl="xla")
    tcfg = tgpt.GPTConfig(**CFG, dtype="float32", attn_impl="xla")
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, 128, (2, 11))
    jl = jgpt.forward(_j(tree), jnp.asarray(toks, jnp.int32), jcfg)
    tl = tgpt.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    # the default attn_impl ("auto") routes to flash attention, as in
    # the reference; ring attention runs over a mesh's seq axis only
    jl = jgpt.forward(_j(tree), jnp.asarray(toks, jnp.int32),
                      jgpt.GPTConfig(**CFG, dtype="float32"))
    tl = tgpt.forward(tgpt.params_from_numpy(
        tree, tgpt.GPTConfig(**CFG, dtype="float32"), device="cpu"),
        torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="ring.*needs a mesh"):
        tgpt.forward(tgpt.params_from_numpy(
            tree, tgpt.GPTConfig(**CFG, dtype="float32", attn_impl="ring"),
            device="cpu"), torch.from_numpy(toks))


def test_out_of_bounds_writes_drop(tree):
    """A padded chunk tail that runs past both the table and pos_embed
    (start 56, 5 real rows in a 16-wide bucket, max_seq_len 64) writes
    only its real rows; decode rows past the table write nothing. The
    rest of the pool stays bit-identical, as under JAX's drop mode."""
    jcfg, tcfg = _cfgs("float32")
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    table = _tables(rng, 1)[0]
    noise = rng.standard_normal((CFG["n_layers"], NB, BS, 2, 16)) \
        .astype(np.float32)
    jpool = {"k": jnp.asarray(noise), "v": jnp.asarray(-noise)}
    tpool = tgpt.init_kv_pool(tcfg, NB, BS, device="cpu")
    tpool["k"].copy_(torch.from_numpy(noise))
    tpool["v"].copy_(torch.from_numpy(-noise))
    before = tpool["k"].clone(), tpool["v"].clone()

    toks = np.zeros((1, 16), np.int32)
    toks[0, :5] = rng.integers(0, 128, 5)
    jl, jpool = jgpt.prefill_paged(
        _j(tree), jnp.asarray(toks), jpool, jcfg,
        block_table=jnp.asarray(table), start=56, length=5)
    tl, _ = tgpt.prefill_paged(
        model, torch.from_numpy(toks), tpool, tcfg,
        block_table=torch.from_numpy(table), start=56, length=5)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    written = torch.zeros(NB, BS, dtype=torch.bool)
    for p in range(56, 61):
        written[table[p // BS], p % BS] = True
    for name, ref in zip(("k", "v"), before):
        assert torch.equal(tpool[name][:, ~written], ref[:, ~written])
        np.testing.assert_allclose(_np(tpool[name]), _np(jpool[name]),
                                   atol=1e-5, rtol=0)

    # every decode row past the table's reach: nothing lands anywhere
    before = tpool["k"].clone(), tpool["v"].clone()
    pos = np.asarray([MB * BS, MB * BS + 3], np.int32)
    toks2 = np.asarray([1, 2], np.int32)
    tables = np.stack([table, table])
    jl, jpool = jgpt.decode_step_paged(
        _j(tree), jnp.asarray(toks2), jpool, jnp.asarray(pos),
        jnp.asarray(tables), jcfg)
    tl, _ = tgpt.decode_step_paged(
        model, torch.from_numpy(toks2), tpool, torch.from_numpy(pos),
        torch.from_numpy(tables), tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    for name, ref in zip(("k", "v"), before):
        assert torch.equal(tpool[name], ref)


def test_copy_block_and_config_checks(tree):
    _, tcfg = _cfgs("float32")
    pool = tgpt.init_kv_pool(tcfg, 4, BS, device="cpu")
    pool["k"][:, 1] = 3.0
    pool["v"][:, 1] = -3.0
    tgpt.copy_block(pool, 1, 2)
    assert torch.equal(pool["k"][:, 2], pool["k"][:, 1])
    assert torch.equal(pool["v"][:, 2], pool["v"][:, 1])
    assert pool["k_rows"].shape == (CFG["n_layers"], 4 * BS + 1, 2, 16)
    # an int8 pool: scales beside the payload (sink row included), and a
    # block copy carries them
    qpool = tgpt.init_kv_pool(tgpt.GPTConfig(**CFG, kv_dtype="int8"), 4, BS,
                              device="cpu")
    assert set(qpool) == {"k", "v", "k_scale", "v_scale", "k_rows",
                          "v_rows", "k_scale_rows", "v_scale_rows"}
    assert qpool["k"].dtype == torch.int8
    assert qpool["k_scale_rows"].shape == (CFG["n_layers"], 4 * BS + 1, 2)
    qpool["k"][:, 1] = 3
    qpool["v_scale"][:, 1] = 0.5
    tgpt.copy_block(qpool, 1, 2)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(qpool[name][:, 2], qpool[name][:, 1])
    with pytest.raises(ValueError, match="kv_dtype"):
        tgpt.init_kv_pool(tgpt.GPTConfig(**CFG, kv_dtype="int4"), 4, BS,
                          device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        tgpt.check_quant_cfg(tgpt.GPTConfig(**CFG, kv_dtype="int4"))
    with pytest.raises(ValueError, match="weight_dtype"):
        tgpt.check_quant_cfg(tgpt.GPTConfig(**CFG, weight_dtype="int4"))
    with pytest.raises(ValueError, match="shape"):
        tgpt.params_from_numpy(tree, tgpt.GPTConfig(**{**CFG, "d_ff": 32}),
                               device="cpu")
