"""Parity of the port's unpaged KV-cache path (`ray_tpu_torch.models.gpt`
`init_kv_cache` / `prefill` / `decode_step`, and `ops.decode_attention.
decode_attention`) with the JAX package's on the CPU. The same numpy
inputs and JAX-initialised params go through JAX with its decode kernel
in interpret mode (``impl="pallas"``) and its pure-JAX path (``"jax"``),
and through the port's plain versions.

Tolerances: `decode_attention` f32 1e-5 (same f32 math, another summation
order); bf16 2**-7 |ref| + 1e-5 against JAX's plain path (both round one
f32 result to bf16) and 2e-2 against its kernel, which also rounds p to
bf16 before p . V (the JAX package's own bf16 tolerance,
`tests/test_infer.py`). Model logits: f32 1e-4 (summation order through
~10 matmuls), bf16 5e-2 (the JAX package's bf16 serving tolerance: the
two frameworks round bf16 intermediates at different places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.ops import decode_attention as jda
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import decode_attention as tda

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64)


# ---------------------------------------------------------------------------
# decode attention over a contiguous cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(dtype):
    """Positions 0, mid-block (block_kv 128) and S - 1."""
    rng = np.random.default_rng(0)
    b, s, h, d = 3, 256, 2, 64
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, d), (b, s, h, d), (b, s, h, d)))
    pos = np.asarray([0, 100, s - 1], np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = {impl: np.asarray(jda.decode_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(pos),
        impl=impl, block_kv=128), np.float32) for impl in ("jax", "pallas")}
    got = tda.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(pos), block_kv=128)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        for w in want.values():
            np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want["jax"])
                      <= 2 ** -7 * np.abs(want["jax"]) + 1e-5)
        np.testing.assert_allclose(got, want["pallas"], atol=2e-2,
                                   rtol=2e-2)


def test_decode_attention_plain_path_and_errors():
    """On the CPU "auto"/"pallas" take the plain version without counting
    a launch; entries past pos never contribute; bad impls and shapes
    raise."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 16))
                         .astype(np.float32))
    pos = torch.tensor([3, 31], dtype=torch.int32)
    before = tda.kernel_launches()
    outs = [tda.decode_attention(q, k, -k, pos, impl=impl)
            for impl in ("auto", "pallas", "jax")]
    assert tda.kernel_launches() == before
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    k2 = k.clone()
    k2[0, 4:] = 1e4
    torch.testing.assert_close(tda.decode_attention(q, k2, -k, pos)[0],
                               outs[0][0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown"):
        tda.decode_attention(q, k, k, pos, impl="nope")
    with pytest.raises(ValueError, match="wants q"):
        tda.decode_attention(k, k, k, pos)


# ---------------------------------------------------------------------------
# prefill + decode_step against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    cfg = jgpt.GPTConfig(**CFG, dtype="float32")
    return jax.tree.map(np.asarray,
                        jgpt.init_params(jax.random.PRNGKey(0), cfg))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("decode_impl", ["jax", "pallas"])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 5e-2)])
def test_prefill_then_decode_matches_jax(tree, dtype, atol, decode_impl):
    """Ragged prefill of 3 rows, then greedy decode_steps token for token;
    logits and the caches agree with JAX's at every step."""
    jcfg = jgpt.GPTConfig(**CFG, dtype=dtype, decode_attn_impl=decode_impl)
    tcfg = tgpt.GPTConfig(**CFG, dtype=dtype)
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, CFG["vocab_size"], (3, 9)).astype(np.int32)
    lens = np.asarray([5, 9, 7], np.int32)
    jcache = jgpt.init_kv_cache(jcfg, 3, 32)
    tcache = tgpt.init_kv_cache(tcfg, 3, 32, device="cpu")
    jl, jcache = jgpt.prefill(_j(tree), jnp.asarray(toks), jcache, jcfg,
                              lengths=jnp.asarray(lens))
    tl, _ = tgpt.prefill(model, torch.from_numpy(toks), tcache, tcfg,
                         lengths=torch.from_numpy(lens))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)
    pos = lens.copy()
    for _ in range(4):
        nxt = np.argmax(_np(jl), axis=-1).astype(np.int32)
        jl, jcache = jgpt.decode_step(_j(tree), jnp.asarray(nxt), jcache,
                                      jnp.asarray(pos), jcfg)
        tl, _ = tgpt.decode_step(model, torch.from_numpy(nxt), tcache,
                                 torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)
        pos += 1
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   atol=atol, rtol=0)


def test_matches_full_forward_and_slot_prefill(tree):
    """A slot-targeted prefill lands in its row only; decode there
    reproduces the full forward's next-token logits (f32)."""
    jcfg = jgpt.GPTConfig(**CFG, dtype="float32")
    tcfg = tgpt.GPTConfig(**CFG, dtype="float32")
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, 128, (1, 6)).astype(np.int32)
    full = np.asarray(jgpt.forward(_j(tree), jnp.asarray(toks), jcfg))
    cache = tgpt.init_kv_cache(tcfg, 4, 16, device="cpu")
    cache["k"][:, 0] = 7.0      # garbage in another slot stays there
    logits, cache = tgpt.prefill(model, torch.from_numpy(toks), cache, tcfg,
                                 slot=2)
    np.testing.assert_allclose(_np(logits)[0], full[0, -1], atol=1e-4)
    assert torch.all(cache["k"][:, 0] == 7.0)
    assert torch.all(cache["k"][:, 1] == 0)
    assert torch.all(cache["k"][:, 3] == 0)
    nxt = int(np.argmax(full[0, -1]))
    ext = np.asarray(jgpt.forward(
        _j(tree), jnp.asarray(np.append(toks, nxt)[None]), jcfg))
    dtoks = torch.zeros(4, dtype=torch.int32)
    dtoks[2] = nxt
    dpos = torch.zeros(4, dtype=torch.int32)
    dpos[2] = 6
    dl, _ = tgpt.decode_step(model, dtoks, cache, dpos, tcfg)
    np.testing.assert_allclose(_np(dl)[2], ext[0, -1], atol=1e-4)


def test_decode_past_the_cache_drops_the_write(tree):
    """A row at or past max_len writes nothing (JAX drops the
    out-of-bounds scatter) and attends to the whole cache; the other row
    is unaffected. Logits and caches agree with JAX's."""
    jcfg = jgpt.GPTConfig(**CFG, dtype="float32")
    tcfg = tgpt.GPTConfig(**CFG, dtype="float32")
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    noise = np.random.default_rng(5).standard_normal(
        (2, 2, 16, 2, 16)).astype(np.float32)
    jcache = {"k": jnp.asarray(noise), "v": jnp.asarray(-noise)}
    tcache = {"k": torch.from_numpy(noise.copy()),
              "v": torch.from_numpy(-noise)}
    before = tcache["k"].clone()
    toks, pos = np.asarray([3, 9], np.int32), np.asarray([20, 5], np.int32)
    jl, jcache = jgpt.decode_step(_j(tree), jnp.asarray(toks), jcache,
                                  jnp.asarray(pos), jcfg)
    tl, _ = tgpt.decode_step(model, torch.from_numpy(toks), tcache,
                             torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    assert torch.equal(tcache["k"][:, 0], before[:, 0])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   atol=1e-5, rtol=0)


def test_validation_errors(tree):
    tcfg = tgpt.GPTConfig(**CFG, dtype="float32")
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        tgpt.init_kv_cache(tcfg, 2, CFG["max_seq_len"] + 1, device="cpu")
    # a cache on a mesh of one rank is the single-card cache (the
    # multi-rank caches are tests/test_torch_serve_mesh.py's)
    from ray_tpu_torch.parallel import single_device_mesh
    one = tgpt.init_kv_cache(tcfg, 2, 8, device="cpu",
                             mesh=single_device_mesh())
    assert one["k"].shape == (CFG["n_layers"], 2, 8, CFG["n_heads"],
                              CFG["d_model"] // CFG["n_heads"])
    cache = tgpt.init_kv_cache(tcfg, 2, 8, device="cpu")
    toks = torch.zeros((2, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds cache"):
        tgpt.prefill(model, toks, cache, tcfg)
    with pytest.raises(ValueError, match="pass slot"):
        tgpt.prefill(model, torch.zeros((3, 4), dtype=torch.int32), cache,
                     tcfg)
    with pytest.raises(ValueError, match="tokens \\[1, T\\]"):
        tgpt.prefill(model, toks, cache, tcfg, slot=0)
    with pytest.raises(ValueError, match="out of range"):
        tgpt.prefill(model, toks[:1, :4], cache, tcfg, slot=2)


def test_forward_features_with_kv_matches_jax(tree):
    """The stacked per-layer K/V [L, B, T, H, Dh] and the activations."""
    jcfg = jgpt.GPTConfig(**CFG, dtype="float32")
    tcfg = tgpt.GPTConfig(**CFG, dtype="float32")
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, 128, (2, 7)).astype(np.int32)
    jx, (jk, jv) = jgpt.forward_features(_j(tree), jnp.asarray(toks), jcfg,
                                         with_kv=True)
    with torch.no_grad():
        tx, (tk, tv) = tgpt.forward_features(model, torch.from_numpy(toks),
                                             with_kv=True)
    assert tk.shape == (2, 2, 7, 2, 16)
    for a, b in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=0)
