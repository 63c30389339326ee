"""Parity of the port's paged attention ops (`ray_tpu_torch.ops.
decode_attention`) with the JAX package's, on the CPU: the same numpy
inputs go through JAX's pure-JAX path (``impl="jax"``), its Pallas
kernels in interpret mode (``impl="pallas"``) and the port's plain
PyTorch versions. f32 throughout, atol 1e-5: both sides accumulate in
f32 and differ only in summation order.

The multi-query kernel is built for pool blocks of 8, 16 and 32; a pool
of any other multiple of 8 reaches it re-viewed (`split_blocks`). The
plain versions on the re-viewed pool and expanded tables must give
exactly what they give on the original pool, and the JAX package's
plain path at block 64 and head dim 96 what the port's gives on the
re-viewed pool."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import decode_attention as jda
from ray_tpu_torch.ops import decode_attention as tda

ATOL = 1e-5


def _pool(rng, nb, bs, h, d):
    return (rng.standard_normal((nb, bs, h, d)).astype(np.float32),
            rng.standard_normal((nb, bs, h, d)).astype(np.float32))


def _tables(rng, b, mb, nb):
    """Disjoint scrambled blocks per row; block 0 (trash) never named."""
    return (rng.permutation(nb - 1)[:b * mb] + 1).reshape(b, mb) \
        .astype(np.int32)


def _jax_both(fn, *args):
    return [np.asarray(fn(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args], impl=impl))
            for impl in ("jax", "pallas")]


def _torch(fn, *args, **kw):
    return fn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in args], **kw).numpy()


def test_gather_kv_pages_matches():
    rng = np.random.default_rng(0)
    kp, _ = _pool(rng, 9, 8, 2, 16)
    tables = _tables(rng, 2, 4, 9)
    np.testing.assert_array_equal(
        _torch(tda.gather_kv_pages, kp, tables),
        np.asarray(jda.gather_kv_pages(jnp.asarray(kp),
                                       jnp.asarray(tables))))


@pytest.mark.parametrize("pos", [
    (0, 7, 8, 31),       # first token, block end, next block start, last
    (3, 19, 20, 12),     # ragged mid-block positions
])
def test_paged_decode_matches_jax(pos):
    rng = np.random.default_rng(sum(pos))
    b, h, d, bs, mb = 4, 2, 16, 8, 4
    kp, vp = _pool(rng, b * mb + 1, bs, h, d)
    tables = _tables(rng, b, mb, b * mb + 1)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    ref_jax, ref_pallas = _jax_both(jda.paged_decode_attention, q, kp, vp,
                                    tables, pos)
    got = _torch(tda.paged_decode_attention, q, kp, vp, tables, pos)
    np.testing.assert_allclose(got, ref_jax, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL, rtol=ATOL)


def test_paged_verify_matches_jax():
    rng = np.random.default_rng(7)
    b, w, h, d, bs, mb = 2, 3, 2, 16, 8, 4
    kp, vp = _pool(rng, b * mb + 1, bs, h, d)
    tables = _tables(rng, b, mb, b * mb + 1)
    q = rng.standard_normal((b, w, h, d)).astype(np.float32)
    pos = np.asarray([5, 22], np.int32)   # 22 + 2 crosses into block 3
    ref_jax, ref_pallas = _jax_both(jda.paged_verify_attention, q, kp, vp,
                                    tables, pos)
    got = _torch(tda.paged_verify_attention, q, kp, vp, tables, pos)
    np.testing.assert_allclose(got, ref_jax, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("start,c", [(0, 8), (8, 5), (13, 16), (16, 8)])
def test_paged_prefill_matches_jax(start, c):
    """start > 0, block-aligned and mid-block starts, a ragged chunk."""
    rng = np.random.default_rng(start * 100 + c)
    h, d, bs, mb = 2, 16, 8, 4
    kp, vp = _pool(rng, mb + 1, bs, h, d)
    table = (rng.permutation(mb) + 1).astype(np.int32)
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    ref_jax, ref_pallas = _jax_both(jda.paged_prefill_attention, q, kp, vp,
                                    table, start)
    got = _torch(tda.paged_prefill_attention, q, kp, vp, table, start)
    np.testing.assert_allclose(got, ref_jax, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL, rtol=ATOL)
    # the start may also ride in as a one-element int32 tensor
    got_t = _torch(tda.paged_prefill_attention, q, kp, vp, table,
                   torch.tensor([start], dtype=torch.int32))
    np.testing.assert_array_equal(got_t, got)


def test_cpu_tensors_take_the_plain_path_without_counting():
    """On the CPU "auto"/"pallas" run the plain version (there is no
    kernel there) and the launch counters do not move."""
    rng = np.random.default_rng(3)
    kp, vp = _pool(rng, 5, 8, 2, 16)
    tables = _tables(rng, 1, 4, 5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16)).astype(np.float32))
    args = (q, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tables), torch.tensor([9], dtype=torch.int32))
    before = tda.kernel_launches()
    outs = [tda.paged_decode_attention(*args, impl=impl)
            for impl in ("auto", "pallas", "jax")]
    assert tda.kernel_launches() == before
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)


def test_rejects_bad_impl_and_int8_pools():
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(3, 8, 2, 16)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        tda.paged_decode_attention(q, pool, pool, tables, pos, impl="xla")
    with pytest.raises(NotImplementedError, match="int8"):
        tda.paged_decode_attention(q, pool, pool, tables, pos,
                                   k_scale=torch.ones(3, 8, 2),
                                   v_scale=torch.ones(3, 8, 2))
    with pytest.raises(ValueError, match="paged_prefill_attention"):
        tda.paged_prefill_attention(q, pool, pool, tables, 0)


def _split_case(bs, kind, seed):
    """(q, k_pool, v_pool, tables, pos) as numpy for a block-``bs`` pool
    of 3 rows x 4 blocks, H 2, D 16: decode ([B, H, D]), verify
    ([B, W, H, D]) or prefill ([C, H, D] through row 0's table)."""
    rng = np.random.default_rng(seed)
    b, mb, h, d = 3, 4, 2, 16
    kp, vp = _pool(rng, b * mb + 1, bs, h, d)
    tables = _tables(rng, b, mb, b * mb + 1)
    span = mb * bs
    if kind == "prefill":
        c = min(bs + 3, span)
        return (rng.standard_normal((c, h, d)).astype(np.float32), kp, vp,
                tables[0], span - c)
    pos = np.asarray([0, bs - 1, span - 2], np.int32)
    shape = (b, h, d) if kind == "decode" else (b, 3, h, d)
    return rng.standard_normal(shape).astype(np.float32), kp, vp, tables, pos


_PLAIN = {"decode": tda.reference_paged_decode_attention,
          "verify": tda.reference_paged_verify_attention,
          "prefill": tda.reference_paged_prefill_attention}


@pytest.mark.parametrize("kind", ["prefill", "verify"])
@pytest.mark.parametrize("bs", [8, 16, 24, 32, 40, 48, 64, 96, 128])
def test_split_blocks_gives_the_same_attention(kind, bs):
    """Every logical position lands on the same pool element after the
    re-view, so the plain versions agree bit for bit."""
    q, kp, vp, tables, pos = (torch.from_numpy(a)
                              if isinstance(a, np.ndarray) else a
                              for a in _split_case(bs, kind, bs))
    k2, v2, t2 = tda.split_blocks(kp, vp, tables)
    sub = next(x for x in (32, 16, 8) if bs % x == 0)
    f = bs // sub
    assert k2.shape == (kp.shape[0] * f, sub) + tuple(kp.shape[2:])
    assert v2.shape == k2.shape and t2.dtype == torch.int32
    assert t2.shape[-1] == tables.shape[-1] * f
    assert k2.data_ptr() == kp.data_ptr()          # a view, not a copy
    np.testing.assert_array_equal(
        tda.gather_kv_pages(k2, t2.reshape(-1, t2.shape[-1])).numpy(),
        tda.gather_kv_pages(kp, tables.reshape(-1, tables.shape[-1]))
        .numpy())
    want = _PLAIN[kind](q, kp, vp, tables, pos)
    got = _PLAIN[kind](q, k2, v2, t2, pos)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bs", [4, 12, 20, 36])
def test_split_blocks_rejects_block_sizes_off_the_multiples_of_8(bs):
    kp = torch.zeros((3, bs, 2, 16))
    with pytest.raises(ValueError, match="multiple of 8"):
        tda.split_blocks(kp, kp, torch.zeros((1, 2), dtype=torch.int32))


@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
def test_block64_head_dim96_matches_jax(kind):
    """The configuration the card used to refuse (an engine at block 64
    over a model with head dim 96): JAX's plain path on the original
    pool against the port's plain versions on the re-viewed one."""
    rng = np.random.default_rng(96)
    b, mb, h, d, bs = 2, 3, 2, 96, 64
    kp, vp = _pool(rng, b * mb + 1, bs, h, d)
    tables = _tables(rng, b, mb, b * mb + 1)
    pos = np.asarray([5, 150], np.int32)
    if kind == "decode":
        q = rng.standard_normal((b, h, d)).astype(np.float32)
        args, jfn = (q, kp, vp, tables, pos), jda.paged_decode_attention
    elif kind == "verify":
        q = rng.standard_normal((b, 4, h, d)).astype(np.float32)
        args, jfn = (q, kp, vp, tables, pos), jda.paged_verify_attention
    else:
        q = rng.standard_normal((40, h, d)).astype(np.float32)
        args, jfn = (q, kp, vp, tables[1], 100), jda.paged_prefill_attention
    want = np.asarray(jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args], impl="jax"))
    q, kp, vp, tbl = (torch.from_numpy(a) for a in args[:4])
    k2, v2, t2 = tda.split_blocks(kp, vp, tbl)
    got = _PLAIN[kind](q, k2, v2, t2, args[4] if kind == "prefill"
                       else torch.from_numpy(args[4]))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("d,ok", [(8, True), (48, True), (96, True),
                                  (120, True), (128, True), (100, False),
                                  (136, False), (4, False)])
def test_kernel_input_check_takes_every_multiple_of_8_up_to_128(d, ok):
    """The kernels' input check (device-independent): every head dim that
    is a multiple of 8 from 8 to 128 passes, others raise."""
    q = torch.zeros((2, 2, d))
    pool = torch.zeros((3, 8, 2, d))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    if ok:
        tda._check_kernel_inputs("op", q, pool, pool, tables=tables,
                                 pos=pos)
    else:
        with pytest.raises(ValueError, match="head dim"):
            tda._check_kernel_inputs("op", q, pool, pool, tables=tables,
                                     pos=pos)
