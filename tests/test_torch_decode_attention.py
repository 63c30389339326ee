"""Parity of the port's paged attention ops (`ray_tpu_torch.ops.
decode_attention`) with the JAX package's, on the CPU: the same numpy
inputs go through JAX's pure-JAX path (``impl="jax"``), its Pallas
kernels in interpret mode (``impl="pallas"``) and the port's plain
PyTorch versions. f32 throughout, atol 1e-5: both sides accumulate in
f32 and differ only in summation order."""

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
