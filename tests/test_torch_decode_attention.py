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
from ray_tpu_torch.ops import pad_last_dim

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
    """A bad impl; int8 pools' scales are both-or-neither and shaped like
    the pool's rows ``[n_blocks, bs, H]`` on every paged wrapper, as in
    the reference (`_check_scales`); a prefill of the wrong rank."""
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(3, 8, 2, 16)
    qpool = torch.zeros(3, 8, 2, 16, dtype=torch.int8)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    scale = torch.ones(3, 8, 2)
    with pytest.raises(ValueError, match="impl"):
        tda.paged_decode_attention(q, pool, pool, tables, pos, impl="xla")
    calls = [(tda.paged_decode_attention, (q, qpool, qpool, tables, pos)),
             (tda.paged_verify_attention, (q[:, None], qpool, qpool, tables,
                                           pos)),
             (tda.paged_prefill_attention, (q, qpool, qpool, tables[0], 0))]
    for fn, args in calls:
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            fn(*args, k_scale=scale)
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            fn(*args, v_scale=scale)
        with pytest.raises(ValueError, match="scale shape"):
            fn(*args, k_scale=scale[:, :4], v_scale=scale)
        assert fn(*args, k_scale=scale, v_scale=scale).shape == \
            args[0].shape
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


# head dim -> the kernel head dim the wrappers run it at (None: raises)
_KERNEL_DIMS = {8: 8, 48: 48, 96: 96, 120: 120, 128: 128, 100: 104,
                136: 136, 4: 8, 256: 256, 0: None, 264: 264, 300: 304,
                512: 512, 520: 1024, 1024: 1024}


@pytest.mark.parametrize("d", list(_KERNEL_DIMS))
def test_kernel_input_check_takes_every_multiple_of_8_up_to_128(d):
    """The kernels' head dims (device-independent): every multiple of 8
    from 8 to 512 runs as it is and passes the kernels' input check; any
    other head dim up to 512 maps to the next multiple of 8, and one above
    512 to the next multiple of 512 (`kernel_head_dim`, the wrappers
    zero-pad to it; the kernels run it in slabs of 512), which passes,
    while the unpadded width does not; 0 raises."""
    want = _KERNEL_DIMS[d]
    tables = torch.zeros((2, 2), dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)

    def check(width):
        tda._check_kernel_inputs("op", torch.zeros((2, 2, width)),
                                 torch.zeros((3, 8, 2, width)),
                                 torch.zeros((3, 8, 2, width)),
                                 tables=tables, pos=pos)

    if want is None:
        with pytest.raises(ValueError, match="head dim"):
            tda.kernel_head_dim(d)
        return
    assert tda.kernel_head_dim(d) == want
    check(want)
    if want != d:
        with pytest.raises(ValueError, match="head dim"):
            check(d)


# ---------------------------------------------------------------------------
# split-K: the plain versions of the kernels' partial states and merge
# ---------------------------------------------------------------------------
# (block size, head dim): blocks 8, 16, 24, 64 and D 8, 96, 100, 256; each
# table reaches 320 or more positions, so past the 128-position splits.
_SPLIT_SHAPES = [(8, 8), (16, 96), (24, 100), (64, 256)]
NEG_INF_F32 = torch.tensor(tda.NEG_INF, dtype=torch.float32).item()


def _split_inputs(kind, bs, d, seed):
    """numpy (q, k_pool, v_pool, tables, pos) for 3 rows (prefill: row 0's
    table, pos = start) whose windows put KS - 1, KS and KS + 1 positions
    in view, start at 0 and reach the table's last row. Decode rows see
    P - 1, P and P + 1 positions for a split boundary P above `_ONE_CTA`
    (tables of `_ONE_CTA` + 300 positions or more), so every row splits."""
    rng = np.random.default_rng(seed)
    h = 2
    mb = -(-(tda._ONE_CTA + 300 if kind == "decode" else 320) // bs)
    span = mb * bs
    ks, _ = tda.split_geometry(span)
    b = 3
    kp, vp = _pool(rng, b * mb + 1, bs, h, d)
    tables = _tables(rng, b, mb, b * mb + 1)
    w = {"decode": 1, "verify1": 1, "verify4": 4, "prefill64": 64}[kind]
    if kind == "prefill64":
        # the chunk runs from ks - 33 to ks + 30: its rows see KS - 32 ..
        # KS + 31 positions, across the first split boundary
        pos = np.asarray([ks - 33], np.int32)
        tables = tables[:1]
    elif kind == "decode":
        edge = tda._ONE_CTA + ks
        pos = np.asarray([edge - 2, edge - 1, edge], np.int32)
    else:
        pos = np.asarray([0, ks - w, span - w], np.int32)   # last row: S-1
    shape = (len(pos), h, d) if kind == "decode" else (len(pos), w, h, d)
    return (rng.standard_normal(shape).astype(np.float32), kp, vp, tables,
            pos)


def _jax_pallas(kind, q, kp, vp, tables, pos):
    j = [jnp.asarray(a) for a in (q, kp, vp, tables, pos)]
    if kind == "decode":
        return np.asarray(jda.paged_decode_attention(*j, impl="pallas"))
    if kind == "prefill64":
        return np.asarray(jda.paged_prefill_attention(
            j[0][0], j[1], j[2], j[3][0], int(pos[0]), impl="pallas"))[None]
    return np.asarray(jda.paged_verify_attention(*j, impl="pallas"))


@pytest.mark.parametrize("kind", ["decode", "verify1", "verify4",
                                  "prefill64"])
@pytest.mark.parametrize("bs,d", _SPLIT_SHAPES)
def test_split_partials_and_merge_match_jax(kind, bs, d):
    """The split-K kernels' arithmetic in plain PyTorch (per-split softmax
    states, merged in split order) against JAX's Pallas kernels in
    interpret mode (which pad D 100 to 104 themselves), f32, atol 1e-5:
    the two differ only in summation order."""
    q, kp, vp, tables, pos = _split_inputs(kind, bs, d, seed=bs + d)
    want = _jax_pallas(kind, q, kp, vp, tables, pos)
    tq, tk, tv, tt, tp = (torch.from_numpy(a)
                          for a in (q, kp, vp, tables, pos))
    ks, n_split = tda.split_geometry(tables.shape[1] * bs)
    assert ks == 128 and n_split >= 3
    if kind == "decode":
        parts = tda.paged_decode_partials_reference(tq, tk, tv, tt, tp,
                                                    n_split)
    else:
        parts = tda.paged_mq_partials_reference(tq, tk, tv, tt, tp, ks)
    m, l, acc = parts
    assert m.shape[0] == n_split and acc.shape == (n_split,) + want.shape
    # a split a query sees nothing of holds (NEG_INF, 0, 0)
    dead = m == NEG_INF_F32
    assert dead.any() and torch.all(l[dead] == 0)
    if kind == "decode":     # every row splits, the last one split more
        live = (~dead).sum(dim=0)[:, 0].tolist()
        assert live[0] == live[1] > 1 and live[2] == live[1] + 1
    got = tda.paged_merge_reference(m, l, acc)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("span,ks,n", [(100, 128, 1), (1024, 128, 8),
                                        (2048, 128, 16), (4091, 256, 16),
                                        (4219, 384, 11)])
def test_split_geometry_is_fixed_by_shapes(span, ks, n):
    """Splits of a multiple of 128 positions, at most 16 a row, and the
    fewest positions a split that keeps to 16."""
    assert tda.split_geometry(span) == (ks, n)


def _tc_walk(q, kp, vp, tables, pos, ks, kt):
    """The bf16 multi-query kernel's arithmetic on the f32 values of bf16
    inputs: per split of ``ks`` positions, key tiles of ``kt``, the
    online softmax with p rounded to bf16 relative to the running row max
    before p . V (l sums the f32 p), then the split-order merge."""
    return tda.paged_merge_reference(*tda.paged_mq_partials_reference(
        q, kp, vp, tables, pos, ks, tile=kt))


@pytest.mark.parametrize("kind,bs,d", [("prefill64", 16, 64),
                                       ("verify4", 24, 96),
                                       ("verify1", 64, 256)])
def test_tensor_core_walk_stays_inside_the_card_limit(kind, bs, d):
    """The bf16 multi-query kernel (key tiles of 64, 32 at D 256; splits
    of 128) rounds p to bf16 relative to its running row max before
    p . V. Its emulation, rounded to bf16, is held against JAX's Pallas
    kernel on the same bf16 inputs within the card's limit: 1e-5 + 2**-7
    |ref| + 2**-8 P|V|. Its f32 output is held against the plain version
    within the rounding term alone (+ 1e-6 for summation order), and
    that term is not vacuous: the two differ."""
    q, kp, vp, tables, pos = _split_inputs(kind, bs, d, seed=7 * d)
    q, kp, vp = (torch.from_numpy(a).bfloat16() for a in (q, kp, vp))
    tt, tp = torch.from_numpy(tables), torch.from_numpy(pos)
    ks, _ = tda.split_geometry(tables.shape[1] * bs)
    emu = _tc_walk(q, kp, vp, tt, tp, ks, 32 if d > 128 else 64)
    want = _jax_pallas(kind, *(np.asarray(x.float().numpy()
                                          if isinstance(x, torch.Tensor)
                                          else x)
                               for x in (q, kp, vp, tables, pos)))
    pv = tda.reference_paged_verify_attention(q.float(), kp.float(),
                                              vp.float().abs(), tt, tp)
    limit = 1e-5 + 2 ** -7 * np.abs(want) + 2 ** -8 * pv.numpy()
    assert np.all(np.abs(emu.bfloat16().float().numpy() - want) <= limit)
    plain = tda.reference_paged_verify_attention(q.float(), kp.float(),
                                                 vp.float(), tt, tp)
    err = (emu - plain).abs()
    assert err.max() > 0
    assert torch.all(err <= 2 ** -8 * pv + 1e-6)


@pytest.mark.parametrize("kind", ["decode", "prefill64"])
@pytest.mark.parametrize("d", [4, 12, 36, 100, 132, 300, 520])
def test_padded_ragged_head_dims_match_jax(kind, d):
    """What the wrappers hand the kernels for a head dim that is not a
    multiple of 8 (or, above 512, not a multiple of 512): q and the pools
    zero-padded to `kernel_head_dim` and the softmax scale of the true
    head dim. The split-K plain versions on
    those inputs, trimmed, against JAX's Pallas kernels on the unpadded
    inputs (which pad the same way themselves), f32, atol 1e-5."""
    q, kp, vp, tables, pos = _split_inputs(kind, 16, d, seed=d)
    want = _jax_pallas(kind, q, kp, vp, tables, pos)
    dk = tda.kernel_head_dim(d)
    assert dk % 8 == 0 and 0 < dk - d < (8 if d <= 512 else 512)
    tq, tk, tv = (pad_last_dim(torch.from_numpy(a), dk) for a in (q, kp, vp))
    assert torch.all(tk[..., d:] == 0)
    ks, n_split = tda.split_geometry(tables.shape[1] * 16)
    fn, cut = ((tda.paged_decode_partials_reference, n_split)
               if kind == "decode" else (tda.paged_mq_partials_reference, ks))
    got = tda.paged_merge_reference(*fn(tq, tk, tv, torch.from_numpy(tables),
                                        torch.from_numpy(pos), cut,
                                        d ** -0.5))
    assert torch.all(got[..., d:] == 0)
    np.testing.assert_allclose(got[..., :d].numpy(), want, atol=ATOL,
                               rtol=ATOL)


# ---------------------------------------------------------------------------
# the contiguous-cache decode kernel's split rule (shared by the paged one)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_split", [1, 3, 8, 16])
def test_decode_split_length_rule(n_split):
    """A row that sees at most `_ONE_CTA` positions is one split of all
    of them; a longer one is cut into splits of a multiple of 128
    positions, at most ``n_split`` of them, the fewest positions a split
    that does so; nothing is left over."""
    one = tda._ONE_CTA
    seen = torch.arange(0, 4 * 128 * n_split + 1)
    ks = tda.decode_split_length(seen, n_split)
    short = seen <= one
    assert torch.equal(ks[short], seen[short])
    long_ks, long_seen = ks[~short], seen[~short]
    assert torch.all(long_ks % 128 == 0)
    n_live = -(-long_seen // long_ks)
    assert torch.all(n_live <= n_split)
    assert torch.all(n_live >= min(2, n_split))
    wide = long_ks > 128              # one unit less would need more splits
    assert torch.all(-(-long_seen[wide] // (long_ks[wide] - 128)) > n_split)


def _decode_split_case(s, d, pos, seed):
    rng = np.random.default_rng(seed)
    b, h = len(pos), 2
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, np.asarray(pos, np.int32)


def _decode_positions(s):
    """Rows around the one-CTA threshold T and a 128-position split
    boundary above it (seeing P - 1, P and P + 1 positions), pos 0, the
    cache's last row and a pos past it."""
    t = tda._ONE_CTA
    edge = t + 128
    return [0, t - 1, t, edge - 2, edge - 1, edge, s - 1, s + 40]


@pytest.mark.parametrize("s,d", [(tda._ONE_CTA + 256, 64),
                                 (tda._ONE_CTA + 172, 100)])
def test_decode_split_partials_match_jax(s, d):
    """The decode kernel's arithmetic in plain PyTorch (each row cut by
    `decode_split_length`, per-split states merged in split order)
    against JAX's Pallas `_decode_kernel` in interpret mode, f32, atol
    1e-5. Rows that take one CTA sit beside rows that split, with
    positions just before, at and just after a split boundary, pos 0 and
    pos past S. Pallas takes S only at a multiple of 128 (or up to 128):
    a ragged S runs there on the cache zero-padded to the next multiple
    (the mask hides the padding), with pos past S clamped to S - 1 first,
    as the kernels clamp it. D 100 runs zero-padded to 104 with the true
    scale, as the wrapper hands it to the kernel."""
    q, k, v, pos = _decode_split_case(s, d, _decode_positions(s), seed=s + d)
    sp = -(-s // 128) * 128
    pad = ((0, 0), (0, sp - s), (0, 0), (0, 0))
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(np.pad(k, pad)),
        jnp.asarray(np.pad(v, pad)), jnp.asarray(np.minimum(pos, s - 1)),
        impl="pallas"))
    _, n_split = tda.split_geometry(s)
    dk = tda.kernel_head_dim(d)
    tq, tk, tv = (pad_last_dim(torch.from_numpy(a), dk) for a in (q, k, v))
    m, l, acc = tda.decode_partials_reference(tq, tk, tv,
                                              torch.from_numpy(pos),
                                              n_split, d ** -0.5)
    live = (m > NEG_INF_F32).sum(dim=0)[:, 0]       # splits per row
    assert live.tolist()[:2] == [1, 1] and live[2] > 1
    assert live[3] == live[4] and live[4] + 1 == live[5]
    assert m.shape[0] == n_split
    got = tda.paged_merge_reference(m, l, acc)[..., :d]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
