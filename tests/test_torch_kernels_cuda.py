"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; on a
machine with a card (and no JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances, per element |kernel - plain| <= atol + rtol * |plain|: f32
atol 2e-5 (summation order and expf only); bf16 atol 1e-5, rtol 2**-7
(the kernel and the plain version both accumulate in f32 from the same
bf16 inputs, so they differ by at most the final rounding to bf16, one
ulp, which is at most 2**-7 of the value). The bf16 multi-query kernel
(tensor cores) also rounds p to bf16 before p . V, relative to its
running row max, which moves each element by at most 2**-8 (P |V|) more
(P the softmax, from the plain version)."""

import pytest
import torch

from ray_tpu_torch.ops import decode_attention as da

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=2e-5, rtol=0),
       torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mq_close(got, ref, q, kp, vp, tables, pos):
    """|kernel - plain| within TOL, plus 2**-8 P|V| for bf16."""
    tol = TOL[q.dtype]
    limit = tol["atol"] + tol["rtol"] * ref.float().abs()
    if q.dtype == torch.bfloat16:
        limit = limit + 2 ** -8 * da.reference_paged_verify_attention(
            q.float(), kp.float(), vp.float().abs(), tables, pos)
    over = ((got.float() - ref.float()).abs() - limit).max().item()
    assert over <= 0, f"off by {over:.3e} beyond its limit"


def _inputs(dev, dtype, b, h, d, bs, mb, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = b * mb + 1
    kp = torch.randn((nb, bs, h, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((nb, bs, h, d), generator=g, device=dev).to(dtype)
    tables = (torch.randperm(nb - 1, generator=g, device=dev)[:b * mb] + 1) \
        .view(b, mb).to(torch.int32).contiguous()
    return g, kp, vp, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 8, 100, 136, 256, 264, 512, 520, 1024])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 24])
def test_decode_kernel_matches_plain(dev, dtype, d, bs):
    """Split-K decode: tables of `_ONE_CTA` + 300 positions or more (6
    splits of 128 and more). Rows that take one CTA see 1 position, a
    block's end, the next block's start and `_ONE_CTA` positions; rows
    that split see P - 1, P and P + 1 positions for a split boundary P
    above `_ONE_CTA` (mid-block at block 24) and the table's last row,
    or run past it. D 100 runs zero-padded to 104; D 264 and 512 on 32
    lanes of 2 (f32: 4) vectors; D 520 zero-padded to 1024, which runs in
    two slabs of 512."""
    h = 3
    mb = -(-(da._ONE_CTA + 300) // bs)
    ks, n_split = da.split_geometry(mb * bs)
    edge = da._ONE_CTA + ks
    rows = [0, bs - 1, bs, da._ONE_CTA - 1, edge - 2, edge - 1, edge,
            mb * bs - 1, mb * bs + 7]
    b = len(rows)
    g, kp, vp, tables = _inputs(dev, dtype, b, h, d, bs, mb)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    pos = torch.tensor(rows, dtype=torch.int32, device=dev)
    seen = pos.clamp(max=mb * bs - 1) + 1
    live = -(-seen // da.decode_split_length(seen, n_split))
    assert live[:4].tolist() == [1] * 4 and live[4] == live[5] > 1
    assert live[6] == live[5] + 1
    n = da.paged_decode_attention.launches
    got = da.paged_decode_attention(q, kp, vp, tables, pos)
    assert da.paged_decode_attention.launches == n + 1
    ref = da.reference_paged_decode_attention(q, kp, vp, tables, pos)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 8, 100, 256, 264, 512, 520, 1024])
@pytest.mark.parametrize("bs", [8, 16, 24, 32, 64])
def test_prefill_and_verify_kernel_match_plain(dev, dtype, d, bs):
    """bf16 up to D 256 runs the tensor-core kernel on the pool as it is,
    f32 and bf16 above 256 the CUDA-core kernel (blocks 24 and 64
    re-viewed as blocks of 8 and 32, `split_blocks`; D 520 zero-padded to
    1024, in two slabs of 512). Tables of 300 or more positions (3 splits of 128):
    chunks at the start, at a block start, ragged, and of 64 rows
    across the first split boundary; verify W 1, 4 and 64 with windows
    that see KS - 1, KS and KS + 1 positions or run past the table's
    reach. D 100 runs zero-padded to 104."""
    b, h = 3, 2
    mb = -(-300 // bs)
    ks, _ = da.split_geometry(mb * bs)
    g, kp, vp, tables = _inputs(dev, dtype, b, h, d, bs, mb, seed=1)
    kind = ("paged_mq_tc" if dtype == torch.bfloat16 and d <= 256
            else "paged_mq_simt")
    one = tables.new_zeros(1)
    for c, start in ((5, 0), (bs, bs), (40, 3), (64, ks - 33)):
        q = torch.randn((c, h, d), generator=g, device=dev).to(dtype)
        n = da.paged_prefill_attention.launches
        kernels = dict(da.LAUNCHES)
        got = da.paged_prefill_attention(q, kp, vp, tables[0], start)
        assert da.paged_prefill_attention.launches == n + 1
        assert {k: da.LAUNCHES[k] - kernels[k] for k in kernels} == \
            {k: int(k == kind) for k in kernels}
        ref = da.reference_paged_prefill_attention(q, kp, vp, tables[0],
                                                   start)
        _mq_close(got[None], ref[None], q[None], kp, vp, tables[:1],
                  one + start)
    for w in (1, 4, 64):
        q = torch.randn((b, w, h, d), generator=g, device=dev).to(dtype)
        pos = torch.tensor([ks - w - 1, ks - w + 1, mb * bs - 3],
                           dtype=torch.int32, device=dev)
        n = da.paged_verify_attention.launches
        got = da.paged_verify_attention(q, kp, vp, tables, pos)
        assert da.paged_verify_attention.launches == n + 1
        ref = da.reference_paged_verify_attention(q, kp, vp, tables, pos)
        _mq_close(got, ref, q, kp, vp, tables, pos)


_SERVING = dict(b=8, h=16, d=64, bs=16, mb=64)   # bench_infer.py's pool


def _serving_call(dev, kind):
    """(fn, args, pos index) for one split-K call at the serving shapes
    (bf16): decode at B 8 through the pool or over a contiguous [8, 1024,
    16, 64] cache ("dense"), a 64-token prefill chunk at start 960, or a
    W 4 verify; pos is args[pos index], a device tensor."""
    sv = _SERVING
    g, kp, vp, tables = _inputs(dev, torch.bfloat16, sv["b"], sv["h"],
                                sv["d"], sv["bs"], sv["mb"], seed=3)
    pos = torch.tensor([0, 15, 16, 100, 511, 700, 1000, 1023],
                       dtype=torch.int32, device=dev)
    if kind == "dense":
        q = torch.randn((sv["b"], sv["h"], sv["d"]), generator=g,
                        device=dev).bfloat16()
        k, v = (torch.randn((sv["b"], sv["mb"] * sv["bs"], sv["h"],
                             sv["d"]), generator=g, device=dev).bfloat16()
                for _ in range(2))
        return da.decode_attention, [q, k, v, pos], 3
    if kind == "decode":
        q = torch.randn((sv["b"], sv["h"], sv["d"]), generator=g,
                        device=dev).bfloat16()
        return da.paged_decode_attention, [q, kp, vp, tables, pos], 4
    if kind == "prefill":
        q = torch.randn((64, sv["h"], sv["d"]), generator=g,
                        device=dev).bfloat16()
        start = torch.tensor([960], dtype=torch.int32, device=dev)
        return da.paged_prefill_attention, [q, kp, vp, tables[0], start], 4
    q = torch.randn((sv["b"], 4, sv["h"], sv["d"]), generator=g,
                    device=dev).bfloat16()
    pos[-1] = 1020                      # the last window ends at 1023
    return da.paged_verify_attention, [q, kp, vp, tables, pos], 4


@pytest.mark.parametrize("kind", ["decode", "prefill", "verify", "dense"])
def test_split_kernels_are_deterministic_and_capturable(dev, kind):
    """At the serving shapes: two calls give bit-identical outputs (the
    split-order merge), the output matches the plain version, and a CUDA
    graph that captured one call, replayed after pos changed on the
    device, gives exactly what an eager call with the new pos gives
    (grid fixed by shapes, pos read on the device, the ticket buffer
    reused)."""
    fn, args, ip = _serving_call(dev, kind)
    first, second = fn(*args), fn(*args)
    assert torch.equal(first, second)
    ref_fn = {da.decode_attention: da.reference_decode_attention,
              da.paged_decode_attention:
              da.reference_paged_decode_attention,
              da.paged_prefill_attention:
              da.reference_paged_prefill_attention,
              da.paged_verify_attention:
              da.reference_paged_verify_attention}[fn]
    if kind in ("decode", "dense"):
        torch.testing.assert_close(first.float(), ref_fn(*args).float(),
                                   **TOL[torch.bfloat16])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)                       # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = fn(*args)
    new_pos = args[ip].flip(0) if kind != "prefill" else args[ip] - 900
    args[ip].copy_(new_pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn(*args))
    assert not torch.equal(captured, first)
    if kind in ("decode", "dense"):
        torch.testing.assert_close(captured.float(), ref_fn(*args).float(),
                                   **TOL[torch.bfloat16])


def test_unsupported_inputs_raise_instead_of_falling_back(dev):
    """Head dim 0, multi-query block sizes not a multiple of 8, and index
    tensors that are not int32 raise; a head dim above 256 (264, once
    refused) runs on the kernel and matches the plain version."""
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    for d in (264, 0):
        g, kp, vp, tables = _inputs(dev, torch.float32, 1, 2, d, 16, 2)
        q = torch.randn((1, 2, d), generator=g, device=dev)
        if d:
            torch.testing.assert_close(
                da.paged_decode_attention(q, kp, vp, tables, pos + 20),
                da.reference_paged_decode_attention(q, kp, vp, tables,
                                                    pos + 20),
                **TOL[torch.float32])
            continue
        with pytest.raises(ValueError, match="head dim"):
            da.paged_decode_attention(q, kp, vp, tables, pos)
    for dtype in (torch.float32, torch.bfloat16):
        _, kp, vp, tables = _inputs(dev, dtype, 1, 2, 64, 12, 2)
        with pytest.raises(ValueError, match="block size"):
            da.paged_prefill_attention(
                torch.zeros((4, 2, 64), device=dev, dtype=dtype), kp, vp,
                tables[0], 0)
    _, kp, vp, tables = _inputs(dev, torch.float32, 1, 2, 64, 16, 2)
    q = torch.zeros((1, 2, 64), device=dev)
    with pytest.raises(TypeError, match="int32"):
        da.paged_decode_attention(q, kp, vp, tables.long(), pos)


# ---------------------------------------------------------------------------
# flash attention: forward, dQ, dK/dV against the plain versions
# ---------------------------------------------------------------------------
# Forward out/lse and all three gradients: both sides accumulate in f32
# from the same inputs, so they differ by summation order (f32: 2e-5
# absolute at these unit-scale values; dq/dk/dv sum up to T products,
# hence 1e-4) plus, in bf16, one final rounding to bf16 (2**-7 of the
# value). lse is f32 on both sides. The bf16 forward also rounds each p
# to bf16 before p . V, the kernel relative to its running row max and
# the plain version relative to the final one, so each term may differ
# by one more bf16 rounding (2**-8 of it): per element the forward may
# differ by 2**-8 * (P |V|) on top.
FLASH_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-4, rtol=2 ** -7)}
# The bf16 tensor-core backward (kernel head dim 64 and 128) also rounds
# P and dS to bf16 once before its products, which moves each element by
# at most bf16's unit roundoff 2**-8 times the same product of absolute
# values: scale |dS| |K| (dq), scale |dS|^T |Q| (dk), |P|^T |dO| (dv),
# from the plain version's f32 P and dS (`flash_backward_abs_bound`).


def _close_with(got, ref, tol, extra=None):
    limit = tol["atol"] + tol["rtol"] * ref.float().abs()
    if extra is not None:
        limit = limit + 2 ** -8 * extra
    over = (got.float() - ref.float()).abs() - limit
    assert over.max().item() <= 0, (
        f"off by {over.max().item():.3e} beyond its limit")


def _forward_ok(out, ref, q, k, v, causal):
    from ray_tpu_torch.ops import flash_attention as fa
    tol = FLASH_TOL[q.dtype]
    limit = tol["atol"] + tol["rtol"] * ref.float().abs()
    if q.dtype == torch.bfloat16:
        p_abs_v = fa.flash_forward_reference(
            q.float(), k.float(), v.float().abs(), causal=causal)[0]
        limit = limit + 2 ** -8 * p_abs_v
    over = (out.float() - ref.float()).abs() - limit
    assert over.max().item() <= 0, (
        f"forward off by {over.max().item():.3e} beyond its limit")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 48, 64, 96, 128, 100, 160, 256, 264, 512, 520, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 64, 129, 1000, 1024])
def test_flash_kernels_match_plain(dev, dtype, d, causal, t):
    """T 1 and 129 (one row past a 128-row tile) put whole tensor-core
    tiles past T; bf16 at kernel head dim 64 and 128 runs on the tensor
    cores, everything else on the CUDA-core kernels (D 256 on 32-row
    tiles, D 512 on 16-row tiles). D 48, 96, 100, 160, 264 and 520 run
    zero-padded to 64, 128, 128, 256, 512 and 1024; D 1024 in two slabs
    of 512."""
    from ray_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(t + d)
    b, h = 2, 2
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    n = [f.launches for f in fa.WRAPPERS]
    fwd = dict(fa.LAUNCHES)
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal=causal)
    _forward_ok(out, ref_out, q, k, v, causal)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    delta = fa.attention_delta(ref_out, do)
    dq = fa.flash_dq(q, k, v, do, ref_lse, delta, causal=causal)
    dk, dv = fa.flash_dkv(q, k, v, do, ref_lse, delta, causal=causal)
    refs = fa.flash_backward_reference(q, k, v, do, ref_lse, delta,
                                       causal=causal)
    tc = dtype == torch.bfloat16 and fa.kernel_head_dim(d) in (64, 128)
    extra = (fa.flash_backward_abs_bound(q, k, v, do, ref_lse, delta,
                                         causal=causal) if tc
             else (None,) * 3)
    for got, ref, bound in zip((dq, dk, dv), refs, extra):
        assert got.shape == ref.shape and got.dtype == dtype
        _close_with(got, ref, FLASH_TOL[dtype], bound)
    assert [f.launches for f in fa.WRAPPERS] == [x + 1 for x in n]
    ran = {f"flash_{k}_{'tc' if tc else 'simt'}" for k in ("fwd", "dq",
                                                           "dkv")}
    assert {k: fa.LAUNCHES[k] - fwd[k] for k in fwd} == \
        {k: int(k in ran) for k in fwd}


def test_flash_unsupported_inputs_raise(dev):
    """Head dim 0 and float16 raise; head dim 264 (once refused) runs."""
    from ray_tpu_torch.ops import flash_attention as fa
    for d in (264, 0):
        q = torch.randn((1, 8, 2, d), device=dev)
        if d:
            _forward_ok(fa.flash_forward(q, q, q, causal=True)[0],
                        fa.flash_forward_reference(q, q, q, causal=True)[0],
                        q, q, q, True)
            continue
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_forward(q, q, q, causal=True)
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_forward(q, q, q, causal=True)


# ---------------------------------------------------------------------------
# decode attention over a contiguous cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 48, 64, 96, 120, 128, 100, 136, 256,
                               264, 512, 520, 1024])
def test_dense_decode_kernel_matches_plain(dev, dtype, d):
    """A ragged cache length, pos 0, mid-cache, S - 1 and past S; a row
    that takes one CTA (seeing `_ONE_CTA` positions) beside rows that
    split (seeing one more; a split boundary's count and one more than
    that); f32 above 128 takes two vectors a lane, D 100 runs zero-padded
    to 104."""
    g = torch.Generator(device=dev).manual_seed(d)
    one = da._ONE_CTA
    b, s, h = 8, da._ONE_CTA + 300, 3
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    pos = torch.tensor([0, 100, one - 1, one, one + 127, one + 128,
                        s - 1, s + 50], dtype=torch.int32, device=dev)
    n = da.decode_attention.launches
    got = da.decode_attention(q, k, v, pos)
    assert da.decode_attention.launches == n + 1
    ref = da.reference_decode_attention(q, k, v, pos)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("kind", ["decode", "dense"])
def test_decode_row_that_sees_nothing_writes_zeros(dev, kind):
    """A row with pos < 0 sees no position: the decode kernels write
    zeros there on every call (the output is never left unwritten),
    and the other rows still match the plain version."""
    fn, args, ip = _serving_call(dev, kind)
    args[ip][2] = -1
    out = torch.full_like(args[0], float("nan"))
    for _ in range(2):
        got = fn(*args)
        assert torch.all(got[2] == 0)
        out.copy_(got)
    keep = torch.arange(len(args[ip]), device=dev) != 2
    ref_fn = (da.reference_decode_attention if kind == "dense"
              else da.reference_paged_decode_attention)
    torch.testing.assert_close(out[keep].float(),
                               ref_fn(*args)[keep].float(),
                               **TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# fused cross-entropy: forward and backward against the plain versions
# ---------------------------------------------------------------------------
# lse, the target logit, dx and dE are f32 on both sides, summed in f32
# from the same inputs (bf16 products are exact in f32) in another order:
# over D products per logit and over V (dx) or N (dE) terms per gradient
# element. Per element |kernel - plain| <= 1e-4 * max|plain| + 1e-4 *
# |plain|, far above that rounding (~1e-6 relative) and far below any
# masking or indexing fault. The bf16 backward also rounds dlog to bf16
# once before its two products, which moves each element by at most
# bf16's unit roundoff 2**-8 times |dlog| . |E| (dx) or |dlog|^T . |x|
# (dE): that term is added for bf16 (`xent_backward_abs_bound`).

def _xent_close(got, ref, bound=None):
    limit = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    if bound is not None:
        limit = limit + 2 ** -8 * bound
    over = ((got - ref).abs() - limit).max().item()
    assert over <= 0, f"off by {over:.3e} beyond its limit"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 200, 384, 1024, 1280, 1600, 2048,
                               4096])
@pytest.mark.parametrize("n,v", [(256, 1024), (77, 517), (300, 9000)])
def test_fused_xent_kernels_match_plain(dev, dtype, d, n, v):
    """(300, 9000): V spans three vocabulary chunks of the bf16 backward,
    the last ragged (808 rows), and N is not a multiple of its row tile,
    so dx's accumulation across chunks and every masked edge run.
    Targets include column 0, V - 1, the first column of the last
    256-column tile of the bf16 forward (ragged unless V is a multiple
    of 256) and three outside [0, V). Width 384 runs on its own kernel
    instantiations, 200 zero-padded to 256; above 1024 bf16 runs the
    width (1600 as it is) and f32 splits it into column chunks (1600
    padded to 2 x 896, 4096 as 4 x 1024)."""
    from ray_tpu_torch.ops import fused_xent as fx
    g = torch.Generator(device=dev).manual_seed(n + v + d)
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    e = (torch.randn((v, d), generator=g, device=dev) * d ** -0.5).to(dtype)
    t = torch.randint(0, v, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    t[:3] = torch.tensor([-1, v, v + 7])        # outside [0, V): tgt 0
    t[3:6] = torch.tensor([0, v - 1, (v - 1) // 256 * 256])
    cl = torch.rand((n,), generator=g, device=dev)
    ct = -torch.rand((n,), generator=g, device=dev)
    before = fx.kernel_launches()
    lse, tgt = fx.fused_xent_fwd(x, e, t)
    ref_lse, ref_tgt = fx.lse_target_reference(x, e, t)
    _xent_close(lse, ref_lse)
    _xent_close(tgt, ref_tgt)
    assert torch.all(tgt[:3] == 0)
    args = (x, e, t, ref_lse, cl, ct)
    dx, de = fx.fused_xent_bwd(*args)
    ref_dx, ref_de = fx.xent_backward_reference(*args)
    assert dx.shape == (n, d) and de.shape == (v, d)
    bound = (fx.xent_backward_abs_bound(*args) if dtype == torch.bfloat16
             else (None, None))
    _xent_close(dx, ref_dx, bound[0])
    _xent_close(de, ref_de, bound[1])
    # bf16: three kernels per vocabulary chunk; f32: one launch each
    chunks = -(-v // fx.BWD_CHUNK)
    grew = (dict.fromkeys(("xent_dlog", "xent_dx", "xent_de"), chunks)
            if dtype == torch.bfloat16 else
            dict.fromkeys(("xent_bwd_dx", "xent_bwd_de"), 1))
    grew["fused_xent_fwd"] = 1
    grew.update(dict.fromkeys(("xent_fwd_tc", "xent_fwd_merge"), 1)
                if dtype == torch.bfloat16 else {"xent_fwd_simt": 1})
    after = fx.kernel_launches()
    assert {k: after[k] - before[k] for k in after} == \
        {k: grew.get(k, 0) for k in after}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v_loc,d", [(2048, 25152, 1024),
                                       (333, 25152, 200), (300, 1000, 200)])
def test_fused_xent_kernels_on_a_vocab_shard(dev, dtype, n, v_loc, d):
    """The vocab-sharded loss's call: the middle shard (rows [V_loc, 2
    V_loc)) of a 3 V_loc vocabulary, with targets drawn from the whole
    vocabulary and shifted by the shard's base, so one call holds ids
    below 0 and at or above V_loc (a target logit of 0, no one-hot in
    dlog) beside ids in the shard. V_loc 25,152 is the tensor=2 shard of
    bench.py's vocabulary (not a multiple of the 256-column tile); width
    200 is not a multiple of the kernels' 64-column width step."""
    from ray_tpu_torch.ops import fused_xent as fx
    g = torch.Generator(device=dev).manual_seed(n + v_loc + d)
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    e = (torch.randn((v_loc, d), generator=g, device=dev) * d ** -0.5
         ).to(dtype)
    t = (torch.randint(0, 3 * v_loc, (n,), generator=g, device=dev)
         - v_loc).to(torch.int32)
    outside = (t < 0) | (t >= v_loc)
    assert int((t < 0).sum()) > 0 and int((t >= v_loc).sum()) > 0
    assert int((~outside).sum()) > 0
    lse, tgt = fx.fused_xent_fwd(x, e, t)
    ref_lse, ref_tgt = fx.lse_target_reference(x, e, t)
    _xent_close(lse, ref_lse)
    _xent_close(tgt, ref_tgt)
    assert torch.all(tgt[outside] == 0)
    cl = torch.rand((n,), generator=g, device=dev)
    args = (x, e, t, ref_lse, cl, -cl)
    dx, de = fx.fused_xent_bwd(*args)
    ref_dx, ref_de = fx.xent_backward_reference(*args)
    bound = (fx.xent_backward_abs_bound(*args) if dtype == torch.bfloat16
             else (None, None))
    _xent_close(dx, ref_dx, bound[0])
    _xent_close(de, ref_de, bound[1])


def test_fused_xent_unsupported_inputs_raise(dev):
    """A width of 0 and mixed dtypes raise."""
    from ray_tpu_torch.ops import fused_xent as fx
    x = torch.zeros((8, 0), device=dev)
    t = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="width"):
        fx.fused_xent_fwd(x, x, t)
    x = torch.zeros((8, 64), device=dev)
    with pytest.raises(TypeError, match="one dtype"):
        fx.fused_xent_fwd(x, x.bfloat16(), t)


# ---------------------------------------------------------------------------
# int8 pools: the int8 instances of the paged kernels against the plain
# versions on the same int8 payloads and scales
# ---------------------------------------------------------------------------
# The plain versions dequantize after the gather (k_int8 * k_scale, f32);
# the kernels apply the scales in f32 around their products, so in f32
# they differ by summation order and rounding (TOL). The bf16 multi-query
# kernel rounds p * v_scale to bf16 before its product with the int8
# value row: 2**-8 P |V| more, V the dequantized values, as for a bf16
# pool (`_mq_close`).

def _int8_inputs(dev, b, h, d, bs, mb, seed=0):
    from ray_tpu_torch.ops import quant
    g, kp, vp, tables = _inputs(dev, torch.float32, b, h, d, bs, mb, seed)
    (kq, ks), (vq, vs) = quant.quantize_rows(kp), quant.quantize_rows(vp)
    return g, kq, vq, dict(k_scale=ks, v_scale=vs), tables


def _int8_mq_close(got, ref, q, kq, vq, sc, tables, pos):
    from ray_tpu_torch.ops import quant
    _mq_close(got, ref, q, quant.dequantize_rows(kq, sc["k_scale"]),
              quant.dequantize_rows(vq, sc["v_scale"]), tables, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 100, 128, 256, 264, 512, 520, 1024])
@pytest.mark.parametrize("bs", [8, 16, 24, 64])
def test_int8_decode_kernel_matches_plain(dev, dtype, d, bs):
    """The int8 paged decode kernel: rows at pos 0, a block's end and the
    next block's start (15, 16 at block 16), `_ONE_CTA` positions, split
    rows at P - 1, P, P + 1 for a split boundary P, the table's last row
    and past it. D 100 runs zero-padded to 104 (the int8 pool too)."""
    h = 3
    mb = -(-(da._ONE_CTA + 300) // bs)
    ks, _ = da.split_geometry(mb * bs)
    edge = da._ONE_CTA + ks
    rows = [0, bs - 1, bs, 15, 16, da._ONE_CTA - 1, edge - 2, edge - 1,
            edge, mb * bs - 1, mb * bs + 7]
    g, kq, vq, sc, tables = _int8_inputs(dev, len(rows), h, d, bs, mb)
    q = torch.randn((len(rows), h, d), generator=g, device=dev).to(dtype)
    pos = torch.tensor(rows, dtype=torch.int32, device=dev)
    n = da.paged_decode_attention.launches
    n8 = da.LAUNCHES["paged_decode_int8"]
    got = da.paged_decode_attention(q, kq, vq, tables, pos, **sc)
    assert da.paged_decode_attention.launches == n + 1
    assert da.LAUNCHES["paged_decode_int8"] == n8 + 1
    ref = da.reference_paged_decode_attention(q, kq, vq, tables, pos, **sc)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 100, 128, 256, 264, 512, 520, 1024])
@pytest.mark.parametrize("bs", [8, 16, 24, 64])
def test_int8_prefill_and_verify_kernel_match_plain(dev, dtype, d, bs):
    """bf16 runs the tensor-core kernel's int8 instance, f32 the CUDA-core
    kernel's (blocks 24 and 64 re-viewed with their scales). Chunks of 8
    and 64 at the start, at a block start and across the first split
    boundary; verify W 1 to 5 with windows that see KS - 1, KS and KS + 1
    positions or end at the table's last row."""
    b, h = 3, 2
    mb = -(-300 // bs)
    ks, _ = da.split_geometry(mb * bs)
    g, kq, vq, sc, tables = _int8_inputs(dev, b, h, d, bs, mb, seed=1)
    kind = ("paged_mq_tc_int8" if dtype == torch.bfloat16 and d <= 256
            else "paged_mq_simt_int8")
    one = tables.new_zeros(1)
    for c, start in ((8, 0), (8, bs), (64, 0), (64, ks - 33)):
        q = torch.randn((c, h, d), generator=g, device=dev).to(dtype)
        kernels = dict(da.LAUNCHES)
        got = da.paged_prefill_attention(q, kq, vq, tables[0], start, **sc)
        assert {k: da.LAUNCHES[k] - kernels[k] for k in kernels} == \
            {k: int(k == kind) for k in kernels}
        ref = da.reference_paged_prefill_attention(q, kq, vq, tables[0],
                                                   start, **sc)
        _int8_mq_close(got[None], ref[None], q[None], kq, vq, sc,
                       tables[:1], one + start)
    for w in range(1, 6):
        q = torch.randn((b, w, h, d), generator=g, device=dev).to(dtype)
        pos = torch.tensor([ks - w - 1, ks - w + 1, mb * bs - w],
                           dtype=torch.int32, device=dev)
        got = da.paged_verify_attention(q, kq, vq, tables, pos, **sc)
        ref = da.reference_paged_verify_attention(q, kq, vq, tables, pos,
                                                  **sc)
        _int8_mq_close(got, ref, q, kq, vq, sc, tables, pos)


@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
def test_int8_kernels_are_deterministic_and_capturable(dev, kind):
    """At the serving shapes on an int8 pool: one launch a call, two
    calls bit-identical, and a CUDA graph that captured one call,
    replayed after pos changed on the device, gives exactly what an
    eager call with the new pos gives."""
    from ray_tpu_torch.ops import quant
    fn, args, ip = _serving_call(dev, kind)
    (args[1], ks), (args[2], vs) = (quant.quantize_rows(args[1].float()),
                                    quant.quantize_rows(args[2].float()))
    sc = dict(k_scale=ks, v_scale=vs)
    key = {"decode": "paged_decode_int8", "prefill": "paged_mq_tc_int8",
           "verify": "paged_mq_tc_int8"}[kind]
    n = da.LAUNCHES[key]
    first, second = fn(*args, **sc), fn(*args, **sc)
    assert da.LAUNCHES[key] == n + 2
    assert torch.equal(first, second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, **sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = fn(*args, **sc)
    new_pos = args[ip].flip(0) if kind != "prefill" else args[ip] - 900
    args[ip].copy_(new_pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn(*args, **sc))
    assert not torch.equal(captured, first)


def test_int8_pool_inputs_raise_instead_of_falling_back(dev):
    """An int8 pool without scales, scales of the wrong dtype, or a float
    pool handed scales: the kernels raise, nothing dequantizes a pool."""
    _, kq, vq, sc, tables = _int8_inputs(dev, 1, 2, 64, 16, 2)
    q = torch.zeros((1, 2, 64), device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int8|dtype"):
        da.paged_decode_attention(q, kq, vq, tables, pos)
    with pytest.raises(TypeError, match="float32"):
        da.paged_decode_attention(q, kq, vq, tables, pos,
                                  k_scale=sc["k_scale"].double(),
                                  v_scale=sc["v_scale"].double())
    with pytest.raises(TypeError, match="int8"):
        da.paged_decode_attention(q, kq.float(), vq.float(), tables, pos,
                                  **sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_engine_at_block_24(dev, dtype):
    """An engine with an int8 pool and int8 weights at block 24 on the
    card (head dim 96): every paged attention launch goes to an int8
    kernel, and the greedy tokens match the same engine on the CPU (the
    plain path) on peaked weights; f32 logprobs within 1e-3 (summation
    order, and a K/V value on a rounding edge may quantize one step
    apart), bf16 within 0.1 of the CPU's f32."""
    import numpy as np
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine
    kw = dict(vocab_size=128, d_model=192, n_layers=2, n_heads=2, d_ff=256,
              max_seq_len=160, kv_dtype="int8", weight_dtype="int8")
    eng_kw = dict(slots=2, max_len=144, prefill_buckets=(16, 32),
                  block_size=24, prefill_chunk=32)
    cpu_cfg = gpt.GPTConfig(**kw, dtype="float32")
    params = gpt.init_params(3, cpu_cfg, "cpu")
    params["embed"] = params["embed"] * 8
    rng = np.random.default_rng(24)
    prefix = rng.integers(0, 128, 50)
    prompts = [np.concatenate([prefix, rng.integers(0, 128, 40)]),
               np.concatenate([prefix, rng.integers(0, 128, 20)]),
               rng.integers(0, 128, 33)]

    def run(cfg, device):
        model = gpt.GPT(cfg, params, device=device, dtype=torch.float32)
        eng = InferenceEngine(model, cfg, device=device, **eng_kw)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        outs = [list(eng.tokens_for(r)) for r in rids]
        eng.check_invariants()
        return outs, eng.stats()

    want, _ = run(cpu_cfg, "cpu")
    ops.reset_kernel_launches()
    got, st = run(gpt.GPTConfig(**kw, dtype=dtype), dev)
    launches = ops.kernel_launches()
    mq = "paged_mq_tc_int8" if dtype == "bfloat16" else "paged_mq_simt_int8"
    # captured steps: each graph's launches once a replay, plus the one
    # eager warm-up run before each capture
    assert launches["paged_decode_int8"] == \
        launches["paged_decode_attention"] == \
        kw["n_layers"] * (st["decode_steps"] + st["decode_traces"]) > 0
    assert launches[mq] == launches["paged_prefill_attention"] \
        == kw["n_layers"] * (st["prefill_chunks"] + st["prefill_traces"]) > 0
    for key in ("paged_mq_tc", "paged_mq_simt"):
        assert launches[key] == 0
    tol = 1e-3 if dtype == "float32" else 0.1
    for w, g_ in zip(want, got):
        assert [int(t) for t in g_] == [int(t) for t in w]
        np.testing.assert_allclose([t.logprob for t in g_],
                                   [t.logprob for t in w], atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the verify caller at the serving geometry, and a speculative engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 5, 9])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_verify_at_serving_geometry(dev, w, kind):
    """`paged_verify_attention` as `models.gpt.verify_step_paged` calls it
    in the engine (B 8, H 16, D 64, block 16, 64-entry tables, W = k + 1
    for k 1, 4 and 8; windows at pos 0, block edges, split edges and the
    table's end): bf16 on `paged_mq_tc`, f32 on `paged_mq_simt`, an int8
    pool (bf16 q) on `paged_mq_tc_int8`, each once a call, against the
    plain version, bit-identical twice, and replayed exactly from a CUDA
    graph after pos changed on the device."""
    from ray_tpu_torch.ops import quant
    sv = _SERVING
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g, kp, vp, tables = _inputs(dev, torch.float32, sv["b"], sv["h"],
                                sv["d"], sv["bs"], sv["mb"], seed=w)
    span = sv["mb"] * sv["bs"]
    ks, _ = da.split_geometry(span)
    pos = torch.tensor([0, 15, 16, ks - w, ks - w + 1, 511, 700, span - w],
                       dtype=torch.int32, device=dev)
    q = torch.randn((sv["b"], w, sv["h"], sv["d"]), generator=g,
                    device=dev).to(dtype)
    if kind == "int8":
        (kp, k_s), (vp, v_s) = quant.quantize_rows(kp), quant.quantize_rows(vp)
        sc, key = dict(k_scale=k_s, v_scale=v_s), "paged_mq_tc_int8"
    else:
        kp, vp, sc = kp.to(dtype), vp.to(dtype), {}
        key = "paged_mq_tc" if kind == "bf16" else "paged_mq_simt"
    kernels = dict(da.LAUNCHES)
    first = da.paged_verify_attention(q, kp, vp, tables, pos, **sc)
    assert {k: da.LAUNCHES[k] - kernels[k] for k in kernels} == \
        {k: int(k == key) for k in kernels}
    ref = da.reference_paged_verify_attention(q, kp, vp, tables, pos, **sc)
    if kind == "int8":
        _int8_mq_close(first, ref, q, kp, vp, sc, tables, pos)
    else:
        _mq_close(first, ref, q, kp, vp, tables, pos)
    assert torch.equal(first, da.paged_verify_attention(q, kp, vp, tables,
                                                        pos, **sc))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.paged_verify_attention(q, kp, vp, tables, pos, **sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = da.paged_verify_attention(q, kp, vp, tables, pos, **sc)
    pos.copy_(pos.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, da.paged_verify_attention(q, kp, vp, tables,
                                                           pos, **sc))
    assert not torch.equal(captured, first)


@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_spec_engine_at_full_width(dev, spec):
    """A speculative engine at the serving model's widths (vocab 50304,
    d_model 1024, 16 heads, d_ff 4096; 2 layers, bf16, peaked weights,
    draft = target) on motif prompts, greedy: the same tokens as the
    same engine with spec off; each verify tick launches `paged_mq_tc`
    once a layer and no plain version runs (the captured verify step,
    built once, counts them at every replay, plus its warm-up run); the
    self-draft accepts nearly everything."""
    import numpy as np
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine
    cfg = gpt.small(vocab_size=50304, d_model=1024, n_layers=2, n_heads=16,
                    d_ff=4096, max_seq_len=1024, dtype="bfloat16")
    tree = gpt.init_params(0, cfg, dev)
    tree["embed"] = tree["embed"] * 8
    model = gpt.GPT(cfg, tree, device=dev)
    rng = np.random.default_rng(1)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, 4), 24)
               for _ in range(6)]
    kw = dict(slots=4, max_len=256, block_size=16, prefill_chunk=64,
              device=dev)

    def run(**spec_kw):
        eng = InferenceEngine(model, cfg, **kw, **spec_kw)
        ops.reset_kernel_launches()
        rids = [eng.submit(p, max_new_tokens=24) for p in prompts]
        eng.run_until_idle()
        outs = [[int(t) for t in eng.tokens_for(r)] for r in rids]
        eng.check_invariants()
        return outs, eng.stats(), ops.kernel_launches()

    want, _, _ = run()
    extra = (dict(draft_params=model, draft_cfg=cfg) if spec == "draft"
             else {})
    got, st, launches = run(spec=spec, spec_k=4, **extra)
    assert got == want
    assert st["spec_steps"] > 0
    assert st["verify_traces"] == 1
    assert launches["paged_verify_attention"] == \
        cfg.n_layers * (st["spec_steps"] + st["verify_traces"])
    assert launches["paged_mq_simt"] == 0
    if spec == "draft":
        assert st["acceptance_rate"] >= 0.9


# ---------------------------------------------------------------------------
# compile-once serving: the engine's steps as CUDA graphs
# ---------------------------------------------------------------------------

def _capture_model(dev, **kw):
    """A bf16 model at head dim 64 on peaked weights (decisive argmaxes),
    its config and its f32 master tree."""
    from ray_tpu_torch.models import gpt
    cfg = gpt.small(vocab_size=4096, d_model=256, n_layers=2, n_heads=4,
                    d_ff=512, max_seq_len=256, dtype="bfloat16", **kw)
    tree = gpt.init_params(0, cfg, dev)
    tree["embed"] = tree["embed"] * 8
    return gpt.GPT(cfg, tree, device=dev), cfg, tree


def _capture_traffic(vocab, seed=0):
    """Six requests for four slots: a shared prefix (radix hit and a
    copy-on-write block), a 70-token prompt over two chunk buckets, one
    request sampled at 0.8, motif tails for the n-gram proposer."""
    import numpy as np
    rng = np.random.default_rng(seed)
    motif = np.tile(rng.integers(0, vocab, 4), 6)
    prefix = rng.integers(0, vocab, 20)
    prompts = [np.concatenate([prefix, motif]),
               np.concatenate([prefix, rng.integers(0, vocab, 5), motif]),
               rng.integers(0, vocab, 70), motif[:13],
               np.concatenate([rng.integers(0, vocab, 9), motif]),
               rng.integers(0, vocab, 30)]
    return [(p.astype(np.int32), 0.8 if i == 3 else 0.0)
            for i, p in enumerate(prompts)]


def _serve(eng, reqs, new=16):
    rids = [eng.submit(p, max_new_tokens=new, temperature=t)
            for p, t in reqs]
    eng.run_until_idle()
    outs = [list(eng.tokens_for(r)) for r in rids]
    eng.check_invariants()
    return outs


@pytest.mark.parametrize("kind", ["bf16", "int8", "ngram", "draft"])
def test_captured_engine_matches_eager(dev, kind):
    """The same traffic through an engine whose steps are CUDA graphs and
    one that runs them eagerly (``_capture = False``): greedy tokens
    identical, logprobs within 1e-5 (the same kernels on the same inputs);
    decode, verify and draft built once, prefill once per chunk bucket,
    no unexpected retrace; the launch accounting of the captured engine
    is the eager one's plus one warm-up run a build."""
    import numpy as np
    from ray_tpu_torch import ops
    from ray_tpu_torch.serve import InferenceEngine
    cfg_kw = (dict(kv_dtype="int8", weight_dtype="int8")
              if kind == "int8" else {})
    model, cfg, _ = _capture_model(dev, **cfg_kw)
    eng_kw = dict(slots=4, max_len=160, block_size=16, prefill_chunk=32,
                  device=dev)
    if kind in ("ngram", "draft"):
        eng_kw.update(spec=kind, spec_k=3)
    if kind == "draft":
        eng_kw.update(draft_params=model, draft_cfg=cfg)
    reqs = _capture_traffic(cfg.vocab_size)
    if kind in ("ngram", "draft"):
        # greedy only: a sampled row's tokens (which differ between the
        # runs) would change what the proposers find, and so the ticks
        reqs = [(p, 0.0) for p, _ in reqs]
    runs = {}
    for capture in (False, True):
        eng = InferenceEngine(model, cfg, **eng_kw)
        eng._capture = capture
        ops.reset_kernel_launches()
        outs = _serve(eng, reqs)
        torch.cuda.synchronize()
        runs[capture] = (outs, eng.stats(), ops.kernel_launches())
    (eager, est, el), (graph, gst, gl) = runs[False], runs[True]
    for (p, t), e, g in zip(reqs, eager, graph):
        assert len(e) == len(g) == 16
        if t == 0.0:
            assert [int(x) for x in g] == [int(x) for x in e]
            np.testing.assert_allclose([x.logprob for x in g],
                                       [x.logprob for x in e], atol=1e-5,
                                       rtol=0)
    for st in (est, gst):
        assert st["decode_traces"] <= 1 and st["verify_traces"] <= 1
        assert st["draft_traces"] <= 1 and st["retraces_unexpected"] == 0
        assert st["prefill_traces"] == 3    # chunk buckets 8, 16 and 32
    assert gst["graph_pool_bytes"] > 0 and est["graph_pool_bytes"] == 0
    if kind in ("ngram", "draft"):
        assert gst["verify_traces"] == 1 and gst["spec_steps"] > 0
        assert gst["draft_traces"] == int(kind == "draft")
    # a build's warm-up: one eager run of the step (the draft step's is
    # W draft decode steps; draft = target, so L layers each)
    warm = {"paged_decode_attention": gst["decode_traces"]
            + gst["draft_traces"] * (eng_kw.get("spec_k", 0) + 1),
            "paged_prefill_attention": gst["prefill_traces"]
            + gst["draft_prefill_traces"],
            "paged_verify_attention": gst["verify_traces"]}
    for name, n in warm.items():
        assert gl[name] == el[name] + cfg.n_layers * n, name
    if kind == "int8":
        assert gl["paged_decode_int8"] == gl["paged_decode_attention"] > 0


def test_captured_sampling_advances_and_reseeds(dev):
    """Replays draw from the engine's generator, which each replay
    advances: the same sampled request twice gives different tokens, and
    an engine built with the same seed repeats both runs."""
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, _ = _capture_model(dev)
    prompt = _capture_traffic(cfg.vocab_size)[5][0]

    def two_runs():
        eng = InferenceEngine(model, cfg, slots=2, max_len=96, seed=5,
                              block_size=16, prefill_chunk=32, device=dev)
        outs = [[int(t) for t in eng.generate(prompt, max_new_tokens=24,
                                                temperature=1.0)]
                for _ in range(2)]
        assert eng.decode_traces == 1 and eng._graph_pool_bytes > 0
        return outs

    first = two_runs()
    assert first[0] != first[1]
    assert two_runs() == first


def test_captured_steps_see_a_weight_swap(dev):
    """`update_params` copies in place, so the graphs captured before it
    read the new weights: the next greedy tokens are those of a fresh
    engine built on them, and nothing is captured again."""
    import numpy as np
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, tree = _capture_model(dev)
    reqs = [(p, 0.0) for p, _ in _capture_traffic(cfg.vocab_size)[:3]]
    kw = dict(slots=4, max_len=160, block_size=16, prefill_chunk=32,
              device=dev)
    eng = InferenceEngine(model, cfg, **kw)
    before = _serve(eng, reqs)
    new = {k: (v if k == "embed" else
               ({n: x * 0.7 for n, x in v.items()} if k == "layers"
                else v))
           for k, v in tree.items()}
    traces = eng.decode_traces, eng.prefill_traces
    assert eng.update_params(new) == 1
    after = _serve(eng, reqs)
    fresh = _serve(InferenceEngine(gpt.GPT(cfg, new, device=dev), cfg, **kw),
                   reqs)
    assert [[int(t) for t in o] for o in after] == \
        [[int(t) for t in o] for o in fresh]
    assert max(abs(a.logprob - b.logprob) for o, p in zip(after, before)
               for a, b in zip(o, p)) > 1e-3     # the swap took effect
    for a, f in zip(after, fresh):
        np.testing.assert_allclose([t.logprob for t in a],
                                   [t.logprob for t in f], atol=1e-5, rtol=0)
    assert (eng.decode_traces, eng.prefill_traces) == traces


def test_failed_capture_raises(dev, monkeypatch):
    """A step that cannot be captured (here: a host sync inside the
    decode step) raises from `step`; the engine does not fall back to
    running it eagerly."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, _ = _capture_model(dev)
    real = gpt.decode_step_paged

    def syncing(*a, **k):
        out = real(*a, **k)
        out[0].sum().item()
        return out

    monkeypatch.setattr(gpt, "decode_step_paged", syncing)
    eng = InferenceEngine(model, cfg, slots=2, max_len=96, block_size=16,
                          prefill_chunk=32, device=dev)
    eng.submit(_capture_traffic(cfg.vocab_size)[5][0], max_new_tokens=4)
    with pytest.raises(RuntimeError):
        eng.run_until_idle()
    assert eng._capture and eng._steps[("decode", None)].graph is None
    torch.cuda.synchronize()


def test_capture_runs_with_the_collector_off(dev, monkeypatch):
    """Automatic garbage collection is off while a step is captured and
    on again after: an engine is a reference cycle, and one dropped
    earlier and collected inside another engine's capture would destroy
    its graphs there, which invalidates the capture."""
    import gc
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, _ = _capture_model(dev)
    real, seen = gpt.decode_step_paged, []

    def recording(*a, **k):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return real(*a, **k)

    monkeypatch.setattr(gpt, "decode_step_paged", recording)
    eng = InferenceEngine(model, cfg, slots=2, max_len=96, block_size=16,
                          prefill_chunk=32, device=dev)
    eng.generate(_capture_traffic(cfg.vocab_size)[5][0], max_new_tokens=4)
    assert seen == [(False, True), (True, False)]   # warm-up, capture
    assert gc.isenabled() and eng._steps[("decode", None)].graph is not None


def _pinned_alloc(dev, keep):
    keep.append(torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True))


def _pinned_free_after_copy(dev, keep):
    host = torch.ones(1 << 18, pin_memory=True)
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        host.to(dev, non_blocking=True)
    del host


def _device_alloc(dev, keep):
    keep.append(torch.empty((3 << 20) + 4096, dtype=torch.uint8,
                            device=dev))


def _default_stream_sync(dev, keep):
    torch.ones(4, device=dev).sum().item()


@pytest.mark.parametrize("act", [_pinned_alloc, _pinned_free_after_copy,
                                 _device_alloc, _default_stream_sync],
                         ids=lambda f: f.__name__[1:])
def test_capture_beside_another_threads_cuda_calls(dev, act, monkeypatch):
    """A served engine captures its steps lazily while other threads of
    its process make CUDA calls of their own (a decode replica's pull
    allocates a pinned handoff buffer, a stream frees one, the runtime
    allocates). Each such call runs in a second thread exactly while the
    first decode step is captured (the captured function waits for it):
    both succeed and the tokens equal an eager engine's. Under torch's
    default capture mode ("global") every one of these calls failed with
    "operation not permitted when stream is capturing" and invalidated
    the capture."""
    import threading
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, _ = _capture_model(dev)
    prompt = _capture_traffic(cfg.vocab_size)[5][0]
    eager = InferenceEngine(model, cfg, slots=2, max_len=96, block_size=16,
                            prefill_chunk=32, device=dev)
    eager._capture = False
    want = [int(t) for t in eager.generate(prompt, max_new_tokens=6)]
    real, start, done, res, keep = (gpt.decode_step_paged,
                                    threading.Event(), threading.Event(),
                                    {}, [])

    def waiting(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            start.set()
            done.wait(30)
        return real(*a, **k)

    def other():
        start.wait(60)
        try:
            act(dev, keep)
            torch.cuda.current_stream(dev).synchronize()
            res["act"] = "ok"
        except Exception as e:  # noqa: BLE001 — the outcome is the result
            res["act"] = repr(e)
        done.set()

    monkeypatch.setattr(gpt, "decode_step_paged", waiting)
    eng = InferenceEngine(model, cfg, slots=2, max_len=96, block_size=16,
                          prefill_chunk=32, device=dev)
    t = threading.Thread(target=other)
    t.start()
    try:
        got = [int(x) for x in eng.generate(prompt, max_new_tokens=6)]
    finally:
        start.set()
        done.set()
        t.join(30)
    assert res == {"act": "ok"} and start.is_set()
    assert eng._steps[("decode", None)].graph is not None
    assert got == want
    torch.cuda.synchronize()


@pytest.mark.parametrize("spec", ["off", "ngram", "draft"])
def test_captured_engine_under_preemption_matches_eager(dev, spec):
    """Scheduling under pressure on CUDA graphs: a pool of 12 blocks for
    4 slots (class-1 arrivals preempt class-0 streams) and the
    ``engine.preempt`` site at p 0.2, through an engine whose steps are
    CUDA graphs and one that runs them eagerly. Greedy tokens identical
    between the two (logprobs within 1e-5: the same kernels on the same
    inputs) and to an unpressured eager run on peaked weights; invariants
    after every tick; after the warm-up and `arm_retrace_sentinel` no
    step is captured again: every resume's re-prefill lands in a chunk
    bucket captured before."""
    import numpy as np
    from ray_tpu_torch.serve import InferenceEngine
    from ray_tpu_torch.util import faults
    model, cfg, _ = _capture_model(dev)
    reqs = [p for p, _ in _capture_traffic(cfg.vocab_size)]
    kw = dict(slots=4, max_len=160, block_size=16, prefill_chunk=32,
              priority_classes=2, device=dev)
    if spec != "off":
        kw.update(spec=spec, spec_k=3)
    if spec == "draft":
        kw.update(draft_params=model, draft_cfg=cfg)
    rng = np.random.default_rng(3)
    warm = [rng.integers(0, cfg.vocab_size, n) for n in (5, 12, 30)]

    def run(capture, pressure):
        eng = InferenceEngine(model, cfg, **kw,
                              cache_blocks=12 if pressure else None)
        eng._capture = capture
        for p in warm + [reqs[3]]:     # every chunk bucket; a motif
            eng.generate(p, max_new_tokens=8)
        eng.arm_retrace_sentinel()
        eng.reset_stats()
        if pressure:
            faults.install(faults.FaultPlan(seed=7).fail(
                "engine.preempt", p=0.2, times=None))
        try:
            rids = [eng.submit(p, max_new_tokens=16, priority=0)
                    for p in reqs[:3]]
            for _ in range(3):
                eng.step()
                eng.check_invariants()
            rids += [eng.submit(p, max_new_tokens=16,
                                priority=int(pressure)) for p in reqs[3:]]
            while eng.step():
                eng.check_invariants()
        finally:
            faults.clear()
        outs = [list(eng.tokens_for(r)) for r in rids]
        eng.check_invariants()
        torch.cuda.synchronize()
        return outs, eng.stats()

    (eager, est), (graph, gst) = run(False, True), run(True, True)
    calm, _ = run(False, False)
    assert est["preemptions"] == gst["preemptions"] >= 1
    assert gst["per_class"]["0"]["preemptions"] >= 1
    for e, g, c in zip(eager, graph, calm):
        assert len(e) == len(g) == len(c) == 16
        assert [int(x) for x in g] == [int(x) for x in e] == \
            [int(x) for x in c]
        np.testing.assert_allclose([x.logprob for x in g],
                                   [x.logprob for x in e], atol=1e-5,
                                   rtol=0)
    assert gst["retraces_unexpected"] == est["retraces_unexpected"] == 0
    assert gst["graph_pool_bytes"] > 0 and est["graph_pool_bytes"] == 0
    if spec != "off":
        assert gst["spec_steps"] > 0


# ---------------------------------------------------------------------------
# disaggregated prefill/decode: the KV-block handoff on the card
# ---------------------------------------------------------------------------

def _disagg_setup(dev):
    """`_capture_model`'s model, its traffic all greedy, engine kwargs,
    and a captured prefill-role engine's blobs of that traffic (16 new
    tokens each)."""
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, _ = _capture_model(dev)
    reqs = [p for p, _ in _capture_traffic(cfg.vocab_size)]
    kw = dict(slots=4, max_len=160, block_size=16, prefill_chunk=32,
              device=dev)
    pre = InferenceEngine(model, cfg, role="prefill", **kw)
    blobs = [pre.handoff_for(pre.submit(p, max_new_tokens=16))
             for p in reqs]
    pre.check_invariants()
    col = InferenceEngine(model, cfg, **kw)
    want = [[int(t) for t in col.generate(p, max_new_tokens=16)]
            for p in reqs]
    return model, cfg, kw, blobs, want


def test_import_scatters_in_place_under_captured_steps(dev):
    """A decode-role engine imports six blobs after its steps were
    captured (a warm-up request first): every pool entry keeps its
    ``data_ptr()`` (the graphs read the pool by address), and its greedy
    tokens equal an eager decode-role engine's on the same blobs
    (logprobs within 1e-5: the same kernels on the same inputs) and a
    colocated engine's."""
    import numpy as np
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, kw, blobs, want = _disagg_setup(dev)
    runs = {}
    for capture in (False, True):
        dec = InferenceEngine(model, cfg, role="decode", **kw)
        dec._capture = capture
        dec.generate(np.arange(1, 40), max_new_tokens=4)
        ptrs = {n: t.data_ptr() for n, t in dec.cache.items()}
        rids = [dec.import_handoff(b) for b in blobs]
        outs = [list(dec.tokens_for(r)) for r in rids]
        torch.cuda.synchronize()
        assert ptrs == {n: t.data_ptr() for n, t in dec.cache.items()}
        dec.check_invariants()
        st = dec.stats()
        assert st["imports"] == len(blobs) and st["kv_scatter_traces"] == 1
        assert (st["graph_pool_bytes"] > 0) == capture
        runs[capture] = outs
    for e, g, w in zip(runs[False], runs[True], want):
        assert [int(x) for x in g] == [int(x) for x in e] == w
        np.testing.assert_allclose([x.logprob for x in g],
                                   [x.logprob for x in e], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("source", ["pinned", "pageable"])
def test_back_to_back_imports_stream_correctly(dev, source):
    """Two imports admitted in one tick while the stream is held up (a
    spin of ~50 ms queued before the tick), so both imports' host memory
    is still waiting to be read when the tick returns to the host: the
    blobs' own pinned ``kv_host`` buffers ("pinned", as the prefill
    engine exported them) or a pageable copy of their arrays without one,
    staged through one pinned buffer per import ("pageable", as a foreign
    blob arrives). Both streams carry the colocated tokens, the engine
    keeps each import's memory until its copies have run, and the pool
    keeps its storage."""
    import numpy as np
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, kw, blobs, want = _disagg_setup(dev)
    pair = [blobs[2], blobs[5]]
    if source == "pageable":
        pair = [dict(b, kv_host=None,
                     payload=[{n: np.array(a) for n, a in blk.items()}
                              for blk in b["payload"]]) for b in pair]
    assert all(torch.from_numpy(b["payload"][0]["k"]).is_pinned()
               == (source == "pinned") for b in pair)
    dec = InferenceEngine(model, cfg, role="decode", **{**kw, "slots": 2})
    dec.generate([5, 6, 7], max_new_tokens=2)
    ptrs = {n: t.data_ptr() for n, t in dec.cache.items()}
    rids = [dec.import_handoff(b) for b in pair]
    torch.cuda._sleep(100_000_000)
    dec._admit_imports()
    held = [k for _, k in dec._h2d_inflight]
    assert len(held) == 2 and not any(e.query()
                                      for e, _ in dec._h2d_inflight)
    assert all(k.is_pinned() for k in held)
    if source == "pinned":
        assert all(k is b["kv_host"] for k, b in zip(held, pair))
    outs = [[int(t) for t in dec.tokens_for(r)] for r in rids]
    assert outs == [want[2], want[5]]
    assert ptrs == {n: t.data_ptr() for n, t in dec.cache.items()}
    dec.check_invariants()


def test_prefill_role_builds_no_decode_step_and_syncs_once(dev):
    """A captured prefill-role engine: prefill graphs only (no decode,
    verify or draft step), no decode launch, and one host sync for each
    prefill chunk plus ONE for the export's pinned copy."""
    import warnings
    import numpy as np
    from ray_tpu_torch import ops
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, _ = _capture_model(dev)
    pre = InferenceEngine(model, cfg, role="prefill", slots=4, max_len=160,
                          block_size=16, prefill_chunk=32, device=dev)
    rng = np.random.default_rng(5)
    for n in (5, 12, 30, 70):       # every chunk bucket captured
        pre.handoff_for(pre.submit(rng.integers(0, 4096, n),
                                   max_new_tokens=8))
    pre.reset_stats()
    ops.reset_kernel_launches()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            blob = pre.handoff_for(pre.submit(rng.integers(0, 4096, 70),
                                              max_new_tokens=8))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    st = pre.stats()
    assert st["prefill_chunks"] == 3 and st["handoffs"] == 1
    assert syncs == st["prefill_chunks"] + st["handoffs"]
    assert {kind for kind, _ in pre._steps} == {"prefill"}
    assert st["decode_traces"] == st["decode_steps"] == 0
    assert ops.kernel_launches()["paged_decode_attention"] == 0
    assert blob["n_blocks"] == 5 and blob["payload"][0]["k"].dtype == \
        np.uint16
    pre.check_invariants()


# ---------------------------------------------------------------------------
# the RL flywheel and the flight recorder on the card
# ---------------------------------------------------------------------------

def _flywheel(dev, cfg, **kw):
    """A `FlywheelLoop` on ``cfg`` with 4 prompts of 24 tokens, 16 new
    tokens, padded to 48, an engine of 4 slots, block 16, chunk 32, and
    a reward with a spread over the batch (the share of the completion in
    the lower half of the vocabulary)."""
    import numpy as np
    from ray_tpu_torch.rl.flywheel import FlywheelLoop
    vocab = cfg.vocab_size
    return FlywheelLoop(
        cfg, lambda rng: rng.integers(0, vocab, 24).astype(np.int32),
        lambda p, c: float((np.asarray(c) < vocab // 2).mean()),
        prompts_per_iter=4, max_new_tokens=16, pad_to=48, lr=1e-4,
        engine_kwargs=dict(slots=4, max_len=64, block_size=16,
                           prefill_chunk=32), device=dev, **kw)


def test_flywheel_learner_step_flash_matches_plain_attention(dev):
    """The learner's surrogate loss and gradients on an engine rollout,
    through the flash kernels (bf16, D 64) and through plain attention
    from the same f32 masters: loss within 1e-2, each leaf's gradient
    within 5e-2 relative (chip_smoke.py phase 6's limits), each
    completion logprob within 0.1; the behaviour logprobs within 0.1 of
    `completion_logprobs`. The first rollout's advantages sum to zero
    (its baseline is its mean reward), and so would the loss: it is
    taken with every advantage 1 instead, where it is about -1."""
    import dataclasses
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.rl.flywheel import surrogate_loss
    _, cfg, _ = _capture_model(dev)
    fly = _flywheel(dev, cfg)
    batch = fly._collect()
    raw = {**batch, "advantage": torch.ones_like(batch["advantage"])}
    model = fly.state.params
    live = batch["mask"] > 0
    res = {}
    for impl in ("flash", "xla"):
        ops.reset_kernel_launches()
        loss, (lp, *_) = surrogate_loss(
            model, raw, dataclasses.replace(cfg, attn_impl=impl), 16, 0.2)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        res[impl] = (loss.item(), grads, ops.kernel_launches(), lp.detach())
    assert res["flash"][2]["flash_dq_tc"] == cfg.n_layers
    assert res["xla"][2]["flash_forward"] == 0
    assert abs(res["flash"][0] + 1) <= 0.2
    assert abs(res["flash"][0] - res["xla"][0]) <= 1e-2
    assert (res["flash"][3] - res["xla"][3]).abs()[live].max().item() <= 0.1
    for a, b in zip(res["flash"][1], res["xla"][1]):
        rel = ((a.float() - b.float()).norm()
               / b.float().norm().clamp_min(1e-30)).item()
        assert rel <= 5e-2
    with torch.no_grad():
        lp = gpt.completion_logprobs(model, batch["tokens"], batch["start"],
                                     16)
    assert (lp - batch["behavior_logp"]).abs()[live].max().item() <= 0.1


def test_flywheel_publish_into_captured_engine_builds_nothing(dev):
    """Iterations of the flywheel on a captured engine: every publish
    copies into the tensors the graphs read, so after the first
    iteration's builds nothing is built again, the engine serves the
    learner's weights (greedy tokens of a fresh engine on them), and
    the rollouts carry the published version."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine
    _, cfg, _ = _capture_model(dev)
    fly = _flywheel(dev, cfg)
    fly.run(1)
    eng = fly.engine
    traces = {k: getattr(eng, k) for k in ("decode_traces",
                                           "prefill_traces")}
    eng.arm_retrace_sentinel()
    fly.run(3)
    st = eng.stats()
    assert {k: st[k] for k in traces} == traces
    assert st["retraces_unexpected"] == 0 and st["swaps"] == 4
    assert [h["engine_version"] for h in fly.history] == [0, 1, 2, 3]
    assert all(h["staleness"] == 0 for h in fly.history)
    for (k, v), (_, w) in zip(eng.model.named_parameters(),
                              fly.state.params.named_parameters()):
        assert torch.equal(v, w.detach().to(v.dtype)), k
    fresh = InferenceEngine(gpt.GPT(cfg, gpt.param_tree(fly.state.params),
                                    device=dev), cfg, slots=4, max_len=64,
                            block_size=16, prefill_chunk=32, device=dev)
    prompt = list(range(5, 29))
    assert [int(t) for t in eng.generate(prompt, max_new_tokens=12)] == \
        [int(t) for t in fresh.generate(prompt, max_new_tokens=12)]


def test_flight_recorder_adds_no_host_sync(dev):
    """A captured engine with every request traced makes the same host
    syncs as one with none (one a prefill chunk and a decode tick), and
    its recorder holds each request's spans."""
    import warnings
    from ray_tpu_torch.serve import InferenceEngine
    model, cfg, _ = _capture_model(dev)
    reqs = _capture_traffic(cfg.vocab_size)
    got = {}
    for sample in (1.0, 0.0):
        # no prefix cache: the second run's chunks are the first's, so
        # every step it runs was built by the first
        eng = InferenceEngine(model, cfg, slots=4, max_len=160,
                              block_size=16, prefill_chunk=32, device=dev,
                              prefix_cache=False, telemetry_sample=sample)
        _serve(eng, reqs)
        eng.reset_stats()
        eng._recorder.clear()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _serve(eng, reqs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        st = eng.stats()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        assert syncs == st["decode_steps"] + st["prefill_chunks"]
        got[sample] = (syncs, len({s["attributes"]["rid"]
                                   for s in eng._recorder.get_spans()}))
    assert got[1.0][1] == len(reqs) and got[0.0][1] == 0


def _thread_syncs():
    """A `warnings.showwarning` recorder that keeps each sync warning's
    thread, and the list it fills."""
    import threading
    seen = []

    def show(message, *args, **kwargs):
        # a host sync's warning, not the mode's own "prototype" notice
        if "synchroniz" in str(message) and "debug mode" not in str(message):
            seen.append(threading.get_ident())
    return show, seen


def test_async_checkpoint_round_trip_adds_no_training_thread_sync(
        dev, tmp_path):
    """`TrainLoop` with an `AsyncCheckpointer` on a CUDA train state: the
    training thread makes no host sync beyond the metrics ring's fetches
    (the clones and their event are queued on its stream; the writer
    waits on its own copy's event), every snapshot commits, and the last
    one restores bit for bit into a trainer built without state, whose
    next step gives the live state's loss bit for bit."""
    import threading
    import warnings

    import numpy as np
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import ft, loop, spmd
    cfg = gpt.small(dtype="bfloat16", loss_impl="fused")
    state, step_fn, place = spmd.make_gpt_trainer(cfg, device=dev)

    def host(seed):
        rng = np.random.default_rng(seed)
        while True:
            toks = rng.integers(0, cfg.vocab_size, (4, cfg.max_seq_len + 1),
                                np.int32)
            yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    ckpt = ft.AsyncCheckpointer(str(tmp_path), every=4, keep=2)
    train = loop.TrainLoop(step_fn, unroll=2, metrics_interval=4,
                           checkpointer=ckpt)
    batches = loop.DevicePrefetcher(host(0), place, group=2)
    state, _ = train.run(state, batches, num_steps=4)     # warm-up
    show, seen = _thread_syncs()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            state, hist = train.run(state, batches, num_steps=16,
                                    start_step=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    main = threading.get_ident()
    assert sum(t == main for t in seen) <= train.last_ring.fetches
    assert len(hist) == 12 and ckpt.commits == ckpt.snapshots == 4
    assert all(r["d2h_ms"] is not None and r["clone_ms"] is not None
               for r in ckpt.timings)
    ckpt.check_invariants()
    ckpt.close()
    tree, step = ft.restore_resharded(str(tmp_path), dev)
    assert step == 16
    back = ft.state_from_tree(tree, cfg, dev)
    for (n, a), b in zip(state.params.named_parameters(),
                         back.params.parameters()):
        assert torch.equal(a, b), n
    for k in ("mu", "nu"):
        for a, b in zip(state.opt_state[k], back.opt_state[k]):
            assert torch.equal(a, b)
    _, step2, _ = spmd.make_gpt_trainer(cfg, device=dev, init_state=False)
    batch = place(next(host(7)))
    _, m_live = step_fn(state, batch)
    _, m_back = step2(back, batch)
    assert m_live["loss"].item() == m_back["loss"].item()


def test_moe_flash_matches_plain_attention(dev):
    """MoE (`moe.small`, D 32, and at d_model 256, D 64) with the flash
    kernels against plain attention from the same f32 masters: in f32,
    where both route every token alike, the loss within 1e-2 and each
    leaf's gradient within 5e-2 relative (chip_smoke.py phase 6's
    limits); in bf16 the loss within 1e-2 (a bf16 rounding flips the
    picks of near-tied tokens, which moves the gradients more), with
    remat two flash forwards and one dQ and dK/dV launch a layer."""
    import dataclasses

    import numpy as np
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.train import spmd
    for cfg in (moe.small(), moe.small(d_model=256)):
        model = moe.MoE(cfg, moe.init_params(0, cfg, dev), device=dev,
                        dtype=torch.float32, trainable=True)
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 129)).astype(np.int64)
        batch = {"inputs": torch.from_numpy(toks[:, :-1]).to(dev),
                 "targets": torch.from_numpy(toks[:, 1:]).to(dev)}
        for dtype in ("float32", "bfloat16"):
            res = {}
            for impl in ("flash", "xla"):
                ops.reset_kernel_launches()
                c = dataclasses.replace(cfg, attn_impl=impl, dtype=dtype)
                loss = spmd.moe_loss_fn(model, batch, c)
                grads = torch.autograd.grad(loss, list(model.parameters()))
                res[impl] = (loss.item(), grads, ops.kernel_launches())
            assert res["flash"][2]["flash_forward"] == 2 * cfg.n_layers
            assert res["flash"][2]["flash_dq"] == cfg.n_layers
            assert res["flash"][2]["flash_dkv"] == cfg.n_layers
            assert res["xla"][2]["flash_forward"] == 0
            assert abs(res["flash"][0] - res["xla"][0]) <= 1e-2
            if dtype == "float32":
                for a, b in zip(res["flash"][1], res["xla"][1]):
                    rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                    assert rel <= 5e-2
