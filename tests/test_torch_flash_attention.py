"""Parity of the port's flash attention (`ray_tpu_torch.ops.flash_attention`)
with the JAX package's Pallas flash kernels on the CPU: the forward, and
dq/dk/dv through autograd against `jax.vjp` (the Pallas kernels run in
interpret mode, as `tests/test_models_ops.py` runs them; on the CPU the
port runs its plain versions, the kernels' math). Also: the plain
backward against autograd through plain attention, and the CPU path
never counting a kernel launch.

Tolerances: f32 atol/rtol 1e-4 (same math, another summation order).
bf16: atol 2e-2, rtol 2**-6: each side rounds its output (and dq/dk/dv)
to bf16 once (one ulp is 2**-7 of the value), and the forward rounds
each p to bf16 relative to a different row max (JAX's 128-row blocks vs
the plain version's whole row), which moves out, and through
delta = rowsum(dO * O) the gradients, by a few more bf16 ulps at most.

The bf16 forward on the card (tensor cores, D 64 and 128) walks kv tiles
of 128 keys and rounds p to bf16 relative to the running row max; a
plain emulation of that walk is held against JAX's Pallas forward within
the card's bf16 limit (1e-4 + 2**-7 |ref| + 2**-8 P|V|), and its f32
output against the plain version's within the limit's rounding term
2**-8 P|V| alone (+ 1e-6 for f32 summation order).

The bf16 backward on the card (tensor cores) rounds P and dS to bf16
before its three products; an emulation of that arithmetic is held
against JAX's Pallas backward (through `jax.vjp`) within the card's
limit, FLASH_TOL's bf16 terms plus 2**-8 times
`flash_backward_abs_bound`, and its f32 result against the plain
version's within the rounding term alone (+ 1e-6).

Head dims the kernels are not built for run zero-padded to the next of
32, 64, 128 and 256 with the true head dim's softmax scale; the plain
versions on padded inputs, with that scale, are held against the
unpadded ones, and the padded columns of dq, dk and dv must be zero.
Head dims 160 and 256 (CUDA-core kernels at 256 on the card) are held
against JAX like the narrower ones."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as jflash
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import pad_last_dim

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2 ** -6)}


def _inputs(seed, t, d, dtype, b=1, h=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(arrs, dtype, causal, block):
    """(JAX out, JAX grads, port out, port grads) for one random
    cotangent, the same numpy inputs on both sides."""
    q, k, v, g = arrs
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jout, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, causal, block,
                                               block), jq, jk, jv)
    jgrads = vjp(jg)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    tout = fa.flash_attention(tq, tk, tv, causal, block, block)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv),
                                 torch.from_numpy(g).to(tdt))
    return jout, jgrads, tout, tgrads


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 48, 96])
@pytest.mark.parametrize("t,block", [(128, 1024), (256, 128), (384, 1024)])
def test_forward_and_grads_match_jax_f32(causal, d, t, block):
    jout, jgrads, tout, tgrads = _both(_inputs(t + d, t, d, "float32"),
                                       "float32", causal, block)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL["float32"])
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(a), _np(b), **TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 256])
def test_wide_head_dims_match_jax_f32(causal, d):
    """Head dims above 128: 160 runs zero-padded to 256 on the card, 256
    as it is; the port's forward and gradients against JAX's."""
    jout, jgrads, tout, tgrads = _both(_inputs(d, 256, d, "float32"),
                                       "float32", causal, 128)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL["float32"])
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(a), _np(b), **TOL["float32"])


@pytest.mark.parametrize("causal,t,block", [(True, 256, 128),
                                            (False, 128, 1024)])
def test_forward_and_grads_match_jax_bf16(causal, t, block):
    jout, jgrads, tout, tgrads = _both(_inputs(7, t, 32, "bfloat16"),
                                       "bfloat16", causal, block)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL["bfloat16"])
    for a, b in zip(tgrads, jgrads):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), _np(b), **TOL["bfloat16"])


def test_sum_of_squares_grad_matches_jax():
    """The reference's own test loss, sum(out**2), through both."""
    q, k, v, _ = _inputs(3, 128, 16, "float32")
    jg = jax.grad(lambda q, k, v: jnp.sum(jflash(q, k, v, True) ** 2),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, True) ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(a), _np(b), **TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_plain_attention(causal):
    """flash_backward_reference (the kernels' math: P from lse, delta)
    against autograd through reference_attention, ragged T included."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(5, 70, 32,
                                                       "float32"))
    out, lse = fa.flash_forward_reference(q, k, v, causal=causal)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    ref = fa.reference_attention(qr, kr, vr, causal=causal)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    want = torch.autograd.grad(ref, (qr, kr, vr), g)
    got = fa.flash_backward_reference(q, k, v, g, lse,
                                      fa.attention_delta(out, g),
                                      causal=causal)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert lse.shape == (2, 70) and lse.dtype == torch.float32


def test_cpu_path_counts_no_launches_and_skips_lse_without_grad():
    from ray_tpu_torch import ops
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 64, 32,
                                                       "float32"))
    before = ops.kernel_launches()
    assert {"flash_forward", "flash_dq", "flash_dkv",
            "paged_decode_attention"} <= set(before)
    out = fa.flash_attention(q, k, v, causal=True)
    qg = q.clone().requires_grad_()
    fa.flash_attention(qg, k, v, causal=True).sum().backward()
    assert ops.kernel_launches() == before
    assert fa.flash_forward(q, k, v, causal=True, with_lse=False)[1] is None
    torch.testing.assert_close(
        out, fa.reference_attention(q, k, v, causal=True), atol=1e-5,
        rtol=1e-5)


def _tile_walk_forward(q, k, v, causal, block_kv=128):
    """The tensor-core forward's arithmetic, in plain PyTorch: per kv
    tile of ``block_kv`` keys, scores in log2 units (q . k * D**-0.5 *
    log2(e)), the running row max m, p = exp2(x - m) rounded to bf16
    before p . V, O and l rescaled by exp2(m_old - m_new). Returns the
    f32 output (before its rounding to q's dtype) and lse [B*H, T]."""
    b, t, h, d = q.shape
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    sl = d ** -0.5 * math.log2(math.e)
    m = torch.full((b, h, t), fa.NEG_INF)
    l = torch.zeros((b, h, t))
    o = torch.zeros((b, h, t, d))
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, block_kv):
        kt, vt = kf[:, :, k0:k0 + block_kv], vf[:, :, k0:k0 + block_kv]
        x = (qf @ kt.transpose(-1, -2)) * sl
        if causal:
            cols = k0 + torch.arange(kt.shape[2])[None, :]
            x = torch.where(cols <= rows, x, fa.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.bfloat16().float() @ vt
        m = m_new
    out = (o / l[..., None]).transpose(1, 2)
    return out, ((m + torch.log2(l)) * math.log(2)).reshape(b * h, t)


@pytest.mark.parametrize("causal", [False, True])
def test_tile_walk_rounding_is_inside_the_card_limit(causal):
    """T 256 (two kv tiles), D 64, bf16 inputs. JAX's forward runs one
    256-key block, so it rounds p against the final row max, as the
    plain version does; the tile walk rounds against the running max."""
    q, k, v, _ = _inputs(11, 256, 64, "bfloat16")
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    emu, emu_lse = _tile_walk_forward(tq, tk, tv, causal)
    jout = _np(jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                      causal, 256, 256))
    p_abs_v = fa.flash_forward_reference(tq.float(), tk.float(),
                                         tv.float().abs(), causal=causal)[0]
    limit = 1e-4 + 2 ** -7 * np.abs(jout) + 2 ** -8 * p_abs_v.numpy()
    assert np.all(np.abs(_np(emu.bfloat16()) - jout) <= limit)
    # p rounded against the final max (the plain version, f32 output)
    plain, plain_lse = fa.flash_forward_reference(tq.float(), tk.float(), tv,
                                                  causal=causal)
    err = (emu - plain).abs()
    assert err.max() > 0
    assert torch.all(err <= 2 ** -8 * p_abs_v + 1e-6)
    torch.testing.assert_close(emu_lse, plain_lse, atol=1e-4, rtol=1e-5)


def _tensor_core_backward(q, k, v, do, lse, delta, causal):
    """The tensor-core backward's arithmetic in plain PyTorch: S, dP, P =
    exp(s - lse) and dS = P (dP - delta) in f32 as the plain version
    computes them, then P and dS rounded to bf16 before dq = sm dS . K,
    dk = sm dS^T . Q and dv = P^T . dO (f32 sums). Returns f32 (dq, dk,
    dv) before their rounding to the inputs' dtype."""
    sm = q.shape[-1] ** -0.5
    p, ds = fa.p_and_ds(q, k, v, do, lse, delta, causal=causal)
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    return (torch.einsum("bhqk,bkhd->bqhd", ds16, k.float()) * sm,
            torch.einsum("bhqk,bqhd->bkhd", ds16, q.float()) * sm,
            torch.einsum("bhqk,bqhd->bkhd", p16, do.float()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(256, 64), (128, 128)])
def test_tensor_core_backward_rounding_is_inside_the_card_limit(causal, t,
                                                                 d):
    """bf16 inputs; JAX runs one block over the whole sequence, so its
    forward rounds p against the final row max as the plain forward
    does, and both backwards start from (almost) the same lse and
    delta."""
    q, k, v, g = _inputs(13 + d, t, d, "bfloat16")
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, causal, t, t), jq, jk,
                     jv)
    jgrads = [_np(x) for x in vjp(jg)]
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    out, lse = fa.flash_forward_reference(tq, tk, tv, causal=causal)
    delta = fa.attention_delta(out, tg)
    emu = _tensor_core_backward(tq, tk, tv, tg, lse, delta, causal)
    bounds = fa.flash_backward_abs_bound(tq, tk, tv, tg, lse, delta,
                                         causal=causal)
    plain = fa.flash_backward_reference(tq.float(), tk.float(), tv.float(),
                                        tg.float(), lse, delta,
                                        causal=causal)
    for got, want, bound, ref in zip(emu, jgrads, bounds, plain):
        limit = (1e-4 + 2 ** -7 * np.abs(want) + 2 ** -8 * bound.numpy())
        assert np.all(np.abs(_np(got.bfloat16()) - want) <= limit)
        # the rounding term alone covers the emulation against the plain
        # f32 backward, and is not vacuous
        err = (got - ref).abs()
        assert err.max() > 0
        assert torch.all(err <= 2 ** -8 * bound + 1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16, 24, 40, 48, 56, 72, 80, 88, 96, 104,
                               112, 120, 4, 100, 132, 160, 200])
def test_padded_heads_with_the_true_scale_match_unpadded(causal, d):
    """What the wrappers do for head dims without a kernel of their own:
    zero columns up to `kernel_head_dim`, the softmax scale of the true
    head dim, outputs sliced back. Forward, lse and the three gradients
    agree with the unpadded plain versions (up to f32 summation order),
    and the padded columns of dq, dk and dv are exactly zero."""
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs(d + causal, 40, d, "float32", h=2))
    dp = fa.kernel_head_dim(d)
    assert dp == min(x for x in (32, 64, 128, 256) if x >= d)
    pq, pk, pv, pg = (pad_last_dim(x, dp) for x in (q, k, v, g))
    assert pq.shape[-1] == dp and torch.all(pq[..., d:] == 0)
    sm = d ** -0.5
    out, lse = fa.flash_forward_reference(q, k, v, causal=causal)
    pout, plse = fa.flash_forward_reference(pq, pk, pv, causal=causal,
                                            scale=sm)
    torch.testing.assert_close(pout[..., :d], out, atol=1e-6, rtol=1e-6)
    assert torch.all(pout[..., d:] == 0)
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    delta = fa.attention_delta(out, g)
    torch.testing.assert_close(fa.attention_delta(pout, pg), delta,
                               atol=1e-6, rtol=1e-6)
    want = fa.flash_backward_reference(q, k, v, g, lse, delta,
                                       causal=causal)
    got = fa.flash_backward_reference(pq, pk, pv, pg, lse, delta,
                                      causal=causal, scale=sm)
    for a, b in zip(got, want):
        torch.testing.assert_close(a[..., :d], b, atol=1e-6, rtol=1e-6)
        assert torch.all(a[..., d:] == 0)


# head dim -> the kernel head dim it runs at (None: raises)
_KERNEL_DIMS = {0: None, 4: 32, 12: 32, 100: 128, 132: 256, 136: 256,
                256: 256, 264: 512, 512: 512, 520: 1024, 1024: 1024,
                1100: 1536}


@pytest.mark.parametrize("d", list(_KERNEL_DIMS))
def test_head_dims_without_a_kernel_raise(d):
    """Every head dim from 1 up runs on a kernel, zero-padded to the next
    of 32, 64, 128, 256 and 512, and above 512 to the next multiple of 512
    (run in slabs of 512), as the reference runs every head dim; only 0
    has no kernel and raises."""
    want = _KERNEL_DIMS[d]
    if want is None:
        with pytest.raises(ValueError, match="head dim"):
            fa.kernel_head_dim(d)
    else:
        assert fa.kernel_head_dim(d) == want
