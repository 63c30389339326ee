"""Parity of the port's fused cross-entropy (`ray_tpu_torch.ops.fused_xent`)
with the JAX package's on the CPU: the same numpy inputs go through JAX's
`fused_softmax_xent` with ``impl="scan"`` and, where the reference has a
block plan (V a multiple of 128), ``impl="pallas"`` (its three kernels in
interpret mode), and through the port's plain path (CPU tensors).

Tolerances: f32 nll 1e-5 absolute, dx and dembed 1e-5 of each gradient's
largest magnitude (both sides form f32 products of the same inputs and
differ only in summation order). bf16: nll 1e-4 (the same f32 math from
bf16 inputs, whose products are exact in f32); dx and dembed per element
2**-7 |ref| + 1e-6, since both are rounded once to bf16 at the autograd
boundary and may land one bf16 ulp apart.

The bf16 forward kernels keep one (max, sum of exp) partial per row and
256-column vocabulary tile and merge them; their plain form
(`xent_fwd_partials_reference` + `xent_fwd_merge_reference`) is held
against the JAX package's scan forward: f32 lse and target logit 1e-5
absolute (summation order), bf16 inputs 1e-4 (as the nll above).

The bf16 backward kernels round dlog to bf16 once before their two
products; the card tests allow for that with 2**-8 (bf16's unit
roundoff) times `xent_backward_abs_bound`. Here that bound is checked
against dense logits, and an emulation of the rounding is held inside
the card's limit (and shown not to be exact, so the limit is not
vacuous).

The kernels are built for widths 64 and the multiples of 128 up to
1024; other widths run zero-padded to the next of those. The plain
versions on zero-padded x and E are held against the unpadded ones (the
padded columns of dx and dE exactly zero), and the port's fused loss at
width 384 and at a width off the kernels' list against the JAX
package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import fused_xent as jfx
from ray_tpu_torch.ops import fused_xent as tfx
from ray_tpu_torch.ops import pad_last_dim
from ray_tpu_torch.train import spmd as tspmd

B, T, D = 2, 16, 64


def _inputs(v, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    emb = (rng.standard_normal((v, D)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, v, (B, T)).astype(np.int32)
    return x, emb, tgt


def _jax(x, emb, tgt, impl, dtype):
    xj, ej = (jnp.asarray(a, dtype) for a in (x, emb))
    tj = jnp.asarray(tgt)
    nll = jfx.fused_softmax_xent(xj, ej, tj, vocab_chunk=128, impl=impl)
    gx, ge = jax.grad(
        lambda a, e: jfx.fused_softmax_xent(a, e, tj, vocab_chunk=128,
                                            impl=impl).mean(),
        argnums=(0, 1))(xj, ej)
    return [np.asarray(a, np.float32) for a in (nll, gx, ge)]


def _torch(x, emb, tgt, dtype, impl="auto"):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    et = torch.from_numpy(emb).to(dtype).requires_grad_()
    nll = tfx.fused_softmax_xent(xt, et, torch.from_numpy(tgt),
                                 vocab_chunk=128, impl=impl)
    nll.mean().backward()
    assert xt.grad.dtype == dtype and et.grad.dtype == dtype
    return [a.detach().float().numpy() for a in (nll, xt.grad, et.grad)]


def _impls(v):
    return ("scan", "pallas") if v % 128 == 0 else ("scan",)


@pytest.mark.parametrize("v", [512, 517, 130, 96])
def test_f32_matches_jax(v):
    x, emb, tgt = _inputs(v)
    got = _torch(x, emb, tgt, torch.float32)
    for impl in _impls(v):
        want = _jax(x, emb, tgt, impl, jnp.float32)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("v", [512, 517, 130, 96])
def test_bf16_matches_jax(v):
    x, emb, tgt = _inputs(v, seed=1)
    got = _torch(x, emb, tgt, torch.bfloat16)
    for impl in _impls(v):
        want = _jax(x, emb, tgt, impl, jnp.bfloat16)
        np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
        for g, w in zip(got[1:], want[1:]):
            assert np.all(np.abs(g - w) <= 2 ** -7 * np.abs(w) + 1e-6)


def test_target_outside_vocab_has_zero_target_logit():
    """Targets outside [0, V) (the tensor-parallel shard case) give a
    target logit of 0, so the nll is the bare logsumexp."""
    x, emb, tgt = _inputs(130, seed=2)
    tgt[0, :4] = [130, 131, -1, 500]
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    nll = tfx.fused_softmax_xent(xt, et, torch.from_numpy(tgt),
                                 vocab_chunk=128)
    lse = torch.logsumexp(xt @ et.t(), dim=-1)
    torch.testing.assert_close(nll[0, :4], lse[0, :4], atol=1e-5, rtol=0)
    lse_j, tgt_j = jfx._lse_tgt_scan(jnp.asarray(x), jnp.asarray(emb),
                                     jnp.asarray(tgt), 128)
    assert np.all(np.asarray(tgt_j)[0, :4] == 0)
    np.testing.assert_allclose(nll.numpy(),
                               np.asarray(lse_j - tgt_j), atol=1e-5)


def test_fused_matches_dense_in_the_port():
    """Fused against the dense loss of the port (`spmd.softmax_xent` over
    materialised logits), value and both gradients, f32."""
    x, emb, tgt = _inputs(517, seed=3)
    out = []
    for fused in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        et = torch.from_numpy(emb).requires_grad_()
        tt = torch.from_numpy(tgt)
        nll = (tfx.fused_softmax_xent(xt, et, tt, vocab_chunk=128) if fused
               else tspmd.softmax_xent(xt @ et.t(), tt))
        nll.mean().backward()
        out.append((nll.detach(), xt.grad, et.grad))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_plain_versions_match_each_other_and_count_nothing():
    """On the CPU "auto" and "pallas" take the plain version (no kernel
    there) exactly as "scan" does, and the launch counters stay put; the
    wrappers' plain halves agree with the autograd op."""
    x, emb, tgt = _inputs(130, seed=4)
    before = tfx.kernel_launches()
    outs = [_torch(x, emb, tgt, torch.float32, impl=impl)
            for impl in ("auto", "pallas", "scan")]
    assert tfx.kernel_launches() == before
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)
    xt, et = torch.from_numpy(x).view(B * T, D), torch.from_numpy(emb)
    tt = torch.from_numpy(tgt).view(-1)
    lse, tg = tfx.fused_xent_fwd(xt, et, tt, chunk=128)
    np.testing.assert_allclose((lse - tg).numpy(), outs[0][0].ravel())
    g = torch.full((B * T,), 1.0 / (B * T))
    dx, de = tfx.fused_xent_bwd(xt, et, tt, lse, g, -g, chunk=128)
    np.testing.assert_allclose(dx.view(B, T, D).numpy(), outs[0][1])
    np.testing.assert_allclose(de.numpy(), outs[0][2])


def test_bad_impl_and_mesh_raise():
    x, emb, tgt = (torch.from_numpy(a) for a in _inputs(96))
    with pytest.raises(ValueError, match="impl"):
        tfx.fused_softmax_xent(x, emb, tgt, impl="tensorcore")
    with pytest.raises(NotImplementedError, match="A9"):
        tfx.fused_softmax_xent(x, emb, tgt, mesh=object())
    with pytest.raises(ValueError, match="wants x"):
        tfx.fused_softmax_xent(x[0], emb, tgt)


def _bwd_inputs(v, dtype, seed):
    """Flat x [B*T, D], E [V, D] in `dtype`, targets (a few outside [0,
    V)), the reference lse and random cotangents, all on the CPU."""
    x, emb, tgt = _inputs(v, seed=seed)
    xt = torch.from_numpy(x).view(B * T, D).to(dtype)
    et = torch.from_numpy(emb).to(dtype)
    tgt = tgt.reshape(-1)
    tgt[:3] = [-1, v, v + 7]
    tt = torch.from_numpy(tgt)
    lse, _ = tfx.lse_target_reference(xt, et, tt, chunk=128)
    rng = np.random.default_rng(seed + 100)
    cl = torch.from_numpy(rng.random(B * T).astype(np.float32))
    ct = -torch.from_numpy(rng.random(B * T).astype(np.float32))
    return xt, et, tt, lse, cl, ct


def _dense_dlog(xt, et, tt, lse, cl, ct):
    """dlog [N, V] f32 from the materialised logits."""
    v = et.shape[0]
    s = xt.float() @ et.float().t()
    inside = (tt >= 0) & (tt < v)
    hit = torch.zeros_like(s)
    hit[inside.nonzero()[:, 0], tt[inside].long()] = 1.0
    return cl[:, None] * torch.exp(s - lse[:, None]) + ct[:, None] * hit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_wrapper_on_cpu_is_the_reference(dtype):
    """`fused_xent_bwd` on CPU tensors is `xent_backward_reference`, bit
    for bit, and launches nothing."""
    args = _bwd_inputs(517, dtype, seed=5)
    before = tfx.kernel_launches()
    got = tfx.fused_xent_bwd(*args, chunk=128)
    assert tfx.kernel_launches() == before
    want = tfx.xent_backward_reference(*args, chunk=128)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


def test_abs_bound_matches_dense_logits():
    """`xent_backward_abs_bound`, chunk by chunk (ragged last chunk), is
    |dlog| . |E| and |dlog|^T . |x| of the dense dlog."""
    xt, et, tt, lse, cl, ct = _bwd_inputs(517, torch.float32, seed=6)
    bx, be = tfx.xent_backward_abs_bound(xt, et, tt, lse, cl, ct, chunk=128)
    dlog = _dense_dlog(xt, et, tt, lse, cl, ct).abs()
    torch.testing.assert_close(bx, dlog @ et.abs(), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(be, dlog.t() @ xt.abs(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("v", [517, 130])
def test_bf16_dlog_rounding_stays_inside_the_card_limit(v):
    """dlog rounded to bf16 once, then f32 products (what the bf16
    kernels compute) lies within 2**-8 * bound of the f32 plain backward
    (2**-8 is bf16's unit roundoff: 8 significant bits), hence inside the
    card tests' limit 1e-4 (max|ref| + |ref|) + 2**-8 * bound, and
    differs from it: the rounding term carries the limit."""
    xt, et, tt, lse, cl, ct = _bwd_inputs(v, torch.bfloat16, seed=7)
    ref = tfx.xent_backward_reference(xt, et, tt, lse, cl, ct, chunk=128)
    bound = tfx.xent_backward_abs_bound(xt, et, tt, lse, cl, ct, chunk=128)
    dlog = _dense_dlog(xt, et, tt, lse, cl, ct).bfloat16().float()
    emu = (dlog @ et.float(), dlog.t() @ xt.float())
    for e, r, b in zip(emu, ref, bound):
        err = (e - r).abs()
        f32_slack = 1e-6 * (r.abs().max() + r.abs())
        assert torch.all(err <= 2 ** -8 * b + f32_slack)
        limit = 1e-4 * (r.abs().max() + r.abs()) + 2 ** -8 * b
        assert torch.all(err <= limit)
        assert err.max() > 0
        # the rounding, not the f32 term, is what the limit has to cover
        assert (err / (2 ** -8 * b).clamp_min(1e-30)).max() > 0.1
        assert err.max() > 1e-4 * r.abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-4)])
def test_tile_partials_and_merge_match_jax(dtype, tol):
    """The bf16 forward's two kernels in plain form, per-tile partials
    then the merge, against the JAX package's fused forward (its scan:
    V 1000 is no multiple of 128, so the reference has no Pallas plan):
    N 300, V 1000 (ragged against the 256-column tile), D 64, targets at
    0 and V - 1 and one outside [0, V)."""
    rng = np.random.default_rng(8)
    n, v, d = 300, 1000, 64
    x = rng.standard_normal((1, n, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, v, (1, n)).astype(np.int32)
    tgt[0, :3] = [0, v - 1, v + 5]
    xt = torch.from_numpy(x[0]).to(dtype)
    et = torch.from_numpy(emb).to(dtype)
    part, tg = tfx.xent_fwd_partials_reference(xt, et,
                                               torch.from_numpy(tgt[0]))
    assert part.shape == (4, n, 2) and part.dtype == torch.float32
    lse = tfx.xent_fwd_merge_reference(part)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj, ej = jnp.asarray(x, jdt), jnp.asarray(emb, jdt)
    lse_j, tgt_j = jfx._lse_tgt_scan(xj, ej, jnp.asarray(tgt), 128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[0], atol=tol,
                               rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(tgt_j)[0], atol=tol,
                               rtol=0)
    assert tg[2] == 0
    nll_j = jfx.fused_softmax_xent(xj, ej, jnp.asarray(tgt), vocab_chunk=128,
                                   impl="scan")
    np.testing.assert_allclose((lse - tg).numpy(), np.asarray(nll_j)[0],
                               atol=tol, rtol=0)


@pytest.mark.parametrize("d,want", [(1, 64), (40, 64), (64, 64), (65, 128),
                                    (96, 128), (200, 256), (300, 384),
                                    (384, 384), (500, 512), (640, 640),
                                    (700, 768), (896, 896), (1000, 1024),
                                    (1024, 1024)])
def test_kernel_width_is_the_next_built_width(d, want):
    assert tfx.kernel_width(d) == want


@pytest.mark.parametrize("d", [0, 1025, 2048])
def test_widths_without_a_kernel_raise(d):
    with pytest.raises(ValueError, match="width"):
        tfx.kernel_width(d)


@pytest.mark.parametrize("d", [40, 96, 200, 300])
def test_padded_width_matches_unpadded(d):
    """What the wrappers do for a width without kernels of its own: zero
    columns of x and E up to `kernel_width` add nothing to a logit, so
    lse, the target logit, dx and dE agree with the unpadded plain
    versions (up to f32 summation order) and dx, dE are zero past D."""
    rng = np.random.default_rng(d)
    n, v = 50, 300
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((v, d)) * d ** -0.5)
                         .astype(np.float32))
    t = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    dp = tfx.kernel_width(d)
    px, pe = pad_last_dim(x, dp), pad_last_dim(e, dp)
    assert px.shape == (n, dp) and torch.all(pe[:, d:] == 0)
    lse, tg = tfx.lse_target_reference(x, e, t, 128)
    plse, ptg = tfx.lse_target_reference(px, pe, t, 128)
    torch.testing.assert_close(plse, lse, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(ptg, tg, atol=1e-5, rtol=1e-6)
    cl = torch.from_numpy(rng.random(n).astype(np.float32))
    ct = -torch.from_numpy(rng.random(n).astype(np.float32))
    dx, de = tfx.xent_backward_reference(x, e, t, lse, cl, ct, 128)
    pdx, pde = tfx.xent_backward_reference(px, pe, t, lse, cl, ct, 128)
    for a, b in ((pdx, dx), (pde, de)):
        torch.testing.assert_close(a[:, :d], b, atol=1e-5, rtol=1e-5)
        assert torch.all(a[:, d:] == 0)


@pytest.mark.parametrize("d", [384, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_widths_384_and_200_match_jax(d, dtype):
    """The width the card used to refuse (d_model 384) and one off the
    kernels' list, through the port's fused loss and JAX's (scan), value
    and both gradients, with the tolerances above."""
    rng = np.random.default_rng(d)
    v = 517
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * d ** -0.5).astype(np.float32)
    tgt = rng.integers(0, v, (B, T)).astype(np.int32)
    tdt = getattr(torch, dtype)
    got = _torch(x, emb, tgt, tdt)
    want = _jax(x, emb, tgt, "scan", jnp.dtype(dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    else:
        np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
        for g, w in zip(got[1:], want[1:]):
            assert np.all(np.abs(g - w) <= 2 ** -7 * np.abs(w) + 1e-6)
