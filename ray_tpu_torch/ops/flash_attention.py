"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper (``csrc/flash_attention.cu``) beside plain PyTorch versions with
the same math.

Counterpart of `ray_tpu/ops/flash_attention.py`. The public API keeps its
layout: ``flash_attention(q, k, v, causal, block_q, block_kv)`` on
``[B, T, H, D]`` tensors, differentiable, with both directions kernels
(a `torch.autograd.Function` whose backward is the dQ and dK/dV kernels
over the forward's saved logsumexp). ``block_q``/``block_kv`` are
accepted for signature parity; the CUDA kernels choose their own tiles.

Layouts differ from the Pallas wrappers where those were TPU artefacts:
q/k/v/dO stay ``[B, T, H, D]`` (no transpose to ``[BH, T, D]``), and
``lse``/``delta`` are ``[B*H, T]`` float32 rows (no 128-lane broadcast).
Every T runs on the kernel: ragged lengths are masked inside it, so
there is no fallback to plain attention. Every head dim runs on the
kernels, as the reference runs every one: the kernels are built for D
32, 64, 128, 256 and 512, and take a multiple of 512 above that in
slabs of 512 (each output slab a CTA of its own, every score summed over
all slabs); the wrappers zero-pad q, k, v (and dO) up to the next of
those (`kernel_head_dim`, `ops.pad_last_dim`) and slice the outputs,
with the softmax scale of the true head dim. Zero columns add nothing
to q.k^T or to delta, and dq, dk, dv come out zero there, so the
padding is exact.

Dispatch: a CUDA tensor launches the kernel, or raises if the kernel
cannot take the inputs; a CPU tensor takes the plain version, because
there is no kernel on the CPU. Each kernel wrapper carries a
plain-integer ``launches`` counter that grows by one per call that
reaches a kernel, and each kernel (tensor cores for bf16 at kernel dim
64 and 128, CUDA cores otherwise, D 256 and up included) a counter in
`LAUNCHES` that grows by one per launch (never on the plain path).

The forward is also registered as the custom operator
``ray_tpu_torch::flash_fwd``, so selective activation checkpointing
(`models.gpt`'s ``remat_policy="attn_out"``) can name its output.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops import pad_last_dim, trim_last_dim

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels are built for; others pad up to the next (256 and
# 512 on the CUDA-core kernels only), above 512 to a multiple of 512 (run
# in slabs of 512)
_KERNEL_HEAD_DIMS = (32, 64, 128, 256, 512)
# bf16 head dims the tensor-core kernels take: rows of whole 128-byte
# TMA boxes (D 32 rows are 64 bytes and stay on the CUDA-core kernels)
_TC_HEAD_DIMS = (64, 128)

# One counter per kernel (the wrappers below count their calls in
# ``.launches``).
LAUNCHES = dict.fromkeys(("flash_fwd_tc", "flash_fwd_simt", "flash_dq_tc",
                          "flash_dq_simt", "flash_dkv_tc", "flash_dkv_simt"),
                         0)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, *, causal: bool = False):
    """O(T^2)-memory plain attention on ``[B, T, H, D]``, f32 inside,
    output in q's dtype (a copy of
    `ray_tpu.parallel.ring_attention.reference_attention`)."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    scale = qf.shape[-1] ** -0.5
    score = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        score = torch.where(mask, score, NEG_INF)
    p = torch.softmax(score, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def _scores(q, k, causal: bool, scale=None):
    """``(q * scale) . k`` as ``[B, H, T, T]`` f32 (scale D**-0.5 unless
    given) with NEG_INF where the causal mask hides a key, and the mask
    (or None)."""
    t, d = q.shape[1], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if not causal:
        return s, None
    live = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    return torch.where(live, s, NEG_INF), live


def _rows(x, b: int, h: int):
    """``[B, H, T]`` -> ``[B*H, T]`` contiguous f32 rows."""
    return x.reshape(b * h, -1).contiguous()


def flash_forward_reference(q, k, v, *, causal: bool, scale=None):
    """The forward kernel's math in plain PyTorch: ``(out [B, T, H, D]``
    in q's dtype, ``lse [B*H, T]`` f32), softmax scale D**-0.5 unless
    ``scale`` is given. Like the kernel (and the Pallas kernel), p is
    rounded to v's dtype before ``p . V`` while the normaliser sums the
    f32 p."""
    b, _, h, _ = q.shape
    s, _ = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (pv / l).transpose(1, 2).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return out, _rows(lse, b, h)


def flash_backward_reference(q, k, v, do, lse, delta, *, causal: bool,
                             scale=None):
    """The backward kernels' math in plain PyTorch: ``(dq, dk, dv)`` in
    the inputs' dtypes, from the forward's ``lse`` and ``delta =
    rowsum(dO * O)`` (both ``[B*H, T]`` f32): p = exp(s - lse), dS =
    p * (dO . V^T - delta), dq = sm * dS . K, dk = sm * dS^T . Q,
    dv = P^T . dO, with sm = D**-0.5 unless ``scale`` is given."""
    sm = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds = p_and_ds(q, k, v, do, lse, delta, causal=causal, scale=sm)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def p_and_ds(q, k, v, do, lse, delta, *, causal: bool, scale=None):
    """The core the backward kernels share, in plain PyTorch: ``P =
    exp(s - lse)`` (0 where the causal mask hides a key) and ``dS = P *
    (dO . V^T - delta)``, both ``[B, H, T, T]`` f32."""
    b, t, h, _ = q.shape
    s, live = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.view(b, h, t, 1))
    if live is not None:
        p = torch.where(live, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.view(b, h, t, 1))


def flash_backward_abs_bound(q, k, v, do, lse, delta, *, causal: bool):
    """f32 ``(sm |dS| . |K|, sm |dS|^T . |Q|, |P|^T . |dO|)``, each
    ``[B, T, H, D]``, from the plain version's f32 P and dS: the scale of
    the bf16 tensor-core backward's roundings of P and dS to bf16 before
    its products, which move each dq, dk and dv element by at most
    2**-8 times these. For tests and on-card checks."""
    sm = q.shape[-1] ** -0.5
    p, ds = p_and_ds(q, k, v, do, lse, delta, causal=causal)
    ds = ds.abs()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()) * sm,
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()) * sm,
            torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()))


def attention_delta(out, do):
    """``delta = rowsum(dO * O)`` in f32 as ``[B*H, T]`` rows: O(T*D)
    traffic, left to PyTorch as the reference leaves it to XLA."""
    b, _, h, _ = out.shape
    delta = (do.float() * out.float()).sum(dim=-1)        # [B, T, H]
    return _rows(delta.transpose(1, 2), b, h)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _on_kernel(op: str, x) -> bool:
    """True for a CUDA tensor (launch the kernel), False on the CPU."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    return True


def kernel_head_dim(d: int) -> int:
    """The head dim a kernel runs ``d`` at: the smallest of 32, 64, 128,
    256 and 512 that holds it, and above 512 the next multiple of 512
    (slabs). Every ``d`` from 1 up runs, as in the reference; 0 raises."""
    if d < 1:
        raise ValueError(f"flash attention kernels take a head dim of 1 "
                         f"or more, got {d}")
    if d > _KERNEL_HEAD_DIMS[-1]:
        return -(-d // 512) * 512
    return next(k for k in _KERNEL_HEAD_DIMS if k >= d)


def _check(op, q, *others, rows=()):
    """What the CUDA kernels take; anything else raises (no fallback).
    Returns (B, T, H, D) with the true head dim D."""
    if q.ndim != 4:
        raise ValueError(f"{op} wants [B, T, H, D] tensors, got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{op}: kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, t, h, d = q.shape
    kernel_head_dim(d)
    for x in (q, *others):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{op}: {tuple(x.shape)} {x.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    for x in rows:
        if x.shape != (b * h, t) or x.dtype != torch.float32:
            raise ValueError(f"{op}: lse/delta must be [B*H, T] float32 = "
                             f"{(b * h, t)}, got {tuple(x.shape)} {x.dtype}")
    for x in (q, *others, *rows):
        if x.device != q.device:
            raise ValueError(f"{op}: inputs on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{op}: inputs must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{op}: inputs must be 16-byte aligned")
    return b, t, h, d


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_tc(q, dp: int) -> bool:
    """bf16 at kernel dim 64 or 128 runs on the tensor-core kernels."""
    return q.dtype == torch.bfloat16 and dp in _TC_HEAD_DIMS


def flash_forward(q, k, v, *, causal: bool, with_lse: bool = True):
    """Forward attention on ``[B, T, H, D]``: ``(out, lse)``, lse
    ``[B*H, T]`` f32 (None without ``with_lse``: the inference variant
    skips its write). The kernels replace
    `ray_tpu/ops/flash_attention.py::_flash_kernel`, chosen by dtype and
    kernel head dim (`kernel_head_dim`):

    - bfloat16 at 64 or 128 (the training and serving paths): the
      tensor-core kernel ``flash_fwd_tc`` (wgmma + TMA, 128 query rows
      against 128-key tiles, p rounded to bf16 relative to the running
      row max, as the CUDA-core kernel does with 64-key tiles);
    - float32, and bfloat16 at 32, 256 and up: the CUDA-core kernel
      ``flash_fwd_simt`` (above 512 in slabs of 512).

    ``flash_forward.launches`` grows by one per call that reaches a
    kernel, and the kernel's counter in `LAUNCHES` by one per launch."""
    if not _on_kernel("flash_forward", q):
        out, lse = flash_forward_reference(q, k, v, causal=causal)
        return out, (lse if with_lse else None)
    from ray_tpu_torch.ops import _build
    q, k, v = (x.contiguous() for x in (q, k, v))
    b, t, h, d = _check("flash_forward", q, k, v)
    dp = kernel_head_dim(d)
    q, k, v = (pad_last_dim(x, dp) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((b * h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, t, h, dp, d ** -0.5,
            int(causal))
    lib = _build.load()
    if _on_tc(q, dp):
        name, err = "flash_fwd_tc", lib.rtt_flash_fwd_tc(*ptrs, _stream(q))
    else:
        name, err = "flash_fwd_simt", lib.rtt_flash_fwd(
            *ptrs, _KERNEL_DTYPES[q.dtype], _stream(q))
    _build.check(err, name)
    LAUNCHES[name] += 1
    flash_forward.launches += 1
    return trim_last_dim(out, d), lse


flash_forward.launches = 0


def _backward_inputs(op, q, k, v, do, lse, delta):
    """The backward kernels' inputs, contiguous and zero-padded to the
    kernel head dim: (q, k, v, do, (B, T, H, D), kernel head dim)."""
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    shape = _check(op, q, k, v, do, rows=(lse, delta))
    dp = kernel_head_dim(shape[3])
    q, k, v, do = (pad_last_dim(x, dp) for x in (q, k, v, do))
    return q, k, v, do, shape, dp


def flash_dq(q, k, v, do, lse, delta, *, causal: bool):
    """dQ from the forward's lse and ``delta``; the kernels replace
    `ray_tpu/ops/flash_attention.py::_dq_kernel`: ``flash_dq_tc`` (wgmma
    + TMA, 128 query rows against 64-key tiles) for bfloat16 at kernel
    head dim 64 and 128, ``flash_dq_simt`` (CUDA cores) otherwise. The
    tensor-core kernel rounds P (through dS) and dS to bf16 before dS . K,
    so per element it may differ from the plain version by 2**-8 * scale
    * |dS| . |K| more."""
    if not _on_kernel("flash_dq", q):
        return flash_backward_reference(q, k, v, do, lse, delta,
                                        causal=causal)[0]
    from ray_tpu_torch.ops import _build
    q, k, v, do, (b, t, h, d), dp = _backward_inputs("flash_dq", q, k, v,
                                                     do, lse, delta)
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, h, dp,
            d ** -0.5, int(causal))
    lib = _build.load()
    if _on_tc(q, dp):
        name, err = "flash_dq_tc", lib.rtt_flash_dq_tc(*args, _stream(q))
    else:
        name, err = "flash_dq_simt", lib.rtt_flash_dq(
            *args, _KERNEL_DTYPES[q.dtype], _stream(q))
    _build.check(err, name)
    LAUNCHES[name] += 1
    flash_dq.launches += 1
    return trim_last_dim(dq, d)


flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """(dK, dV) from the forward's lse and ``delta``; the kernels replace
    `ray_tpu/ops/flash_attention.py::_dkv_kernel`: ``flash_dkv_tc``
    (wgmma + TMA, 128 key rows against 64-row query tiles, in the
    transposed form S^T = K Q^T) for bfloat16 at kernel head dim 64 and
    128, ``flash_dkv_simt`` (CUDA cores) otherwise. The tensor-core
    kernel rounds P and dS to bf16 before P^T . dO and dS^T . Q, so per
    element dV may differ from the plain version by 2**-8 * |P|^T . |dO|
    and dK by 2**-8 * scale * |dS|^T . |Q| more."""
    if not _on_kernel("flash_dkv", q):
        return flash_backward_reference(q, k, v, do, lse, delta,
                                        causal=causal)[1:]
    from ray_tpu_torch.ops import _build
    q, k, v, do, (b, t, h, d), dp = _backward_inputs("flash_dkv", q, k, v,
                                                     do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, h, dp, d ** -0.5, int(causal))
    lib = _build.load()
    if _on_tc(q, dp):
        name, err = "flash_dkv_tc", lib.rtt_flash_dkv_tc(*args, _stream(q))
    else:
        name, err = "flash_dkv_simt", lib.rtt_flash_dkv(
            *args, _KERNEL_DTYPES[q.dtype], _stream(q))
    _build.check(err, name)
    LAUNCHES[name] += 1
    flash_dkv.launches += 1
    return trim_last_dim(dk, d), trim_last_dim(dv, d)


flash_dkv.launches = 0

WRAPPERS = (flash_forward, flash_dq, flash_dkv)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_forward(q, k, v, causal=causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = torch.ops.ray_tpu_torch.flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = attention_delta(out, do)
        dq = flash_dq(q, k, v, do, lse, delta, causal=ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False, block_q: int = 1024,
                    block_kv: int = 1024):
    """``[B, T, H, D]`` attention, softmax((q k^T) D**-0.5) v with f32
    accumulation, output in q's dtype; differentiable through the dQ and
    dK/dV kernels. Without autograd the forward skips the lse write.
    ``block_q``/``block_kv`` are accepted for signature parity with the
    JAX package and ignored."""
    del block_q, block_kv
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_forward(q, k, v, causal=causal, with_lse=False)[0]


def kernel_launches() -> dict:
    """Launch count of each flash kernel wrapper (the counters live on
    the wrappers as ``.launches``) and of each kernel (`LAUNCHES`)."""
    return {**{f.__name__: f.launches for f in WRAPPERS}, **LAUNCHES}


def reset_kernel_launches() -> None:
    for f in WRAPPERS:
        f.launches = 0
    for name in LAUNCHES:
        LAUNCHES[name] = 0
