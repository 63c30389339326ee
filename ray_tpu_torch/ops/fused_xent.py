"""Fused cross-entropy over a tied embedding: the LM loss without the
``[B, T, V]`` logits. Hand-written CUDA kernels for Hopper
(``csrc/fused_xent.cu``) beside plain PyTorch versions with the same math.

Counterpart of `ray_tpu/ops/fused_xent.py`. ``fused_softmax_xent(x,
embed, targets)`` takes the final-norm activations ``x [B, T, D]`` and
the tied embedding ``embed [V, D]`` and returns the per-token nll
``[B, T]`` f32, as ``logsumexp(x . embed^T) - x . embed[target]``. The
differentiable op is the pair (lse, target logit), a
`torch.autograd.Function` whose forward saves only (x, embed, targets,
lse); its backward rebuilds each logits block from lse:

    dlog = c_lse * softmax + c_tgt * onehot(target)
    dx   = dlog . embed          dembed = dlog^T . x

The implied logits are f32 products of f32-cast inputs (a bf16 product
of bf16 operands is exact in f32), summed in f32. A target outside
[0, V) contributes a target logit of 0 (the reference's tensor-parallel
shard case). The bf16 backward kernels round dlog to bf16 once before
their two products (see `fused_xent_bwd`); the plain version does not.

Dispatch: ``impl="scan"`` names the plain version (its meaning in the
reference, a loop over vocab chunks of ``vocab_chunk`` rows). ``"auto"``
and ``"pallas"`` name the kernels: a CUDA tensor launches them, or raises
if they cannot take the inputs; a CPU tensor takes the plain version,
because there is no kernel on the CPU. Any N and V run on the kernels
(ragged edges are masked inside them); the kernels choose their own
tiles, so ``vocab_chunk`` only shapes the plain version. Every width
runs on the kernels: up to 1024 they are built for 64 and every multiple
of 128; above 1024 the bf16 kernels take any multiple of 64 and the f32
backward splits the width into equal column chunks of those built
widths. Any other width runs zero-padded to one the kernels take
(`kernel_width`, `ops.pad_last_dim`): zero columns of x and E add
nothing to a logit, and dx and dE are sliced back. With a mesh
(``mesh=``, `vocab_sharded_xent`) the same kernels run on each rank's
vocabulary shard, the ids shifted by the shard's base, and collectives
over the vocab axis combine the shards.

`LAUNCHES` holds one plain-integer counter per kernel that grows by one
per launch, and ``fused_xent_fwd`` one that grows by one per forward
call that reaches the kernels (none grows on the plain path).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops import pad_last_dim, trim_last_dim
from ray_tpu_torch.parallel import collectives

NEG = -1e30   # finite -inf stand-in, as the reference's _NEG

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# widths up to 1024 the kernels are built for; others pad up to the next
# (wider ones: `kernel_width`)
_KERNEL_WIDTHS = (64, 128, 256, 384, 512, 640, 768, 896, 1024)
# The bf16 backward's vocabulary chunk, and the row / column tile of the
# bf16 kernels (csrc/fused_xent.cu tc::BM, tc::BN): the shared dlog buffer
# is [N rounded up to _TILE_ROWS, BWD_CHUNK] bf16, so BWD_CHUNK is a
# multiple of _TILE_COLS; the forward keeps one partial per row and
# _TILE_COLS-column vocabulary tile.
BWD_CHUNK = 4096
_TILE_ROWS, _TILE_COLS = 128, 256

LAUNCHES = dict.fromkeys(("fused_xent_fwd", "xent_fwd_tc", "xent_fwd_merge",
                          "xent_fwd_simt", "xent_dlog", "xent_dx", "xent_de",
                          "xent_bwd_dx", "xent_bwd_de"), 0)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def _chunked_embed(embed, chunk: int):
    """[V, D] -> ([nc, chunk, D], padded V); zero rows past V are masked
    by the callers through their column index."""
    v, d = embed.shape
    nc = -(-v // chunk)
    vpad = nc * chunk
    if vpad != v:
        embed = torch.cat([embed, embed.new_zeros((vpad - v, d))])
    return embed.reshape(nc, chunk, d), vpad


def lse_target_reference(x, embed, targets, chunk: int = 512):
    """x [N, D], embed [V, D], targets [N] int -> (lse [N], target logit
    [N]) f32, streaming the vocabulary in chunks of ``chunk`` rows with a
    running max / sum-exp (the reference's `_lse_tgt_scan`)."""
    n, v = x.shape[0], embed.shape[0]
    chunk = min(chunk, v)
    emb, _ = _chunked_embed(embed, chunk)
    xf = x.float()
    tg_ids = targets.long()[:, None]
    m = torch.full((n,), NEG, dtype=torch.float32, device=x.device)
    l = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tg = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for i in range(emb.shape[0]):
        s = xf @ emb[i].float().t()                          # [N, chunk]
        col = i * chunk + torch.arange(chunk, device=x.device)
        valid = col < v
        s = torch.where(valid, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(-1)
        hit = (col == tg_ids) & valid
        tg = tg + torch.where(hit, s, 0.0).sum(-1)
        m = m_new
    return m + torch.log(l), tg


def xent_fwd_partials_reference(x, embed, targets, tile: int = _TILE_COLS):
    """The bf16 forward's first kernel in plain PyTorch: per vocabulary
    tile of ``tile`` embedding rows, each x row's max m and sum l of
    exp(s - m) over the tile's columns < V, as ``part [n_tiles, N, 2]``
    f32, and the target logit ``[N]`` f32 (0 for a target outside [0,
    V)). `xent_fwd_merge_reference` turns ``part`` into lse."""
    n, v = x.shape[0], embed.shape[0]
    emb, _ = _chunked_embed(embed, tile)
    xf = x.float()
    tg_ids = targets.long()[:, None]
    part, tg = [], torch.zeros((n,), dtype=torch.float32, device=x.device)
    for i in range(emb.shape[0]):
        s = xf @ emb[i].float().t()                          # [N, tile]
        col = i * tile + torch.arange(tile, device=x.device)
        valid = col < v
        m = torch.where(valid, s, NEG).amax(dim=-1)
        l = torch.where(valid, torch.exp(s - m[:, None]), 0.0).sum(-1)
        part.append(torch.stack([m, l], dim=-1))
        tg = tg + torch.where((col == tg_ids) & valid, s, 0.0).sum(-1)
    return torch.stack(part), tg


def xent_fwd_merge_reference(part):
    """The bf16 forward's second kernel in plain PyTorch: lse ``[N]`` of
    the per-tile partials ``part [n_tiles, N, 2]`` (max m, sum l of exp(s
    - m)): M + log(sum_t l_t exp(m_t - M)), M the largest m_t."""
    m, l = part[..., 0], part[..., 1]
    mx = m.amax(dim=0)
    return mx + torch.log((l * torch.exp(m - mx)).sum(dim=0))


def _dlog_chunks(x, embed, targets, lse, c_lse, c_tgt, chunk):
    """Yields (x f32, E_c f32 [chunk, D], dlog f32 [N, chunk]) per vocab
    chunk, rebuilding the chunk's logits from lse (the reference's
    `_recompute_dlog`); columns past V are 0."""
    v = embed.shape[0]
    chunk = min(chunk, v)
    emb, _ = _chunked_embed(embed, chunk)
    xf = x.float()
    tg_ids = targets.long()[:, None]
    lse, c_lse, c_tgt = (a.float()[:, None] for a in (lse, c_lse, c_tgt))
    for i in range(emb.shape[0]):
        e_c = emb[i].float()
        s = xf @ e_c.t()
        col = i * chunk + torch.arange(chunk, device=x.device)
        valid = col < v
        p = torch.where(valid, torch.exp(s - lse), 0.0)
        hit = ((col == tg_ids) & valid).float()
        yield xf, e_c, c_lse * p + c_tgt * hit


def xent_backward_reference(x, embed, targets, lse, c_lse, c_tgt,
                            chunk: int = 512):
    """f32 (dx [N, D], dembed [V, D]) from the saved lse and the
    cotangents of (lse, target logit), rebuilding each chunk's logits
    (the reference's `_bwd_scan`)."""
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    de = []
    for xf, e_c, dlog in _dlog_chunks(x, embed, targets, lse, c_lse, c_tgt,
                                      chunk):
        dx = dx + dlog @ e_c
        de.append(dlog.t() @ xf)
    return dx, torch.cat(de)[:embed.shape[0]]


def xent_backward_abs_bound(x, embed, targets, lse, c_lse, c_tgt,
                            chunk: int = 512):
    """f32 (|dlog| . |E| [N, D], |dlog|^T . |x| [V, D]), chunk by chunk:
    the scale of the bf16 backward's one rounding of dlog, which moves
    each dx element by at most 2**-8 times the first and each dE element
    by at most 2**-8 times the second. For tests and on-card checks."""
    bx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    be = []
    for xf, e_c, dlog in _dlog_chunks(x, embed, targets, lse, c_lse, c_tgt,
                                      chunk):
        dlog = dlog.abs()
        bx = bx + dlog @ e_c.abs()
        be.append(dlog.t() @ xf.abs())
    return bx, torch.cat(be)[:embed.shape[0]]


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


def _check(op, x, embed, targets, rows=()):
    """What the CUDA kernels take; anything else raises (no fallback).
    Returns (N, V, D)."""
    if x.ndim != 2 or embed.ndim != 2 or x.shape[1] != embed.shape[1]:
        raise ValueError(f"{op} wants x [N, D] and embed [V, D]; got "
                         f"{tuple(x.shape)} and {tuple(embed.shape)}")
    if x.dtype not in _KERNEL_DTYPES or embed.dtype != x.dtype:
        raise TypeError(f"{op}: kernels take float32 or bfloat16 x and "
                        f"embed of one dtype, got {x.dtype} / {embed.dtype}")
    n, d = x.shape
    v = embed.shape[0]
    kernel_width(d, x.dtype)
    if targets.shape != (n,) or targets.dtype != torch.int32:
        raise ValueError(f"{op}: targets must be [N] int32 = ({n},), got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    for a in rows:
        if a.shape != (n,) or a.dtype != torch.float32:
            raise ValueError(f"{op}: lse and cotangents must be [N] "
                             f"float32, got {tuple(a.shape)} {a.dtype}")
    for a in (x, embed, targets, *rows):
        if a.device != x.device:
            raise ValueError(f"{op}: inputs on {a.device} and {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{op}: inputs must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{op}: inputs must be 16-byte aligned")
    return n, v, d


def kernel_width(d: int, dtype=torch.float32) -> int:
    """The width the kernels for ``dtype`` run ``d`` at. Up to 1024 the
    smallest of `_KERNEL_WIDTHS` that holds it (both dtypes, so the main
    path's width 1024 runs as it is). Above: for bfloat16 the next
    multiple of 64 (the tensor-core kernels take any); for float32, with
    n = ceil(d / 1024) column chunks, n times the next multiple of 128 at
    or above d / n (the f32 backward keeps one chunk's accumulator in
    registers, built for multiples of 128 up to 1024). Widths below 1
    raise."""
    if d < 1:
        raise ValueError(f"fused cross-entropy kernels take a width D of "
                         f"at least 1, got {d}")
    if d <= _KERNEL_WIDTHS[-1]:
        return next(w for w in _KERNEL_WIDTHS if w >= d)
    if dtype == torch.bfloat16:
        return -(-d // 64) * 64
    n = -(-d // _KERNEL_WIDTHS[-1])      # column chunks
    chunk = -(-d // n)
    return n * (-(-chunk // 128) * 128)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _i32(t):
    return t.to(torch.int32).contiguous()


def _f32(t):
    return t.to(torch.float32).contiguous()


def fused_xent_fwd(x, embed, targets, *, chunk: int = 512):
    """(lse [N], target logit [N]) f32 for x [N, D], embed [V, D],
    targets [N]. The kernels replace `ray_tpu/ops/fused_xent.py::
    _fwd_kernel`, chosen by dtype:

    - bfloat16 (the training path): two tensor-core kernels,
      ``xent_fwd_tc`` (per 128-row x 256-column tile of x . E^T, each
      row's max and sum of exp into a [ceil(V / 256), N, 2] f32 workspace,
      and the target logit; `xent_fwd_partials_reference`) and
      ``xent_fwd_merge`` (lse from each row's partials;
      `xent_fwd_merge_reference`).
    - float32: the CUDA-core kernel ``xent_fwd_simt``, exact f32 sums.

    ``LAUNCHES["fused_xent_fwd"]`` grows by one per call that reaches the
    kernels, and each kernel's own counter by one per launch. ``chunk``
    only shapes the plain version (CPU tensors)."""
    if not _on_kernel("fused_xent_fwd", x):
        return lse_target_reference(x, embed, targets, chunk)
    from ray_tpu_torch.ops import _build
    x, embed, targets = x.contiguous(), embed.contiguous(), _i32(targets)
    n, v, d = _check("fused_xent_fwd", x, embed, targets)
    d = kernel_width(d, x.dtype)
    x, embed = pad_last_dim(x, d), pad_last_dim(embed, d)
    lib, stream = _build.load(), _stream(x)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    tgt = torch.empty((n,), dtype=torch.float32, device=x.device)
    if x.dtype == torch.float32:
        _build.check(lib.rtt_xent_fwd(x.data_ptr(), embed.data_ptr(),
                                      targets.data_ptr(), lse.data_ptr(),
                                      tgt.data_ptr(), n, v, d, stream),
                     "xent_fwd_simt")
        LAUNCHES["xent_fwd_simt"] += 1
    else:
        part = torch.empty((-(-v // _TILE_COLS), n, 2), dtype=torch.float32,
                           device=x.device)
        _build.check(lib.rtt_xent_fwd_tc(x.data_ptr(), embed.data_ptr(),
                                         targets.data_ptr(), part.data_ptr(),
                                         tgt.data_ptr(), n, v, d, stream),
                     "xent_fwd_tc")
        LAUNCHES["xent_fwd_tc"] += 1
        _build.check(lib.rtt_xent_fwd_merge(part.data_ptr(),
                                            targets.data_ptr(),
                                            lse.data_ptr(), tgt.data_ptr(),
                                            n, v, stream), "xent_fwd_merge")
        LAUNCHES["xent_fwd_merge"] += 1
    LAUNCHES["fused_xent_fwd"] += 1
    return lse, tgt


def fused_xent_bwd(x, embed, targets, lse, c_lse, c_tgt, *,
                   chunk: int = 512):
    """f32 (dx [N, D], dembed [V, D]) from the saved lse and the
    cotangents of (lse, target logit), as the reference's `_bwd_impl`.
    The kernels replace `ray_tpu/ops/fused_xent.py::_dx_kernel` and
    `::_de_kernel`, chosen by dtype:

    - bfloat16 (the training path): per vocabulary chunk of `BWD_CHUNK`
      embedding rows, three tensor-core kernels on one shared bf16 dlog
      buffer: ``xent_dlog`` (dlog of the chunk), ``xent_dx`` (dx +=
      dlog . E_c) and ``xent_de`` (dE_c = dlog^T . x). dlog is rounded to
      bf16 once, so per element |d dx| <= 2**-8 |dlog| . |E| and |d dE| <=
      2**-8 |dlog|^T . |x| (`xent_backward_abs_bound`).
    - float32: the CUDA-core kernels ``xent_bwd_dx`` and ``xent_bwd_de``,
      exact f32 sums.

    Each counter in `LAUNCHES` grows by one per launch of its kernel.
    ``chunk`` only shapes the plain version (CPU tensors)."""
    if not _on_kernel("fused_xent_bwd", x):
        return xent_backward_reference(x, embed, targets, lse, c_lse, c_tgt,
                                       chunk)
    from ray_tpu_torch.ops import _build
    x, embed, targets = x.contiguous(), embed.contiguous(), _i32(targets)
    lse, c_lse, c_tgt = _f32(lse), _f32(c_lse), _f32(c_tgt)
    n, v, d_true = _check("fused_xent_bwd", x, embed, targets,
                          rows=(lse, c_lse, c_tgt))
    d = kernel_width(d_true, x.dtype)
    x, embed = pad_last_dim(x, d), pad_last_dim(embed, d)
    lib, stream = _build.load(), _stream(x)
    rows = (targets.data_ptr(), lse.data_ptr(), c_lse.data_ptr(),
            c_tgt.data_ptr())
    dx = torch.empty((n, d), dtype=torch.float32, device=x.device)
    de = torch.empty((v, d), dtype=torch.float32, device=x.device)
    if x.dtype == torch.float32:
        for name, fn, out in (("xent_bwd_dx", lib.rtt_xent_dx, dx),
                              ("xent_bwd_de", lib.rtt_xent_de, de)):
            _build.check(fn(x.data_ptr(), embed.data_ptr(), *rows,
                            out.data_ptr(), n, v, d, stream), name)
            LAUNCHES[name] += 1
        return trim_last_dim(dx, d_true), trim_last_dim(de, d_true)
    n_pad = -(-n // _TILE_ROWS) * _TILE_ROWS
    ldd = min(BWD_CHUNK, -(-v // _TILE_COLS) * _TILE_COLS)
    dlog = torch.empty((n_pad, ldd), dtype=torch.bfloat16, device=x.device)
    for v0 in range(0, v, BWD_CHUNK):
        geom = (n, n_pad, d, v0, min(BWD_CHUNK, v - v0), ldd)
        _build.check(lib.rtt_xent_dlog(x.data_ptr(), embed.data_ptr(), *rows,
                                       dlog.data_ptr(), *geom, stream),
                     "xent_dlog")
        LAUNCHES["xent_dlog"] += 1
        _build.check(lib.rtt_xent_dx_tc(dlog.data_ptr(), embed.data_ptr(),
                                        dx.data_ptr(), *geom, int(v0 > 0),
                                        stream), "xent_dx")
        LAUNCHES["xent_dx"] += 1
        _build.check(lib.rtt_xent_de_tc(dlog.data_ptr(), x.data_ptr(),
                                        de.data_ptr(), *geom, stream),
                     "xent_de")
        LAUNCHES["xent_de"] += 1
    return trim_last_dim(dx, d_true), trim_last_dim(de, d_true)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _resolve_impl(impl: str) -> str:
    """"scan" (plain) or "kernel" (the wrappers: kernels on the card, the
    plain version for CPU tensors)."""
    if impl not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown fused-xent impl {impl!r} (expected "
                         "'auto' | 'pallas' | 'scan')")
    return "scan" if impl == "scan" else "kernel"


class _LseAndTarget(torch.autograd.Function):
    """(lse, target logit) over x [N, D] and embed [V, D]; the backward
    returns dx in x's dtype and dembed in embed's dtype, as the
    reference's custom_vjp does."""

    @staticmethod
    def forward(ctx, x, embed, targets, chunk, kind):
        if kind == "scan":
            lse, tgt = lse_target_reference(x, embed, targets, chunk)
        else:
            lse, tgt = fused_xent_fwd(x, embed, targets, chunk=chunk)
        ctx.save_for_backward(x, embed, targets, lse)
        ctx.chunk, ctx.kind = chunk, kind
        return lse, tgt

    @staticmethod
    def backward(ctx, c_lse, c_tgt):
        x, embed, targets, lse = ctx.saved_tensors
        args = (x, embed, targets, lse, c_lse, c_tgt)
        if ctx.kind == "scan":
            dx, de = xent_backward_reference(*args, ctx.chunk)
        else:
            dx, de = fused_xent_bwd(*args, chunk=ctx.chunk)
        return dx.to(x.dtype), de.to(embed.dtype), None, None, None


class _VocabShardedXent(torch.autograd.Function):
    """nll over this rank's vocabulary shard ``embed [V / n, D]`` (rows
    ``[base, base + V / n)``, ``base`` the rank's position along
    ``vocab_axis`` times ``V / n``) with the rank's tokens ``x [N, D]``.

    Forward: the per-shard (lse, target logit) of the shifted ids
    ``targets - base`` (below 0 on the shards above the target's, at or
    above ``V / n`` on those below it: a target logit of 0 there), then
    a pmax and a psum of ``exp(lse_p - max)`` over ``vocab_axis`` and a
    psum of the partial target logit. Backward, with the nll's cotangent
    g (the same on every rank of ``vocab_axis``): the per-shard backward
    with ``c_lse = g`` and ``c_tgt = -g``, dx summed over ``vocab_axis``
    and dE over ``token_axes``."""

    @staticmethod
    def forward(ctx, x, embed, targets, mesh, vocab_axis, token_axes, chunk,
                kind):
        base = mesh.axis_index(vocab_axis) * embed.shape[0] if vocab_axis \
            else 0
        shifted = targets.to(torch.int32) - base
        if kind == "scan":
            lse_p, tgt_p = lse_target_reference(x, embed, shifted, chunk)
        else:
            lse_p, tgt_p = fused_xent_fwd(x, embed, shifted, chunk=chunk)
        lse, tgt = lse_p, tgt_p
        if vocab_axis:
            mg = collectives.pmax(lse_p, vocab_axis, mesh)
            lse = mg + torch.log(collectives.psum(torch.exp(lse_p - mg),
                                                  vocab_axis, mesh))
            tgt = collectives.psum(tgt_p, vocab_axis, mesh)
        ctx.save_for_backward(x, embed, shifted, lse)
        ctx.mesh, ctx.vocab_axis, ctx.token_axes = mesh, vocab_axis, token_axes
        ctx.chunk, ctx.kind = chunk, kind
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, embed, shifted, lse = ctx.saved_tensors
        g = g.float().contiguous()
        args = (x, embed, shifted, lse, g, -g)
        if ctx.kind == "scan":
            dx, de = xent_backward_reference(*args, ctx.chunk)
        else:
            dx, de = fused_xent_bwd(*args, chunk=ctx.chunk)
        if ctx.vocab_axis:
            dx = collectives.psum(dx, ctx.vocab_axis, ctx.mesh)
        if ctx.token_axes:
            de = collectives.psum(de, ctx.token_axes, ctx.mesh)
        return (dx.to(x.dtype), de.to(embed.dtype), None, None, None, None,
                None, None)


def vocab_sharded_xent(x, embed, targets, mesh, *, vocab_axis,
                       token_axes=(), vocab_chunk: int = 512,
                       impl: str = "auto"):
    """Per-token nll ``[B, T]`` f32 of this rank's tokens ``x [B, T, D]``
    against its vocabulary shard ``embed [V / n, D]`` of ``vocab_axis``
    (None: the whole vocabulary), every rank of the axis calling it with
    the same tokens; dE comes back summed over ``token_axes`` (the
    trainer passes none: it sums every gradient over the axes that split
    tokens itself). The kernels run on each shard with the ids shifted
    by the shard's base."""
    kind = _resolve_impl(impl)
    b, t, d = x.shape
    nll = _VocabShardedXent.apply(
        x.reshape(b * t, d), embed, targets.reshape(b * t), mesh,
        vocab_axis, tuple(token_axes), int(vocab_chunk), kind)
    return nll.view(b, t)


def fused_softmax_xent(x, embed, targets, *, vocab_chunk: int = 512,
                       impl: str = "auto", mesh=None, rules=None):
    """Per-token nll ``[B, T]`` f32 from the final-norm activations ``x
    [B, T, D]`` and the tied embedding ``embed [V, D]``, never
    materialising the ``[B, T, V]`` logits, forward or backward. The same
    contract as `train.spmd.softmax_xent(x @ embed.T, targets)`.

    With a `mesh` (one process per rank, `parallel.sharding.
    fused_xent_specs`): ``x`` and ``targets`` are this rank's block of
    tokens, and, when the vocab rule's axis (default ``tensor``) has n >
    1 ranks, ``embed`` is the rank's vocabulary shard ``[V / n, D]``:
    each shard reduces its own rows and one psum of the partial
    log-sum-exp and target-logit terms over that axis combines them
    (`vocab_sharded_xent`). Gradients as the reference's global ones: dx
    for the rank's tokens, dE for its shard summed over the axes that
    split tokens."""
    if x.ndim != 3 or embed.ndim != 2:
        raise ValueError(
            f"fused_softmax_xent wants x [B, T, D] and embed [V, D]; got "
            f"{tuple(x.shape)} and {tuple(embed.shape)}")
    kind = _resolve_impl(impl)
    if mesh is not None and mesh.size > 1:
        from ray_tpu_torch.parallel.sharding import (fused_xent_specs,
                                                     spec_axes)
        _, e_spec, t_spec = fused_xent_specs(mesh, rules)
        vocab_axis = e_spec[0]
        if not (isinstance(vocab_axis, str)
                and mesh.shape.get(vocab_axis, 1) > 1):
            vocab_axis = None
        return vocab_sharded_xent(
            x, embed, targets, mesh, vocab_axis=vocab_axis,
            token_axes=mesh.live_axes(spec_axes(t_spec)),
            vocab_chunk=vocab_chunk, impl=impl)
    del rules
    b, t, d = x.shape
    lse, tgt = _LseAndTarget.apply(x.reshape(b * t, d), embed,
                                   targets.reshape(b * t), int(vocab_chunk),
                                   kind)
    return (lse - tgt).view(b, t)


def kernel_launches() -> dict:
    """Launch count of each fused-xent kernel (`LAUNCHES`)."""
    return dict(LAUNCHES)


def reset_kernel_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
