"""Decode attention over a contiguous KV cache and paged attention over a
block-table KV pool: hand-written CUDA kernels for Hopper
(``csrc/paged_attention.cu``) beside plain PyTorch versions with the same
math.

Counterpart of `ray_tpu/ops/decode_attention.py`, with the same public
names, signatures and layouts: a contiguous cache ``[B, S, H, D]``
(`decode_attention`, read in place by the kernel), pools ``[n_blocks,
block_size, H, D]`` (logical block j of row b is physical block
``tables[b, j]``), queries ``[B, H, D]`` (decode), ``[B, W, H, D]``
(verify) or ``[C, H, D]`` (chunked prefill). Every path masks logical
positions past the row's horizon with the finite ``NEG_INF`` and
accumulates in float32; outputs come back in q's dtype.

Dispatch: ``impl="jax"`` names the plain version (its meaning in the JAX
package, where it is the everywhere-correct path). ``"auto"`` and
``"pallas"`` name the kernel: a CUDA tensor launches it, or raises if the
kernel cannot take the inputs; a CPU tensor takes the plain version,
because there is no kernel on the CPU. There is no fallback from the
kernel to the plain version on the card.

Each kernel wrapper carries a plain-integer ``launches`` counter that
grows by one per call that reaches a kernel (never on the plain path),
so a run can show that its main path went through the kernels; the
multi-query wrappers share two kernels, counted per launch in
`LAUNCHES`: ``paged_mq_tc`` (bf16, tensor cores) and ``paged_mq_simt``
(f32, CUDA cores).

The kernels take every head dim that is a multiple of 8 up to 256
unpadded (the lanes or tile columns past D idle), so pools and caches
keep their head dim. Any other head dim up to 256 runs as the reference
runs it: the wrapper zero-pads q and the pools (or caches) to the next
multiple of 8 for that call and trims the output, with the softmax scale
of the true head dim (`kernel_head_dim`). That copies the pools on every
call, so it is for such head dims only; no model the port serves has
one. The paged kernels split each row's key range across CTAs (split-K,
`split_geometry`) and merge the partial softmax states in split order
inside the same launch (`paged_mq_partials_reference`,
`paged_merge_reference`). The bf16 multi-query kernel and the decode
kernels take any block size (the multi-query wrappers ask for a multiple
of 8, as the reference does); the f32 multi-query kernel is built for
block sizes 8, 16 and 32, and a pool of any other multiple of 8 is
handed to it re-viewed (`split_blocks`): a contiguous ``[n, 64, H, D]``
pool is ``[2n, 32, H, D]``, with table entry j of a row expanded to
``2 tables[j]`` and ``2 tables[j] + 1``.

Int8 pools (``k_scale``/``v_scale``) are not ported yet and raise
`NotImplementedError`.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops import pad_last_dim, trim_last_dim

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256                 # head dims: multiples of 8 up to this
_KERNEL_BLOCK_SIZES = (32, 16, 8)   # f32 multi-query kernel
# Split-K: a split is a multiple of _SPLIT_UNIT key positions, at most
# _MAX_SPLITS splits a row (csrc/paged_attention.cu).
_SPLIT_UNIT, _MAX_SPLITS = 128, 16
# query rows of a bf16 multi-query CTA (csrc/paged_attention.cu tc::QR)
_MQ_TILE = 64

# One counter per multi-query kernel (the wrappers count their calls in
# ``.launches``).
LAUNCHES = dict.fromkeys(("paged_mq_tc", "paged_mq_simt"), 0)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def reference_decode_attention(q, k, v, pos):
    """q [B, H, D]; k, v [B, S, H, D]; pos [B] int. Attends to cache
    positions <= pos[b]; returns [B, H, D] in q.dtype, f32 accumulation."""
    s, d = k.shape[1], k.shape[3]
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * (d ** -0.5)
    live = torch.arange(s, device=q.device)[None, None, :] <= \
        pos.long()[:, None, None]
    scores = torch.where(live, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v.float()).to(q.dtype)


def gather_kv_pages(pool, tables):
    """``pool [n_blocks, bs, H, D]`` gathered through ``tables
    [B, max_blocks]`` -> ``[B, max_blocks * bs, H, D]``, where row b's
    logical position p lives at ``(tables[b, p // bs], p % bs)``."""
    b, mb = tables.shape
    nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.reshape((nb * bs,) + tuple(pool.shape[2:]))
    idx = (tables.long()[:, :, None] * bs
           + torch.arange(bs, device=pool.device)[None, None, :]
           ).reshape(b, mb * bs)
    return flat[idx]


def _no_scales(k_scale, v_scale, op: str):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            f"{op}: int8 pools (k_scale/v_scale) are not ported yet "
            "(ROADMAP queue B: int8 paths of the paged kernels)")


def reference_paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                                     k_scale=None, v_scale=None):
    """Gather-then-attend plain version of the paged decode kernel."""
    _no_scales(k_scale, v_scale, "reference_paged_decode_attention")
    return reference_decode_attention(q, gather_kv_pages(k_pool, tables),
                                      gather_kv_pages(v_pool, tables), pos)


def reference_paged_verify_attention(q, k_pool, v_pool, tables, pos, *,
                                     k_scale=None, v_scale=None):
    """q [B, W, H, D]: token i of row b attends to logical positions
    ``<= pos[b] + i``. Returns [B, W, H, D] in q.dtype."""
    _no_scales(k_scale, v_scale, "reference_paged_verify_attention")
    k_seq = gather_kv_pages(k_pool, tables)
    v_seq = gather_kv_pages(v_pool, tables)
    s, d = k_seq.shape[1], k_seq.shape[3]
    w = q.shape[1]
    scores = torch.einsum("bwhd,bshd->bhws", q.float(),
                          k_seq.float()) * (d ** -0.5)
    limit = pos.long()[:, None] + torch.arange(w, device=q.device)
    live = torch.arange(s, device=q.device)[None, None, :] <= \
        limit[:, :, None]                                  # [B, W, S]
    scores = torch.where(live[:, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhws,bshd->bwhd", p, v_seq.float()).to(q.dtype)


def split_geometry(span: int) -> tuple[int, int]:
    """``(ks, n_split)`` of the split-K kernels for a table that reaches
    ``span = max_blocks * block_size`` positions: splits of ``ks``
    positions (a multiple of 128, the least that keeps ``n_split =
    ceil(span / ks)`` at 16 or fewer). Fixed by shapes, so a captured
    graph keeps its grid."""
    ks = _SPLIT_UNIT * -(-span // (_SPLIT_UNIT * _MAX_SPLITS))
    return ks, -(-span // ks)


def paged_mq_partials_reference(q, k_pool, v_pool, tables, pos, ks: int,
                                scale=None):
    """The split-K kernels' first half in plain PyTorch: for q ``[B, W,
    H, D]`` (query i of row b sees logical positions ``<= pos[b] + i``)
    and each split of ``ks`` positions of the table's reach, every
    query's softmax state over the positions of that split it may see:
    ``(m, l, acc)``, f32, ``m, l [n_split, B, W, H]``, ``acc [n_split, B,
    W, H, D]``: the max score (softmax scale ``D**-0.5`` unless
    ``scale`` is given, as for a zero-padded head dim), the sum of
    ``exp(s - m)`` and the unnormalised ``sum exp(s - m) v``. A split a
    query sees nothing of holds ``(NEG_INF, 0, 0)``.
    `paged_merge_reference` turns the states into the attention
    output."""
    k_seq = gather_kv_pages(k_pool, tables).float()
    v_seq = gather_kv_pages(v_pool, tables).float()
    s_len, d = k_seq.shape[1], k_seq.shape[3]
    w = q.shape[1]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bwhd,bshd->bwhs", q.float(), k_seq) * scale
    limit = pos.long()[:, None] + torch.arange(w, device=q.device)
    cols = torch.arange(s_len, device=q.device)
    live = (cols[None, None, :] <= limit[:, :, None])[:, :, None, :]
    ms, ls, accs = [], [], []
    for k0 in range(0, s_len, ks):
        sl = slice(k0, min(k0 + ks, s_len))
        see = live[..., sl]
        sc = torch.where(see, scores[..., sl], NEG_INF)
        m = sc.amax(dim=-1)
        p = torch.where(see, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bwhs,bshd->bwhd", p, v_seq[:, sl]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def paged_decode_partials_reference(q, k_pool, v_pool, tables, pos,
                                    ks: int, scale=None):
    """`paged_mq_partials_reference` for the decode kernel's one query
    per row: q ``[B, H, D]``; states ``[n_split, B, H]`` and ``[n_split,
    B, H, D]``."""
    m, l, acc = paged_mq_partials_reference(q[:, None], k_pool, v_pool,
                                            tables, pos, ks, scale)
    return m[:, :, 0], l[:, :, 0], acc[:, :, 0]


def paged_merge_reference(m, l, acc):
    """The split-K kernels' merge in plain PyTorch: the attention output
    (f32) from per-split states ``m, l [n_split, ...]`` and ``acc
    [n_split, ..., D]``, taken in split order: ``sum_s acc_s w_s / sum_s
    l_s w_s`` with ``w_s = exp(m_s - max_s m_s)``."""
    w = torch.exp(m - m.amax(dim=0))
    return (acc * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]


def reference_paged_prefill_attention(q, k_pool, v_pool, table, start, *,
                                      k_scale=None, v_scale=None):
    """Chunked-prefill attention for ONE sequence: q [C, H, D], chunk
    token t at absolute position ``start + t`` attends to gathered
    positions ``<= start + t``. table [max_blocks]; start int or 0-d/[1]
    int tensor. Returns [C, H, D] in q.dtype."""
    _no_scales(k_scale, v_scale, "reference_paged_prefill_attention")
    c, d = q.shape[0], q.shape[2]
    kctx = gather_kv_pages(k_pool, table[None])[0]
    vctx = gather_kv_pages(v_pool, table[None])[0]
    start = torch.as_tensor(start, device=q.device).long().reshape(())
    positions = start + torch.arange(c, device=q.device)
    scores = torch.einsum("thd,shd->hts", q.float(),
                          kctx.float()) * (d ** -0.5)
    cols = torch.arange(kctx.shape[0], device=q.device)
    live = cols[None, None, :] <= positions[None, :, None]
    scores = torch.where(live, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hts,shd->thd", p, vctx.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _resolve_impl(impl: str, op: str, x) -> str:
    """"kernel" for a CUDA tensor under auto/pallas, "plain" otherwise."""
    if impl not in ("auto", "pallas", "jax"):
        raise ValueError(f"unknown {op} impl {impl!r} "
                         "(expected 'auto' | 'pallas' | 'jax')")
    if impl == "jax" or x.device.type == "cpu":
        return "plain"
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    return "kernel"


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: ``d`` rounded up to a
    multiple of 8 (as the reference pads it), for ``d`` from 1 to 256;
    others raise."""
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"paged attention kernels take a head dim from 1 "
                         f"to {_MAX_HEAD_DIM}, got {d}")
    return -(-d // 8) * 8


def _check_kernel_inputs(op, q, k_pool, v_pool, **indices):
    """What the CUDA kernels take; anything else raises (no fallback).
    ``indices`` are the int32 tensors the kernel reads (tables, pos).
    The head dim is the kernel's (`kernel_head_dim`)."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{op}: kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise TypeError(f"{op}: {name} dtype {t.dtype} != q dtype "
                            f"{q.dtype}")
    for name, t in indices.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{op}: {name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    *indices.items()):
        if t.device != q.device:
            raise ValueError(f"{op}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned")
    d = q.shape[-1]
    if d % 8 or not 8 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"{op}: kernel head dim must be a multiple of 8 "
                         f"from 8 to {_MAX_HEAD_DIM}, got {d}")
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != q.shape[-2:]:
        raise ValueError(f"{op}: pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# (device index, stream) -> zeroed int32 ticket buffers of the split-K
# kernels, newest last. A buffer outgrown is kept, not freed: a captured
# graph may still point at it.
_TICKETS: dict = {}


def _tickets(x, n: int):
    """At least ``n`` int32 tickets on x's device for its current stream,
    zero between calls: each split-K launch leaves them as it found them,
    so one buffer serves every call (and every replay of a captured one)
    on that stream."""
    key = (x.device.index, _stream(x))
    bufs = _TICKETS.setdefault(key, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=x.device))
    return bufs[-1]


def _padded_heads(*xs):
    """``xs`` zero-padded on the last dim to `kernel_head_dim` (the
    tensors themselves when it is a multiple of 8), and the true head
    dim."""
    d = xs[0].shape[-1]
    dk = kernel_head_dim(d)
    return tuple(pad_last_dim(x, dk) for x in xs), d


def _launch_dense_decode(q, k, v, pos):
    """q [B, H, D] against a contiguous cache k, v [B, S, H, D]."""
    from ray_tpu_torch.ops import _build
    op = "decode_attention"
    (q, k, v), d = _padded_heads(q, k, v)
    _check_kernel_inputs(op, q, k, v, pos=pos)
    b, s, h, dk = k.shape
    if q.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: q {tuple(q.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    err = _build.load().rtt_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, s, h, dk, d ** -0.5, _KERNEL_DTYPES[q.dtype],
        _stream(q))
    _build.check(err, op)
    decode_attention.launches += 1
    return trim_last_dim(out, d)


def _launch_decode(q, k_pool, v_pool, tables, pos):
    from ray_tpu_torch.ops import _build
    op = "paged_decode_attention"
    (q, k_pool, v_pool), d = _padded_heads(q, k_pool, v_pool)
    _check_kernel_inputs(op, q, k_pool, v_pool, tables=tables, pos=pos)
    b, h, dk = q.shape
    bs, mb = k_pool.shape[1], tables.shape[1]
    if tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    ks, n_split = split_geometry(mb * bs)
    out = torch.empty_like(q)
    ws = torch.empty(b * h * n_split * (2 + dk), dtype=torch.float32,
                     device=q.device)
    err = _build.load().rtt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
        _tickets(q, b * h).data_ptr(), b, h, dk, bs, mb, ks, n_split,
        d ** -0.5, _KERNEL_DTYPES[q.dtype], _stream(q))
    _build.check(err, op)
    paged_decode_attention.launches += 1
    return trim_last_dim(out, d)


def split_blocks(k_pool, v_pool, tables):
    """The same pools and block tables seen at the largest of the f32
    multi-query kernel's block sizes (32, 16, 8) that divides the pool's
    block size ``bs``: with f = bs / that size, pools ``[n, bs, H, D]``
    become ``[f n, bs / f, H, D]`` views (no copy; the pools must be
    contiguous) and ``tables [..., mb]`` becomes ``[..., f mb]`` int32
    with entry ``f j + i`` = ``f tables[j] + i``: logical position p still
    lives at the same element. Raises for a block size that is not a
    multiple of 8."""
    bs = k_pool.shape[1]
    _check_block_size(bs)
    sub = next(s for s in _KERNEL_BLOCK_SIZES if bs % s == 0)
    f = bs // sub
    if f == 1:
        return k_pool, v_pool, tables
    nb, rest = k_pool.shape[0], tuple(k_pool.shape[2:])
    k_pool, v_pool = (p.view((nb * f, sub) + rest) for p in (k_pool, v_pool))
    parts = torch.arange(f, dtype=torch.int32, device=tables.device)
    tables = (tables[..., None] * f + parts).flatten(-2).to(torch.int32)
    return k_pool, v_pool, tables


def _check_block_size(bs: int) -> None:
    if bs % 8:
        raise ValueError(f"paged multi-query attention: block size must be "
                         f"a multiple of 8, got {bs}")


def _launch_mq(op, q, k_pool, v_pool, tables, pos):
    """q [B, W, H, D] through a multi-query kernel: ``paged_mq_tc`` for
    bf16 (the pool as it is), ``paged_mq_simt`` for f32 (the pool
    re-viewed at block 8, 16 or 32 by `split_blocks`)."""
    from ray_tpu_torch.ops import _build
    (q, k_pool, v_pool), d = _padded_heads(q, k_pool, v_pool)
    _check_kernel_inputs(op, q, k_pool, v_pool, tables=tables, pos=pos)
    b, w, h, dk = q.shape
    if tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    lib = _build.load()
    if q.dtype == torch.bfloat16:
        bs, mb = k_pool.shape[1], tables.shape[1]
        _check_block_size(bs)
        ks, n_split = split_geometry(mb * bs)
        n_tiles = -(-w // _MQ_TILE)
        ws = torch.empty(b * h * n_tiles * n_split * min(w, _MQ_TILE)
                         * (2 + dk), dtype=torch.float32, device=q.device)
        name, err = "paged_mq_tc", lib.rtt_paged_mq_tc(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ws.data_ptr(), _tickets(q, b * h * n_tiles).data_ptr(), b, w,
            h, dk, bs, mb, ks, n_split, d ** -0.5, _stream(q))
    else:
        k_pool, v_pool, tables = split_blocks(k_pool, v_pool, tables)
        name, err = "paged_mq_simt", lib.rtt_paged_mq(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, w, h, dk,
            k_pool.shape[1], tables.shape[1], d ** -0.5, _stream(q))
    _build.check(err, op)
    LAUNCHES[name] += 1
    return trim_last_dim(out, d)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def decode_attention(q, k, v, pos, *, impl: str = "auto",
                     block_kv: int = 512):
    """Decode-step attention over a contiguous KV cache: ``q [B, H, D]``
    against ``k, v [B, S, H, D]``, attending to positions ``<= pos[b]``
    (``pos [B]`` int32, the position of the token q was computed from).
    Returns ``[B, H, D]`` in q.dtype. ``block_kv`` is accepted for
    signature parity with the JAX package and ignored: the kernel skips
    every position past ``pos[b]`` at run time. A head dim that is not a
    multiple of 8 runs zero-padded (a copy of the cache per call).

    The kernel replaces `ray_tpu/ops/decode_attention.py::_decode_kernel`.
    """
    del block_kv
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(
            f"decode_attention wants q [B, H, D] and k/v [B, S, H, D]; "
            f"got {tuple(q.shape)} and {tuple(k.shape)}")
    if _resolve_impl(impl, "decode_attention", q) == "plain":
        return reference_decode_attention(q, k, v, pos)
    return _launch_dense_decode(q, k, v, pos)


decode_attention.launches = 0


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                           k_scale=None, v_scale=None, impl: str = "auto"):
    """Decode-step attention through a paged KV cache: ``q [B, H, D]``
    against pools ``[n_blocks, block_size, H, D]`` indexed by ``tables
    [B, max_blocks]`` int32, attending to logical positions ``<= pos[b]``
    (``pos [B]`` int32, each >= 0). Returns ``[B, H, D]`` in q.dtype.

    The kernel replaces `ray_tpu/ops/decode_attention.py::_paged_kernel`:
    one launch per call, each row's key range split across CTAs
    (`split_geometry`) and merged in split order inside the launch; the
    grid is fixed by shapes and pos and tables are read on the device,
    so the call can be captured in a CUDA graph. A head dim that is not
    a multiple of 8 runs zero-padded, q and both pools copied for that
    call (the reference's padding); others up to 256 run as they are.
    """
    if q.ndim != 3 or k_pool.ndim != 4 or tables.ndim != 2:
        raise ValueError(
            "paged_decode_attention wants q [B, H, D], pools "
            f"[n_blocks, bs, H, D] and tables [B, max_blocks]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(tables.shape)}")
    _no_scales(k_scale, v_scale, "paged_decode_attention")
    if _resolve_impl(impl, "paged_decode_attention", q) == "plain":
        return reference_paged_decode_attention(q, k_pool, v_pool, tables,
                                                pos)
    return _launch_decode(q, k_pool, v_pool, tables, pos)


paged_decode_attention.launches = 0


def paged_verify_attention(q, k_pool, v_pool, tables, pos, *,
                           k_scale=None, v_scale=None, impl: str = "auto"):
    """Masked multi-query attention through the paged cache: ``q
    [B, W, H, D]``, token i of row b at logical position ``pos[b] + i``
    attending to positions ``<= pos[b] + i``. Returns ``[B, W, H, D]``.

    The kernel replaces `ray_tpu/ops/decode_attention.py::_paged_mq_kernel`
    (shared with `paged_prefill_attention`): bf16 runs ``paged_mq_tc``
    (tensor cores, split-K, one launch, capturable), f32
    ``paged_mq_simt``. A head dim that is not a multiple of 8 runs
    zero-padded, q and both pools copied for that call."""
    if q.ndim != 4 or k_pool.ndim != 4 or tables.ndim != 2:
        raise ValueError(
            "paged_verify_attention wants q [B, W, H, D], pools "
            f"[n_blocks, bs, H, D] and tables [B, max_blocks]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(tables.shape)}")
    _no_scales(k_scale, v_scale, "paged_verify_attention")
    if _resolve_impl(impl, "paged_verify_attention", q) == "plain":
        return reference_paged_verify_attention(q, k_pool, v_pool, tables,
                                                pos)
    out = _launch_mq("paged_verify_attention", q, k_pool, v_pool, tables,
                     pos)
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0


def paged_prefill_attention(q, k_pool, v_pool, table, start, *,
                            k_scale=None, v_scale=None, impl: str = "auto"):
    """Chunked-prefill attention for one sequence: ``q [C, H, D]`` (chunk
    token t at absolute position ``start + t``) attends over the
    sequence's whole prefix through ``table [max_blocks]`` int32; the
    caller scatters the chunk's K/V into the pool first. ``start`` is an
    int or an int32 tensor of one element on q's device (the kernel reads
    it there, so the host never waits). Returns ``[C, H, D]``.

    On the kernel path this is the multi-query kernel with B = 1, W = C
    and pos = start: the prefill staircase is the verify mask."""
    if q.ndim != 3 or k_pool.ndim != 4 or table.ndim != 1:
        raise ValueError(
            "paged_prefill_attention wants q [C, H, D], pools "
            f"[n_blocks, bs, H, D] and table [max_blocks]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(table.shape)}")
    _no_scales(k_scale, v_scale, "paged_prefill_attention")
    if _resolve_impl(impl, "paged_prefill_attention", q) == "plain":
        return reference_paged_prefill_attention(q, k_pool, v_pool, table,
                                                 start)
    if isinstance(start, torch.Tensor):
        pos = start.reshape(1)
    else:
        pos = torch.full((1,), int(start), dtype=torch.int32,
                         device=q.device)
    out = _launch_mq("paged_prefill_attention", q[None], k_pool, v_pool,
                     table[None], pos)
    paged_prefill_attention.launches += 1
    return out[0]


paged_prefill_attention.launches = 0


WRAPPERS = (decode_attention, paged_decode_attention,
            paged_prefill_attention, paged_verify_attention)


def kernel_launches() -> dict:
    """Launch count of each kernel wrapper (the counters live on the
    wrappers as ``.launches``) and of each multi-query kernel
    (`LAUNCHES`)."""
    return {**{f.__name__: f.launches for f in WRAPPERS}, **LAUNCHES}


def reset_kernel_launches() -> None:
    for f in WRAPPERS:
        f.launches = 0
    for name in LAUNCHES:
        LAUNCHES[name] = 0
