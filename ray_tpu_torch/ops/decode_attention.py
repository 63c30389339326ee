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
grows by one per kernel launch (never on the plain path), so a run can
show that its main path went through the kernels.

The kernels take every head dim that is a multiple of 8 up to 128
unpadded (the lanes or tile columns past D idle), so pools and caches
keep their head dim. The multi-query kernel is built for block sizes 8,
16 and 32; a pool of any other multiple of 8 is handed to it re-viewed
(`split_blocks`): a contiguous ``[n, 64, H, D]`` pool is ``[2n, 32, H,
D]``, with table entry j of a row expanded to ``2 tables[j]`` and
``2 tables[j] + 1``. The decode kernels take any block size.

Int8 pools (``k_scale``/``v_scale``) are not ported yet and raise
`NotImplementedError`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128                 # head dims: multiples of 8 up to this
_KERNEL_BLOCK_SIZES = (32, 16, 8)   # multi-query kernel; decode takes any


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


def _check_kernel_inputs(op, q, k_pool, v_pool, **indices):
    """What the CUDA kernels take; anything else raises (no fallback).
    ``indices`` are the int32 tensors the kernel reads (tables, pos)."""
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


def _launch_dense_decode(q, k, v, pos):
    """q [B, H, D] against a contiguous cache k, v [B, S, H, D]."""
    from ray_tpu_torch.ops import _build
    op = "decode_attention"
    _check_kernel_inputs(op, q, k, v, pos=pos)
    b, s, h, d = k.shape
    if q.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: q {tuple(q.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    err = _build.load().rtt_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, s, h, d, d ** -0.5, _KERNEL_DTYPES[q.dtype],
        _stream(q))
    _build.check(err, op)
    decode_attention.launches += 1
    return out


def _launch_decode(q, k_pool, v_pool, tables, pos):
    from ray_tpu_torch.ops import _build
    op = "paged_decode_attention"
    _check_kernel_inputs(op, q, k_pool, v_pool, tables=tables, pos=pos)
    b, h, d = q.shape
    bs = k_pool.shape[1]
    if tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    lib = _build.load()
    err = lib.rtt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, d, bs,
        tables.shape[1], d ** -0.5, _KERNEL_DTYPES[q.dtype], _stream(q))
    _build.check(err, op)
    paged_decode_attention.launches += 1
    return out


def split_blocks(k_pool, v_pool, tables):
    """The same pools and block tables seen at the largest of the
    multi-query kernel's block sizes (32, 16, 8) that divides the pool's
    block size ``bs``: with f = bs / that size, pools ``[n, bs, H, D]``
    become ``[f n, bs / f, H, D]`` views (no copy; the pools must be
    contiguous) and ``tables [..., mb]`` becomes ``[..., f mb]`` int32
    with entry ``f j + i`` = ``f tables[j] + i``: logical position p still
    lives at the same element. Raises for a block size that is not a
    multiple of 8."""
    bs = k_pool.shape[1]
    sub = next((s for s in _KERNEL_BLOCK_SIZES if bs % s == 0), None)
    if sub is None:
        raise ValueError(f"paged multi-query attention: block size must be "
                         f"a multiple of 8, got {bs}")
    f = bs // sub
    if f == 1:
        return k_pool, v_pool, tables
    nb, rest = k_pool.shape[0], tuple(k_pool.shape[2:])
    k_pool, v_pool = (p.view((nb * f, sub) + rest) for p in (k_pool, v_pool))
    parts = torch.arange(f, dtype=torch.int32, device=tables.device)
    tables = (tables[..., None] * f + parts).flatten(-2).to(torch.int32)
    return k_pool, v_pool, tables


def _launch_mq(op, q, k_pool, v_pool, tables, pos):
    """q [B, W, H, D] through the multi-query kernel."""
    from ray_tpu_torch.ops import _build
    _check_kernel_inputs(op, q, k_pool, v_pool, tables=tables, pos=pos)
    b, w, h, d = q.shape
    k_pool, v_pool, tables = split_blocks(k_pool, v_pool, tables)
    bs = k_pool.shape[1]
    if tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    lib = _build.load()
    err = lib.rtt_paged_mq(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, w, h, d, bs,
        tables.shape[1], d ** -0.5, _KERNEL_DTYPES[q.dtype], _stream(q))
    _build.check(err, op)
    return out


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
    every position past ``pos[b]`` at run time.

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

    The kernel replaces `ray_tpu/ops/decode_attention.py::_paged_kernel`.
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
    (shared with `paged_prefill_attention`)."""
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
    """Launch count of each kernel wrapper (the counters themselves live
    on the wrappers as ``.launches``)."""
    return {f.__name__: f.launches for f in WRAPPERS}


def reset_kernel_launches() -> None:
    for f in WRAPPERS:
        f.launches = 0
