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

The kernels take every head dim that is a multiple of 8 up to 512
unpadded (the lanes or tile columns past D idle), so pools and caches
keep their head dim; bf16 multi-query calls above 256 run on the
CUDA-core kernel. Every other head dim runs as the reference runs it:
the wrapper zero-pads q and the pools (or caches) for that call, to the
next multiple of 8 up to 512 and to the next multiple of 512 above, and
trims the output, with the softmax scale of the true head dim
(`kernel_head_dim`). Above 512 the kernels work in slabs of 512: each
output slab is a CTA of its own, and every score sums over all slabs.
Padding copies the pools on every call, so it is for such head dims
only; no model the port serves has one. Every kernel splits each row's key range across CTAs (split-K,
grids from `split_geometry`) and merges the partial softmax states in
split order inside the same launch (`paged_mq_partials_reference`,
`decode_partials_reference`, `paged_merge_reference`); the two decode
kernels share one body and cut each row on the device by its length
(`decode_split_length`): a short row runs in one CTA, with no merge.
The bf16 multi-query kernel and the decode kernels take any block size
(the multi-query wrappers ask for a multiple of 8, as the reference
does); the f32 multi-query kernel is built for block sizes 8, 16 and
32, and a pool of any other multiple of 8 is handed to it re-viewed
(`split_blocks`): a contiguous ``[n, 64, H, D]`` pool is ``[2n, 32, H,
D]``, with table entry j of a row expanded to ``2 tables[j]`` and ``2
tables[j] + 1``.

Int8 pools: every paged wrapper takes ``k_scale``/``v_scale`` ``[n_blocks,
block_size, H]`` f32 (both or neither, `_check_scales`) beside int8
pools, the rows of `ops.quant.quantize_rows`. The plain versions
dequantize after the gather (`_gather_dequant`), as the reference does;
the kernels read the int8 payload and its per-row scale and dequantize
in registers (int8 instances of each kernel, counted under their own
keys in `LAUNCHES`: ``paged_decode_int8``, ``paged_mq_tc_int8``,
``paged_mq_simt_int8``). Nothing dequantizes a whole pool.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops import pad_last_dim, trim_last_dim

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims: multiples of 8 up to this, multiples of it above (slabs)
_SLAB = 512
# the bf16 tensor-core multi-query kernel's widest head (above: CUDA cores)
_MQ_TC_MAX_HEAD_DIM = 256
_KERNEL_BLOCK_SIZES = (32, 16, 8)   # f32 multi-query kernel
# Split-K: a split is a multiple of _SPLIT_UNIT key positions, at most
# _MAX_SPLITS splits a row (csrc/paged_attention.cu).
_SPLIT_UNIT, _MAX_SPLITS = 128, 16
# The decode kernels run a row that sees at most this many positions in
# one CTA, with no workspace and no merge (`decode_split_length`; chosen
# by an A/B on the H100, PERF.md).
_ONE_CTA = 384
# query rows of a bf16 multi-query CTA (csrc/paged_attention.cu tc::QR)
_MQ_TILE = 64

# One counter per multi-query kernel and per int8 kernel (the wrappers
# count their calls that reach any kernel in ``.launches``).
LAUNCHES = dict.fromkeys(("paged_mq_tc", "paged_mq_simt", "paged_mq_tc_int8",
                          "paged_mq_simt_int8", "paged_decode_int8"), 0)


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


def _gather_dequant(pool, scale, tables):
    """`gather_kv_pages`, dequantized to f32 through the gathered
    per-row ``scale [n_blocks, bs, H]`` when there is one (an int8
    pool); a float pool comes back as it was gathered."""
    seq = gather_kv_pages(pool, tables)
    if scale is None:
        return seq
    return seq.float() * gather_kv_pages(scale, tables).float()[..., None]


def _check_scales(k_scale, v_scale, k_pool, op: str) -> bool:
    """Both scales or neither, each shaped like the pool's rows
    ``[n_blocks, bs, H]``; True for an int8 pool."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            f"{op} wants both k_scale and v_scale or neither; got "
            f"k_scale={'set' if k_scale is not None else None}, "
            f"v_scale={'set' if v_scale is not None else None}")
    if k_scale is None:
        return False
    for t in (k_scale, v_scale):
        if tuple(t.shape) != tuple(k_pool.shape[:3]):
            raise ValueError(
                f"{op} scale shape {tuple(t.shape)} != pool row shape "
                f"{tuple(k_pool.shape[:3])} ([n_blocks, bs, H])")
    return True


def reference_paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                                     k_scale=None, v_scale=None):
    """Gather-then-attend plain version of the paged decode kernel (an
    int8 pool dequantized after the gather)."""
    return reference_decode_attention(
        q, _gather_dequant(k_pool, k_scale, tables),
        _gather_dequant(v_pool, v_scale, tables), pos)


def reference_paged_verify_attention(q, k_pool, v_pool, tables, pos, *,
                                     k_scale=None, v_scale=None):
    """q [B, W, H, D]: token i of row b attends to logical positions
    ``<= pos[b] + i``. Returns [B, W, H, D] in q.dtype."""
    k_seq = _gather_dequant(k_pool, k_scale, tables)
    v_seq = _gather_dequant(v_pool, v_scale, tables)
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
    ``span = max_blocks * block_size`` positions (or a contiguous cache
    of ``span`` positions): splits of ``ks`` positions (a multiple of
    128, the least that keeps ``n_split = ceil(span / ks)`` at 16 or
    fewer). Fixed by shapes, so a captured graph keeps its grid. The
    multi-query kernel cuts every row at ``ks``; the decode kernels take
    ``n_split`` as their grid and cut each row by its own length
    (`decode_split_length`)."""
    ks = _SPLIT_UNIT * -(-span // (_SPLIT_UNIT * _MAX_SPLITS))
    return ks, -(-span // ks)


def paged_mq_partials_reference(q, k_pool, v_pool, tables, pos, ks: int,
                                scale=None, *, k_scale=None, v_scale=None,
                                tile: int | None = None):
    """The multi-query kernels' first half in plain PyTorch: for q ``[B,
    W, H, D]`` (query i of row b sees logical positions ``<= pos[b] + i``)
    and each split of ``ks`` positions of the table's reach, every
    query's softmax state over the positions of that split it may see:
    ``(m, l, acc)``, f32, ``m, l [n_split, B, W, H]``, ``acc [n_split, B,
    W, H, D]``: the max score (softmax scale ``D**-0.5`` unless
    ``scale`` is given, as for a zero-padded head dim), the sum of
    ``exp(s - m)`` and the unnormalised ``sum exp(s - m) v``. A split a
    query sees nothing of holds ``(NEG_INF, 0, 0)``.
    `paged_merge_reference` turns the states into the attention
    output. ``k_scale``/``v_scale`` mark int8 pools (dequantized after
    the gather).

    ``tile`` makes it the tensor-core kernel's walk: each split in key
    tiles of ``tile`` positions, the softmax relative to the running row
    max, and each key's factor ``p`` (``p * v_scale`` on an int8 pool)
    rounded to bf16 before its product with the value row (bf16, or the
    int8 payload, exact in bf16), as the kernel rounds its A operand;
    ``l`` sums the unrounded ``p``."""
    k_seq = _gather_dequant(k_pool, k_scale, tables).float()
    s_len, d = k_seq.shape[1], k_seq.shape[3]
    w = q.shape[1]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bwhd,bshd->bwhs", q.float(), k_seq) * scale
    limit = pos.long()[:, None] + torch.arange(w, device=q.device)
    cols = torch.arange(s_len, device=q.device)
    live = (cols[None, None, :] <= limit[:, :, None])[:, :, None, :]
    if tile is None:
        v_seq = _gather_dequant(v_pool, v_scale, tables).float()
    else:
        v_seq = gather_kv_pages(v_pool, tables).float()
        v_col = (None if v_scale is None else
                 gather_kv_pages(v_scale, tables).float().permute(0, 2, 1)
                 [:, None])                               # [B, 1, H, S]
    ms, ls, accs = [], [], []
    for k0 in range(0, s_len, ks):
        k1 = min(k0 + ks, s_len)
        if tile is None:
            see = live[..., k0:k1]
            sc = torch.where(see, scores[..., k0:k1], NEG_INF)
            m = sc.amax(dim=-1)
            p = torch.where(see, torch.exp(sc - m[..., None]), 0.0)
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("bwhs,bshd->bwhd", p, v_seq[:, k0:k1]))
            continue
        m = torch.full(scores.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros(scores.shape[:-1], device=q.device)
        acc = torch.zeros(scores.shape[:-1] + (d,), device=q.device)
        for t0 in range(k0, k1, tile):
            sl = slice(t0, min(t0 + tile, k1))
            see = live[..., sl]
            sc = torch.where(see, scores[..., sl], NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.where(see, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * corr + p.sum(dim=-1)
            f = p if v_col is None else p * v_col[..., sl]
            acc = acc * corr[..., None] + torch.einsum(
                "bwhs,bshd->bwhd", f.bfloat16().float(), v_seq[:, sl])
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def decode_split_length(seen, n_split: int):
    """The decode kernels' split rule: the positions a split of a row
    holds, for ``seen`` (int tensor) positions in view and a grid of
    ``n_split`` splits a row. A row that sees at most `_ONE_CTA`
    positions takes them all in one CTA, which writes the output itself;
    a longer row is cut into splits of the least multiple of 128
    positions that keeps it to ``n_split`` splits."""
    unit = _SPLIT_UNIT * n_split
    return torch.where(seen <= _ONE_CTA, seen,
                       _SPLIT_UNIT * ((seen + unit - 1) // unit))


def decode_partials_reference(q, k, v, pos, n_split: int, scale=None):
    """The decode kernels' first half in plain PyTorch: for q ``[B, H,
    D]`` against a contiguous cache ``k, v [B, S, H, D]`` (row b sees
    positions ``<= min(pos[b], S - 1)``), cut as the kernels cut it
    (`decode_split_length` over a grid of ``n_split`` splits a row), each
    split's softmax state in split order: ``m, l [n_split, B, H]``,
    ``acc [n_split, B, H, D]``, f32, as `paged_mq_partials_reference`
    defines them (softmax scale ``D**-0.5`` unless ``scale`` is given). A
    split past a row's last holds ``(NEG_INF, 0, 0)``.
    `paged_merge_reference` turns the states into the output."""
    s_len, d = k.shape[1], k.shape[3]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    seen = pos.long().clamp(-1, s_len - 1) + 1
    ks = decode_split_length(seen, n_split).clamp(min=1)
    t = torch.arange(s_len, device=q.device)[None]
    piece = torch.where(t < seen[:, None], t // ks[:, None], -1)   # [B, S]
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        see = (piece == sp)[:, None, :]
        sc = torch.where(see, scores, NEG_INF)
        m = sc.amax(dim=-1)
        p = torch.where(see, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhs,bshd->bhd", p, v.float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def paged_decode_partials_reference(q, k_pool, v_pool, tables, pos,
                                    n_split: int, scale=None, *,
                                    k_scale=None, v_scale=None):
    """`decode_partials_reference` through a paged pool: the paged decode
    kernel cuts a row as the contiguous-cache one does, over the table's
    reach ``max_blocks * block_size``. ``k_scale``/``v_scale`` mark int8
    pools (dequantized after the gather)."""
    return decode_partials_reference(
        q, _gather_dequant(k_pool, k_scale, tables),
        _gather_dequant(v_pool, v_scale, tables), pos, n_split, scale)


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
    c, d = q.shape[0], q.shape[2]
    kctx = _gather_dequant(k_pool, k_scale, table[None])[0]
    vctx = _gather_dequant(v_pool, v_scale, table[None])[0]
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
    multiple of 8 (as the reference pads it) up to 512, and above 512 to
    a multiple of 512 (slabs). Every ``d`` from 1 up runs, as in the
    reference; 0 raises."""
    if d < 1:
        raise ValueError(f"paged attention kernels take a head dim of 1 or "
                         f"more, got {d}")
    unit = 8 if d <= _SLAB else _SLAB
    return -(-d // unit) * unit


def _check_kernel_inputs(op, q, k_pool, v_pool, scales=(), **indices):
    """What the CUDA kernels take; anything else raises (no fallback).
    ``indices`` are the int32 tensors the kernel reads (tables, pos);
    ``scales`` the (k_scale, v_scale) f32 rows of an int8 pool, or ().
    The head dim is the kernel's (`kernel_head_dim`)."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{op}: kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    pool_dtype = torch.int8 if scales else q.dtype
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != pool_dtype:
            what = "an int8 pool" if scales else "q's dtype"
            raise TypeError(f"{op}: {name} dtype {t.dtype} != "
                            f"{pool_dtype} ({what})")
    for name, t in zip(("k_scale", "v_scale"), scales):
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be float32, got {t.dtype}")
    for name, t in indices.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{op}: {name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    *zip(("k_scale", "v_scale"), scales), *indices.items()):
        if t.device != q.device:
            raise ValueError(f"{op}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned")
    d = q.shape[-1]
    if d < 8 or d % (8 if d <= _SLAB else _SLAB):
        raise ValueError(f"{op}: kernel head dim must be a multiple of 8 "
                         f"from 8 to {_SLAB}, or of {_SLAB} above, got {d}")
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


def _scale_ptrs(scales) -> tuple:
    """The kernels' scale arguments: both pointers, or two nulls for a
    float pool."""
    return tuple(t.data_ptr() for t in scales) if scales else (None, None)


def _launch_split_decode(op, q, k, v, pos, tables=None, scales=()):
    """One launch of a decode kernel: q [B, H, D] against a contiguous
    cache k, v [B, S, H, D] (``decode_kernel``, counted in
    `decode_attention`) or, with ``tables [B, max_blocks]``, pools
    [n_blocks, bs, H, D] (``paged_decode_kernel``, counted in
    `paged_decode_attention`, and in ``LAUNCHES["paged_decode_int8"]``
    for an int8 pool with its ``scales``). The grid is (B * H, n_split),
    n_split from `split_geometry` of the cache's span; each row's split
    length comes from pos on the device (`decode_split_length`)."""
    from ray_tpu_torch.ops import _build
    (q, k, v), d = _padded_heads(q, k, v)
    index = {"pos": pos} if tables is None else {"tables": tables,
                                                 "pos": pos}
    _check_kernel_inputs(op, q, k, v, scales, **index)
    b, h, dk = q.shape
    lead, name = (k, "k") if tables is None else (tables, "tables")
    if lead.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: q {tuple(q.shape)} / {name} "
                         f"{tuple(lead.shape)} / pos {tuple(pos.shape)} do "
                         f"not match batch {b}")
    bs = k.shape[1]
    span = bs if tables is None else bs * tables.shape[1]
    n_split = split_geometry(span)[1]
    nslab = dk // _SLAB if dk > _SLAB else 1
    out = torch.empty_like(q)
    ws = torch.empty(b * h * n_split * (2 * nslab + dk), dtype=torch.float32,
                     device=q.device)
    lib = _build.load()
    common = (out.data_ptr(), ws.data_ptr(),
              _tickets(q, b * h * nslab).data_ptr())
    tail = (n_split, _ONE_CTA, d ** -0.5, _KERNEL_DTYPES[q.dtype],
            _stream(q))
    if tables is None:
        err = lib.rtt_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             pos.data_ptr(), *common, b, span, h, dk, *tail)
        _build.check(err, op)
        decode_attention.launches += 1
    else:
        err = lib.rtt_paged_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *_scale_ptrs(scales),
            tables.data_ptr(), pos.data_ptr(), *common, b, h, dk, bs,
            tables.shape[1], *tail)
        _build.check(err, op)
        paged_decode_attention.launches += 1
        if scales:
            LAUNCHES["paged_decode_int8"] += 1
    return trim_last_dim(out, d)


def split_blocks(k_pool, v_pool, tables, *scales):
    """The same pools and block tables seen at the largest of the f32
    multi-query kernel's block sizes (32, 16, 8) that divides the pool's
    block size ``bs``: with f = bs / that size, pools ``[n, bs, H, D]``
    become ``[f n, bs / f, H, D]`` views (no copy; the pools must be
    contiguous), an int8 pool's ``scales`` (k_scale, v_scale) ``[n, bs,
    H]`` become ``[f n, bs / f, H]`` views, and ``tables [..., mb]``
    becomes ``[..., f mb]`` int32 with entry ``f j + i`` = ``f tables[j]
    + i``: logical position p still lives at the same element. Returns
    ``(k_pool, v_pool, tables, *scales)``. Raises for a block size that
    is not a multiple of 8."""
    bs = k_pool.shape[1]
    _check_block_size(bs)
    sub = next(s for s in _KERNEL_BLOCK_SIZES if bs % s == 0)
    f = bs // sub
    if f == 1:
        return (k_pool, v_pool, tables, *scales)
    nb = k_pool.shape[0]
    k_pool, v_pool, *scales = (t.view((nb * f, sub) + tuple(t.shape[2:]))
                               for t in (k_pool, v_pool, *scales))
    parts = torch.arange(f, dtype=torch.int32, device=tables.device)
    tables = (tables[..., None] * f + parts).flatten(-2).to(torch.int32)
    return (k_pool, v_pool, tables, *scales)


def _check_block_size(bs: int) -> None:
    if bs % 8:
        raise ValueError(f"paged multi-query attention: block size must be "
                         f"a multiple of 8, got {bs}")


def _launch_mq(op, q, k_pool, v_pool, tables, pos, scales=()):
    """q [B, W, H, D] through a multi-query kernel: ``paged_mq_tc`` for
    bf16 up to head dim 256 (the pool as it is), ``paged_mq_simt`` for f32
    and for bf16 above 256 (the pool re-viewed at block 8, 16 or 32 by
    `split_blocks`); their int8 instances, counted as ``paged_mq_tc_int8``
    and ``paged_mq_simt_int8``, for an int8 pool with its ``scales``."""
    from ray_tpu_torch.ops import _build
    (q, k_pool, v_pool), d = _padded_heads(q, k_pool, v_pool)
    _check_kernel_inputs(op, q, k_pool, v_pool, scales, tables=tables,
                         pos=pos)
    b, w, h, dk = q.shape
    if tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{op}: tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    lib = _build.load()
    if q.dtype == torch.bfloat16 and dk <= _MQ_TC_MAX_HEAD_DIM:
        bs, mb = k_pool.shape[1], tables.shape[1]
        _check_block_size(bs)
        ks, n_split = split_geometry(mb * bs)
        n_tiles = -(-w // _MQ_TILE)
        ws = torch.empty(b * h * n_tiles * n_split * min(w, _MQ_TILE)
                         * (2 + dk), dtype=torch.float32, device=q.device)
        name, err = "paged_mq_tc", lib.rtt_paged_mq_tc(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            *_scale_ptrs(scales), tables.data_ptr(), pos.data_ptr(),
            out.data_ptr(), ws.data_ptr(),
            _tickets(q, b * h * n_tiles).data_ptr(), b, w, h, dk, bs, mb, ks,
            n_split, d ** -0.5, _stream(q))
    else:
        k_pool, v_pool, tables, *scales = split_blocks(k_pool, v_pool,
                                                       tables, *scales)
        name, err = "paged_mq_simt", lib.rtt_paged_mq(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            *_scale_ptrs(scales), tables.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, w, h, dk, k_pool.shape[1], tables.shape[1],
            d ** -0.5, _KERNEL_DTYPES[q.dtype], _stream(q))
    _build.check(err, op)
    LAUNCHES[name + ("_int8" if scales else "")] += 1
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
    multiple of 8 runs zero-padded (a copy of the cache per call). A row
    with ``pos[b] < 0`` sees nothing: the kernel writes zeros there.

    The kernel replaces `ray_tpu/ops/decode_attention.py::_decode_kernel`:
    one launch per call, a row of more than `_ONE_CTA` positions split
    across CTAs and merged in split order inside the launch, a shorter
    one in one CTA; the grid is fixed by shapes and pos is read on the
    device, so the call can be captured in a CUDA graph.
    """
    del block_kv
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(
            f"decode_attention wants q [B, H, D] and k/v [B, S, H, D]; "
            f"got {tuple(q.shape)} and {tuple(k.shape)}")
    if _resolve_impl(impl, "decode_attention", q) == "plain":
        return reference_decode_attention(q, k, v, pos)
    return _launch_split_decode("decode_attention", q, k, v, pos)


decode_attention.launches = 0


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                           k_scale=None, v_scale=None, impl: str = "auto"):
    """Decode-step attention through a paged KV cache: ``q [B, H, D]``
    against pools ``[n_blocks, block_size, H, D]`` indexed by ``tables
    [B, max_blocks]`` int32, attending to logical positions ``<= pos[b]``
    (``pos [B]`` int32, each >= 0). Returns ``[B, H, D]`` in q.dtype.

    The kernel replaces `ray_tpu/ops/decode_attention.py::_paged_kernel`:
    the body of `decode_attention`'s kernel, reading K/V through the
    table: one launch per call, a long row's key range split across CTAs
    and merged in split order inside the launch; the grid is fixed by
    shapes and pos and tables are read on the device, so the call can be
    captured in a CUDA graph. A head dim that is not a multiple of 8 (or,
    above 512, of 512) runs zero-padded, q and both pools copied for that
    call (the reference's padding); others run as they are.
    ``k_scale``/``v_scale`` ``[n_blocks, block_size, H]`` f32 mark int8
    pools, dequantized in the kernel's registers (its int8 instance).
    """
    if q.ndim != 3 or k_pool.ndim != 4 or tables.ndim != 2:
        raise ValueError(
            "paged_decode_attention wants q [B, H, D], pools "
            f"[n_blocks, bs, H, D] and tables [B, max_blocks]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(tables.shape)}")
    quant = _check_scales(k_scale, v_scale, k_pool, "paged_decode_attention")
    if _resolve_impl(impl, "paged_decode_attention", q) == "plain":
        return reference_paged_decode_attention(
            q, k_pool, v_pool, tables, pos, k_scale=k_scale, v_scale=v_scale)
    return _launch_split_decode("paged_decode_attention", q, k_pool,
                                v_pool, pos, tables,
                                (k_scale, v_scale) if quant else ())


paged_decode_attention.launches = 0


def paged_verify_attention(q, k_pool, v_pool, tables, pos, *,
                           k_scale=None, v_scale=None, impl: str = "auto"):
    """Masked multi-query attention through the paged cache: ``q
    [B, W, H, D]``, token i of row b at logical position ``pos[b] + i``
    attending to positions ``<= pos[b] + i``. Returns ``[B, W, H, D]``.

    The kernel replaces `ray_tpu/ops/decode_attention.py::_paged_mq_kernel`
    (shared with `paged_prefill_attention`): bf16 up to head dim 256 runs
    ``paged_mq_tc`` (tensor cores, split-K, one launch, capturable), f32
    and bf16 above 256 ``paged_mq_simt``. A head dim that is not a multiple of 8 runs
    zero-padded, q and both pools copied for that call. ``k_scale``/
    ``v_scale`` ``[n_blocks, block_size, H]`` f32 mark int8 pools, read
    by the kernels' int8 instances."""
    if q.ndim != 4 or k_pool.ndim != 4 or tables.ndim != 2:
        raise ValueError(
            "paged_verify_attention wants q [B, W, H, D], pools "
            f"[n_blocks, bs, H, D] and tables [B, max_blocks]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(tables.shape)}")
    quant = _check_scales(k_scale, v_scale, k_pool, "paged_verify_attention")
    if _resolve_impl(impl, "paged_verify_attention", q) == "plain":
        return reference_paged_verify_attention(
            q, k_pool, v_pool, tables, pos, k_scale=k_scale, v_scale=v_scale)
    out = _launch_mq("paged_verify_attention", q, k_pool, v_pool, tables,
                     pos, (k_scale, v_scale) if quant else ())
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
    and pos = start: the prefill staircase is the verify mask. Int8
    pools as in `paged_verify_attention`."""
    if q.ndim != 3 or k_pool.ndim != 4 or table.ndim != 1:
        raise ValueError(
            "paged_prefill_attention wants q [C, H, D], pools "
            f"[n_blocks, bs, H, D] and table [max_blocks]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(table.shape)}")
    quant = _check_scales(k_scale, v_scale, k_pool,
                          "paged_prefill_attention")
    if _resolve_impl(impl, "paged_prefill_attention", q) == "plain":
        return reference_paged_prefill_attention(
            q, k_pool, v_pool, table, start, k_scale=k_scale, v_scale=v_scale)
    if isinstance(start, torch.Tensor):
        pos = start.reshape(1)
    else:
        pos = torch.full((1,), int(start), dtype=torch.int32,
                         device=q.device)
    out = _launch_mq("paged_prefill_attention", q[None], k_pool, v_pool,
                     table[None], pos, (k_scale, v_scale) if quant else ())
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
