"""Ring attention: sequence/context parallelism over the mesh's ``seq``
axis, the counterpart of `ray_tpu/parallel/ring_attention.py`.

Long sequences shard over ``seq``: each rank holds ``T / n`` tokens of
q, k and v. The K/V blocks rotate around the ring through the
differentiable `collectives.ppermute` while each rank accumulates
flash-attention-style running softmax statistics, so the scores a rank
holds at once are ``[B, H, T / n, T / n]``:

    for step in 0..n-1:
        score  = q_local @ k_ring.T          # [B,H,Tq,Tk]
        m_new  = max(m, rowmax(score))
        o      = o * exp(m - m_new) + exp(score - m_new) @ v_ring
        l      = l * exp(m - m_new) + rowsum(exp(score - m_new))
        (k_ring, v_ring) <- ppermute(+1 on the ring)

Causal masking uses global positions reconstructed from the ring step, so
the result equals full attention on the gathered sequence. Plain
PyTorch, as the reference's ring is einsums and not a kernel; the last
step's rotation, whose result the reference drops, is not made.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def _block_attn(q, k, v, m, l, o, q_off, k_off, causal):
    """One blockwise-softmax accumulation step. q:[B,Tq,H,D] k/v:[B,Tk,H,D]
    m,l:[B,H,Tq] o:[B,Tq,H,D]; offsets are global token positions."""
    qf, kf = q.float(), k.float()
    scale = qf.shape[-1] ** -0.5
    score = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = q_off + torch.arange(tq, device=q.device)[:, None]
        kpos = k_off + torch.arange(tk, device=q.device)[None, :]
        score = torch.where(qpos >= kpos, score, NEG_INF)
    m_new = torch.maximum(m, score.amax(dim=-1))          # [B,H,Tq]
    corr = torch.exp(m - m_new)
    p = torch.exp(score - m_new[..., None])               # [B,H,Tq,Tk]
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _init_stats(q):
    b, t, h, d = q.shape
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    return (m, torch.zeros_like(m),
            torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device))


def _ring_attn_sharded(q, k, v, mesh: Mesh, axis_name: str, causal: bool):
    """q,k,v are this rank's sequence blocks [B, T_local, H, D]."""
    n = mesh.shape[axis_name]
    idx = mesh.axis_index(axis_name)
    t_local = q.shape[1]
    m, l, o = _init_stats(q)
    q_off = idx * t_local
    perm = [(i, (i + 1) % n) for i in range(n)]
    for s in range(n):
        # the K/V block held at step s came from rank (idx - s) mod n
        k_off = ((idx - s) % n) * t_local
        m, l, o = _block_attn(q, k, v, m, l, o, q_off, k_off, causal)
        if s < n - 1:
            k = collectives.ppermute(k, axis_name, mesh, perm)
            v = collectives.ppermute(v, axis_name, mesh, perm)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh: Mesh, *, causal: bool = False,
                   axis_name: str = "seq"):
    """Sequence-parallel attention over ``axis_name`` of ``mesh``.

    q, k, v are this rank's blocks ``[B, T / n, H, D]`` of the sequence
    (rank i holds tokens ``[i T / n, (i + 1) T / n)``); returns its
    block of the output. Every rank of the axis calls it. With an axis of
    size 1: plain (blockwise-stable) attention on the whole sequence.
    """
    if mesh.shape.get(axis_name, 1) == 1:
        m, l, o = _block_attn(q, k, v, *_init_stats(q), 0, 0, causal)
        return (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return _ring_attn_sharded(q, k, v, mesh, axis_name, causal)


def reference_attention(q, k, v, *, causal: bool = False):
    """O(T^2)-memory reference for tests."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = qf.shape[-1] ** -0.5
    score = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        score = torch.where(mask, score, NEG_INF)
    p = torch.softmax(score, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
