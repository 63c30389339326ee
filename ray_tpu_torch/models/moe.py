"""Mixture-of-Experts transformer on one device: the counterpart of
`ray_tpu/models/moe.py`, with its configuration, parameter tree
(stacked ``[L, ...]`` layer leaves, JAX's ``[in, out]`` orientation, a
leading expert axis on the expert weights) and math.

Routing is the reference's dense one-hot dispatch and combine with a
fixed per-expert capacity ``max(1, int(capacity_factor * K * n / E))``:
top-K picks by argmax (first index on ties), each pick placed at its
expert's running fill, picks past the capacity dropped, the combine
weights renormalised over a token's surviving picks, and the Shazeer
load-balance auxiliary loss on the top-1 assignment. No gather-based
router: the contractions are the reference's, as matrix products.

Attention is `models.gpt._attention`, so ``attn_impl`` "auto"/"flash"
launches the port's flash kernels on the card; per-block remat is
`torch.utils.checkpoint`, as in `models.gpt`. On one card every expert
lives on the device: the reference's expert mesh axis waits for
multi-rank parallelism (ROADMAP A6 (b)).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ray_tpu_torch.models import gpt
from ray_tpu_torch.models._stacked import StackedModel


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 50304
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 2048              # per-expert FFN width
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01
    max_seq_len: int = 1024
    dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def small(**kw) -> MoEConfig:
    return MoEConfig(**{**dict(vocab_size=512, d_model=128, n_layers=2,
                               n_heads=4, d_ff=256, n_experts=4, top_k=2,
                               max_seq_len=128), **kw})


def _shapes(cfg: MoEConfig) -> tuple[dict, dict]:
    d, h = cfg.d_model, cfg.n_heads * cfg.head_dim
    f, E, L = cfg.d_ff, cfg.n_experts, cfg.n_layers
    top = {"embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_seq_len, d),
           "final_ln_scale": (d,)}
    layer = {"ln1_scale": (L, d), "ln2_scale": (L, d), "wq": (L, d, h),
             "wk": (L, d, h), "wv": (L, d, h), "wo": (L, h, d),
             "router": (L, d, E), "w_up": (L, E, d, f),
             "w_gate": (L, E, d, f), "w_down": (L, E, f, d)}
    return top, layer


def init_params(seed: int, cfg: MoEConfig, device=None) -> dict:
    """float32 master params with `ray_tpu.models.moe.init_params`'s tree,
    shapes and scales, drawn from a `torch.Generator` seeded with
    ``seed`` on ``device`` (the bits differ from ``jax.random``'s; carry
    JAX params across with `params_from_numpy` when they must match)."""
    device = gpt.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, h = cfg.d_model, cfg.n_heads * cfg.head_dim
    f, E, L = cfg.d_ff, cfg.n_experts, cfg.n_layers

    def norm(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) \
            * (1.0 / np.sqrt(fan_in))

    layers = {
        "ln1_scale": torch.ones((L, d), device=device),
        "ln2_scale": torch.ones((L, d), device=device),
        "wq": norm((L, d, h), d),
        "wk": norm((L, d, h), d),
        "wv": norm((L, d, h), d),
        "wo": norm((L, h, d), h) / np.sqrt(2 * L),
        "router": norm((L, d, E), d) * 0.1,
        "w_up": norm((L, E, d, f), d),
        "w_gate": norm((L, E, d, f), d),
        "w_down": norm((L, E, f, d), f) / np.sqrt(2 * L),
    }
    return {
        "embed": norm((cfg.vocab_size, d), 1.0) * 0.02,
        "pos_embed": norm((cfg.max_seq_len, d), 1.0) * 0.01,
        "final_ln_scale": torch.ones((d,), device=device),
        "layers": layers,
    }


class MoE(StackedModel):
    """The MoE model's weights in one dtype on one device (the card unless
    ``device`` says otherwise), as `models.gpt.GPT`: activation dtype
    for inference, ``dtype=torch.float32, trainable=True`` for the f32
    training masters."""

    def __init__(self, cfg: MoEConfig, params: dict, *, device=None,
                 dtype: torch.dtype | None = None, trainable: bool = False):
        super().__init__(cfg, params, *_shapes(cfg), device=device,
                         dtype=dtype, trainable=trainable)


def params_from_numpy(tree: dict, cfg: MoEConfig, device=None,
                      dtype: torch.dtype | None = None,
                      trainable: bool = False) -> MoE:
    """Carry a JAX param pytree across (``jax.tree.map(np.asarray,
    params)``, or the same tree of tensors): the leaves are copied, never
    transposed. For training pass ``dtype=torch.float32,
    trainable=True``."""
    return MoE(cfg, tree, device=device, dtype=dtype, trainable=trainable)


# ---------------------------------------------------------------------------
# routing + expert FFN
# ---------------------------------------------------------------------------

def _route(h, router_w, cfg: MoEConfig):
    """-> (dispatch [N, E, C] one-hot-ish mask, combine [N, E, C] weights,
    aux load-balance loss), all f32; N = B*T flattened tokens
    (`ray_tpu.models.moe._route`, step for step)."""
    n = h.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * K * n / E))
    dev = h.device

    logits = h.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                    # [N, E]
    slots = torch.arange(capacity, device=dev, dtype=torch.float32)

    dispatch = torch.zeros((n, E, capacity), device=dev)
    combine = torch.zeros((n, E, capacity), device=dev)
    # running per-expert fill count, updated after each of the K choices
    fill = torch.zeros((E,), device=dev)
    masked = probs
    top1_assign = None
    for _ in range(K):
        idx = torch.argmax(masked, dim=-1)                   # first max
        onehot = nn.functional.one_hot(idx, E).float()       # [N, E]
        if top1_assign is None:
            top1_assign = onehot
        gate = torch.sum(probs * onehot, dim=-1)             # [N]
        # position of each token within its chosen expert's buffer
        pos = torch.cumsum(onehot, dim=0) - onehot + fill[None]
        pos_tok = torch.sum(pos * onehot, dim=-1)            # [N]
        keep = (pos_tok < capacity).float()
        # one_hot(pos_tok, capacity): all zero past the capacity, as JAX's
        pos_oh = (pos_tok[:, None] == slots[None]).float()
        contrib = (onehot[:, :, None] * pos_oh[:, None, :]
                   * keep[:, None, None])
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[:, None, None]
        fill = fill + torch.sum(onehot * keep[:, None], dim=0)
        masked = masked * (1.0 - onehot)                     # next choice

    # Shazeer load-balance aux: E * mean_e(frac_tokens_e * frac_prob_e),
    # on the top-1 assignment
    frac_tokens = torch.mean(top1_assign, dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    # renormalize combine weights over the K picks (Mixtral-style)
    denom = torch.sum(combine, dim=(1, 2), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9)
    return dispatch, combine, aux


def _moe_ffn(x, lp: dict, cfg: MoEConfig):
    """x: [B, T, D] -> (out [B, T, D], aux loss). The dense dispatch and
    combine contractions as matrix products over the flattened ``[E *
    C]`` expert buffers, each accumulated in f32 and rounded once to the
    activation dtype (the reference's ``preferred_element_type``)."""
    adt = x.dtype
    b, t, d = x.shape
    E = cfg.n_experts
    h = x.reshape(b * t, d)
    dispatch, combine, aux = _route(h, lp["router"], cfg)
    c = dispatch.shape[-1]
    # tokens -> expert buffers [E, C, D]
    xs = (dispatch.to(adt).reshape(b * t, E * c).t() @ h).view(E, c, d)
    up = torch.bmm(xs, lp["w_up"].to(adt))
    gate = torch.bmm(xs, lp["w_gate"].to(adt))
    act = nn.functional.silu(gate) * up
    down = torch.bmm(act, lp["w_down"].to(adt))
    out = combine.to(adt).reshape(b * t, E * c) @ down.reshape(E * c, d)
    return out.view(b, t, d), aux


def _block(lp: dict, x, cfg: MoEConfig, gpt_cfg: gpt.GPTConfig):
    adt = x.dtype
    b, t, d = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim

    h = gpt._rms_norm(x, lp["ln1_scale"].to(adt))
    q = (h @ lp["wq"].to(adt)).view(b, t, nh, hd)
    k = (h @ lp["wk"].to(adt)).view(b, t, nh, hd)
    v = (h @ lp["wv"].to(adt)).view(b, t, nh, hd)
    att = gpt._attention(q, k, v, gpt_cfg).reshape(b, t, nh * hd)
    x = x + att @ lp["wo"].to(adt)

    h = gpt._rms_norm(x, lp["ln2_scale"].to(adt))
    ff, aux = _moe_ffn(h, lp, cfg)
    return x + ff, aux


def forward(model: MoE, tokens, cfg: MoEConfig | None = None):
    """tokens [B, T] -> (logits [B, T, vocab] f32, aux loss scalar: the
    layers' mean)."""
    cfg = model.cfg if cfg is None else cfg
    adt = cfg.activation_dtype()
    t = tokens.shape[1]
    emb = model.embed.to(adt)
    x = emb[tokens] + model.pos_embed[:t].to(adt)[None]
    gpt_cfg = gpt.GPTConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                            dtype=cfg.dtype, attn_impl=cfg.attn_impl)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), device=x.device)
    for lp in model.layer_params():
        if remat:
            x, aux = ckpt.checkpoint(_block, lp, x, cfg, gpt_cfg,
                                     use_reentrant=False)
        else:
            x, aux = _block(lp, x, cfg, gpt_cfg)
        aux_sum = aux_sum + aux
    x = gpt._rms_norm(x, model.final_ln_scale.to(adt))
    return gpt._mm_f32(x, emb.t()), aux_sum / cfg.n_layers


def loss_fn(model: MoE, batch: dict, cfg: MoEConfig | None = None):
    """Next-token cross entropy plus the weighted aux loss. batch:
    {"tokens": [B, T]}."""
    cfg = model.cfg if cfg is None else cfg
    tokens = batch["tokens"]
    logits, aux = forward(model, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return -ll.mean() + cfg.aux_loss_coeff * aux


def num_params(model: MoE) -> int:
    return sum(p.numel() for p in model.parameters())
