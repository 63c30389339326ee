"""Mixture-of-Experts transformer: the counterpart of
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
`torch.utils.checkpoint`, as in `models.gpt`.

On a mesh (``mesh=``, one process per rank; `param_logical_axes` under
the rule table) each rank holds its block of every leaf: its experts'
FFN weights over ``expert`` (and their ``mlp`` columns over
``tensor``), the router's expert columns over ``expert``, attention's
heads and the vocabulary over ``tensor`` (Megatron, as `models.gpt`),
``embed`` over ``fsdp`` (gathered at use); a rank's tokens are its
block of the batch's ``("batch", "length")``: rows over the data axes,
positions over ``seq`` (its positions offset by its block, attention
through the ring, `parallel.ring_attention`, as `models.gpt`). The
reference's route sees the global batch: a rank's picks take their place
in each expert's buffer after every pick that comes before them in the
global ``[B, T]`` order (`_Split.before`: the counts of the earlier row
blocks and, row by row, of the earlier ``seq`` ranks' positions), under
the global capacity, and the auxiliary loss's fractions are global
means. Each rank routes with the whole ``[N, E]`` router logits
(gathered over ``expert``), runs its experts on its slices of the
dispatch and combine, and the combine's partial sums leave through
`parallel.collectives.reduce_from` over ``expert`` (and ``tensor``).
No leaf sits on ``pipe``: its ranks repeat the step, as in the
reference, whose model has no ``stage`` axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ray_tpu_torch.models import gpt
from ray_tpu_torch.models._stacked import StackedModel
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import sharding


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


def param_logical_axes(cfg: MoEConfig) -> dict:
    """Pytree of logical-axis tuples, mirroring `init_params`' structure
    (`ray_tpu.models.moe.param_logical_axes`): the expert weights carry
    a leading ``expert`` axis, the router its expert columns."""
    layer = {
        "ln1_scale": (None, "embed"),
        "ln2_scale": (None, "embed"),
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "heads"),
        "wv": (None, "embed", "heads"),
        "wo": (None, "heads", "embed"),
        "router": (None, "embed", "expert"),
        "w_up": (None, "expert", "embed", "mlp"),
        "w_gate": (None, "expert", "embed", "mlp"),
        "w_down": (None, "expert", "mlp", "embed"),
    }
    return {
        "embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        "final_ln_scale": ("embed",),
        "layers": layer,
    }


# The mesh axes the model computes on split, by the logical axes they may
# split (the others a leaf may sit on are gathered before use).
_MODEL_AXES = {"tensor": ("heads", "mlp", "vocab"), "expert": ("expert",)}


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
    training masters. With ``mesh`` each rank keeps its block of every
    leaf (`param_logical_axes` under ``rules``)."""

    def __init__(self, cfg: MoEConfig, params: dict, *, device=None,
                 dtype: torch.dtype | None = None, trainable: bool = False,
                 mesh=None, rules: dict | None = None):
        super().__init__(cfg, params, *_shapes(cfg), device=device,
                         dtype=dtype, trainable=trainable, mesh=mesh,
                         rules=rules, logical_axes=param_logical_axes(cfg),
                         model_axes=_MODEL_AXES)


def params_from_numpy(tree: dict, cfg: MoEConfig, device=None,
                      dtype: torch.dtype | None = None,
                      trainable: bool = False, mesh=None,
                      rules: dict | None = None) -> MoE:
    """Carry a JAX param pytree across (``jax.tree.map(np.asarray,
    params)``, or the same tree of tensors): the leaves are copied, never
    transposed. For training pass ``dtype=torch.float32,
    trainable=True``; with ``mesh`` each rank keeps its blocks."""
    return MoE(cfg, tree, device=device, dtype=dtype, trainable=trainable,
               mesh=mesh, rules=rules)


# ---------------------------------------------------------------------------
# routing + expert FFN
# ---------------------------------------------------------------------------

class _Split:
    """How a rank's route sits in the global one: the mesh, the live axes
    that split the batch's rows and its positions (the ``("batch",
    "length")`` rules', in their order) and the rank's place along them,
    the expert axes its experts are split over, the rank's rows ``b``
    and the global token count."""

    def __init__(self, mesh, b: int, t: int, rules=None):
        spec = sharding.logical_to_spec(("batch", "length"), rules, mesh)
        live = [tuple(a for a in sharding.spec_axes((e,))
                      if mesh.shape[a] > 1) for e in spec]
        self.mesh = mesh
        self.rows, self.seq = live
        self.batch = self.rows + self.seq
        self.expert = mesh.live_axes("expert")
        self.b = b
        self.n = b * t * mesh.axis_size(self.batch)

    def before(self, onehot):
        """``[N, E]``: for each of this rank's tokens, the picks of its
        expert that come before it in the global batch's flattened
        ``[B, T]`` order (the reference's exclusive ``cumsum`` over its
        ``B * T`` tokens), no grad. A rank holds a block of rows and a
        block of positions in each, so its tokens interleave with the
        other ``seq`` ranks' row by row: a token's count is its row's
        earlier positions here, the same row's blocks on the earlier
        ``seq`` ranks, the earlier rows of this rank's row block (every
        ``seq`` rank's part of them) and every row of the earlier row
        blocks."""
        mesh = self.mesh
        n, e = onehot.shape
        oh = onehot.view(self.b, n // self.b, e)
        within = torch.cumsum(oh, dim=1) - oh
        rows = oh.sum(dim=1)                                 # [b, E]
        off = torch.zeros_like(rows)
        if self.seq:
            every = col.all_gather(rows[None], self.seq, mesh, dim=0)
            off = off + every[:mesh.axis_index(self.seq)].sum(dim=0)
            rows = every.sum(dim=0)
        off = off + torch.cumsum(rows, dim=0) - rows
        if self.rows:
            every = col.all_gather(rows.sum(dim=0)[None], self.rows, mesh,
                                   dim=0)
            off = off + every[:mesh.axis_index(self.rows)].sum(dim=0)
        return (within + off[:, None]).view(n, e)

    def total(self, x, grad: bool = False):
        """``x`` summed over the ranks that split the tokens
        (differentiable with ``grad``: its backward sums the cotangents
        back)."""
        if grad:
            return col.psum(x, self.batch, self.mesh)
        with torch.no_grad():
            return col.psum(x, self.batch, self.mesh)

    def mine(self, n_experts: int) -> slice:
        """This rank's experts."""
        per = n_experts // self.mesh.axis_size(self.expert)
        lo = self.mesh.axis_index(self.expert) * per if self.expert else 0
        return slice(lo, lo + per)


def _route(h, router_w, cfg: MoEConfig, split: _Split | None = None):
    """-> (dispatch [N, E, C] one-hot-ish mask, combine [N, E, C] weights,
    aux load-balance loss), all f32; N = B*T flattened tokens
    (`ray_tpu.models.moe._route`, step for step). With ``split`` (a
    mesh) ``h`` is this rank's tokens and ``router_w`` its experts'
    columns: the capacity, the buffer positions and the aux fractions
    are the global batch's, and the aux is this rank's experts' terms."""
    n = h.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    n_all = n if split is None else split.n
    capacity = max(1, int(cfg.capacity_factor * K * n_all / E))
    dev = h.device

    logits = h.float() @ router_w.float()
    if split is not None and split.expert:
        logits = col.all_gather(logits, split.expert, split.mesh, dim=-1)
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
        if split is None:
            pos = torch.cumsum(onehot, dim=0) - onehot + fill[None]
        else:
            pos = split.before(onehot) + fill[None]
        pos_tok = torch.sum(pos * onehot, dim=-1)            # [N]
        keep = (pos_tok < capacity).float()
        # one_hot(pos_tok, capacity): all zero past the capacity, as JAX's
        pos_oh = (pos_tok[:, None] == slots[None]).float()
        contrib = (onehot[:, :, None] * pos_oh[:, None, :]
                   * keep[:, None, None])
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[:, None, None]
        kept = torch.sum(onehot * keep[:, None], dim=0)
        fill = fill + (kept if split is None else split.total(kept))
        masked = masked * (1.0 - onehot)                     # next choice

    # Shazeer load-balance aux: E * mean_e(frac_tokens_e * frac_prob_e),
    # on the top-1 assignment
    if split is None:
        frac_tokens = torch.mean(top1_assign, dim=0)
        frac_probs = torch.mean(probs, dim=0)
        aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    else:
        # global means; this rank's experts' terms, summed over the
        # expert ranks by the caller (each rank's cotangent reaches the
        # gathered logits through its own terms only)
        frac_tokens = split.total(top1_assign.sum(dim=0)) / n_all
        frac_probs = split.total(probs.sum(dim=0), grad=True) / n_all
        mine = split.mine(E)
        aux = cfg.n_experts * torch.sum(frac_tokens[mine] * frac_probs[mine])
    # renormalize combine weights over the K picks (Mixtral-style)
    denom = torch.sum(combine, dim=(1, 2), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9)
    return dispatch, combine, aux


def _moe_ffn(x, lp: dict, cfg: MoEConfig, split: _Split | None = None):
    """x: [B, T, D] -> (out [B, T, D], aux loss). The dense dispatch and
    combine contractions as matrix products over the flattened ``[E *
    C]`` expert buffers, each accumulated in f32 and rounded once to the
    activation dtype (the reference's ``preferred_element_type``). With
    ``split`` (a mesh) the rank runs its experts on its slices of the
    dispatch and combine: its experts' outputs (their ``mlp`` columns
    summed over ``tensor`` first) combined, then summed over the expert
    ranks, as are the aux terms. Every value whose cotangent a rank sees
    only in part enters through `parallel.collectives.copy_to` over the
    axes that split it: the router's input over ``expert``, the experts'
    over ``expert`` and ``tensor``."""
    adt = x.dtype
    b, t, d = x.shape
    E = cfg.n_experts
    h = x.reshape(b * t, d)
    h_route = h
    if split is not None:
        mesh = split.mesh
        h_route = col.copy_to(h, split.expert, mesh)
        h = col.copy_to(h, mesh.live_axes(("expert", "tensor")), mesh)
    dispatch, combine, aux = _route(h_route, lp["router"], cfg, split)
    if split is not None:
        mine = split.mine(E)
        dispatch, combine = dispatch[:, mine], combine[:, mine]
        E = dispatch.shape[1]
    c = dispatch.shape[-1]
    # tokens -> expert buffers [E, C, D]
    xs = (dispatch.to(adt).reshape(b * t, E * c).t() @ h).view(E, c, d)
    up = torch.bmm(xs, lp["w_up"].to(adt))
    gate = torch.bmm(xs, lp["w_gate"].to(adt))
    act = nn.functional.silu(gate) * up
    down = torch.bmm(act, lp["w_down"].to(adt))
    comb = combine.to(adt).reshape(b * t, E * c)
    if split is not None:
        down = col.reduce_from(down, "tensor", mesh)
        aux = col.reduce_from(aux, split.expert, mesh)
    if split is None or not split.expert:
        out = comb @ down.reshape(E * c, d)
    else:
        # each rank's experts' share accumulated in f32 and summed over
        # the expert ranks in f32, then rounded once, as the one product
        # over every expert is on one card
        out = col.reduce_from(gpt._mm_f32(comb, down.reshape(E * c, d)),
                              split.expert, mesh).to(adt)
    return out.view(b, t, d), aux


def _block(lp: dict, x, cfg: MoEConfig, gpt_cfg: gpt.GPTConfig,
           model: MoE | None = None):
    """One block; with ``model`` (on a mesh) ``lp`` holds this rank's
    blocks, gathered here (inside the remat region) over the axes that
    only store them split, and attention runs on the rank's heads."""
    adt = x.dtype
    b, t, d = x.shape
    hd = cfg.head_dim
    split = None
    enter = leave = (lambda y: y)
    if model is not None:
        mesh = model.mesh
        lp = {k: model.whole(k, w) for k, w in lp.items()}
        split = _Split(mesh, b, t, model.rules)
        enter, leave = gpt.tensor_conjugates(mesh)

    h = enter(gpt._rms_norm(x, lp["ln1_scale"].to(adt)))
    q = (h @ lp["wq"].to(adt)).view(b, t, -1, hd)
    k = (h @ lp["wk"].to(adt)).view(b, t, -1, hd)
    v = (h @ lp["wv"].to(adt)).view(b, t, -1, hd)
    att = gpt._attention(q, k, v, gpt_cfg,
                         None if model is None else model.mesh
                         ).reshape(b, t, -1)
    x = x + leave(att @ lp["wo"].to(adt))

    h = gpt._rms_norm(x, lp["ln2_scale"].to(adt))
    ff, aux = _moe_ffn(h, lp, cfg, split)
    return x + ff, aux


def forward(model: MoE, tokens, cfg: MoEConfig | None = None):
    """tokens [B, T] -> (logits [B, T, vocab] f32, aux loss scalar: the
    layers' mean). On a mesh (the model's): this rank's rows, the logits
    its block of the vocabulary, and the aux its experts' share (summed
    over the expert ranks)."""
    cfg = model.cfg if cfg is None else cfg
    adt = cfg.activation_dtype()
    t = tokens.shape[1]
    mesh = model.mesh
    emb = gpt._embed_table(model, cfg, mesh)
    # a seq rank's tokens start at its block's first position
    off = 0 if mesh is None else mesh.axis_index("seq") * t
    x = gpt._lookup(model, emb, tokens) + model.whole(
        "pos_embed")[off:off + t].to(adt)[None]
    gpt_cfg = gpt.GPTConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                            dtype=cfg.dtype, attn_impl=cfg.attn_impl)
    args = () if mesh is None else (model,)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), device=x.device)
    for lp in model.layer_params():
        if remat:
            x, aux = ckpt.checkpoint(_block, lp, x, cfg, gpt_cfg, *args,
                                     use_reentrant=False)
        else:
            x, aux = _block(lp, x, cfg, gpt_cfg, *args)
        aux_sum = aux_sum + aux
    x = gpt._rms_norm(x, model.whole("final_ln_scale").to(adt))
    if mesh is not None and gpt.vocab_axes(model):
        x = col.copy_to(x, gpt.vocab_axes(model), mesh)
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
