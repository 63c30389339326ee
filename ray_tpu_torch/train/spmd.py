"""Train state and step: the counterpart of `ray_tpu/train/spmd.py`, in
eager PyTorch: `TrainState`, optimizers with optax's exact semantics
(`default_optimizer`'s `AdamW`, and `Adam`, ``optax.adam``),
`make_train_step` with gradient accumulation as a running f32 mean over
microbatches, the GPT loss (`softmax_xent`, `gpt_loss_fn` with its
padding mask, dense or fused), the one-call `make_gpt_trainer`
(``init_state=False`` for the resume path, whose state `train.ft`
restores), the GPipe `make_gpt_pipeline_trainer`, the MoE loss and
trainer (`moe_loss_fn`, `make_moe_trainer`, one card: the expert axis is
ROADMAP A6 (b)) and `train_flops_per_token` (copied as it is, so MFU
reads the same work in both packages).

On a mesh (``mesh=``, `ray_tpu_torch.parallel`: one process per rank,
each holding its block of every leaf) the reference's sharding lattice
becomes explicit collectives. A rank's loss is its tokens' sum over the
global token count (`models.gpt.token_mean`), so its gradients are its
tokens' share; the step sums each leaf's gradient over the axes that
split tokens and do not split that leaf (one all-reduce per set of
axes, over one flat buffer; an fsdp-split leaf's reduce-scatter did its
own axis), clips by the global norm (each leaf's sum of squares summed
over exactly the axes that split it), and updates each rank's blocks.
The reported loss is summed over the token axes. A mesh of one rank, or
none, is the single-card trainer.

The step updates parameters and optimizer state in place and never
synchronises with the host: its metrics come back as device tensors
(a host-staged collective, gloo with CUDA tensors, waits for the device
itself).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import active_mesh
from ray_tpu_torch.train import loop


@dataclass
class TrainState:
    params: Any           # the model (`models.gpt.GPT`, trainable masters)
    opt_state: Any        # `AdamW.init`'s dict
    step: torch.Tensor    # int32 scalar on the model's device


def _leaves(params) -> list[torch.Tensor]:
    return [p for p in params.parameters() if p.requires_grad]


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps, weight_decay))`` with ``schedule =
    warmup_cosine_decay_schedule(0, lr, warmup, total)``, written out to
    match optax step for step:

    - the schedule is read at the update count BEFORE it is incremented,
      so update 0 uses lr 0;
    - clipping is optax's ``g / norm * max_norm`` when ``norm >=
      max_norm`` (not `clip_grad_norm_`'s ``+1e-6``);
    - weight decay applies to every leaf, norms and embeddings included
      (optax's default ``mask=None``);
    - moments and bias corrections as `optax.scale_by_adam`.

    Every scalar stays on the device, so an update never waits on the
    host. Parameters and moments are updated in place."""

    def __init__(self, learning_rate: float = 3e-4,
                 weight_decay: float = 0.1, warmup_steps: int = 100,
                 total_steps: int = 10_000, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 grad_clip: float = 1.0):
        self.learning_rate = float(learning_rate)
        self.weight_decay = float(weight_decay)
        self.warmup_steps = int(warmup_steps)
        self.decay_steps = max(int(total_steps), self.warmup_steps + 1)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.grad_clip = float(grad_clip)

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay) at
        ``count`` (f32, on count's device)."""
        # Same operations in the same order as optax's linear_schedule
        # and cosine_decay_schedule, joined at the warmup boundary.
        c = count.float()
        peak, w = self.learning_rate, self.warmup_steps
        frac = 1 - torch.clamp(c, 0, w) / max(w, 1)
        warm = (0.0 - peak) * frac + peak
        span = self.decay_steps - w
        cd = 0.5 * (1 + torch.cos(math.pi * torch.clamp(c - w, 0, span)
                                  / span))
        return torch.where(c < w, warm, peak * cd)

    def init(self, params) -> dict:
        leaves = _leaves(params)
        dev = leaves[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, grads, state: dict, params, norm=None) -> torch.Tensor:
        """Apply one update to ``params`` in place; returns the global
        norm of ``grads`` before clipping (f32 device scalar; on a mesh
        the caller passes the norm over every rank's blocks)."""
        leaves = _leaves(params)
        norm = global_norm(grads) if norm is None else norm
        keep = norm < self.grad_clip
        grads = [torch.where(keep, g, g / norm * self.grad_clip)
                 for g in grads]
        count = state["count"]
        lr = self.schedule(count)
        n = (count + 1).float()
        bc1 = 1 - torch.pow(self.b1, n)
        bc2 = 1 - torch.pow(self.b2, n)
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            upd = upd + self.weight_decay * p
            p.add_(-lr * upd)
        count.add_(1)
        return norm


class Adam:
    """``optax.adam(learning_rate, b1, b2, eps)``: a constant learning
    rate, no clipping and no weight decay (the RL flywheel's default
    optimizer, `rl.FlywheelLoop`), with `AdamW`'s interface: moments and
    bias corrections as `optax.scale_by_adam`, parameters and moments
    updated in place, every scalar on the device."""

    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    init = AdamW.init

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> None:
        """Apply one update to ``params`` in place. Unlike `AdamW.update`
        it computes no gradient norm: nothing clips by it, as in
        ``optax.adam``."""
        n = (state["count"] + 1).float()
        bc1 = 1 - torch.pow(self.b1, n)
        bc2 = 1 - torch.pow(self.b2, n)
        for p, g, mu, nu in zip(_leaves(params), grads, state["mu"],
                                state["nu"]):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.add_(-self.learning_rate
                   * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)))
        state["count"].add_(1)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10_000,
                      b1: float = 0.9, b2: float = 0.95,
                      grad_clip: float = 1.0) -> AdamW:
    """AdamW + cosine schedule + global-norm clip, the standard LLM
    recipe, with `ray_tpu.train.spmd.default_optimizer`'s arguments."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps,
                 b1, b2, grad_clip=grad_clip)


def _named_leaves(model) -> list[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def sync_grads(grads, model) -> list:
    """Each gradient summed over the axes that split the batch's tokens
    and not the leaf (the model's mesh and rules), one all-reduce per
    set of axes over one flat buffer."""
    mesh = model.mesh
    tok = sharding.token_axes(mesh, model.rules)
    grads = list(grads)
    buckets: dict[tuple, list] = {}
    for i, name in enumerate(_named_leaves(model)):
        split = sharding.spec_axes(model.specs[name])
        axes = tuple(a for a in tok if a not in split)
        if axes:
            buckets.setdefault(axes, []).append(i)
    with torch.no_grad():
        for axes, idx in buckets.items():
            flat = col.psum(torch.cat([grads[i].reshape(-1) for i in idx]),
                            axes, mesh)
            for i, part in zip(idx, flat.split(
                    [grads[i].numel() for i in idx])):
                grads[i] = part.view_as(grads[i])
    return grads


def sharded_global_norm(grads, model) -> torch.Tensor:
    """The global norm of every rank's gradient blocks: each leaf's local
    sum of squares, summed over exactly the axes that split it (a leaf
    whole on an axis counts once), in f32."""
    mesh = model.mesh
    sums: dict[tuple, torch.Tensor] = {}
    for name, g in zip(_named_leaves(model), grads):
        axes = mesh.live_axes(sharding.spec_axes(model.specs[name]))
        sq = g.float().square().sum()
        sums[axes] = sq if axes not in sums else sums[axes] + sq
    with torch.no_grad():
        return torch.sqrt(sum(col.psum(v, axes, mesh)
                              for axes, v in sums.items()))


def make_train_step(loss_fn: Callable, optimizer: AdamW, accum: int = 1):
    """(state, batch) -> (state, metrics). ``loss_fn(model, batch)`` ->
    scalar loss. ``accum=k`` splits the batch's leading axis into k
    microbatches and keeps a running f32 mean of loss and gradients over
    them (the k-th increment is ``(x_k - mean) / k``), then applies ONE
    update; peak activation memory is one microbatch's. Metrics
    ``{"loss", "grad_norm", "step"}`` are device tensors; the state is
    updated in place and returned.

    On a mesh (the model's) ``batch`` is this rank's block and
    ``loss_fn`` returns
    its share of the global loss (`models.gpt.token_mean`); gradients
    are synchronised once, after the accumulation (`sync_grads`), the
    norm is `sharded_global_norm`, and the reported loss is summed over
    the axes that split tokens."""
    accum = int(accum)
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")

    def split(batch):
        def rs(a):
            if a.shape[0] % accum:
                raise ValueError(f"batch dim {a.shape[0]} not divisible "
                                 f"by accum={accum}")
            return a.reshape(accum, a.shape[0] // accum, *a.shape[1:])
        parts = {k: rs(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(accum)]

    def value_and_mean_grad(model, batch):
        leaves = _leaves(model)
        if accum == 1:
            loss = loss_fn(model, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        loss_mean = torch.zeros((), device=leaves[0].device)
        gmean = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for i, mb in enumerate(split(batch)):
            loss = loss_fn(model, mb)
            grads = torch.autograd.grad(loss, leaves)
            inv = 1.0 / (i + 1.0)
            loss_mean = loss_mean + (loss.detach().float() - loss_mean) * inv
            for m, g in zip(gmean, grads):
                m.add_((g.float() - m) * inv)
        return loss_mean, [m.to(p.dtype) for m, p in zip(gmean, leaves)]

    def step(state: TrainState, batch):
        model = state.params
        loss, grads = value_and_mean_grad(model, batch)
        if getattr(model, "mesh", None) is None:
            gnorm = optimizer.update(grads, state.opt_state, model)
        else:
            grads = sync_grads(grads, model)
            gnorm = optimizer.update(grads, state.opt_state, model,
                                     norm=sharded_global_norm(grads, model))
            with torch.no_grad():
                loss = col.psum(loss, sharding.token_axes(model.mesh,
                                                     model.rules),
                                model.mesh)
        state.step.add_(1)
        return state, {"loss": loss, "grad_norm": gnorm,
                       "step": state.step.clone()}

    return step


# ---------------------------------------------------------------------------
# GPT-specific assembly
# ---------------------------------------------------------------------------

def softmax_xent(logits, targets):
    """Dense cross entropy ``logsumexp - target logit`` per position, in
    f32 (bf16 logits are upcast before the logsumexp)."""
    logits = logits.float()
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - tgt


def gpt_loss_fn(model, batch: dict, cfg=None, mesh=None):
    """Cross entropy over pre-shifted ``inputs``/``targets`` [B, T], with
    an optional padding ``mask`` [B, T] (masked mean); dense logits or,
    under ``loss_impl="fused"``, the fused cross-entropy kernels. On a
    mesh (the model's) the batch is this rank's block of
    ``("batch", "length")`` (pre-shifted, so T stays divisible by
    ``seq``) and the loss its share of the global mean: its tokens' sum
    over the global (unmasked) count."""
    cfg = model.cfg if cfg is None else cfg
    mesh = gpt._mesh_of(model, mesh)
    if mesh is not None:
        nll = (gpt.fused_nll if gpt.check_loss_impl(cfg) == "fused"
               else gpt.dense_nll)(model, batch["inputs"], batch["targets"],
                                   cfg, mesh)
        return gpt.token_mean(nll, mesh, batch.get("mask"), model.rules)
    if gpt.check_loss_impl(cfg) == "fused":
        nll = gpt.fused_nll(model, batch["inputs"], batch["targets"], cfg)
    else:
        nll = softmax_xent(gpt.forward(model, batch["inputs"], cfg),
                           batch["targets"])
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def make_gpt_trainer(cfg, seed: int = 0, optimizer: AdamW | None = None,
                     accum: int = 1, device=None, init_state: bool = True,
                     mesh=None, rules: dict | None = None):
    """One-call assembly: f32 trainable params from ``seed`` on ``device``
    (the card unless told otherwise), optimizer state, the step, and the
    host-batch placer. Returns ``(state, step_fn, place)``.

    ``init_state=False`` builds no parameters or optimizer state and
    returns ``state=None``: the resume path (`train.ft.restore_resharded`
    and `ft.state_from_tree`) already holds the state.

    ``mesh`` (every rank of it calls this, with the same arguments):
    each rank keeps its block of every leaf (`models.gpt.
    param_logical_axes` under ``rules``), and ``place`` keeps its block
    of a host batch's ``("batch", "length")``. A mesh of one rank is the
    single-card trainer."""
    gpt.check_loss_impl(cfg)
    mesh = active_mesh(mesh)
    return _make_lm_trainer(
        lambda dev: gpt.GPT(cfg, gpt.init_params(seed, cfg, dev), device=dev,
                            dtype=torch.float32, trainable=True, mesh=mesh,
                            rules=rules),
        lambda m, b: gpt_loss_fn(m, b, cfg), optimizer, accum, device,
        init_state, mesh, rules)


def pipeline_logical_axes(cfg) -> dict:
    """`models.gpt.param_logical_axes` with the layer stack's axis on
    "stage" (rule: ``pipe``): a pipe rank holds its stage's layers."""
    axes = gpt.param_logical_axes(cfg)
    axes["layers"] = {k: ("stage",) + v[1:]
                      for k, v in axes["layers"].items()}
    return axes


def make_gpt_pipeline_trainer(cfg, mesh, num_microbatches: int = 2,
                              seed: int = 0,
                              optimizer: AdamW | None = None,
                              rules: dict | None = None, device=None):
    """GPipe-staged GPT trainer: the layer stack splits into
    ``mesh.shape["pipe"]`` contiguous stages, rank s of the axis holding
    stage s's layers (`pipeline_logical_axes`), and activations stream
    between neighbouring stages (`parallel.pipeline.pipeline_apply`),
    combinable with the data-like axes (each pipe rank streams its rows).
    As in the reference: the embedding lookup, the final norm, the dense
    unembed and the loss (no mask) run on every pipe rank, the blocks
    without remat. ``tensor``, ``seq`` and ``expert`` must be 1: the
    reference runs its stages' blocks without a mesh. Returns ``(state,
    step_fn, place)``."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    for axis in ("tensor", "seq", "expert"):
        if mesh.shape[axis] > 1:
            raise ValueError(f"make_gpt_pipeline_trainer: the stages run "
                             f"their blocks unsplit; {axis}="
                             f"{mesh.shape[axis]} must be 1")
    s_count = max(mesh.shape.get("pipe", 1), 1)
    if cfg.n_layers % s_count:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pipe={s_count}")
    mesh_on = active_mesh(mesh)
    cfg_blocks = dataclasses.replace(cfg, remat=False)

    def loss_fn(model, batch):
        adt = cfg.activation_dtype()
        tokens = batch["inputs"]
        t = tokens.shape[1]
        emb = gpt._embed_table(model, cfg, mesh_on)
        pos = model.pos_embed
        final_ln = model.final_ln_scale
        if mesh_on is not None:
            pos = gpt._whole(pos, model.specs["pos_embed"], mesh_on)
            final_ln = gpt._whole(final_ln, model.specs["final_ln_scale"],
                                  mesh_on)
        x = emb[tokens] + pos[:t].to(adt)[None]
        per_stage = [None] * s_count
        per_stage[mesh.axis_index("pipe") if mesh_on else 0] = \
            model.layer_params()

        def stage_fn(layers, h):
            for lp in layers:
                h = gpt._block(lp, h, cfg_blocks, None, mesh_on,
                               model.layer_specs if mesh_on else None)
            return h

        x = pipeline_apply(stage_fn, per_stage, x, mesh=mesh,
                           num_microbatches=num_microbatches)
        x = gpt._rms_norm(x, final_ln.to(adt))
        nll = softmax_xent(gpt._mm_f32(x, emb.t()), batch["targets"])
        return gpt.token_mean(nll, mesh_on, rules=rules)

    return _make_lm_trainer(
        lambda dev: gpt.GPT(cfg, gpt.init_params(seed, cfg, dev), device=dev,
                            dtype=torch.float32, trainable=True, mesh=mesh_on,
                            rules=rules,
                            logical_axes=pipeline_logical_axes(cfg)),
        loss_fn, optimizer, 1, device, True, mesh_on, rules)


def moe_loss_fn(model, batch: dict, cfg=None):
    """MoE counterpart of `gpt_loss_fn` (pre-shifted ``inputs``/``targets``,
    the same optional padding ``mask``) adding the router load-balance
    auxiliary loss (`ray_tpu.train.spmd.moe_loss_fn`): the dense f32
    log-softmax over the logits."""
    from ray_tpu_torch.models import moe
    cfg = model.cfg if cfg is None else cfg
    logits, aux = moe.forward(model, batch["inputs"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.float()
        ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        ce = -ll.mean()
    return ce + cfg.aux_loss_coeff * aux


def make_moe_trainer(cfg, seed: int = 0, optimizer: AdamW | None = None,
                     accum: int = 1, device=None, init_state: bool = True):
    """`make_gpt_trainer` for the MoE family on one card
    (`ray_tpu.train.spmd.make_moe_trainer` without the expert mesh axis:
    every expert lives on the card). Returns ``(state, step_fn,
    place)``."""
    from ray_tpu_torch.models import moe
    return _make_lm_trainer(
        lambda dev: moe.MoE(cfg, moe.init_params(seed, cfg, dev), device=dev,
                            dtype=torch.float32, trainable=True),
        lambda m, b: moe_loss_fn(m, b, cfg), optimizer, accum, device,
        init_state)


def create_sharded_state(build: Callable, optimizer,
                         device=None) -> TrainState:
    """Parameters and optimizer state in their shards: ``build(device)``
    returns the model, on a mesh holding this rank's block of every leaf
    (so no rank ever holds the whole state past construction; the leaf
    specs are ``model.specs``), and the optimizer's moments take the
    blocks' shapes."""
    device = gpt.resolve_device(device)
    model = build(device)
    return TrainState(model, optimizer.init(model),
                      torch.zeros((), dtype=torch.int32, device=device))


def _make_lm_trainer(build, loss_fn, optimizer, accum, device, init_state,
                     mesh=None, rules=None):
    """Shared assembly behind `make_gpt_trainer` / `make_moe_trainer` and
    the pipeline trainer. On a mesh the placer keeps the rank's
    ``("batch", "length")`` block of each of the ``accum`` microbatches
    (`loop.make_placer`)."""
    device = gpt.resolve_device(device)
    optimizer = optimizer or default_optimizer()
    state = (create_sharded_state(build, optimizer, device) if init_state
             else None)
    step_fn = make_train_step(loss_fn, optimizer, accum=accum)
    return state, step_fn, loop.make_placer(device, mesh=mesh, rules=rules,
                                            accum=accum)


def train_flops_per_token(cfg, seq_len: int) -> float:
    """Approximate model FLOPs per trained token (fwd+bwd ≈ 3x fwd), for
    MFU reporting."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    h = cfg.n_heads * cfg.head_dim
    matmuls = 2 * (3 * d * h + h * d + 3 * d * f)      # qkv+o+glu-mlp
    attn = 2 * 2 * seq_len * h                         # scores + p@v
    embed = 2 * d * cfg.vocab_size                     # logits matmul
    return 3.0 * (L * (matmuls + attn) + embed)        # fwd + 2x bwd
