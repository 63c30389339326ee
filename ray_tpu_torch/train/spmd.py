"""Train state and step on one device: the counterpart of
`ray_tpu/train/spmd.py` without the mesh.

The JAX module builds sharded state and a jitted step from logical axes;
on one card there is nothing to shard, so this module keeps the same
pieces in eager PyTorch: `TrainState`, optimizers with optax's exact
semantics (`default_optimizer`'s `AdamW`, and `Adam`, ``optax.adam``),
`make_train_step` with gradient accumulation as a running f32 mean over
microbatches, the GPT loss
(`softmax_xent`, `gpt_loss_fn` with its padding mask, dense or fused),
the one-call `make_gpt_trainer` and `train_flops_per_token` (copied as
it is, so MFU reads the same work in both packages). Meshes, sharding
rules and the pipeline and MoE trainers wait for multi-rank parallelism
(ROADMAP A6, A7).

The step updates parameters and optimizer state in place and never
synchronises with the host: its metrics come back as device tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ray_tpu_torch.models import gpt
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
    def update(self, grads, state: dict, params) -> torch.Tensor:
        """Apply one update to ``params`` in place; returns the global
        norm of ``grads`` before clipping (f32 device scalar)."""
        leaves = _leaves(params)
        norm = global_norm(grads)
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


def make_train_step(loss_fn: Callable, optimizer: AdamW, accum: int = 1):
    """(state, batch) -> (state, metrics). ``loss_fn(model, batch)`` ->
    scalar loss. ``accum=k`` splits the batch's leading axis into k
    microbatches and keeps a running f32 mean of loss and gradients over
    them (the k-th increment is ``(x_k - mean) / k``), then applies ONE
    update; peak activation memory is one microbatch's. Metrics
    ``{"loss", "grad_norm", "step"}`` are device tensors; the state is
    updated in place and returned."""
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
        loss, grads = value_and_mean_grad(state.params, batch)
        gnorm = optimizer.update(grads, state.opt_state, state.params)
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


def gpt_loss_fn(model, batch: dict, cfg=None):
    """Cross entropy over pre-shifted ``inputs``/``targets`` [B, T], with
    an optional padding ``mask`` [B, T] (masked mean); dense logits or,
    under ``loss_impl="fused"``, the fused cross-entropy kernels."""
    cfg = model.cfg if cfg is None else cfg
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
                     accum: int = 1, device=None):
    """One-call assembly: f32 trainable params from ``seed`` on ``device``
    (the card unless told otherwise), optimizer state, the step, and the
    host-batch placer. Returns ``(state, step_fn, place)``."""
    device = gpt.resolve_device(device)
    gpt.check_loss_impl(cfg)
    model = gpt.GPT(cfg, gpt.init_params(seed, cfg, device), device=device,
                    dtype=torch.float32, trainable=True)
    optimizer = optimizer or default_optimizer()
    state = TrainState(model, optimizer.init(model),
                       torch.zeros((), dtype=torch.int32, device=device))
    step_fn = make_train_step(lambda m, b: gpt_loss_fn(m, b, cfg),
                              optimizer, accum=accum)
    return state, step_fn, loop.make_placer(device)


def train_flops_per_token(cfg, seq_len: int) -> float:
    """Approximate model FLOPs per trained token (fwd+bwd ≈ 3x fwd), for
    MFU reporting."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    h = cfg.n_heads * cfg.head_dim
    matmuls = 2 * (3 * d * h + h * d + 3 * d * f)      # qkv+o+glu-mlp
    attn = 2 * 2 * seq_len * h                         # scores + p@v
    embed = 2 * d * cfg.vocab_size                     # logits matmul
    return 3.0 * (L * (matmuls + attn) + embed)        # fwd + 2x bwd
