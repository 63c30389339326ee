"""FlywheelLoop: colocated trainer <-> generator RL driver, the port of
`ray_tpu/rl/flywheel.py` (the port imports nothing of `ray_tpu`).

One machine-resident cycle per iteration (Anakin-style colocation,
2104.06272: both halves share the card, no weight shipping over a
network):

    TrainLoop step (PPO-on-sequences)  --publisher-->  engine.update_params
           ^                                               | (copied in place
           | trajectories                                  |  into the tensors
           | (tokens + behavior logprobs                   v  the graphs read)
           |  + params_version tags)                 InferenceEngine
           +------------------------  EngineSampler <------+

Generation for iteration N+1 runs AFTER iteration N's weights publish
(the batch iterator is lazy and `TrainLoop.publisher` fires between
dispatches), so rollouts are on-policy up to the engine's in-flight
sequences, whose tokens carry older `params_version` tags. The
objective is a clipped surrogate (PPO) on whole sampled sequences: the
ratio is exp(logp_new - behavior_logp) with behavior logprobs taken from
the engine's emitted `TokenEvent`s, the advantage is the sequence reward
minus an EMA baseline, and ``clip=None`` recovers plain
REINFORCE-with-baseline. `models.gpt.completion_logprobs` recomputes,
differentiably, exactly the quantity the engine emitted.

The learner and the engine never share a tensor: the optimizer updates
the learner's f32 masters in place, so an engine reading them would
serve new weights without ``params_version`` moving, and its captured
graphs would read them mid-rollout. The engine gets its own model, and
only `InferenceEngine.update_params` writes it. The publish is queued on
the stream the learner's backward and optimizer update were queued on,
and the engine's graphs replay on it too, so stream order alone puts the
copy after the update and before the next rollout: no host sync.

On a mesh (``mesh=``, one process per rank, every rank building the
loop with the same arguments): the engine serves on the mesh
(`serve.engine.InferenceEngine`, each rank its heads), the learner holds
each rank's block of the f32 masters, and every rank draws the same
prompts and gets the same rollouts. The learner keeps its rank's rows
of the batch (the ``("batch", "length")`` rules); its loss is its rows'
share of the global masked mean, so the gradients are summed over the
data axes (`train.spmd.sync_grads`) and over ``tensor`` not at all.
The publish copies each rank's blocks into its engine's, with no
gather. Over a ``seq`` split the learner keeps its block of each row's
positions (the completion windows stay whole): every ``seq`` rank
computes the same loss from the gathered windows
(`models.gpt.completion_logprobs`), its gradients are its positions'
share, and `train.spmd.sync_grads` sums them over ``seq`` too.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import active_mesh
from ray_tpu_torch.rl.sampler import (MASK, PARAMS_VERSION, START, TOKENS,
                                      EngineSampler)
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.serve.engine import InferenceEngine
from ray_tpu_torch.train import loop as _loop
from ray_tpu_torch.train import spmd
from ray_tpu_torch.util import telemetry as _telemetry


def motif_reward(motif: int):
    """Reward = fraction of completion tokens equal to `motif`: the
    smallest objective that proves the loop closes (the e2e test drives
    it up from the random-init ~1/vocab base rate)."""
    motif = int(motif)

    def reward(prompt, completion):
        comp = np.asarray(completion)
        return float((comp == motif).mean()) if comp.size else 0.0
    return reward


def surrogate_loss(model, batch, cfg, width: int, clip: float | None):
    """The learner's objective on a batch of ``tokens``, ``start``,
    ``behavior_logp``, ``mask`` and ``advantage``: the masked mean of the
    clipped surrogate (REINFORCE-with-baseline when ``clip`` is None)
    over `models.gpt.completion_logprobs` of the ``width``-token
    completion window, negated. Returns ``(loss, (logprobs, ratio, mask,
    denom))``. On the model's mesh the batch is this rank's rows and the
    loss their share of the global mean: ``denom`` is the mask's sum over
    the axes that split the rows."""
    lp = gpt.completion_logprobs(model, batch["tokens"], batch["start"],
                                 width, cfg)
    ratio = torch.exp(lp - batch["behavior_logp"])
    adv = batch["advantage"][:, None]
    if clip is None:
        surr = lp * adv        # REINFORCE-with-baseline
    else:
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
    m = batch["mask"]
    total = m.sum()
    if model.mesh is not None:
        with torch.no_grad():
            total = col.psum(total, sharding.row_axes(
                model.mesh, model.rules), model.mesh)
    denom = torch.clamp(total, min=1.0)
    return -(surr * m).sum() / denom, (lp, ratio, m, denom)


def make_learner_step(cfg, optimizer, width: int, clip: float | None):
    """The learner's step, a plain function on tensors: ``(state, batch)
    -> (state, metrics)``: `surrogate_loss`, its gradients, then
    ``optimizer``'s in-place update. Metrics ``loss``, ``mean_logprob``
    and ``mean_ratio`` are device tensors (masked means, before the
    update). On the model's mesh the gradients are summed over the axes
    that split the rows (`train.spmd.apply_update`) and the metrics over
    them."""

    def step_fn(state, batch):
        model = state.params
        loss, (lp, ratio, m, denom) = surrogate_loss(model, batch, cfg,
                                                     width, clip)
        leaves = [p for p in model.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, leaves)
        spmd.apply_update(optimizer, grads, state.opt_state, model)
        state.step.add_(1)
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       "mean_logprob": (lp * m).sum() / denom,
                       "mean_ratio": (ratio * m).sum() / denom}
            if model.mesh is not None:
                axes = sharding.row_axes(model.mesh, model.rules)
                metrics = {k: col.psum(v, axes, model.mesh)
                           for k, v in metrics.items()}
        return state, metrics

    return step_fn


def _copy_tree(tree: dict) -> dict:
    """``tree`` with every tensor leaf cloned (numpy leaves are copied
    when a model is built from them)."""
    return {k: (_copy_tree(v) if isinstance(v, dict) else
                v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


class FlywheelLoop:
    """Drives train -> publish -> generate -> learn on one model.

    cfg/params: a `models.gpt` config and (optionally) initial params (a
    `models.gpt.GPT` or its tree; the loop copies them). prompt_fn(rng)
    -> token-id sequence; reward_fn(prompt, completion) -> float. The
    engine is built internally from ``engine_kwargs`` (slots, max_len,
    block_size, spec, ...) on its OWN copy of the initial weights, in
    the config's activation dtype, or pass a live ``engine``. The
    learner holds f32 masters; ``optimizer`` is one of the port's
    (``spmd.Adam(lr)`` by default, ``optax.adam``'s equal).

    ``publish_to`` takes extra targets every publish also reaches:
    objects with ``.update_params(params)`` (engines, replicas) are
    called with the learner's model; an ``update_params`` with the
    ``.remote`` method sugar (a serve deployment handle) gets host numpy
    params (gathered whole on a mesh).

    ``mesh`` (a `parallel.Mesh`; every rank builds the loop with the
    same arguments): the engine and the learner hold each rank's blocks
    (module docstring); ``params`` may be whole or a model built on the
    mesh.

    `run(iterations)` returns ``(state, per-step host metrics)``;
    ``self.history`` holds one host-side record per iteration
    (reward_mean, rollout_tok_s, staleness = engine version minus the
    oldest tag in the batch). Entry points run on the card unless
    ``device`` says otherwise."""

    def __init__(self, cfg, prompt_fn, reward_fn, *, params=None,
                 seed: int = 0, engine=None, engine_kwargs=None,
                 mesh=None, optimizer=None, lr: float = 1e-2,
                 clip: float | None = 0.2, baseline_decay: float = 0.8,
                 prompts_per_iter: int = 4, max_new_tokens: int = 6,
                 temperature: float = 1.0, pad_to: int | None = None,
                 publish_every: int = 1, publish_to=(), device=None):
        mesh = active_mesh(mesh)
        self.mesh = mesh
        self.device = gpt.resolve_device(device)
        self.cfg = cfg
        self.prompt_fn, self.reward_fn = prompt_fn, reward_fn
        self.prompts_per_iter = int(prompts_per_iter)
        self.publish_every = max(1, int(publish_every))
        self._publish_targets = list(publish_to)
        self._rng = np.random.default_rng(seed)
        self._baseline: float | None = None
        self._decay = float(baseline_decay)
        self.history: list[dict] = []
        self.published_version = 0

        if params is None:
            params = gpt_init(cfg, seed, self.device)
        tree = (gpt.param_tree(params) if isinstance(params, gpt.GPT)
                else params)
        learner = gpt.GPT(cfg, _copy_tree(tree), device=self.device,
                          dtype=torch.float32, trainable=True, mesh=mesh)
        if engine is None:
            engine = InferenceEngine(
                gpt.GPT(cfg, _copy_tree(gpt.param_tree(learner)),
                        device=self.device, mesh=mesh),
                cfg, device=self.device, mesh=mesh,
                **(engine_kwargs or {}))
        self.engine = engine
        self.sampler = EngineSampler(
            engine, max_new_tokens=max_new_tokens,
            temperature=temperature, pad_to=pad_to)
        optimizer = optimizer if optimizer is not None else spmd.Adam(lr)
        self._step = make_learner_step(cfg, optimizer, int(max_new_tokens),
                                       clip)
        # the rows' block of the token sequences (and of their positions
        # over ``seq``); the rows' block of everything else, whose second
        # axis is a completion window
        place_tokens = _loop.make_placer(self.device, mesh=mesh)
        place_rows = _loop.make_placer(self.device, mesh=mesh, rules={
            **sharding.DEFAULT_RULES, "length": None})

        def place(batch):
            return {**place_rows({k: v for k, v in batch.items()
                                  if k != "tokens"}),
                    "tokens": place_tokens(batch["tokens"])}
        self._place = place
        self.state = spmd.TrainState(
            learner, optimizer.init(learner),
            torch.zeros((), dtype=torch.int32, device=self.device))
        # the learner's model FLOPs a step, on the padded batch, for the
        # loop's MFU
        t = self.sampler.pad_to
        flops = spmd.train_flops_per_token(cfg, t) * self.prompts_per_iter * t
        self.loop = _loop.TrainLoop(self._step, publisher=self._publish,
                                    flops_per_step=flops, device=self.device)
        # Flywheel-staleness series: the telemetry bridge republishes
        # stats() (last iteration's history record) at every snapshot,
        # through a weakref.
        self.name = _telemetry.next_name("flywheel")
        _telemetry.register_stats_source(self.name, self, kind="flywheel")

    # -- publish side ---------------------------------------------------

    def _publish(self, state, step: int):
        if step % self.publish_every:
            return
        self.published_version = self.engine.update_params(state.params)
        host = None
        for t in self._publish_targets:
            up = getattr(t, "update_params", None)
            if up is None:
                continue
            if hasattr(up, "remote"):   # serve deployment-handle sugar
                if host is None:
                    # the host copy is made only for remote targets
                    host = gpt.params_to_numpy(state.params)
                up.remote(host)
            else:
                up(state.params)

    # -- generate side --------------------------------------------------

    def _collect(self):
        """One engine rollout -> device batch for the learner's step,
        plus the host-side history record."""
        prompts = [self.prompt_fn(self._rng)
                   for _ in range(self.prompts_per_iter)]
        batch = self.sampler.rollout(prompts, self.reward_fn)
        r = batch[sb.REWARDS]
        mean_r = float(r.mean())
        if self._baseline is None:
            self._baseline = mean_r
        adv = (r - self._baseline).astype(np.float32)
        self._baseline = (self._decay * self._baseline
                          + (1.0 - self._decay) * mean_r)
        live = batch[MASK] > 0
        oldest = (int(batch[PARAMS_VERSION][live].min())
                  if live.any() else self.engine.params_version)
        self.history.append({
            "reward_mean": mean_r,
            "baseline": self._baseline,
            "staleness": self.engine.params_version - oldest,
            "engine_version": self.engine.params_version,
            "rollout_tok_s": self.sampler.last_rollout_tok_s,
        })
        return self._place({
            "tokens": batch[TOKENS],
            "start": batch[START],
            "behavior_logp": batch[sb.ACTION_LOGP],
            "mask": batch[MASK],
            "advantage": adv,
        })

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        """Host-side flywheel health: iteration count plus the last
        history record (reward, baseline, staleness, engine version,
        rollout rate), what the telemetry bridge tags as flywheel_*."""
        last = self.history[-1] if self.history else {}
        return {
            "iterations": len(self.history),
            "published_version": self.published_version,
            "reward_mean": last.get("reward_mean", 0.0),
            "baseline": last.get("baseline", 0.0),
            "staleness": last.get("staleness", 0),
            "engine_version": last.get(
                "engine_version", self.engine.params_version),
            "rollout_tok_s": last.get("rollout_tok_s", 0.0),
        }

    # -- drive ----------------------------------------------------------

    def run(self, iterations: int):
        """Alternate generate/train/publish for `iterations` cycles
        through `TrainLoop.run` (generation rides the lazy batch
        iterator, publication the `publisher` hook). Returns
        (final TrainState, per-step host metrics)."""
        it = (self._collect() for _ in range(int(iterations)))
        self.state, metrics = self.loop.run(self.state, it,
                                            num_steps=int(iterations))
        return self.state, metrics


def gpt_init(cfg, seed: int, device=None) -> dict:
    """f32 initial params from ``seed`` on ``device`` (the card unless
    told otherwise)."""
    return gpt.init_params(seed, cfg, device)
