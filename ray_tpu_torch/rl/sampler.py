"""Engine-backed rollout generation for token-level RL: the port of
`ray_tpu/rl/sampler.py` (the port imports nothing of `ray_tpu`).

`EngineSampler` submits prompts to a live `serve.engine.InferenceEngine`
and turns the streamed `TokenEvent`s (token id + behavior logprob +
params_version) into SampleBatch-compatible trajectories, so RLHF-style
learners train on tokens sampled by the same paged-KV, continuous-
batching, captured (and optionally speculative) path that serves
traffic, instead of paying a full-sequence forward per sampled token.

`TokenEnvRunner` adapts the sampler to the `rllib.rollout` runner
contract (`sample(params) -> (SampleBatch, last_value)` +
`pop_episode_stats()`) and registers as the "engine" generation backend
of `rllib.rollout.make_env_runner`.

A token-level env is anything with:
  ``make_prompt(rng) -> sequence of token ids``  (rng: np.random.Generator)
  ``reward(prompt, completion) -> float``
  optional ``eos_id`` attribute.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.rollout import register_generation_backend
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# Extra trajectory columns (beyond the sb.* constants) the flywheel
# learner consumes. Every trajectory carries PARAMS_VERSION so learners
# can bound staleness / importance-correct against the publisher.
TOKENS = "tokens"                 # [B, T] padded prompt + completion
START = "start"                   # [B] first completion index
MASK = "mask"                     # [B, W] 1.0 on real completion tokens
PARAMS_VERSION = "params_version"  # [B, W] per-token weight version


class EngineSampler:
    """Rollout backend over a live InferenceEngine.

    `rollout(prompts)` submits every prompt up front (they continuous-
    batch into the engine's slots), drains the token streams, and packs
    one fixed-shape SampleBatch: behavior logprobs come off the
    `TokenEvent`s the engine's decode/verify/prefill steps computed
    (natural, temperature-1 log pi(a|s), the quantity RL ratios need)
    and every token carries the `params_version` it was sampled under.

    `pad_to` fixes the padded sequence width [B, pad_to] (default: the
    engine's max_len) so the learner's step sees one shape.
    """

    def __init__(self, engine, *, max_new_tokens: int = 8,
                 temperature: float = 1.0, eos_id: int | None = None,
                 pad_to: int | None = None):
        self.engine = engine
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.pad_to = int(pad_to) if pad_to is not None else engine.max_len
        # last-rollout throughput (bench_infer's rollout_tok_s probe)
        self.last_rollout_tok_s = 0.0
        self.last_rollout_tokens = 0

    def rollout(self, prompts, reward_fn=None) -> SampleBatch:
        """prompts: list of token-id sequences -> SampleBatch with
        columns TOKENS/START/MASK/PARAMS_VERSION plus sb.ACTIONS (the
        completion tokens), sb.ACTION_LOGP (behavior logprobs),
        sb.REWARDS (reward_fn per sequence, else zeros), sb.DONES,
        sb.EPS_ID."""
        eng, W = self.engine, self.max_new_tokens
        B = len(prompts)
        if B == 0:
            raise ValueError("rollout needs at least one prompt")
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=W,
                           temperature=self.temperature,
                           eos_id=self.eos_id) for p in prompts]
        # Draining rid 0 pumps the shared engine, so later requests are
        # usually finished by the time their turn comes: one
        # continuously-batched device loop, not B sequential decodes.
        outs = [list(eng.tokens_for(rid)) for rid in rids]
        dt = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        self.last_rollout_tokens = n_tok
        self.last_rollout_tok_s = n_tok / dt if dt > 0 else 0.0

        T = self.pad_to
        tokens = np.zeros((B, T), np.int32)
        actions = np.zeros((B, W), np.int32)
        logp = np.zeros((B, W), np.float32)
        vers = np.zeros((B, W), np.int32)
        mask = np.zeros((B, W), np.float32)
        start = np.zeros((B,), np.int32)
        rewards = np.zeros((B,), np.float32)
        for b, (p, out) in enumerate(zip(prompts, outs)):
            if p.size + len(out) > T:
                raise ValueError(
                    f"prompt {p.size} + completion {len(out)} exceeds "
                    f"pad_to {T}")
            tokens[b, :p.size] = p
            start[b] = p.size
            comp = np.asarray([int(t) for t in out], np.int32)
            tokens[b, p.size:p.size + comp.size] = comp
            actions[b, :comp.size] = comp
            logp[b, :comp.size] = [getattr(t, "logprob", 0.0)
                                   for t in out]
            vers[b, :comp.size] = [getattr(t, "params_version", 0)
                                   for t in out]
            mask[b, :comp.size] = 1.0
            if reward_fn is not None:
                rewards[b] = float(reward_fn(p, comp))
        return SampleBatch({
            TOKENS: tokens, START: start, MASK: mask,
            PARAMS_VERSION: vers,
            sb.ACTIONS: actions,
            sb.ACTION_LOGP: logp,
            sb.REWARDS: rewards,
            sb.DONES: np.ones((B,), bool),
            sb.EPS_ID: np.asarray(rids, np.int64),
        })


class TokenEnvRunner:
    """`rllib.rollout` runner contract over an EngineSampler.

    Each `sample(params)` call: (1) hot-swaps `params` (a
    `models.gpt.GPT` or its tree) into the engine when a NEW params
    object arrives (`publish=True`, the on-policy default: repeated
    samples on the same tree don't re-swap; a model is swapped in at
    every call, since the port's optimizers update a model in place and
    the same object may hold new weights); (2) draws
    `rollout_length` prompts from the env; (3) returns the engine
    trajectory batch and a zero bootstrap value (sequence-level rewards
    have no tail to bootstrap)."""

    def __init__(self, env, module, rollout_length: int, *,
                 seed: int = 0, engine=None, engine_factory=None,
                 publish: bool = True, max_new_tokens: int = 8,
                 temperature: float = 1.0, pad_to: int | None = None):
        if engine is None:
            if engine_factory is None:
                raise ValueError(
                    "TokenEnvRunner needs engine= or engine_factory= "
                    "(an InferenceEngine to generate with)")
            engine = engine_factory()
        self.env = env
        self.module = module
        self.rollout_length = int(rollout_length)
        self.publish = publish
        self.sampler = EngineSampler(
            engine, max_new_tokens=max_new_tokens,
            temperature=temperature,
            eos_id=getattr(env, "eos_id", None), pad_to=pad_to)
        self._rng = np.random.default_rng(seed)
        self._last_params = None
        self._episode_rewards: list = []

    def sample(self, params):
        if (self.publish and params is not None
                and (params is not self._last_params
                     or isinstance(params, torch.nn.Module))):
            self.sampler.engine.update_params(params)
            self._last_params = params
        prompts = [self.env.make_prompt(self._rng)
                   for _ in range(self.rollout_length)]
        batch = self.sampler.rollout(prompts, self.env.reward)
        self._episode_rewards.extend(batch[sb.REWARDS].tolist())
        return batch, np.zeros((len(prompts),), np.float32)

    def pop_episode_stats(self) -> dict:
        rs = self._episode_rewards
        stats = {
            "episode_reward_mean": (float(np.mean(rs)) if rs
                                    else float("nan")),
            "episode_len_mean": float(self.sampler.max_new_tokens),
            "episodes_this_iter": len(rs),
        }
        self._episode_rewards = []
        return stats


def _engine_backend(env, module, rollout_length, *, seed=0, **kw):
    return TokenEnvRunner(env, module, rollout_length, seed=seed, **kw)


register_generation_backend("engine", _engine_backend)
