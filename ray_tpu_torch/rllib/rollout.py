"""Pluggable rollout generation backends: the registry and
`make_env_runner` of `ray_tpu/rllib/rollout.py` (the port imports
nothing of `ray_tpu`).

Token-level "envs" (RLHF prompts, best-of-n eval) use the serving
engine's paged-KV path as their sampler. A backend is a factory

    factory(env, module, rollout_length, *, seed, **backend_kwargs)
      -> runner with sample(params) -> (SampleBatch, last_value)
         and pop_episode_stats() -> dict

`ray_tpu_torch.rl.sampler` registers "engine" (`EngineSampler` behind
`TokenEnvRunner`) on import; `make_env_runner` imports it lazily, so
this module never pays for the serving stack unless asked.

Not ported yet (ROADMAP A8): ``backend=None``, the reference's eager
`PythonEnvRunner` over gym-API envs (it jits an RLlib module), and the
in-graph samplers (`InGraphSampler`, `VectorEnvRunner`).
"""

from __future__ import annotations

_GENERATION_BACKENDS: dict = {}


def register_generation_backend(name: str, factory) -> None:
    """Register a rollout generation backend under `name` (overwrites:
    tests swap in fakes)."""
    _GENERATION_BACKENDS[name] = factory


def make_env_runner(env, module, rollout_length: int, *, seed: int = 0,
                    backend: str | None = None,
                    backend_kwargs: dict | None = None):
    """Build a rollout runner from the named generation backend.
    ``backend=None`` is the reference's `PythonEnvRunner`, which is not
    ported (ROADMAP A8) and raises; so do its ``obs_connectors`` and
    ``action_connectors``, which only that runner reads."""
    if backend is None:
        raise NotImplementedError(
            "make_env_runner(backend=None), the eager PythonEnvRunner over "
            "gym-API envs, is not ported yet (ROADMAP A8: RLlib); pass "
            "backend='engine' for token-level envs")
    if backend not in _GENERATION_BACKENDS and backend == "engine":
        from ray_tpu_torch.rl import sampler as _sampler  # noqa: F401
        # import side effect registers "engine"
    try:
        factory = _GENERATION_BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown generation backend {backend!r} "
            f"(registered: {sorted(_GENERATION_BACKENDS)})") from None
    return factory(env, module, rollout_length, seed=seed,
                   **(backend_kwargs or {}))
