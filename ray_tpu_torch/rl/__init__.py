"""ray_tpu_torch.rl: the training <-> serving RL flywheel, the port of
`ray_tpu.rl`.

- `EngineSampler` / `TokenEnvRunner` (`sampler.py`): engine-backed
  rollouts returning SampleBatch trajectories with per-token logprobs
  and `params_version` staleness tags; registers the "engine"
  generation backend with `rllib.rollout.make_env_runner`.
- `FlywheelLoop` (`flywheel.py`): colocated trainer <-> generator
  driver: `TrainLoop` steps a PPO/REINFORCE-on-sequences objective on
  engine rollouts and publishes each update into the live engine (and
  any other targets) through `TrainLoop`'s ``publisher`` hook.
"""

__all__ = ["EngineSampler", "TokenEnvRunner", "FlywheelLoop",
           "motif_reward"]

# the serving stack loads lazily (PEP 562), as in the reference
_LAZY = {"EngineSampler": "ray_tpu_torch.rl.sampler",
         "TokenEnvRunner": "ray_tpu_torch.rl.sampler",
         "FlywheelLoop": "ray_tpu_torch.rl.flywheel",
         "motif_reward": "ray_tpu_torch.rl.flywheel"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
