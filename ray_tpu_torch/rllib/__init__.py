"""The parts of `ray_tpu.rllib` the RL flywheel rides on: `sample_batch`
(the columnar trajectory container) and `rollout` (the generation-backend
registry and `make_env_runner`). The algorithms, the in-graph samplers
and the eager gym-env runner are ROADMAP A8."""
