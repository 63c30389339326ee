"""Training on one device: `spmd` (train state, optax-exact AdamW and Adam,
the step with gradient accumulation, the GPT and MoE losses and
trainers), `loop` (host-to-device prefetch on a side stream, multi-step
dispatch, lagged metric fetches), `ft` (asynchronous checkpoints and
resume, in the JAX package's format), `checkpoint` (the dict, directory
and URI checkpoint) and `predictor` (`TorchPredictor`)."""
