"""Training on one device: `spmd` (train state, optax-exact AdamW and Adam,
the step with gradient accumulation, the GPT loss and trainer) and
`loop` (host-to-device prefetch on a side stream, multi-step dispatch,
lagged metric fetches)."""
