"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside `ray_tpu` (the JAX reference, which it never
imports). Layout mirrors the JAX package so that counterparts are easy
to find: `models.gpt`, `ops.decode_attention` (hand-written CUDA kernels
under `ops/csrc/` beside plain PyTorch versions), `serve.engine`.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
