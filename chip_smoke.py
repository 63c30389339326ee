#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments
    python3 chip_smoke.py --decode-times [CHECKOUT]
    python3 chip_smoke.py --ft-child    # phase 17 (b)'s trainer (env)
    python3 chip_smoke.py --mesh-child  # one rank of phases 18 (b) to 21

Builds the port's CUDA kernels from ``ray_tpu_torch/ops/csrc/`` with nvcc
(sm_90a, one nvcc per source, all at once) and drives its paths, paged
serving, training (dense and fused loss, checkpointed and resumed, and
the MoE, ViT and ResNet families) and unpaged decode, end to end:

1. kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the same inputs at the serving shapes (H=16, D=64,
   block 16, 513 pool blocks, 64-entry tables), in bf16 (the split-K
   decode kernel and the tensor-core multi-query kernel, the latter
   within an extra 2^-8 P|V| for its bf16 P) and f32, each bf16 kernel
   called twice for bit-identical outputs, with its device time per
   call, the plain version's, one PyTorch library call's
   (``scaled_dot_product_attention`` over K/V gathered beforehand, the
   gather not timed), the least time the card could take (the bound)
   and its registers and spills;
2. the engine: `InferenceReplica` at the width of the model
   ``bench_infer.py`` serves (vocab 50304, d_model 1024, 12 layers, 16
   heads, d_ff 4096, bf16, random weights from a seed) answers 17
   requests (a shared 64-token prefix, a repeated prompt that forces a
   copy-on-write, a 300-token prompt prefilled in several chunks, one
   sampled request), after a warm-up that takes every chunk bucket and
   arms the retrace sentinel, with every kernel's launch counter read
   around it (12 split-K decode launches a tick, 12 tensor-core
   multi-query launches a prefill chunk, no CUDA-core multi-query
   launch: the engine's steps are CUDA graphs, whose launches the engine
   counts once a replay), its steps built once (decode once, prefill
   once a chunk bucket, no unexpected retrace, a graph pool), prefill
   tok/s and decode p50/p99 printed beside the paged kernels' numbers
   before split-K;
3. teacher-forced check: a dense float32 forward with plain attention
   over two greedy requests' prompt + output must reproduce the
   engine's per-token logprobs;
4. profile: a short engine run under ``torch.profiler``, device time by
   kernel name, the device's busy share of the wall time, and the paged
   kernels' launches by name as the profiler sees them inside the
   replayed graphs (one each per layer call: no merge kernel);
5. flash kernels vs plain: forward (out, lse), dQ and dK/dV (bf16 on
   the tensor-core kernels, f32 on the CUDA-core ones) against their
   plain versions at the training shape (B 8, T 1024, H 16, D 64) in
   bf16 and f32, causal and full, at ragged T of 1000 and 129, and at
   D 128; device time, bound, plain time and the library time
   (``scaled_dot_product_attention`` forward, and its backward through
   autograd for the two backward kernels);
6. training at the width of ``bench.py``'s GPT (the model above, bf16
   activations over f32 masters, flash attention, bf16 logits, remat
   "dots", dense loss, batch 8 x 1024): (a) loss and every gradient
   leaf with flash attention against plain attention from the same
   masters; (b) the step-0 loss near ln(vocab) + sigma^2/2, the
   expected loss of the init's logits; (c) `make_gpt_trainer`
   + `DevicePrefetcher` + `TrainLoop` on fresh host batches: tok/s, MFU,
   the loop's breakdown, host syncs, flash launch counts (per step one
   tensor-core dQ and dK/dV launch per layer, no CUDA-core flash
   kernel), and the device busy share from a short profiled window;
   (d) 25 steps on one
   repeated batch (5 of them warm-up) must lower the loss by at least
   1 nat;
7. fused cross-entropy kernels vs plain: the forward (lse, target logit)
   and the backward (dx, dE) against their plain versions at bench.py's
   loss shape (N 24576 rows, vocab 50304, D 1024) in bf16 (on the tensor
   cores: the forward's tile and merge kernels, the backward's three
   kernels over 13 vocabulary chunks) and f32 (CUDA cores) and at a
   ragged N 1000, V 50257; device time, bound, plain time and cuBLAS's
   time for the same products, for the forward (and each of its two
   kernels), each backward kernel (summed over its chunks) and the whole
   backward;
8. bench.py's own training configuration (phase 6's model with the fused
   loss at batch 24, unroll 4, prefetch 2, metrics interval 10; 4
   warm-up and 20 timed steps): (a) fused against dense loss and every
   gradient leaf from the same masters; (b) the step-0 loss; (c) tok/s,
   MFU, host syncs and the launches of all seven training kernels; (d) the
   peak memory of one forward + backward, fused against dense: dense must
   exceed fused by at least the bf16 logits' bytes; (e) a profiled
   window with the fused kernels' share of device time and the device
   time of each of the port's kernels;
9. the unpaged KV-cache path at the serving model's width: the decode
   kernel (split-K, sharing the paged decode kernel's body) against its
   plain version at [8, 1024, 16, 64], called twice for bit-identical
   outputs, with its times at DECODE_POS and at the path's own contexts
   (each with plain, SDPA and bound), then `prefill` of 8 ragged
   prompts (100-300 tokens), a slot-targeted prefill and 64 greedy
   `decode_step`s, with step p50/p99, tok/s, launches, and the emitted
   tokens' logprobs against a dense f32 forward (phase 3's limits);
10. the shapes the kernels once refused (head dims 96, 100 and 256, pool
   block 64, fused-loss widths 384, 1600 and 4096; depth cut to 2
   layers): the decode and multi-query kernels at each head dim over a
   block-64 pool against plain, a training step at each head dim (flash
   against plain attention, then a trainer step: tensor-core kernels at
   96 and 100, padded to 128, CUDA-core kernels at 256), an engine at
   block 64 on the D 96 model against a dense f32 forward, and the fused
   loss at each width against the dense loss; and the head dims above
   256 (264, 512, 520 and 1024: the decode, multi-query and flash
   kernels against plain, in bf16 and, for the int8 pool and flash, f32
   too; above 512 in slabs of 512) with an engine at head dim 520;
11. int8 serving: (a) the int8 instances of the paged kernels (int8
   pool, one f32 scale per (position, head) row) against their plain
   versions at phase 1's shapes, decode at DECODE_POS, prefill at
   PREFILL_CASES and verify at W 5, f32 and bf16 q (bf16 multi-query
   within an extra 2^-8 P|V|), each once a call, bit-identical twice and
   replayed exactly from a CUDA graph with a new pos; the decode and C 64
   prefill times beside the bf16 kernels' (phase 1), plain and bound (no
   library call dequantizes and attends); (b) phase 2's traffic through
   an engine with ``kv_dtype="int8"`` and one with ``weight_dtype="int8"``
   as well: every paged launch an int8 kernel's, ``kv_bytes_per_token``
   2 D / (D + 4) = 1.88x under the bf16 engine's, logprobs against the
   bf16 engine's (printed), one ``update_params`` of the same weights
   (tokens unchanged, ``quantize_traces`` unchanged, ``params_version``
   1), decode p50/p99 and tok/s, and phase 3's teacher-forced check;
12. speculative decoding: (a) the verify caller of the multi-query
   kernel (`paged_verify_attention`, as `verify_step_paged` calls it) at
   the engine's geometry, W 2, 5 and 9 (k 1, 4, 8) in bf16 and f32 and
   an int8 pool at W 5, each against its plain version, one launch a
   call by name, bit-identical twice, CUDA-graph replay with a new pos;
   the W 5 bf16 call's time beside plain, SDPA with the staircase mask,
   the bound and the five `paged_decode_attention` calls W sequential
   ticks would make; (b) ``bench_infer.py``'s spec traffic (16 prompts
   tiling a 4-token motif to 128 tokens, 64 new tokens each, one
   sampled) through phase 2's model with spec off, ``spec="ngram"`` and
   ``spec="draft"`` (a 1-layer draft from seed + 1), k 4: decode tok/s,
   tick p50/p99, tokens_per_step, acceptance_rate, wall time, one host
   sync a tick, the paged launches per spec tick (12 ``paged_mq_tc`` a
   verify, W ``paged_decode`` a draft layer's proposal), 8 ticks under
   ``torch.profiler`` (wall and device time a tick by kernel group),
   phase 3's teacher-forced check of each spec engine; (c) draft = target on
   peaked weights (embed x 8) at temperature 0: acceptance_rate >= 0.9,
   tokens_per_step >= 3, tokens identical to spec off, and
   ``update_params(..., draft_params=...)`` of the same weights;
13. compile-once serving: phase 2's traffic (bf16, and int8 pool and
   weights) and phase 12's prompts (all greedy; spec off, n-gram and
   draft) through an engine whose steps run eagerly (``_capture =
   False``) and one whose steps are CUDA graphs: tick p50/p99, decode
   tok/s, device busy share over 8 profiled ticks with every slot
   decoding, the trace counters, ``retraces_unexpected`` (0),
   ``graph_pool_bytes``, and the greedy tokens, which must be identical;
14. scheduling under pressure, at phase 2's model and engine geometry
   with captured steps after the warm-up: (a) a pool of 64 blocks for 8
   slots, 12 class-0 requests (128-token prompts, 64 new tokens, a
   12-block footprint) and after 16 ticks 6 class-1 ones, on peaked
   weights against an unpressured engine (tokens identical) and at random
   weights (phase 3's check of every preempted stream): preemptions,
   invariants after every tick, per-class counters, nothing built again,
   the paged launches (re-prefill chunks among them), per-class TTFT,
   tick and decode-step p50/p99 and decode tok/s beside the unpressured
   engine's; (b) ``spec="ngram"`` and ``"draft"`` under the
   ``engine.preempt`` site at p 0.1: tokens identical to the run without
   the plan, the same fault log on a second run; (c) shedding on
   ``max_queue`` and ``shed_high_water``, the counts the CPU test pins;
   (d) ``watchdog_s`` against a delayed tick; (e) ``engine.alloc``
   exhaustion preempting exactly twice;
15. disaggregated prefill/decode at phase 2's model and engine geometry:
   (a) ``bench_infer.py``'s A/B (8 decode streams of 128 + 128 tokens,
   then 32 prompts of 512 tokens with one new token each, drained by
   threads that stamp each token) through 2 colocated engines and
   through a prefill-role + a decode-role engine, all warmed and
   captured, on peaked weights: client-side TPOT and TTFT p99 per mode,
   the handoff's blocks, bytes, ``kv_transfer_gbps`` (``bench_infer.py``'s
   definition) and export/import p50/p99; held to identical tokens,
   nothing built after the warm-up, invariants, a prefill engine that
   never decodes, the paged launches of each engine, and one host sync
   an export (beside one a prefill chunk); the streams at random weights
   against phase 3's dense f32 check; (b) int8 kv + w, n-gram and a
   1-layer draft through a prefill/decode pair against a colocated
   engine of the same backend (identical tokens, verify launches); (c)
   `PrefillReplica` -> `DecodeReplica` over localhost netaddr (identical
   tokens, pull p50/p99 and rate, a dead address prefilled locally),
   both closed;
16. the RL flywheel and the telemetry plane: (a) `rl.FlywheelLoop` on
   phase 2's model (f32 masters, bf16 compute) with `spmd.Adam`,
   ``bench_infer.py``'s rollout probe (8 prompts of 128 tokens, 128 new
   tokens at temperature 1, padded to 256) through a captured engine of
   8 slots, block 16, chunk 64, 6 iterations with a publish each:
   rollout_tok_s, the learner step's device time (CUDA events) and MFU,
   the loop's breakdown, weight_swap_ms, staleness, the paged and flash
   launches of the engine and the learner apart; held to no build after
   the warm-up, the first learner step with flash against plain
   attention on the raw rewards (phase 6's limits; the per-token
   logprobs within phase 3's 0.1), the behaviour logprobs against
   `completion_logprobs` (max and mean |diff|, phase 3's 0.1), and peaked
   final weights' greedy tokens identical to a fresh engine's; (b)
   ``tests/test_flywheel.py``'s tiny flywheel (12 iterations): the reward
   rises by more than 0.15, 12 swaps, nothing rebuilt, the ``publish_to``
   fan-out; (c) phase 2's traffic through captured engines at
   ``telemetry_sample`` 1.0 and 0.0, 8 rounds of 3 runs alternating:
   ``trace_overhead_pct`` as ``bench_infer.py`` computes it and its
   standard error over the rounds, the hooks' own host time, spans
   recorded and dropped, one host sync a tick and a chunk,
   `util.telemetry.check_invariants`, a Prometheus text with the engine's,
   the train loop's and the flywheel's series that parses, and a replica
   pair's export, import and handoff spans.
17. fault-tolerant training and the other model families: (a)
   ``bench.py``'s checkpoint region on phase 8's configuration: a clean
   20-step region, then the same `TrainLoop` with an `AsyncCheckpointer`
   (every max(unroll, steps // 2), 2 in flight, keep 1) in a temporary
   directory (its filesystem printed): ``checkpoint_overhead_pct`` as
   ``bench.py`` computes it (end-of-run flush included, and without it),
   commits (> 0), stalls, the breakdown, each ``ft.checkpoint_commit``
   span, each commit split into the clones' and the host copy's device
   time, sha256 and write + fsync; the training thread's host syncs equal
   to the clean region's; a forced snapshot of the live state restored
   into a trainer built with ``init_state=False``, every leaf bit for bit,
   and 4 more steps from each with bit-identical losses; (b)
   ``tests/test_chaos.py``'s kill/resume with ``--ft-child`` children
   (``bench.py``'s GPT at full width, 2 layers, fused loss, flash, batch
   8; ``CUBLAS_WORKSPACE_CONFIG`` set): a control run, a victim that
   checkpoints every 3 steps and SIGKILLs itself at batch 8, a resume
   whose losses equal the control's bit for bit; (c) ``MoEConfig()``
   through `make_moe_trainer` at batch 8: the flash kernels against plain
   at its shape (H 12), the step-0 loss, flash against plain attention
   (phase 6's limits), 6 timed steps (tok/s, peak memory, flash launches
   a step: 24 forward with remat, 12 dQ, 12 dK/dV), a profiled window by
   kernel group, and a checkpoint restored with a bit-identical next
   step; (d) ``ViTConfig()`` and ``resnet50(1000)`` at 224^2, bf16, batch
   32: 3 steps of Adam on one repeated batch (images/s, falling losses),
   a `Checkpoint` of the trained weights through a directory into
   `TorchPredictor` with predictions equal to the model's own bit for
   bit, and ResNet's batch statistics changed by training and used in
   eval;
18. SPMD training on a mesh (``ray_tpu_torch.parallel``): (a) phase
   17's model at 12 layers, fused loss, attn "auto", batch 8, 3 steps of
   ``make_gpt_trainer(cfg, mesh=single_device_mesh())`` against
   ``make_gpt_trainer(cfg)`` from one seed: losses and launches by name
   identical; the same at 4 layers without a mesh as the reference of
   (b); (b) two ``--mesh-child`` ranks on the one card (gloo, its
   collectives staged through host memory: NCCL refuses two ranks on one
   device; the backend printed), from the same seed and global batches:
   ``tensor=2`` at 12 layers (each rank flash on 8 heads, the fused-xent
   kernels on a 25,152-row vocabulary shard), ``data=2``, ``seq=2`` (the
   ring) and ``pipe=2`` (``make_gpt_pipeline_trainer``, 2 microbatches)
   at 4 layers: 3 steps each, loss within 2e-3 and grad norm within 2e-2
   relative of (a)'s trainer at the same depth at every step, both ranks'
   losses equal, and after the last step every leaf gathered whole from
   the ranks' blocks within a quarter of the norm of (a)'s update of it
   (the largest element gap printed); per rank the step times, the
   collectives' seconds and host copies, peak device memory and the
   launches by kernel name; in the tensor=2 run each rank holds its
   shard's fused-xent forward and backward kernels against the plain
   versions on the batch's shifted ids (some below the shard, some above
   it) and times them.
19. serving, RL and MoE on a mesh: two ``--mesh-child`` ranks
   (``MESH_PHASE=19``) on the one card over gloo, as 18 (b). (a)
   ``bench_infer.py``'s model (12 layers, 16 heads, bf16) built with
   ``mesh=`` tensor=2, 8 heads a rank: 6 of phase 2's requests (its first
   two, the one that repeats the first, two unrelated, one sampled, and
   the 300-token prompt) with 32 new tokens each (cut) through engines
   with a bf16 pool and an int8 pool, then 4 motif prompts through an
   n-gram engine; steps uncaptured (``captured`` false), the launches
   exactly one a layer per decode tick, prefill chunk and verify tick
   by kernel name; rank 0 holds each engine's greedy requests to phase
   3's rule; then every paged kernel (decode, multi-query, verify, the
   int8 pool's decode and multi-query) at the rank's 8 heads on the
   rank's own pools against its plain version, timed in turn with the
   other rank beside the plain version, SDPA and the bound; (b)
   ``init_kv_cache(mesh=)``, phase 9 (b)'s 8 prompts and 32 greedy
   ``decode_step``s (12 ``decode_attention`` launches a step), two rows
   held to phase 3's rule, the contiguous decode kernel at 8 heads on
   the rank's cache against plain and timed; (c) ``FlywheelLoop(mesh=)``
   on (a)'s model, 3 iterations of 4 prompts (cut), every leaf of the
   rank's engine equal to its learner block after each publish; (d)
   ``MoEConfig()``'s width cut to 4 layers, batch 2, 2 steps of
   ``make_moe_trainer`` on expert=2 (4 experts a rank), losses and grad
   norms within 18 (b)'s limits of a single-card run from the same seed
   in the parent, flash launched on each rank. Per rank: tick and step
   p50/p99, the collectives' seconds and bytes through the host, peak
   memory and launches by kernel name. Both ranks' tokens, decoded rows
   and flywheel histories must be equal.
20. the rest of serving on a mesh: two ``--mesh-child`` ranks
   (``MESH_PHASE=20``) on the one card over gloo, as 19, on 19's model
   and cut requests at tensor=2 (8 heads a rank): (a) int8 weights with
   the int8 pool (only int8 paged launches, one a layer per tick and
   chunk; each rank's int8 and scale blocks the cut of one card's
   ``quantize_params``, bit for bit); (b) the 1-layer draft proposer
   (its pool at 8 heads a rank; one paged decode a draft layer for each
   of a verify tick's W proposal steps and each draft prefill chunk);
   (c) the greedy requests through a prefill-role engine on the mesh
   (whole-head blobs: export ms, one multi-query a layer per chunk) into
   a decode-role engine on the mesh (import ms, one paged decode a layer
   per tick), then a single card's blobs, exported on the first rank and
   sent to both, into a second decode-role engine; then every paged
   kernel at 8 heads on the decode-role and int8 engines' pools against
   its plain version, timed in turn beside plain, SDPA and the bound;
   (d) seq=2 (16 heads a rank, the step repeated): the engine, and
   ``completion_logprobs`` of 2 rows of 256 tokens over the split (the
   ring) within 0.1 of one card's. Rank 0 holds every path's greedy
   requests to phase 3's rule. Per rank: tick p50/p99, the collectives'
   share of the wall, export and import ms, peak memory and launches by
   kernel name. Both ranks' tokens and log-probabilities must be equal.
21. the rest of training on a mesh: single-card references in the
   parent first (``MoEConfig()`` at 4 layers in bf16 and f32,
   ``ViTConfig()``, ``bench.py``'s GPT at 4 layers), then two
   ``--mesh-child`` ranks (``MESH_PHASE=21``): (a) ``make_moe_trainer``
   over seq=2 (the ring; the route's slots over the global order) in f32,
   held to 18 (b)'s limits, and in bf16, printed (the router turns
   bf16 rounding into other experts), and over pipe=2 (the ranks repeat
   the step), 2 steps, each leaf's gap and the router's and an expert's
   printed; (b) ``ViTConfig()`` over pipe=2, 2 steps at batch 8; (d)
   ``make_gpt_trainer`` on tensor=2 with an ``AsyncCheckpointer``
   snapshotting every step: one commit a snapshot (rank 0's), the
   manifest's specs equal to ``ft.state_specs``, ``maybe_snapshot``'s
   host ms, the clones' device ms, the writer's gather and commit, the
   next loss again from the checkpoint restored onto the mesh, and
   restored onto this card in the parent within 18 (b)'s loss limit;
   then four ranks (``MESH_PHASE=21c``): (c) ``make_gpt_pipeline_trainer``
   on pipe=2 x tensor=2, 3 steps, each stage's blocks whole on both
   tensor ranks (flash launches a rank at 16 heads), held to 18 (b)'s
   limits, and the three flash kernels against their plain versions at
   a stage's shapes on each rank in turn.

Before the phases it prints the registers and spilled bytes of every
tensor-core kernel and of the two split-K decode kernels from nvcc's
ptxas report.

``--decode-times`` runs no phase: it times the two decode kernels of the
checkout at CHECKOUT (default: this one) at the serving shapes, on the
inputs phases 1, 4 and 9 give them, and prints its checks and then one
JSON line (`decode_times`). Run it once a checkout, in one call, in the
order parent, change, change, parent, to hold a change against its
parent.

Any failed phase raises, so the exit code is non-zero. The last two
lines of stdout are a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak, same source
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores

# training shapes (bench.py's model at batch 8): flash attention inputs
FB, FT, FH, FD = 8, 1024, 16, 64
FLASH_RAGGED_T = 1000
# Flash kernels vs plain, per element |kernel - plain| <= atol + rtol *
# |plain|: both accumulate in f32 from the same inputs, so they differ by
# summation order (f32; gradients sum up to T products, hence 1e-4) and,
# in bf16, one final rounding (2**-7 of the value). The bf16 forward also
# rounds each p to bf16 before p . V, the kernel relative to its running
# row max and the plain version relative to the final one, so each term
# may differ by one more bf16 rounding: + 2**-8 * (P |V|) per element.
FLASH_TOL = {"bfloat16": (1e-4, 2 ** -7), "float32": (1e-4, 1e-5)}
# The bf16 tensor-core backward (D 64 and 128) rounds P and dS to bf16
# once before its products: + 2**-8 times scale |dS| |K| (dq), scale
# |dS|^T |Q| (dk) and |P|^T |dO| (dv), from the plain version's f32 P and
# dS (`flash_backward_abs_bound`). f32 and D 32 keep the limit above.
# Phase 5's cases: (T, causal, dtype, D); the main path's is the first.
FLASH_CASES = ((FT, True, "bfloat16", FD), (FT, False, "bfloat16", FD),
               (FT, True, "float32", FD), (FT, False, "float32", FD),
               (FLASH_RAGGED_T, True, "bfloat16", FD),
               (FLASH_RAGGED_T, False, "float32", FD),
               (129, True, "bfloat16", FD), (FT, True, "bfloat16", 128))
# Flash vs plain attention inside the whole bf16 model, same f32
# masters: the two paths round at different places (the kernel rounds p
# to bf16, the plain path keeps it f32), so activations, the loss and
# each gradient leaf differ like two bf16 runs: a mean loss over 8192
# positions to well under 1e-2, each leaf's gradient to a few bf16
# roundings (2**-8 each) in relative Frobenius norm.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
# At init the final RMSNorm gives x unit RMS over d_model and embed rows
# are N(0, 0.02^2), so each logit is ~N(0, sigma^2) with sigma^2 =
# d_model * 0.02^2 (0.41 here), and the expected loss is
# logsumexp ~ ln(vocab) + sigma^2 / 2, not ln(vocab) itself: the step-0
# loss must be within 0.1 of that.
STEP0_LOSS_TOL = 0.1
OVERFIT_DROP = 1.0

# fused cross-entropy at bench.py's loss shape (batch 24 x 1024 rows,
# vocab 50304, d_model 1024) and one ragged case
XN, XV, XD = 24 * 1024, 50304, 1024
XENT_RAGGED = (1000, 50257)
# Fused-xent kernels vs plain, per element |kernel - plain| <= XENT_TOL *
# (max|plain| + |plain|): lse, the target logit, dx and dE are f32 on both
# sides, summed in f32 from the same inputs (bf16 products are exact in
# f32) in another order, over D = 1024 products per logit and V (dx) or N
# (dE) terms per gradient element: ~1e-6 relative, far under the limit,
# and a masking or indexing fault is far over it. The bf16 backward also
# rounds dlog to bf16 once before its two products: + 2^-8 (bf16's unit
# roundoff) times |dlog| . |E| for dx and |dlog|^T . |x| for dE.
XENT_TOL = 1e-4
FUSED_STEPS, FUSED_WARMUP = 20, 4

# serving shapes (bench_infer.py's model, slots 8, max_len 1024, block 16)
H, D, BS, MB = 16, 64, 16, 64
NB = 8 * MB + 1
DECODE_POS = (0, 15, 16, 100, 511, 700, 1000, 1023)
PREFILL_CASES = ((8, 0), (8, 17), (8, 960), (64, 0), (64, 17), (64, 960))
# Per element, |kernel - plain| <= atol + rtol * |plain|. Both sides
# accumulate in f32 from the same inputs: in f32 they differ by summation
# order; in bf16 by at most one final rounding, one bf16 ulp, which is at
# most 2**-7 of the value.
TOL = {"bfloat16": (1e-5, 2 ** -7), "float32": (2e-5, 0.0)}
# The bf16 multi-query kernel (tensor cores) also rounds p to bf16 before
# p . V, relative to its running row max: + 2**-8 * (P |V|) per element.
TIME_SETS = 8
# Phase 9 (a) times the decode kernel at these of (b)'s 64 decode steps:
# row b at position (its prompt length) + i.
CONTEXT_STEPS = (0, 9, 18, 27, 36, 45, 54, 63)
LOGPROB_TOL = 0.1
# The model bench_infer.py serves (phases 2-4 and 9).
SERVE_CFG = dict(vocab_size=50304, d_model=1024, n_layers=12, n_heads=16,
                 d_ff=4096, max_seq_len=1024, dtype="bfloat16")
# Phase 4's traffic: 8 requests of PROFILE_PROMPT tokens, PROFILE_NEW new
# tokens each.
PROFILE_PROMPT, PROFILE_NEW = 128, 32
# The engine of phases 2 and 4 with the paged kernels before split-K (one
# CTA per (row, head) for decode, the CUDA-core multi-query kernel for
# prefill), on an NVIDIA H100 80GB HBM3 at 700 W: printed beside this
# run's numbers.
SERVING_BEFORE = {"prefill_tok_s": 5622.8, "p50_token_latency_ms": 9.489,
                  "p99_token_latency_ms": 13.377, "device_busy_share": 0.0889}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, args, reps: int = 21, per_rep: int = 16) -> float:
    """Device time of one call, median over `reps`: each rep times
    `per_rep` back-to-back calls between one pair of CUDA events and
    divides by `per_rep`. The calls cycle through `args`, input sets
    whose bytes exceed the 50 MB L2 between two uses of one set, so each
    call finds its inputs cold as the main path does. A spin kernel
    queued ahead holds the card while the host enqueues the calls, so no
    host dispatch time falls inside the window; a rep whose start event
    had already passed when the last call was queued is retried with a
    longer spin."""
    import torch
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    spin, out, i = 1 << 20, [], 0
    while len(out) < reps:
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn(*args[i % len(args)])
            i += 1
        end.record()
        starved = start.query()
        end.synchronize()
        if starved:
            spin *= 2
            if spin > 1 << 32:
                fail("the host cannot queue the timed calls ahead of the card")
            continue
        out.append(start.elapsed_time(end) / per_rep)
    return statistics.median(out)


def time_long_ms(fn, args, reps: int = 5) -> float:
    """Device time of one call that runs for many milliseconds: median
    over `reps` of CUDA events around a single call between two
    synchronisations. At that length the host queues a call's launches
    far faster than the card runs them, so no spin kernel is needed."""
    import torch
    fn(*args)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


# The engine's trace counters: builds of its static steps (captures on
# the card).
TRACE_KEYS = ("decode_traces", "prefill_traces", "verify_traces",
              "draft_traces", "draft_prefill_traces")
# Warm-up prompt lengths that take every chunk bucket at chunk 64 (8, 16,
# 32 and 64).
WARM_PROMPTS = (5, 12, 30, 64)


def bound(bytes_moved: float, ops: float, dtype) -> tuple[float, str]:
    import torch
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name, got, ref, dtype_name, what, tol=None, extra=None,
          extra_name="2^-8*P|V|") -> float:
    atol, rtol = (tol or TOL)[dtype_name]
    diff = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if extra is not None:
        limit = limit + extra
    over = (diff - limit).max().item()
    err = diff.max().item()
    print(f"  {what}: max|kernel-plain| = {err:.3e} "
          f"(limit {atol} + {rtol:.4g}*|plain|"
          f"{' + ' + extra_name if extra is not None else ''})")
    if not over <= 0:
        fail(f"{name} kernel disagrees with plain ({what})")
    return err


def same_twice(name, fn, args):
    """Fails unless two calls of ``fn`` give bit-identical outputs."""
    import torch
    if not torch.equal(fn(*args), fn(*args)):
        fail(f"{name}: two calls on the same inputs differ")
    return True


def phase_kernels(dev, regs) -> dict:
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(0)
    k32 = torch.randn((NB, BS, H, D), generator=g, device=dev)
    v32 = torch.randn((NB, BS, H, D), generator=g, device=dev)
    perm = torch.randperm(NB - 1, generator=g, device=dev) + 1
    tables = perm[:8 * MB].view(8, MB).to(torch.int32).contiguous()
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    rows_seen = sum(p + 1 for p in DECODE_POS)
    # Timing inputs: TIME_SETS bf16 pools (33.6 MB of K+V each); every
    # set holds other values, so no set is a cached copy of another.
    pools = [(k32.bfloat16(), v32.bfloat16())] + [
        (torch.randn((NB, BS, H, D), generator=g, device=dev,
                     dtype=torch.bfloat16),
         torch.randn((NB, BS, H, D), generator=g, device=dev,
                     dtype=torch.bfloat16)) for _ in range(TIME_SETS - 1)]
    report = {}

    # -- paged decode ---------------------------------------------------
    rec = {"cases": []}
    q32 = torch.randn((8, H, D), generator=g, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        q, kp, vp = q32.to(dt), k32.to(dt), v32.to(dt)
        name = str(dt).split(".")[-1]
        err = check("paged decode",
                    da.paged_decode_attention(q, kp, vp, tables, pos),
                    da.reference_paged_decode_attention(q, kp, vp, tables,
                                                        pos),
                    name, f"paged_decode {name:8s} B=8 pos={DECODE_POS}")
        rec["cases"].append({"dtype": name, "max_abs_err": err,
                             "atol_rtol": TOL[name]})
    q = q32.bfloat16()
    # 8 sets x 13.8 MB read per call: 97 MB between two uses of a set.
    args = [(q, kp, vp, tables, pos) for kp, vp in pools]
    rec["deterministic"] = same_twice("paged decode",
                                      da.paged_decode_attention, args[0])
    rec["split"] = {"n_split": da.split_geometry(MB * BS)[1],
                    "one_cta": da._ONE_CTA}
    rec["ptxas"] = regs.get("paged_decode_kernel<bf16, 8, 1>")
    rec["ms"] = time_ms(da.paged_decode_attention, args)
    rec["plain_ms"] = time_ms(da.reference_paged_decode_attention, args)
    mask = (torch.arange(MB * BS, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    lib_args = [(q[:, :, None],
                 da.gather_kv_pages(kp, tables).transpose(1, 2).contiguous(),
                 da.gather_kv_pages(vp, tables).transpose(1, 2).contiguous(),
                 mask) for kp, vp in pools]
    rec["library_ms"] = time_ms(
        lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=m_), lib_args)
    del lib_args
    nbytes = (2 * q.numel() * 2 + rows_seen * H * D * 2 * 2
              + sum(p // BS + 1 for p in DECODE_POS) * 4 + 8 * 4)
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes, rows_seen * H * D * 4, torch.bfloat16)
    rec["shape"] = f"bf16 q[8,{H},{D}] pool[{NB},{BS},{H},{D}] pos={list(DECODE_POS)}"
    report["paged_decode"] = rec

    # -- paged multi-query (chunked prefill) ----------------------------
    rec = {"cases": []}
    table = tables[0].contiguous()
    for c, start in PREFILL_CASES:
        q32 = torch.randn((c, H, D), generator=g, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp = q32.to(dt), k32.to(dt), v32.to(dt)
            name = str(dt).split(".")[-1]
            extra = None
            if dt == torch.bfloat16:
                extra = 2 ** -8 * da.reference_paged_prefill_attention(
                    q.float(), kp.float(), vp.float().abs(), table, start)
            kernels = dict(da.LAUNCHES)
            got = da.paged_prefill_attention(q, kp, vp, table, start)
            want = "paged_mq_tc" if dt == torch.bfloat16 else "paged_mq_simt"
            if {k: da.LAUNCHES[k] - kernels[k] for k in kernels} != \
                    {k: int(k == want) for k in kernels}:
                fail(f"paged prefill {name} did not launch {want} once")
            err = check("paged prefill", got,
                        da.reference_paged_prefill_attention(q, kp, vp,
                                                             table, start),
                        name,
                        f"paged_prefill {name:8s} C={c:2d} start={start:3d}",
                        extra=extra)
            rec["cases"].append({"dtype": name, "C": c, "start": start,
                                 "max_abs_err": err, "atol_rtol": TOL[name]})
    c, start = PREFILL_CASES[-1]
    q = q32.bfloat16()
    s = start + c
    start_t = torch.full((1,), start, dtype=torch.int32, device=dev)
    # Each (pool set, table row) pair reads other memory: 64 pairs x
    # 4.2 MB read per call.
    rows = [tables[r].contiguous() for r in range(8)]
    args = [(q, kp, vp, t, start_t) for kp, vp in pools for t in rows]
    rec["deterministic"] = same_twice("paged prefill",
                                      da.paged_prefill_attention, args[0])
    rec["split"] = dict(zip(("ks", "n_split"), da.split_geometry(MB * BS)))
    rec["ptxas"] = regs.get("paged_mq_tc_kernel<64>")
    rec["ms"] = time_ms(da.paged_prefill_attention, args)
    rec["plain_ms"] = time_ms(da.reference_paged_prefill_attention, args)
    mask = (torch.arange(s, device=dev)[None, :]
            <= start + torch.arange(c, device=dev)[:, None])
    qh = q.transpose(0, 1)[None].contiguous()
    lib_args = [(qh,
                 da.gather_kv_pages(kp, t[None])[:, :s].transpose(1, 2)
                 .contiguous(),
                 da.gather_kv_pages(vp, t[None])[:, :s].transpose(1, 2)
                 .contiguous(), mask) for kp, vp in pools for t in rows]
    rec["library_ms"] = time_ms(
        lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=m_), lib_args)
    del lib_args
    seen = sum(start + i + 1 for i in range(c))
    nbytes = (2 * q.numel() * 2 + s * H * D * 2 * 2
              + (-(-s // BS)) * 4 + 4)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, seen * H * D * 4,
                                             torch.bfloat16)
    rec["shape"] = f"bf16 q[{c},{H},{D}] start={start} pool[{NB},{BS},{H},{D}]"
    report["paged_prefill"] = rec
    for name, r in report.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, sdpa (gather excluded) {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{r['shape']}]"
              f"; splits {r['split']}, bit-identical twice, ptxas "
              f"{r['ptxas']}")
    return report


def make_traffic(vocab: int, seed: int = 0):
    """17 requests: 8 share a 64-token prefix (the last repeats the first
    exactly, so its admission copies a shared block on write), 8 are
    unrelated 128-token prompts (one sampled at temperature 0.8), and one
    300-token prompt prefills in several 64-token chunks."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 64)
    reqs = []
    for i in range(8):
        p = (reqs[0][0] if i == 7 else
             np.concatenate([prefix, rng.integers(0, vocab, 64)]))
        reqs.append((p.astype(np.int32), 0.0))
    for i in range(8):
        reqs.append((rng.integers(0, vocab, 128).astype(np.int32),
                     0.8 if i == 3 else 0.0))
    reqs.append((rng.integers(0, vocab, 300).astype(np.int32), 0.0))
    return reqs


def warm_up(eng, spec: bool = False):
    """Requests through the engine ``eng`` that take every chunk bucket
    (`WARM_PROMPTS`) and, on a speculative engine, motif prompts that
    speculate; then the retrace sentinel is armed: any later build of a
    step is unexpected."""
    import numpy as np
    vocab = eng.cfg.vocab_size
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n) for n in WARM_PROMPTS]
    if spec:
        prompts += [p for p, _ in spec_traffic(vocab, 2, seed=9)]
    for batch in (prompts[:len(WARM_PROMPTS)], prompts[len(WARM_PROMPTS):]):
        for rid in [eng.submit(p, max_new_tokens=8) for p in batch]:
            list(eng.tokens_for(rid))
    eng.arm_retrace_sentinel()


def builds(before: dict, after: dict) -> dict:
    """Static-step builds (captures) between two ``stats()`` reads."""
    return {k: after[k] - before[k] for k in TRACE_KEYS}


def check_compile_once(eng, what: str) -> dict:
    """The engine's steps are CUDA graphs, each built once for the
    engine's whole life: decode at most once (spec off: once), verify
    and draft once where the engine speculates with them, prefill (and
    the draft's prefill) once per chunk bucket used, no build beyond the
    sentinel's allowances, and a graph pool."""
    st = eng.stats()
    used = {k: sorted(b for kind, b in eng._steps if kind == k)
            for k in ("prefill", "draft_prefill")}
    spec = eng.spec
    want_ok = (eng._captures() and st["retraces_unexpected"] == 0
               and st["graph_pool_bytes"] > 0
               and st["decode_traces"] == (1 if spec is None
                                           else min(st["decode_traces"], 1))
               and st["verify_traces"] == int(spec is not None)
               and st["draft_traces"] == int(spec == "draft")
               and st["prefill_traces"] == len(used["prefill"]) > 0
               and st["draft_prefill_traces"] == len(used["draft_prefill"]))
    out = {k: st[k] for k in (*TRACE_KEYS, "retraces_unexpected",
                              "graph_pool_bytes")}
    out["chunk_buckets"] = used["prefill"]
    if not want_ok:
        fail(f"{what}: compile-once broke: {out}")
    return out


def phase_engine(dev, cfg_kwargs, seed: int, new_tokens: int = 64):
    import numpy as np
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.serve import InferenceReplica

    t0 = time.perf_counter()
    replica = InferenceReplica(cfg_kwargs, slots=8, max_len=1024, seed=seed,
                               engine_kwargs=dict(block_size=16),
                               device=dev)
    eng = replica.engine
    torch.cuda.synchronize()
    print(f"  replica built in {time.perf_counter() - t0:.1f} s")
    # Warm-up outside the measured run: every step captured (the kernels
    # built, cuBLAS handles, the allocator), then the sentinel armed.
    t0 = time.perf_counter()
    warm_up(replica.engine)
    print(f"  warm-up (captures) {time.perf_counter() - t0:.1f} s")
    eng.reset_stats()
    st0 = eng.stats()

    reqs = make_traffic(cfg_kwargs["vocab_size"], seed)
    ops.reset_kernel_launches()
    # Every host<->device synchronisation in the run is recorded: the
    # engine promises exactly one per prefill chunk and per decode tick.
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        gens = [replica(p, max_new_tokens=new_tokens, temperature=t)
                for p, t in reqs]
        outs = [list(g) for g in gens]
        wall = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    syncs = sum("synchroniz" in str(w.message) for w in caught)

    st = eng.stats()
    built = builds(st0, st)
    eng.check_invariants()
    for i, o in enumerate(outs):
        if len(o) != new_tokens:
            fail(f"request {i} finished with {len(o)} tokens, "
                 f"wanted {new_tokens}")
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the main path")
    check_paged_launches(launches, cfg_kwargs["n_layers"], st, built)
    compile_once = check_compile_once(eng, "phase 2 engine")
    if st["prefix_hit_tokens"] <= 0 or st["cow_copies"] <= 0:
        fail(f"prefix sharing / copy-on-write did not run: "
             f"hit {st['prefix_hit_tokens']} cow {st['cow_copies']}")
    if st["blocks_in_use"] != st["cached_prefix_blocks"]:
        fail("blocks leaked after every request finished")
    # one sync a tick and a chunk; a capture in the window adds its own
    if syncs != st["decode_steps"] + st["prefill_chunks"] + sum(
            built.values()):
        fail(f"{syncs} host syncs for {st['decode_steps']} decode ticks, "
             f"{st['prefill_chunks']} prefill chunks and {built} builds "
             f"(want one each)")
    before = SERVING_BEFORE
    print(f"  {len(reqs)} requests, {st['decode_tokens']} decode tokens in "
          f"{wall:.2f} s wall; prefill {st['prefill_tok_s']:.1f} tok/s "
          f"(before split-K {before['prefill_tok_s']}), "
          f"decode {st['decode_tok_s']:.1f} tok/s, decode step "
          f"p50 {st['p50_token_latency_ms']:.3f} ms "
          f"({before['p50_token_latency_ms']}) "
          f"p99 {st['p99_token_latency_ms']:.3f} ms "
          f"({before['p99_token_latency_ms']}); launches {launches}; "
          f"{syncs} host syncs; compile-once {compile_once}")
    keep = ("prefill_tokens", "decode_tokens", "prefill_chunks",
            "decode_steps", "prefill_time_s", "decode_time_s",
            "prefill_tok_s", "decode_tok_s", "p50_token_latency_ms",
            "p99_token_latency_ms", "ttft_ms_p50", "ttft_ms_p99",
            "prefix_hit_tokens", "cow_copies", "slot_occupancy",
            "pool_bytes", "kv_bytes_per_token")
    summary = {k: st[k] for k in keep}
    summary.update(requests=len(reqs), wall_s=wall, launches=launches,
                   host_syncs=syncs, compile_once=compile_once,
                   builds_in_run=built)
    return replica, reqs, outs, summary


def phase_teacher_forced(dev, cfg_kwargs, seed, reqs, outs,
                         which=None) -> dict:
    """Engine logprobs (bf16, paged, kernels) vs a dense f32 forward with
    plain attention over prompt + emitted tokens, for the greedy requests
    at the indices ``which`` (default: the first and the last). Where the
    f32 reference's top-2 margin exceeds twice the tolerance, the
    engine's greedy token must be its argmax."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import gpt

    cfg = gpt.small(**{**cfg_kwargs, "dtype": "float32", "attn_impl": "xla"})
    ref = gpt.GPT(cfg, gpt.init_params(seed, cfg, dev))
    worst, checked, decisive = 0.0, 0, 0
    for i in ((0, len(reqs) - 1) if which is None else which):
        prompt, temp = reqs[i]
        if temp:
            fail("teacher-forced check wants greedy requests")
        toks = [int(t) for t in outs[i]]
        seq = torch.tensor(np.concatenate([prompt, toks[:-1]]),
                           dtype=torch.long, device=dev)[None]
        with torch.inference_mode():
            lp = torch.log_softmax(gpt.forward(ref, seq)[0], dim=-1)
        rows = lp[len(prompt) - 1:]
        ref_lp = rows.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0]
        eng_lp = torch.tensor([t.logprob for t in outs[i]], device=dev)
        err = (ref_lp - eng_lp).abs().max().item()
        top2 = rows.topk(2, dim=-1)
        margin = top2.values[:, 0] - top2.values[:, 1]
        sure = margin > 2 * LOGPROB_TOL
        agree = top2.indices[:, 0] == torch.tensor(toks, device=dev)
        if not bool(agree[sure].all()):
            fail(f"request {i}: greedy token differs from the f32 "
                 f"reference's argmax at a decisive position")
        worst = max(worst, err)
        checked += len(toks)
        decisive += int(sure.sum())
        print(f"  request {i}: {len(toks)} tokens, max|logprob engine - "
              f"f32 ref| = {err:.4f} (tol {LOGPROB_TOL}); ref logprob "
              f"spread {ref_lp.std().item():.3f}; "
              f"{int(sure.sum())} decisive positions agree")
    if not worst <= LOGPROB_TOL:
        fail(f"engine logprobs off the f32 reference by {worst:.4f}")
    return {"max_abs_logprob_err": worst, "tol": LOGPROB_TOL,
            "tokens_checked": checked, "decisive_tokens": decisive}


def check_paged_launches(launches: dict, layers: int, st: dict,
                         built: dict, int8: bool = False):
    """The bf16 engine's paged kernels: one split-K decode launch per
    layer a tick, one tensor-core multi-query launch per layer a prefill
    chunk, and never the CUDA-core multi-query kernel; on an int8 pool
    (``int8``) every one of them the int8 instance, else none. ``st``
    holds the window's ticks and chunks, ``built`` the builds of steps in
    the window (`builds`): each ran its step once eagerly before its
    capture. The engine counts a graph's launches at every replay
    (`ops.add_kernel_launches`); phase 4 reads the same launches by
    kernel name from the profiler."""
    ticks = st["decode_steps"] + built["decode_traces"]
    chunks = st["prefill_chunks"] + built["prefill_traces"]
    want = {"paged_decode_attention": layers * ticks,
            "paged_prefill_attention": layers * chunks,
            "paged_decode_int8": layers * ticks * int8,
            "paged_mq_tc": layers * chunks * (not int8),
            "paged_mq_tc_int8": layers * chunks * int8,
            "paged_mq_simt": 0, "paged_mq_simt_int8": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"paged kernel launches {got}, want {want}")


def phase_profile(replica, vocab: int, layers: int, seed: int = 2) -> dict:
    """Where the engine's time goes: 8 requests of 128 prompt + 32 new
    tokens under `torch.profiler`, device time summed by kernel name, and
    the device busy share (summed kernel time over wall time; one stream,
    so kernels do not overlap). The paged kernels' launches by name must
    be one per layer call: no merge kernel beside them."""
    import numpy as np

    eng = replica.engine
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, PROFILE_PROMPT) for _ in range(8)]
    eng.reset_stats()
    before = eng.stats()

    def serve():
        for p in prompts:
            eng.submit(p, max_new_tokens=PROFILE_NEW)
        eng.run_until_idle()

    _, prof = profile_window(serve)
    kernels, wall = prof["kernels"], prof["wall_s"]
    st = eng.stats()
    built = builds(before, st)
    by_name = {k: sum(n for name, _, n in kernels if f"::{k}<" in name)
               for k in ("paged_decode_kernel", "paged_mq_tc_kernel",
                         "paged_mq_kernel")}
    want = {"paged_decode_kernel": layers * (st["decode_steps"]
                                             + built["decode_traces"]),
            "paged_mq_tc_kernel": layers * (st["prefill_chunks"]
                                            + built["prefill_traces"]),
            "paged_mq_kernel": 0}
    if by_name != want:
        fail(f"profiled paged kernel launches {by_name}, want {want}")
    paged_ms = {k: sum(t for name, t, _ in kernels if f"::{k}<" in name)
                for k in by_name}
    out = {"wall_s": wall, "device_busy_s": prof["device_ms"] * 1e-3,
           "device_busy_share": prof["device_busy_share"],
           "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"],
           "paged_launches": by_name, "paged_device_ms": paged_ms,
           "top_kernels": top_kernels(kernels, 12)}
    print(f"  wall {wall * 1e3:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms ({out['device_busy_share']:.1%}; "
          f"before split-K {SERVING_BEFORE['device_busy_share']:.1%}); "
          f"{st['decode_steps']} decode ticks, {st['prefill_chunks']} "
          f"prefill chunks; paged kernels {by_name}, device ms "
          f"{ {k: round(v, 3) for k, v in paged_ms.items()} }")
    for k in out["top_kernels"]:
        print(f"    {k['device_ms']:9.3f} ms  {k['calls']:6d}  {k['name']}")
    return out


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def profile_window(fn, groups=()) -> tuple:
    """``fn()`` once under `torch.profiler`, after a synchronize and
    ended by one: ``(fn's result, record)``. The record holds the wall
    (s), each device kernel as (name, device ms, launches) by device
    time, the device's busy ms (summed kernel time; one stream, so
    kernels do not overlap) and busy share of the wall, the launches,
    and device ms by group: ``groups`` is a sequence of (label,
    substrings), and a kernel goes to the first label with a substring
    in its name, else to "other"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(((e.key, e.self_device_time_total * 1e-3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy = sum(ms for _, ms, _ in kernels)
    by_group = {}
    for name, ms, _ in kernels:
        g = next((label for label, keys in groups
                  if any(k in name for k in keys)), "other")
        by_group[g] = by_group.get(g, 0.0) + ms
    return result, {"wall_s": wall, "kernels": kernels, "device_ms": busy,
                    "device_busy_share": busy * 1e-3 / wall,
                    "launches": sum(n for _, _, n in kernels),
                    "device_ms_by_group": by_group}


def top_kernels(kernels, n: int) -> list:
    """The first ``n`` of `profile_window`'s kernels, as records."""
    return [{"name": k[:80], "device_ms": t, "calls": c}
            for k, t, c in kernels[:n]]


def flash_bound(t: int, causal: bool, which: str, dtype) -> tuple[float, str]:
    """Least time for one flash kernel at [FB, t, FH, FD]: each input
    read once and each output written once (q/k/v/dO/out/dq/dk/dv are
    [B, T, H, D] in the working dtype, lse/delta [B*H, T] f32), against
    4/6/8 * D flops per visible (query, key) pair (forward: q.k and p.v;
    dQ adds dO.v; dK/dV adds both products into dk and dv)."""
    import torch
    es = 2 if dtype == torch.bfloat16 else 4
    act = FB * t * FH * FD * es
    row = FB * FH * t * 4
    pairs = FB * FH * (t * (t + 1) // 2 if causal else t * t)
    nbytes, per_pair = {"fwd": (4 * act + row, 4),
                        "dq": (5 * act + 2 * row, 6),
                        "dkv": (6 * act + 2 * row, 8)}[which]
    return bound(nbytes, per_pair * FD * pairs, dtype)


def flash_case(g, dev, b: int, t: int, h: int, d: int, causal: bool,
               name: str) -> dict:
    """The three flash kernels against their plain versions on random
    [b, t, h, d] inputs of dtype ``name`` (bf16 at D 64 and 128 on the
    tensor cores, within FLASH_TOL plus their extra roundings): each
    kernel's case record with its max |kernel - plain|."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    dt = getattr(torch, name)
    tc = dt == torch.bfloat16 and d in (64, 128)
    q, k, v, do = (torch.randn((b, t, h, d), generator=g,
                               device=dev).to(dt) for _ in range(4))
    what = f"{name:8s} B={b} T={t} H={h} D={d} causal={causal!s:5s}"
    case = {"dtype": name, "B": b, "T": t, "H": h, "D": d, "causal": causal,
            "kernel": "tc" if tc else "simt"}
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal=causal)
    extra = None
    if dt == torch.bfloat16:
        extra = 2 ** -8 * fa.flash_forward_reference(
            q.float(), k.float(), v.float().abs(), causal=causal)[0]
    errs = [check("flash forward", out, ref_out, name,
                  f"flash fwd out {what}", FLASH_TOL, extra),
            check("flash forward", lse, ref_lse, "float32",
                  f"flash fwd lse {what}", FLASH_TOL)]
    rec = {"fwd": {**case, "max_abs_err": max(errs)}}
    del extra
    delta = fa.attention_delta(ref_out, do)
    dq = fa.flash_dq(q, k, v, do, ref_lse, delta, causal=causal)
    dk, dv = fa.flash_dkv(q, k, v, do, ref_lse, delta, causal=causal)
    rdq, rdk, rdv = fa.flash_backward_reference(q, k, v, do, ref_lse,
                                                delta, causal=causal)
    bq = bk = bv = None
    if tc:
        bq, bk, bv = (2 ** -8 * x for x in fa.flash_backward_abs_bound(
            q, k, v, do, ref_lse, delta, causal=causal))
    e = check("flash dq", dq, rdq, name, f"flash dq      {what}",
              FLASH_TOL, bq, "2^-8*sm|dS||K|")
    rec["dq"] = {**case, "max_abs_err": e}
    e = max(check("flash dkv", dk, rdk, name, f"flash dk      {what}",
                  FLASH_TOL, bk, "2^-8*sm|dS|^T|Q|"),
            check("flash dkv", dv, rdv, name, f"flash dv      {what}",
                  FLASH_TOL, bv, "2^-8*|P|^T|dO|"))
    rec["dkv"] = {**case, "max_abs_err": e}
    del q, k, v, do, out, lse, ref_out, ref_lse, delta, dq, dk, dv
    del rdq, rdk, rdv, bq, bk, bv
    torch.cuda.empty_cache()
    return rec


def phase_flash(dev) -> dict:
    """Phase 5: the three flash kernels against their plain versions at
    the training shape, then their times beside bound, plain and SDPA."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(5)
    rec = {k: {"cases": []} for k in ("fwd", "dq", "dkv")}
    for t, causal, name, d in FLASH_CASES:
        for key, case in flash_case(g, dev, FB, t, FH, d, causal,
                                    name).items():
            rec[key]["cases"].append(case)

    # Times at the main path's case: bf16, causal, T 1024. Three input
    # sets of 67 MB each, so a set is cold in the 50 MB L2 when reused.
    dt = torch.bfloat16
    sets = []
    for _ in range(3):
        q, k, v, do = (torch.randn((FB, FT, FH, FD), generator=g,
                                   device=dev).to(dt) for _ in range(4))
        out, lse = fa.flash_forward_reference(q, k, v, causal=True)
        sets.append((q, k, v, do, lse, fa.attention_delta(out, do)))
    fwd_args = [(q, k, v) for q, k, v, *_ in sets]
    bwd_args = sets
    rec["fwd"]["ms"] = time_ms(
        lambda q, k, v: fa.flash_forward(q, k, v, causal=True), fwd_args)
    rec["fwd"]["plain_ms"] = time_ms(
        lambda q, k, v: fa.flash_forward_reference(q, k, v, causal=True),
        fwd_args)
    rec["dq"]["ms"] = time_ms(
        lambda *a: fa.flash_dq(*a, causal=True), bwd_args)
    rec["dkv"]["ms"] = time_ms(
        lambda *a: fa.flash_dkv(*a, causal=True), bwd_args)
    plain_bwd = time_ms(
        lambda *a: fa.flash_backward_reference(*a, causal=True), bwd_args)
    # the plain backward computes dq, dk and dv together
    rec["dq"]["plain_ms"] = rec["dkv"]["plain_ms"] = plain_bwd
    # SDPA on [B, H, T, D], layouts prepared beforehand (not timed).
    lib = []
    for q, k, v, do, *_ in sets:
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        lib.append((qh, kh, vh, oh, do.transpose(1, 2).contiguous()))
    rec["fwd"]["library_ms"] = time_ms(
        lambda qh, kh, vh, *_: F.scaled_dot_product_attention(
            qh.detach(), kh.detach(), vh.detach(), is_causal=True), lib)
    lib_bwd = time_ms(
        lambda qh, kh, vh, oh, doh: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True), lib)
    # one SDPA backward computes dq, dk and dv together
    rec["dq"]["library_ms"] = rec["dkv"]["library_ms"] = lib_bwd
    del lib, sets, fwd_args, bwd_args
    torch.cuda.empty_cache()
    for key in rec:
        rec[key]["bound_ms"], rec[key]["bound_by"] = flash_bound(
            FT, True, key, dt)
        r = rec[key]
        print(f"  flash {key}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
              f"[bf16 causal B={FB} T={FT} H={FH} D={FD}]")
    return rec


def _train_cfg(**kw):
    from ray_tpu_torch.models import gpt
    return gpt.GPTConfig(**{**dict(
        vocab_size=50304, d_model=1024, n_layers=12, n_heads=16, d_ff=4096,
        max_seq_len=1024, dtype="bfloat16", attn_impl="flash",
        logits_dtype="bfloat16", remat=True, remat_policy="dots",
        loss_impl="dense"), **kw})


def _host_batches(cfg, batch: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, cfg.vocab_size,
                            (batch, cfg.max_seq_len + 1)).astype(np.int32)
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _loss_and_grads(model, batch, cfg) -> tuple[float, list]:
    import torch
    from ray_tpu_torch.train import spmd
    loss = spmd.gpt_loss_fn(model, batch, cfg)
    return loss.item(), torch.autograd.grad(loss, list(model.parameters()))


def _grad_rel(model, ga, gb) -> dict:
    """Each leaf's relative Frobenius gap between two gradient lists."""
    return {n: ((x.float() - y.float()).norm()
                / y.float().norm().clamp_min(1e-30)).item()
            for (n, _), x, y in zip(model.named_parameters(), ga, gb)}


def _compare_runs(what, model, a, b) -> dict:
    """Loss and every gradient leaf of two runs of one model, each a
    (loss, grads) pair, held to TRAIN_LOSS_TOL and TRAIN_GRAD_REL_TOL."""
    dloss = abs(a[0] - b[0])
    rel = _grad_rel(model, a[1], b[1])
    worst = max(rel, key=rel.get)
    print(f"  {what}: loss {a[0]:.6f} vs {b[0]:.6f}, |diff| {dloss:.2e} "
          f"(limit {TRAIN_LOSS_TOL}); worst leaf gradient rel. error "
          f"{rel[worst]:.2e} ({worst}, limit {TRAIN_GRAD_REL_TOL})")
    if not dloss <= TRAIN_LOSS_TOL:
        fail(f"{what}: losses differ by {dloss}")
    if not rel[worst] <= TRAIN_GRAD_REL_TOL:
        fail(f"{what}: gradient of {worst} off by {rel[worst]}")
    return {"loss": a[0], "loss_plain": b[0], "loss_abs_diff": dloss,
            "grad_rel_err": rel, "grad_rel_err_max": rel[worst]}


def check_flash_backward_launches(launches, steps: int, layers: int):
    """A bf16 training run at D 64: per step one tensor-core dQ and one
    dK/dV launch per layer, and no CUDA-core flash kernel."""
    for name in ("flash_dq_tc", "flash_dkv_tc"):
        if launches[name] != steps * layers:
            fail(f"{name} launched {launches[name]} times in {steps} steps "
                 f"of {layers} layers (want {steps * layers})")
    for name in ("flash_fwd_simt", "flash_dq_simt", "flash_dkv_simt"):
        if launches[name]:
            fail(f"the bf16 training path ran {name} (CUDA cores)")


def phase_train(dev) -> dict:
    """Phase 6: training at full width (see the module docstring)."""
    import dataclasses
    import math

    import torch

    from ray_tpu_torch import ops
    from ray_tpu_torch.train import loop, spmd

    cfg = _train_cfg()
    batch, unroll, prefetch, interval = 8, 2, 2, 4
    out = {"config": dataclasses.asdict(cfg), "batch": batch,
           "unroll": unroll, "prefetch": prefetch, "interval": interval}

    # (a) + (b): one batch, flash against plain attention, same masters.
    t0 = time.perf_counter()
    state, step_fn, place = spmd.make_gpt_trainer(cfg, seed=0, device=dev)
    model = state.params
    b0 = place(next(_host_batches(cfg, batch, seed=1)))
    res = {impl: _loss_and_grads(model, b0,
                                 dataclasses.replace(cfg, attn_impl=impl))
           for impl in ("flash", "xla")}
    cmp = _compare_runs("(a) flash vs plain attention", model, res["flash"],
                        res["xla"])
    ln_v = math.log(cfg.vocab_size)
    want0 = ln_v + cfg.d_model * 0.02 ** 2 / 2
    print(f"  (b) step-0 loss {res['flash'][0]:.4f}: ln(vocab) {ln_v:.4f}, "
          f"+ sigma^2/2 of the init's logits = {want0:.4f} (limit "
          f"{STEP0_LOSS_TOL})")
    if not abs(res["flash"][0] - want0) <= STEP0_LOSS_TOL:
        fail(f"step-0 loss {res['flash'][0]} is not near {want0}")
    out.update(loss_flash=cmp["loss"], loss_plain=cmp["loss_plain"],
               loss_abs_diff=cmp["loss_abs_diff"],
               grad_rel_err=cmp["grad_rel_err"],
               grad_rel_err_max=cmp["grad_rel_err_max"],
               step0_loss=res["flash"][0], step0_expected=want0,
               ln_vocab=ln_v)
    del res
    torch.cuda.empty_cache()
    out["check_s"] = time.perf_counter() - t0

    # (c) the trainer through the prefetcher and the loop.
    tokens_per_step = batch * cfg.max_seq_len
    flops_step = spmd.train_flops_per_token(cfg, cfg.max_seq_len) \
        * tokens_per_step
    batches = loop.DevicePrefetcher(_host_batches(cfg, batch, seed=2),
                                    place, depth=prefetch, group=unroll)
    train = loop.TrainLoop(step_fn, unroll=unroll, metrics_interval=interval,
                           flops_per_step=flops_step, device=dev)
    t0 = time.perf_counter()
    state, warm = train.run(state, batches, num_steps=2 * unroll)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    steps = 12
    ops.reset_kernel_launches()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        state, hist = train.run(state, batches, num_steps=steps)
        wall = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    launches = ops.kernel_launches()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    fetches = train.last_ring.fetches
    losses = [float(m["loss"]) for m in hist]
    if len(hist) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"train loop returned {len(hist)} steps, losses {losses}")
    for name in ("flash_forward", "flash_fwd_tc", "flash_dq", "flash_dkv"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the training path")
    check_flash_backward_launches(launches, steps, cfg.n_layers)
    tok_s = tokens_per_step * steps / wall
    mfu = train.last_mfu
    print(f"  (c) warm-up {2 * unroll} steps in {warm_s:.1f} s; {steps} "
          f"steps in {wall:.3f} s: {wall / steps * 1e3:.1f} ms/step, "
          f"{tok_s:.0f} tok/s, MFU {mfu:.4f} (of 989 TFLOP/s); losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"      host syncs {syncs} ({fetches} metric fetches); "
          f"launches {launches}")
    print(f"      breakdown {json.dumps(train.last_breakdown)}")
    if syncs > fetches:
        fail(f"{syncs} host syncs in {steps} steps, the metrics ring made "
             f"{fetches} fetches (want none outside them)")
    out.update(warmup_s=warm_s, steps=steps, wall_s=wall,
               step_ms=wall / steps * 1e3, tok_s=tok_s, mfu=mfu,
               breakdown=train.last_breakdown, host_syncs=syncs,
               metric_fetches=fetches, launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()},
               losses=losses,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    # Device busy share and time by kernel over one dispatch (2 steps).
    (state, _), prof = profile_window(
        lambda: train.run(state, batches, num_steps=unroll),
        (("flash", ("flash_",)),))
    busy = prof["device_ms"]
    flash = prof["device_ms_by_group"].get("flash", 0.0)
    print(f"      profiled {unroll} steps: wall {prof['wall_s'] * 1e3:.1f} "
          f"ms, device busy {busy:.1f} ms ({prof['device_busy_share']:.1%}); "
          f"flash kernels {flash:.1f} ms "
          f"({flash / max(busy, 1e-9):.1%} of device time)")
    for n, t, c in prof["kernels"][:12]:
        print(f"    {t:9.3f} ms  {c:6d}  {n[:80]}")
    out["profile"] = {
        "wall_s": prof["wall_s"], "device_busy_s": busy * 1e-3,
        "device_busy_share": prof["device_busy_share"],
        "flash_share_of_device": flash / max(busy, 1e-9),
        "top_kernels": top_kernels(prof["kernels"], 16)}
    del state, step_fn, model, batches, train, prof, b0
    torch.cuda.empty_cache()

    # (d) overfit one repeated batch: 5 warm-up steps, then 20.
    opt = spmd.default_optimizer(learning_rate=1e-3, warmup_steps=5,
                                 total_steps=25)
    state, step_fn, place = spmd.make_gpt_trainer(cfg, seed=3, device=dev,
                                                  optimizer=opt)
    one = place(next(_host_batches(cfg, batch, seed=4)))
    fit = []
    for _ in range(25):
        state, m = step_fn(state, one)
        fit.append(m["loss"])
    fit = [x.item() for x in fit]
    drop = fit[0] - fit[-1]
    print(f"  (d) one batch, 25 steps: loss {fit[0]:.4f} -> {fit[-1]:.4f} "
          f"(drop {drop:.3f}, want >= {OVERFIT_DROP})")
    if not drop >= OVERFIT_DROP:
        fail(f"overfitting one batch lowered the loss by only {drop}")
    out.update(overfit_losses=fit, overfit_drop=drop)
    del state, step_fn, one
    torch.cuda.empty_cache()
    return out


def xent_bound(n: int, v: int, d: int, which: str, dtype) -> tuple[float, str]:
    """Least time for one fused-xent function: its inputs read once in
    their dtype (x [n, d], E [v, d]; the [n] rows: targets, and lse and
    the two cotangents for the backward; the bf16 dlog [n, v] for the dx
    and dE products), its outputs written once (lse and tgt; the bf16
    dlog; dx [n, d] f32; dE [v, d] f32), and 2 n v d flops per product:
    one for the forward and for each of the three backward kernels
    (dlog, dx, dE), six for the backward pair as one function."""
    import torch
    es = 2 if dtype == torch.bfloat16 else 4
    x, e, dlog = n * d * es, v * d * es, 2 * n * v
    nbytes, ops = {"fwd": (x + e + 4 * n + 8 * n, 2),
                   "dlog": (x + e + 16 * n + dlog, 2),
                   "dx": (dlog + e + 4 * n * d, 2),
                   "de": (dlog + x + 4 * v * d, 2),
                   "bwd": (x + e + 16 * n + 4 * n * d + 4 * v * d, 6)}[which]
    return bound(nbytes, ops * n * v * d, dtype)


def _xent_inputs(g, dev, n, v, dtype):
    """x at unit scale and embedding rows N(0, 0.02^2), as the model's
    final-norm activations and its init give them."""
    import torch
    x = torch.randn((n, XD), generator=g, device=dev).to(dtype)
    e = (torch.randn((v, XD), generator=g, device=dev) * 0.02).to(dtype)
    t = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    return x, e, t


def _xent_check(what, got, ref, rounding=None) -> float:
    diff = (got.float() - ref.float()).abs()
    limit = XENT_TOL * (ref.abs().max() + ref.abs())
    if rounding is not None:
        limit = limit + 2 ** -8 * rounding
    err = diff.max().item()
    print(f"  {what}: max|kernel-plain| = {err:.3e} (limit {XENT_TOL} * "
          f"(max|plain| + |plain|){' + 2^-8 * bound' if rounding is not None else ''}"
          f", max|plain| {ref.abs().max().item():.3e})")
    if not (diff - limit).max().item() <= 0:
        fail(f"fused-xent kernel disagrees with plain ({what})")
    return err


def device_ms_by_kernel(fn, args, launches: dict, reps: int = 3) -> dict:
    """{kernel: {"ms": device ms per call of fn, "records": launches the
    profiler recorded, "launched": launches made}} for each kernel name
    in `launches` (name -> launches per call of fn), from torch.profiler
    over `reps` calls: the mean device time of a recorded launch times
    the launches per call, so a launch the profiler did not record
    cannot shrink the time (the two counts show whether one was lost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # The profiler has missed the first 3 launches of a window on an
        # H100: short spin kernels take their place.
        for _ in range(4):
            torch.cuda._sleep(1000)
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    out = {k: {"ms": 0.0, "records": 0, "launched": n * reps}
           for k, n in launches.items()}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for k, rec in out.items():
            if f"{k}_kernel" in e.key:
                rec["ms"] += e.self_device_time_total * 1e-3
                rec["records"] += e.count
    for k, rec in out.items():
        if not rec["records"]:
            fail(f"the profiler recorded no launch of {k}_kernel")
        rec["ms"] *= launches[k] / rec["records"]
    return out


def phase_xent(dev) -> dict:
    """Phase 7: the fused cross-entropy kernels against their plain
    versions at bench.py's loss shape (bf16 and f32) and a ragged one,
    then their times beside bound, plain and cuBLAS."""
    import torch
    from ray_tpu_torch.ops import fused_xent as fx

    g = torch.Generator(device=dev).manual_seed(7)
    rec = {k: {"cases": []} for k in ("fwd", "dx", "de")}
    for n, v, dt in ((XN, XV, torch.bfloat16), (XN, XV, torch.float32),
                     (*XENT_RAGGED, torch.bfloat16)):
        name = str(dt).split(".")[-1]
        x, e, t = _xent_inputs(g, dev, n, v, dt)
        what = f"{name:8s} N={n} V={v}"
        lse, tgt = fx.fused_xent_fwd(x, e, t)
        ref_lse, ref_tgt = fx.lse_target_reference(x, e, t)
        err = max(_xent_check(f"xent fwd lse {what}", lse, ref_lse),
                  _xent_check(f"xent fwd tgt {what}", tgt, ref_tgt))
        rec["fwd"]["cases"].append({"dtype": name, "N": n, "V": v,
                                    "max_abs_err": err})
        del lse, tgt
        cl = torch.full((n,), 1.0 / n, device=dev)
        args = (x, e, t, ref_lse, cl, -cl)
        # bf16: the kernels round dlog to bf16 once (bf16's unit roundoff
        # 2^-8 times |dlog| . |E| for dx, |dlog|^T . |x| for dE)
        rounding = (fx.xent_backward_abs_bound(*args)
                    if dt == torch.bfloat16 else (None, None))
        grads = fx.fused_xent_bwd(*args)
        for key, got, ref, r in zip(("dx", "de"), grads,
                                    fx.xent_backward_reference(*args),
                                    rounding):
            rec[key]["cases"].append({
                "dtype": name, "N": n, "V": v,
                "max_abs_err": _xent_check(f"xent {key}      {what}", got,
                                           ref, r)})
        del x, e, t, grads, rounding, ref_lse, ref_tgt, cl, args
        torch.cuda.empty_cache()

    # Times at the main path's case: bf16, N 24576, V 50304, D 1024. One
    # input set (x 50 MB + E 103 MB) already exceeds the 50 MB L2.
    dt = torch.bfloat16
    x, e, t = _xent_inputs(g, dev, XN, XV, dt)
    lse, _ = fx.lse_target_reference(x, e, t)
    cl = torch.full((XN,), 1.0 / XN, device=dev)
    bwd = (x, e, t, lse, cl, -cl)
    rec["fwd"]["ms"] = time_long_ms(fx.fused_xent_fwd, (x, e, t))
    rec["fwd"]["plain_ms"] = time_long_ms(fx.lse_target_reference, (x, e, t))
    # the forward's two kernels: tile partials, then their merge
    rec["fwd"]["kernels"] = device_ms_by_kernel(
        fx.fused_xent_fwd, (x, e, t), {"xent_fwd_tc": 1, "xent_fwd_merge": 1})
    rec["fwd"]["workspace_mib"] = -(-XV // 256) * XN * 8 / 2 ** 20
    whole = {"ms": time_long_ms(fx.fused_xent_bwd, bwd),
             "plain_ms": time_long_ms(fx.xent_backward_reference, bwd)}
    # each backward kernel's device time, summed over its launches (one
    # per vocabulary chunk) in one backward
    chunks = -(-XV // fx.BWD_CHUNK)
    parts = device_ms_by_kernel(fx.fused_xent_bwd, bwd,
                                dict.fromkeys(("xent_dlog", "xent_dx",
                                               "xent_de"), chunks))
    for p in parts.values():
        p["launches_per_call"] = chunks
    # cuBLAS (bf16 in, bf16 out, f32 accumulation) for the same products:
    # the logits s = x . E^T (the forward's and the dlog kernel's), s . E
    # (dx's), s^T . x (dE's), and the three in a row (the backward). Timed
    # here only; the port never calls it.
    rec["fwd"]["library_ms"] = parts["xent_dlog"]["library_ms"] = \
        time_long_ms(lambda a, b: a @ b.t(), (x, e))
    s = x @ e.t()
    parts["xent_dx"]["library_ms"] = time_long_ms(lambda a, b: a @ b, (s, e))
    parts["xent_de"]["library_ms"] = time_long_ms(lambda a, b: a.t() @ b,
                                                  (s, x))
    del s
    whole["library_ms"] = time_long_ms(
        lambda a, b: (lambda s: (s @ b, s.t() @ a))(a @ b.t()), (x, e))
    del x, e, t, lse, cl, bwd
    torch.cuda.empty_cache()
    rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = xent_bound(
        XN, XV, XD, "fwd", dt)
    whole["bound_ms"], whole["bound_by"] = xent_bound(XN, XV, XD, "bwd", dt)
    for k, p in parts.items():
        p["bound_ms"], p["bound_by"] = xent_bound(XN, XV, XD,
                                                  k.split("_")[1], dt)
    # The TPU's _dx_kernel and _de_kernel each rebuild dlog; here one
    # kernel rebuilds it for both, so each row takes its own product's
    # kernel and half of the shared dlog kernel (the rows add up to the
    # whole backward). Plain: the whole plain backward, which computes
    # both.
    half = parts["xent_dlog"]
    for key in ("dx", "de"):
        own = parts[f"xent_{key}"]
        rec[key].update(
            ms=own["ms"] + half["ms"] / 2, plain_ms=whole["plain_ms"],
            library_ms=own["library_ms"] + half["library_ms"] / 2,
            bound_ms=own["bound_ms"] + half["bound_ms"] / 2,
            bound_by=own["bound_by"])
    rec["bwd"], rec["bwd_kernels"] = whole, parts
    shape = f"[bf16 N={XN} V={XV} D={XD}]"
    fk = rec["fwd"]["kernels"]
    print(f"  xent fwd: kernels {rec['fwd']['ms']:.3f} ms (xent_fwd_tc "
          f"{fk['xent_fwd_tc']['ms']:.3f} + xent_fwd_merge "
          f"{fk['xent_fwd_merge']['ms']:.3f}, profiler records "
          f"{fk['xent_fwd_tc']['records']}/{fk['xent_fwd_tc']['launched']} "
          f"and {fk['xent_fwd_merge']['records']}/"
          f"{fk['xent_fwd_merge']['launched']}; workspace "
          f"{rec['fwd']['workspace_mib']:.1f} MiB), plain "
          f"{rec['fwd']['plain_ms']:.3f} ms, cuBLAS "
          f"{rec['fwd']['library_ms']:.3f} ms, bound "
          f"{rec['fwd']['bound_ms']:.3f} ms ({rec['fwd']['bound_by']}) {shape}")
    for k, p in parts.items():
        print(f"  {k}_kernel x {chunks} ({p['records']}/{p['launched']} "
              f"profiler records): {p['ms']:.3f} ms, cuBLAS "
              f"{p['library_ms']:.3f} ms, bound {p['bound_ms']:.3f} ms "
              f"({p['bound_by']}) {shape}")
    print(f"  xent backward (dlog + dx + dE): {whole['ms']:.3f} ms, plain "
          f"{whole['plain_ms']:.3f} ms, cuBLAS (s = x@E^T; s@E; s^T@x) "
          f"{whole['library_ms']:.3f} ms, bound {whole['bound_ms']:.3f} ms "
          f"({whole['bound_by']}) {shape}")
    return rec


def phase_fused_train(dev) -> dict:
    """Phase 8: bench.py's training configuration at full width, fused
    loss at batch 24 (see the module docstring)."""
    import dataclasses
    import math

    import torch

    from ray_tpu_torch import ops
    from ray_tpu_torch.train import loop, spmd

    cfg = _train_cfg(loss_impl="fused")
    batch, unroll, prefetch, interval = 24, 4, 2, 10
    out = {"config": dataclasses.asdict(cfg), "batch": batch,
           "unroll": unroll, "prefetch": prefetch, "interval": interval}

    # (a), (b), (d): one batch, fused against dense loss from the same
    # masters, with the peak memory of each forward + backward.
    state, step_fn, place = spmd.make_gpt_trainer(cfg, seed=0, device=dev)
    model = state.params
    b0 = place(next(_host_batches(cfg, batch, seed=11)))
    res, peak = {}, {}
    for impl in ("fused", "dense"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res[impl] = _loss_and_grads(model, b0,
                                    dataclasses.replace(cfg, loss_impl=impl))
        torch.cuda.synchronize()
        peak[impl] = torch.cuda.max_memory_allocated() - base
    # The fused loss keeps the unembed in f32 from bf16 operands; the
    # dense one rounds the logits and their cotangent to bf16: they
    # differ like two bf16 runs (phase 6's limits).
    cmp = _compare_runs("(a) fused vs dense loss", model, res["fused"],
                        res["dense"])
    want0 = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    print(f"  (b) step-0 loss {res['fused'][0]:.4f}, expected {want0:.4f} "
          f"(limit {STEP0_LOSS_TOL})")
    if not abs(res["fused"][0] - want0) <= STEP0_LOSS_TOL:
        fail(f"step-0 loss {res['fused'][0]} is not near {want0}")
    logits_bytes = batch * cfg.max_seq_len * cfg.vocab_size * 2
    print(f"  (d) peak memory of one forward + backward at batch {batch}: "
          f"fused {peak['fused'] / 2**30:.2f} GiB, dense "
          f"{peak['dense'] / 2**30:.2f} GiB (dense - fused "
          f"{(peak['dense'] - peak['fused']) / 2**30:.2f} GiB, want >= the "
          f"bf16 logits' {logits_bytes / 2**30:.2f} GiB)")
    if not peak["dense"] - peak["fused"] >= logits_bytes:
        fail("the fused loss does not save the logits' memory")
    out.update(loss_fused=cmp["loss"], loss_dense=cmp["loss_plain"],
               loss_abs_diff=cmp["loss_abs_diff"],
               grad_rel_err=cmp["grad_rel_err"],
               grad_rel_err_max=cmp["grad_rel_err_max"],
               step0_loss=res["fused"][0],
               step0_expected=want0, peak_fused_gib=peak["fused"] / 2**30,
               peak_dense_gib=peak["dense"] / 2**30,
               logits_bf16_gib=logits_bytes / 2**30)
    del res
    torch.cuda.empty_cache()

    # (c) the trainer through the prefetcher and the loop.
    tokens_per_step = batch * cfg.max_seq_len
    flops_step = spmd.train_flops_per_token(cfg, cfg.max_seq_len) \
        * tokens_per_step
    batches = loop.DevicePrefetcher(_host_batches(cfg, batch, seed=12),
                                    place, depth=prefetch, group=unroll)
    train = loop.TrainLoop(step_fn, unroll=unroll, metrics_interval=interval,
                           flops_per_step=flops_step, device=dev)
    t0 = time.perf_counter()
    state, _ = train.run(state, batches, num_steps=FUSED_WARMUP)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        state, hist = train.run(state, batches, num_steps=FUSED_STEPS)
        wall = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    launches = ops.kernel_launches()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    fetches = train.last_ring.fetches
    losses = [float(m["loss"]) for m in hist]
    if len(hist) != FUSED_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"train loop returned {len(hist)} steps, losses {losses}")
    for name in ("flash_forward", "flash_fwd_tc", "flash_dq", "flash_dkv",
                 "fused_xent_fwd", "xent_fwd_tc", "xent_fwd_merge",
                 "xent_dlog", "xent_dx", "xent_de"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the fused training path")
    if launches["xent_fwd_simt"]:
        fail("the bf16 fused training path ran xent_fwd_simt (CUDA cores)")
    check_flash_backward_launches(launches, FUSED_STEPS, cfg.n_layers)
    tok_s = tokens_per_step * FUSED_STEPS / wall
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  (c) warm-up {FUSED_WARMUP} steps in {warm_s:.1f} s; "
          f"{FUSED_STEPS} steps in {wall:.3f} s: "
          f"{wall / FUSED_STEPS * 1e3:.1f} ms/step, {tok_s:.0f} tok/s, MFU "
          f"{train.last_mfu:.4f} (of 989 TFLOP/s); losses {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}; peak memory {peak_gib:.1f} GiB")
    print(f"      host syncs {syncs} ({fetches} metric fetches); "
          f"launches {launches}")
    print(f"      breakdown {json.dumps(train.last_breakdown)}")
    if syncs > fetches:
        fail(f"{syncs} host syncs in {FUSED_STEPS} steps, the metrics ring "
             f"made {fetches} fetches (want none outside them)")
    out.update(warmup_s=warm_s, steps=FUSED_STEPS, wall_s=wall,
               step_ms=wall / FUSED_STEPS * 1e3, tok_s=tok_s,
               mfu=train.last_mfu, breakdown=train.last_breakdown,
               host_syncs=syncs, metric_fetches=fetches, launches=launches,
               launches_per_step={k: v / FUSED_STEPS
                                  for k, v in launches.items()},
               losses=losses, peak_mem_gib=peak_gib)

    # (e) device busy share and time by kernel over one dispatch.
    (state, _), prof = profile_window(
        lambda: train.run(state, batches, num_steps=unroll),
        (("xent", ("xent_",)), ("flash", ("flash_",))))
    kernels, busy = prof["kernels"], prof["device_ms"]
    xent = prof["device_ms_by_group"].get("xent", 0.0)
    flash = prof["device_ms_by_group"].get("flash", 0.0)
    print(f"  (e) profiled {unroll} steps: wall {prof['wall_s'] * 1e3:.1f} "
          f"ms, device busy {busy:.1f} ms ({prof['device_busy_share']:.1%}); "
          f"fused-xent kernels {xent:.1f} ms "
          f"({xent / max(busy, 1e-9):.1%} of device time), flash "
          f"{flash:.1f} ms ({flash / max(busy, 1e-9):.1%})")
    for n, t, c in kernels[:12]:
        print(f"    {t:9.3f} ms  {c:6d}  {n[:80]}")
    # device time of each of the port's kernels over the window
    ours = {}
    for n, t, c in kernels:
        m = re.search(r"(\w+_kernel)\b", n)
        if m and ("flash_" in n or "xent_" in n):
            k = ours.setdefault(m.group(1), {"device_ms": 0.0, "calls": 0})
            k["device_ms"] += t
            k["calls"] += c
    print("      the port's kernels over the window: " + ", ".join(
        f"{k} {v['device_ms']:.1f} ms ({v['calls']})"
        for k, v in sorted(ours.items(), key=lambda kv: -kv[1]["device_ms"])))
    out["profile"] = {
        "wall_s": prof["wall_s"], "device_busy_s": busy * 1e-3,
        "device_busy_share": prof["device_busy_share"],
        "kernel_device_ms": ours,
        "xent_share_of_device": xent / max(busy, 1e-9),
        "flash_share_of_device": flash / max(busy, 1e-9),
        "top_kernels": top_kernels(kernels, 16)}
    del state, step_fn, model, batches, train, prof, b0
    torch.cuda.empty_cache()
    return out


def unpaged_traffic(vocab: int, seed: int = 0):
    """Phase 9 (b)'s requests: 8 prompts of 100-300 tokens, then slot 5
    prefilled again with 150: (the 8 prompt lengths, the prompts, the
    slot, its new prompt)."""
    import numpy as np
    rng = np.random.default_rng(seed + 9)
    lens = rng.integers(100, 301, 8)
    prompts = [rng.integers(0, vocab, n) for n in lens]
    slot, again = 5, rng.integers(0, vocab, 150)
    return lens, prompts, slot, again


def unpaged_contexts(vocab: int, seed: int = 0) -> list:
    """pos of phase 9 (b)'s decode steps CONTEXT_STEPS: row b at its
    prompt length (after the slot prefill) + i, i of the 64 steps."""
    lens, _, slot, again = unpaged_traffic(vocab, seed)
    lens[slot] = len(again)
    return [[int(n) + i for n in lens] for i in CONTEXT_STEPS]


def decode_record(dev, fn, plain, sets, rows_seen: float) -> dict:
    """Device time of ``fn`` over ``sets`` (q, k, v, pos) of bf16 caches
    [B, S, H, D], of the plain version and of SDPA over K/V laid out
    beforehand, and the bound for ``rows_seen`` key rows a call (mean
    over the sets)."""
    import torch
    import torch.nn.functional as F
    q, k = sets[0][0], sets[0][1]
    rec = {"ms": time_ms(fn, sets), "plain_ms": time_ms(plain, sets)}
    lib = [(q_[:, :, None], k_.transpose(1, 2).contiguous(),
            v_.transpose(1, 2).contiguous(),
            (torch.arange(k.shape[1], device=dev)[None, :]
             <= p_.long()[:, None])[:, None, None, :])
           for q_, k_, v_, p_ in sets]
    rec["library_ms"] = time_ms(
        lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=m_), lib)
    del lib
    h, d = k.shape[2], k.shape[3]
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * q.numel() * 2 + rows_seen * h * d * 2 * 2 + q.shape[0] * 4,
        rows_seen * h * d * 4, torch.bfloat16)
    return rec


def phase_unpaged(dev, cfg_kwargs, regs, seed: int = 0) -> dict:
    """Phase 9: the unpaged KV-cache path at bench_infer.py's model width:
    (a) the decode kernel against its plain version at the path's shape
    (8 slots, cache 1024, 16 heads of 64), with its times at DECODE_POS
    and at (b)'s own contexts, and two calls bit-identical; (b)
    `prefill` of 8 ragged prompts (100-300 tokens) and one slot-targeted
    prefill, then 64 greedy `decode_step`s; (c) the emitted tokens'
    logprobs against a dense f32 forward with plain attention, as phase
    3."""
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch import ops
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import decode_attention as da

    slots, max_len, new_tokens = 8, 1024, 64
    out = {}
    # (a) kernel vs plain at [8, 1024, 16, 64]
    g = torch.Generator(device=dev).manual_seed(9)
    shape = (slots, max_len, H, D)
    k32, v32 = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    q32 = torch.randn((slots, H, D), generator=g, device=dev)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    contexts = [torch.tensor(p, dtype=torch.int32, device=dev)
                for p in unpaged_contexts(cfg_kwargs["vocab_size"], seed)]
    rec = {"cases": []}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
        last = contexts[-1]
        for p, what in ((pos, f"pos={DECODE_POS}"),
                        (last, f"(b)'s last step, pos={last.tolist()}")):
            err = check("decode", da.decode_attention(q, k, v, p),
                        da.reference_decode_attention(q, k, v, p), name,
                        f"decode {name:8s} B={slots} S={max_len} {what}")
            rec["cases"].append({"dtype": name, "pos": p.tolist(),
                                 "max_abs_err": err, "atol_rtol": TOL[name]})
    del k32, v32
    # 8 bf16 cache sets of 33.6 MB (K+V): 268 MB between two uses.
    q = q32.bfloat16()
    caches = [tuple(torch.randn(shape, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
              for _ in range(TIME_SETS)]
    sets = [(q, k_, v_, pos) for k_, v_ in caches]
    # (b)'s contexts: one decode step's pos a set
    ctx_sets = [(q, k_, v_, p_) for (k_, v_), p_ in zip(caches, contexts)]
    rec["deterministic"] = same_twice("decode", da.decode_attention, sets[0])
    rec["split"] = {"n_split": da.split_geometry(max_len)[1],
                    "one_cta": da._ONE_CTA}
    rec["ptxas"] = regs.get("decode_kernel<bf16, 8, 1>")
    rec.update(decode_record(dev, da.decode_attention,
                             da.reference_decode_attention, sets,
                             sum(p + 1 for p in DECODE_POS)))
    ctx_seen = statistics.mean(int(p_.sum()) + slots for p_ in contexts)
    rec["contexts"] = decode_record(dev, da.decode_attention,
                                    da.reference_decode_attention, ctx_sets,
                                    ctx_seen)
    rec["contexts"]["pos"] = [p_.tolist() for p_ in contexts]
    rec["shape"] = (f"bf16 q[{slots},{H},{D}] cache[{slots},{max_len},{H},"
                    f"{D}] pos={list(DECODE_POS)}")
    c = rec["contexts"]
    print(f"  decode: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
          f" ms, sdpa {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{rec['shape']}]; "
          f"splits {rec['split']}, bit-identical twice, ptxas "
          f"{rec['ptxas']}")
    print(f"  decode at (b)'s contexts ({ctx_seen:.1f} rows seen a call): "
          f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, sdpa "
          f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
          f"({c['bound_by']})")
    out["kernel"] = rec
    del caches, sets, ctx_sets
    torch.cuda.empty_cache()

    # (b) the path: ragged prefill, a slot-targeted prefill, greedy decode
    cfg = gpt.GPTConfig(**cfg_kwargs)
    model = gpt.GPT(cfg, gpt.init_params(seed, cfg, dev))
    cache = gpt.init_kv_cache(cfg, slots, max_len, dev)
    lens, prompts, slot, again = unpaged_traffic(cfg.vocab_size, seed)
    toks = np.zeros((slots, lens.max()), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    logits, cache = gpt.prefill(model, torch.from_numpy(toks).to(dev), cache,
                                cfg, lengths=torch.from_numpy(lens).to(dev))
    one, cache = gpt.prefill(model, torch.from_numpy(again)[None].to(dev),
                             cache, cfg, slot=slot)
    logits[slot] = one[0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prompts[slot], lens[slot] = again, len(again)
    pos = torch.from_numpy(lens).to(dev, torch.int32)
    tok = logits.argmax(-1)
    emitted, logps, step_s = [tok], [], []
    for _ in range(new_tokens):
        logps.append(torch.log_softmax(logits, -1).gather(
            1, tok[:, None])[:, 0])
        t0 = time.perf_counter()
        logits, cache = gpt.decode_step(model, tok, cache, pos, cfg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        pos += 1
        tok = logits.argmax(-1)
        emitted.append(tok)
    launches = ops.kernel_launches()
    want = cfg.n_layers * new_tokens
    if launches["decode_attention"] != want:
        fail(f"decode_attention launched {launches['decode_attention']} "
             f"times in {new_tokens} decode steps, want {want}")
    emitted = torch.stack(emitted[:-1], 1).cpu().numpy()     # [B, 64]
    logps = torch.stack(logps, 1).cpu()
    step_ms = sorted(x * 1e3 for x in step_s)
    p50, p99 = (step_ms[int(q * (len(step_ms) - 1))] for q in (0.5, 0.99))
    tok_s = slots * new_tokens / sum(step_s)
    print(f"  (b) prefill of {slots} ragged prompts ({int(lens.min())}-"
          f"{int(lens.max())} tokens) + one slot prefill in "
          f"{prefill_s * 1e3:.1f} ms; {new_tokens} decode steps: p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} ms, {tok_s:.1f} tok/s; launches "
          f"{launches}")

    # (c) logprobs of every emitted token vs a dense f32 forward
    ref_cfg = dataclasses.replace(cfg, dtype="float32", attn_impl="xla")
    ref = gpt.GPT(ref_cfg, gpt.init_params(seed, ref_cfg, dev))
    worst, decisive = 0.0, 0
    for i in range(slots):
        seq = np.concatenate([prompts[i], emitted[i, :-1]])
        with torch.inference_mode():
            lp = torch.log_softmax(gpt.forward(
                ref, torch.from_numpy(seq)[None].to(dev))[0], -1)
        rows = lp[len(prompts[i]) - 1:].cpu()
        got = torch.from_numpy(emitted[i]).long()
        ref_lp = rows.gather(1, got[:, None])[:, 0]
        worst = max(worst, (ref_lp - logps[i]).abs().max().item())
        top2 = rows.topk(2, dim=-1)
        sure = (top2.values[:, 0] - top2.values[:, 1]) > 2 * LOGPROB_TOL
        if not bool((top2.indices[:, 0] == got)[sure].all()):
            fail(f"slot {i}: greedy token differs from the f32 reference's "
                 "argmax at a decisive position")
        decisive += int(sure.sum())
    print(f"  (c) {slots * new_tokens} tokens: max|logprob - f32 ref| = "
          f"{worst:.4f} (tol {LOGPROB_TOL}); {decisive} decisive positions "
          "agree with the reference's argmax")
    if not worst <= LOGPROB_TOL:
        fail(f"unpaged logprobs off the f32 reference by {worst:.4f}")
    out.update(prefill_s=prefill_s, decode_step_ms_p50=p50,
               decode_step_ms_p99=p99, decode_tok_s=tok_s,
               launches=launches, prompt_lens=[int(x) for x in lens],
               max_abs_logprob_err=worst, decisive_tokens=decisive)
    del model, ref, cache
    torch.cuda.empty_cache()
    return out


# Phase 10's shapes, which the card refused before. Head dims: 96
# (d_model 768 over 8 heads), 100 (d_model 800 over 8 heads; the flash
# kernels pad both to 128, the decode kernels take 96 as it is and 100
# padded to 104) and 256 (d_model 2048 over 8 heads, as Gemma's heads;
# the CUDA-core flash kernels at 256, the decode kernels as it is); pool
# block 64 (read as it is by the bf16 multi-query kernel); fused-loss
# widths 384, 1600 (GPT-2 XL's d_model, 25 heads of 64) and 4096 (a
# Llama-2-7B-wide model, 32 heads of 128). Widths are these shapes' own;
# depth is cut to 2 layers, the widest loss's batch to 2 sequences.
C1_HEADS = {96: dict(vocab_size=50304, d_model=768, n_layers=2, n_heads=8,
                     d_ff=3072, max_seq_len=1024),
            100: dict(vocab_size=50304, d_model=800, n_layers=2, n_heads=8,
                      d_ff=3200, max_seq_len=1024),
            256: dict(vocab_size=50304, d_model=2048, n_layers=2, n_heads=8,
                      d_ff=8192, max_seq_len=1024)}
C1_BLOCK = 64
C1_XENT = {384: (dict(vocab_size=50304, d_model=384, n_layers=2, n_heads=6,
                      d_ff=1536, max_seq_len=1024), 4),
           1600: (dict(vocab_size=50304, d_model=1600, n_layers=2,
                       n_heads=25, d_ff=6400, max_seq_len=1024), 4),
           4096: (dict(vocab_size=50304, d_model=4096, n_layers=2,
                       n_heads=32, d_ff=16384, max_seq_len=1024), 2)}
C1_BATCH = 4


def _c1_kernels(dev, g, d: int) -> dict:
    """(a) the paged decode, prefill and verify kernels over a block-64
    pool and the contiguous-cache decode kernel at head dim ``d``, bf16,
    against their plain versions (the multi-query kernel within an extra
    2^-8 P|V|)."""
    import torch
    from ray_tpu_torch.ops import decode_attention as da
    dt, h = torch.bfloat16, 8
    b, mb = 8, 16
    nb = b * mb + 1
    kp, vp = (torch.randn((nb, C1_BLOCK, h, d), generator=g,
                          device=dev).to(dt) for _ in range(2))
    tables = (torch.randperm(nb - 1, generator=g, device=dev)[:b * mb] + 1) \
        .view(b, mb).to(torch.int32).contiguous()
    pos = torch.tensor([0, 63, 64, 100, 511, 700, 1000, 1023],
                       dtype=torch.int32, device=dev)

    def pv_extra(qv, tbl, p):
        return 2 ** -8 * da.reference_paged_verify_attention(
            qv.float(), kp.float(), vp.float().abs(), tbl, p)

    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    errs = {"paged_decode": check(
        "paged decode", da.paged_decode_attention(q, kp, vp, tables, pos),
        da.reference_paged_decode_attention(q, kp, vp, tables, pos),
        "bfloat16", f"(a) paged decode D={d} block={C1_BLOCK}")}
    qc = torch.randn((64, h, d), generator=g, device=dev).to(dt)
    errs["paged_prefill"] = check(
        "paged prefill", da.paged_prefill_attention(qc, kp, vp, tables[0],
                                                    960),
        da.reference_paged_prefill_attention(qc, kp, vp, tables[0], 960),
        "bfloat16", f"(a) paged prefill D={d} block={C1_BLOCK} C=64 "
        f"start=960", extra=pv_extra(qc[None], tables[:1], pos[-1:] - 63))
    qv = torch.randn((b, 4, h, d), generator=g, device=dev).to(dt)
    errs["paged_verify"] = check(
        "paged verify", da.paged_verify_attention(qv, kp, vp, tables, pos),
        da.reference_paged_verify_attention(qv, kp, vp, tables, pos),
        "bfloat16", f"(a) paged verify D={d} block={C1_BLOCK} W=4",
        extra=pv_extra(qv, tables, pos))
    kc, vc = (torch.randn((b, 1024, h, d), generator=g, device=dev).to(dt)
              for _ in range(2))
    errs["decode"] = check(
        "decode", da.decode_attention(q, kc, vc, pos),
        da.reference_decode_attention(q, kc, vc, pos), "bfloat16",
        f"(a) decode D={d} S=1024")
    return errs


def _c1_train(dev, d: int) -> dict:
    """(b) a training step at head dim ``d``: loss and gradients with
    flash attention against plain attention, then one trainer step on
    the kernels its kernel head dim takes (tensor cores at 128, CUDA
    cores at 256)."""
    import dataclasses

    import numpy as np
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import spmd
    cfg = _train_cfg(**C1_HEADS[d])
    state, step_fn, place = spmd.make_gpt_trainer(cfg, seed=0, device=dev)
    batch = place(next(_host_batches(cfg, C1_BATCH, seed=20)))
    runs = {impl: _loss_and_grads(state.params, batch,
                                  dataclasses.replace(cfg, attn_impl=impl))
            for impl in ("flash", "xla")}
    out = _compare_runs(f"(b) D={d} flash vs plain attention", state.params,
                        runs["flash"], runs["xla"])
    del runs
    ops.reset_kernel_launches()
    state, m = step_fn(state, batch)
    loss = m["loss"].item()
    launches = ops.kernel_launches()
    if not np.isfinite(loss):
        fail(f"D {d} train step loss {loss}")
    on, off = ("tc", "simt") if fa.kernel_head_dim(d) in (64, 128) \
        else ("simt", "tc")
    for k in ("fwd", "dq", "dkv"):
        if launches[f"flash_{k}_{on}"] < cfg.n_layers:
            fail(f"D {d} train step: flash_{k}_{on} launched "
                 f"{launches[f'flash_{k}_{on}']} times")
        if launches[f"flash_{k}_{off}"]:
            fail(f"D {d} train step ran flash_{k}_{off}")
    print(f"  (b) one D={d} trainer step: loss {loss:.4f}; launches "
          f"{ {k: v for k, v in launches.items() if k.startswith('flash')} }")
    out.update(step_loss=loss, launches=launches)
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return out


def _c1_fused_loss(dev, width: int) -> dict:
    """(d) the fused loss at d_model ``width`` against the dense loss,
    loss and every gradient leaf, on the fused-xent kernels."""
    import dataclasses

    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.train import spmd
    shape, batch_rows = C1_XENT[width]
    cfg = _train_cfg(**shape, loss_impl="fused")
    state, _, place = spmd.make_gpt_trainer(cfg, seed=0, device=dev)
    batch = place(next(_host_batches(cfg, batch_rows, seed=22)))
    ops.reset_kernel_launches()
    fused = _loss_and_grads(state.params, batch, cfg)
    launches = ops.kernel_launches()
    dense = _loss_and_grads(state.params, batch,
                            dataclasses.replace(cfg, loss_impl="dense"))
    for name in ("xent_fwd_tc", "xent_fwd_merge", "xent_dlog", "xent_dx",
                 "xent_de"):
        if launches[name] <= 0:
            fail(f"the width-{width} fused loss did not launch {name}")
    out = _compare_runs(f"(d) d_model={width} fused vs dense loss",
                        state.params, fused, dense)
    out.update(batch=batch_rows, launches={
        k: v for k, v in launches.items() if k.startswith("xent")})
    del state, batch, fused, dense
    torch.cuda.empty_cache()
    return out

# Phase 10's head dims above 256 (ROADMAP C2): 264 and 512 run as they
# are (the decode kernels on 32 lanes of 2 or 4 vectors, the multi-query
# kernel on its CUDA-core instance at 512 columns, flash on 16-row
# tiles; 264 padded to 512 there), 520 padded to 1024, and 1024: above
# 512 every kernel works in slabs of 512. The engine's model has head
# dim 520 (d_model 2080 over 4 heads), 2 layers.
C2_HEADS = (264, 512, 520, 1024)
C2_ENGINE = dict(vocab_size=50304, d_model=2080, n_layers=2, n_heads=4,
                 d_ff=4096, max_seq_len=1024, dtype="bfloat16")


def phase_c2(dev, g) -> dict:
    """Phase 10 (e)-(g): (e) at each of `C2_HEADS` the paged decode,
    prefill and verify kernels over a block-64 pool and the
    contiguous-cache decode kernel (`_c1_kernels`), and the int8 pool's
    decode and verify in bf16 and f32; (f) the flash forward, dQ and
    dK/dV in bf16 and f32 (B 2, T 300, H 4, causal) against their plain
    versions, each on the CUDA-core kernel; (g) an `InferenceReplica` at
    head dim 520 answering 3 requests, its logprobs against a dense f32
    forward (phase 3's check)."""
    import numpy as np
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.ops import decode_attention as da
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import quant
    from ray_tpu_torch.serve import InferenceReplica

    out = {"kernels": {}, "flash": {}}
    for d in C2_HEADS:
        errs = _c1_kernels(dev, g, d)
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            b, h, mb = 4, 4, 8
            nb = b * mb + 1
            kq, ks = quant.quantize_rows(torch.randn(
                (nb, C1_BLOCK, h, d), generator=g, device=dev))
            vq, vs = quant.quantize_rows(torch.randn(
                (nb, C1_BLOCK, h, d), generator=g, device=dev))
            sc = dict(k_scale=ks, v_scale=vs)
            tables = (torch.randperm(nb - 1, generator=g, device=dev)
                      [:b * mb] + 1).view(b, mb).to(torch.int32)
            pos = torch.tensor([0, 100, 300, b * mb * 8 - 1],
                               dtype=torch.int32, device=dev)
            q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
            errs[f"int8_decode_{name}"] = check(
                "int8 paged decode",
                da.paged_decode_attention(q, kq, vq, tables, pos, **sc),
                da.reference_paged_decode_attention(q, kq, vq, tables, pos,
                                                    **sc),
                name, f"(e) int8 paged decode {name} D={d}")
            qv = torch.randn((b, 5, h, d), generator=g, device=dev).to(dt)
            errs[f"int8_verify_{name}"] = check(
                "int8 paged verify",
                da.paged_verify_attention(qv, kq, vq, tables, pos, **sc),
                da.reference_paged_verify_attention(qv, kq, vq, tables, pos,
                                                    **sc),
                name, f"(e) int8 paged verify {name} D={d} W=5")
        out["kernels"][d] = errs
        torch.cuda.empty_cache()
        fl = {}
        for name in ("bfloat16", "float32"):
            dt = getattr(torch, name)
            q, k, v, do = (torch.randn((2, 300, 4, d), generator=g,
                                       device=dev).to(dt) for _ in range(4))
            n = dict(fa.LAUNCHES)
            o, lse = fa.flash_forward(q, k, v, causal=True)
            ro, rl = fa.flash_forward_reference(q, k, v, causal=True)
            extra = None
            if dt == torch.bfloat16:
                extra = 2 ** -8 * fa.flash_forward_reference(
                    q.float(), k.float(), v.float().abs(), causal=True)[0]
            e = [check("flash forward", o, ro, name,
                       f"(f) flash fwd {name} D={d}", FLASH_TOL, extra),
                 check("flash forward", lse, rl, "float32",
                       f"(f) flash lse {name} D={d}", FLASH_TOL)]
            delta = fa.attention_delta(ro, do)
            dq = fa.flash_dq(q, k, v, do, rl, delta, causal=True)
            dk, dv = fa.flash_dkv(q, k, v, do, rl, delta, causal=True)
            for got, ref, what in zip((dq, dk, dv),
                                      fa.flash_backward_reference(
                                          q, k, v, do, rl, delta,
                                          causal=True),
                                      ("dq", "dk", "dv")):
                e.append(check(f"flash {what}", got, ref, name,
                               f"(f) flash {what} {name} D={d}", FLASH_TOL))
            ran = {k_: fa.LAUNCHES[k_] - n[k_] for k_ in n}
            if ran != {k_: int(k_.endswith("_simt")) for k_ in n}:
                fail(f"(f) flash D={d} {name} launched {ran}")
            fl[name] = max(e)
        out["flash"][d] = fl
        del q, k, v, do, o, lse, ro, rl, delta, dq, dk, dv, extra
        torch.cuda.empty_cache()

    replica = InferenceReplica(C2_ENGINE, slots=4, max_len=1024, seed=0,
                               engine_kwargs=dict(block_size=16),
                               device=dev)
    rng = np.random.default_rng(23)
    reqs = [(rng.integers(0, C2_ENGINE["vocab_size"], n).astype(np.int32),
             0.0) for n in (150, 64, 20)]
    before = replica.engine.stats()
    ops.reset_kernel_launches()
    outs = [list(gen) for gen in [replica(p, max_new_tokens=16)
                                  for p, _ in reqs]]
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    st = replica.engine.stats()
    built = builds(before, st)
    layers = C2_ENGINE["n_layers"]
    want = {"paged_decode_attention":
            layers * (st["decode_steps"] + built["decode_traces"]),
            "paged_mq_simt":
            layers * (st["prefill_chunks"] + built["prefill_traces"]),
            "paged_mq_tc": 0}
    if {k: launches[k] for k in want} != want:
        fail(f"(g) D=520 engine launches "
             f"{ {k: launches[k] for k in want} }, want {want}")
    if any(len(o) != 16 for o in outs):
        fail("(g) the D=520 engine cut a request short")
    replica.engine.check_invariants()
    check_compile_once(replica.engine, "phase 10 D=520 engine")
    print(f"  (g) engine at head dim 520: {len(reqs)} requests, "
          f"{st['prefill_chunks']} prefill chunks, {st['decode_steps']} "
          f"decode ticks; launches {want}")
    del replica
    torch.cuda.empty_cache()
    out["engine_d520"] = phase_teacher_forced(dev, C2_ENGINE, 0, reqs, outs)
    out["engine_d520"]["launches"] = want
    return out


def phase_c1(dev) -> dict:
    """Phase 10: the configurations the card refused before (ROADMAP C1),
    each through its entry points against a plain version: (a) the
    decode kernels and the multi-query kernel (prefill and verify) at
    head dims 96, 100 and 256 over a block-64 pool; (b) a training step
    at each of those head dims; (c) an `InferenceReplica` with block size
    64 on the D 96 model answering 3 requests, its logprobs against a
    dense f32 forward (phase 3's check); (d) the fused loss at d_model
    384, 1600 and 4096 against the dense loss."""
    import numpy as np
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.serve import InferenceReplica

    out = {}
    g = torch.Generator(device=dev).manual_seed(10)
    out["kernel_max_abs_err"] = {d: _c1_kernels(dev, g, d) for d in C1_HEADS}
    torch.cuda.empty_cache()
    out["train"] = {d: _c1_train(dev, d) for d in C1_HEADS}

    # (c) the engine at block 64 on the D 96 model
    cfg_kwargs = {**C1_HEADS[96], "dtype": "bfloat16"}
    replica = InferenceReplica(cfg_kwargs, slots=4, max_len=1024, seed=0,
                               engine_kwargs=dict(block_size=C1_BLOCK),
                               device=dev)
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(0, cfg_kwargs["vocab_size"], n).astype(np.int32),
             0.0) for n in (300, 128, 70)]
    before = replica.engine.stats()
    ops.reset_kernel_launches()
    outs = [list(gen) for gen in [replica(p, max_new_tokens=16)
                                  for p, _ in reqs]]
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    st = replica.engine.stats()
    check_paged_launches(launches, cfg_kwargs["n_layers"], st,
                         builds(before, st))
    check_compile_once(replica.engine, "phase 10 block-64 engine")
    if any(len(o) != 16 for o in outs):
        fail("the block-64 engine cut a request short")
    replica.engine.check_invariants()
    print(f"  (c) engine at block {C1_BLOCK}, D=96: {len(reqs)} requests, "
          f"{st['prefill_chunks']} prefill chunks, {st['decode_steps']} "
          f"decode ticks; launches "
          f"{ {k: launches[k] for k in ('paged_prefill_attention', 'paged_decode_attention', 'paged_mq_tc')} }")
    del replica
    torch.cuda.empty_cache()
    out["engine_block64"] = phase_teacher_forced(dev, cfg_kwargs, 0, reqs,
                                                 outs)
    out["engine_block64"]["launches"] = launches

    out["fused_loss"] = {w: _c1_fused_loss(dev, w) for w in C1_XENT}
    out["c2"] = phase_c2(dev, g)
    return out


# Phase 11: int8 serving. (a) the int8 instances of the paged kernels at
# phase 1's shapes; (b) phase 2's traffic through an engine with an int8
# pool ("kv") and one with int8 weights as well ("kv+w"), at SERVE_CFG.
INT8_VERIFY_W = 5
INT8_ENGINES = {"kv": dict(kv_dtype="int8"),
                "kv+w": dict(kv_dtype="int8", weight_dtype="int8")}


def same_and_capturable(name, fn, args, kw, ip, new_pos, counter) -> bool:
    """Fails unless ``fn(*args, **kw)`` launches its kernel once a call
    (`LAUNCHES[counter]`), gives bit-identical outputs twice, and a CUDA
    graph that captured one call, replayed after ``args[ip]`` (pos, on
    the device) took ``new_pos``, gives exactly what an eager call with
    the new pos gives (and not the old output). Restores ``args[ip]``."""
    import torch
    from ray_tpu_torch.ops import decode_attention as da
    n = da.LAUNCHES[counter]
    first, second = fn(*args, **kw), fn(*args, **kw)
    if da.LAUNCHES[counter] != n + 2:
        fail(f"{name}: {da.LAUNCHES[counter] - n} {counter} launches for "
             f"two calls")
    if not torch.equal(first, second):
        fail(f"{name}: two calls on the same inputs differ")
    old = args[ip].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, **kw)                 # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = fn(*args, **kw)
    args[ip].copy_(new_pos)
    graph.replay()
    torch.cuda.synchronize()
    eager = fn(*args, **kw)
    args[ip].copy_(old)
    if not torch.equal(captured, eager) or torch.equal(captured, first):
        fail(f"{name}: the CUDA graph's replay with a new pos is not the "
             f"eager call's output")
    return True


def phase_int8_kernels(dev, kern) -> dict:
    """(a) The int8 paged kernels against their plain versions on the
    same int8 payloads and scales (quantized on the card from normal
    rows): decode at B 8 over the 513 x 16 pool at DECODE_POS, prefill
    at PREFILL_CASES, verify at W 5, each in f32 and bf16 q (bf16
    multi-query within an extra 2^-8 P|V|, V dequantized); one launch a
    call, bit-identical twice and exact CUDA-graph replay with a new pos
    (bf16); device times of decode and of the C 64 prefill beside the bf16
    kernels' phase 1 times, the plain versions' and the bound (int8
    payload plus 4 bytes of scale a row). No single PyTorch call
    dequantizes and attends, so there is no library time."""
    import torch
    from ray_tpu_torch.ops import decode_attention as da
    from ray_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(11)

    def int8_pool():
        (kq, ks), (vq, vs) = (quant.quantize_rows(torch.randn(
            (NB, BS, H, D), generator=g, device=dev)) for _ in range(2))
        return kq, vq, ks, vs

    # TIME_SETS int8 pools; a decode call at DECODE_POS reads 7.3 MB of
    # one, so 8 sets pass 58 MB between two uses of a set.
    pools = [int8_pool() for _ in range(TIME_SETS)]
    kq, vq, ks, vs = pools[0]
    sc = dict(k_scale=ks, v_scale=vs)
    kdeq, vdeq = quant.dequantize_rows(kq, ks), quant.dequantize_rows(vq, vs)
    perm = torch.randperm(NB - 1, generator=g, device=dev) + 1
    tables = perm[:8 * MB].view(8, MB).to(torch.int32).contiguous()
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    rows_seen = sum(p + 1 for p in DECODE_POS)
    report = {}

    def decode(q, kq_, vq_, t, p, ks_, vs_):
        return da.paged_decode_attention(q, kq_, vq_, t, p, k_scale=ks_,
                                         v_scale=vs_)

    def decode_plain(q, kq_, vq_, t, p, ks_, vs_):
        return da.reference_paged_decode_attention(q, kq_, vq_, t, p,
                                                   k_scale=ks_, v_scale=vs_)

    rec = {"cases": []}
    q32 = torch.randn((8, H, D), generator=g, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        q = q32.to(dt)
        name = str(dt).split(".")[-1]
        err = check("int8 paged decode",
                    da.paged_decode_attention(q, kq, vq, tables, pos, **sc),
                    da.reference_paged_decode_attention(q, kq, vq, tables,
                                                        pos, **sc),
                    name, f"(a) paged_decode int8 {name:8s} B=8 "
                    f"pos={DECODE_POS}")
        rec["cases"].append({"dtype": name, "max_abs_err": err,
                             "atol_rtol": TOL[name]})
    q = q32.bfloat16()
    rec["deterministic_capturable"] = same_and_capturable(
        "int8 paged decode", da.paged_decode_attention,
        [q, kq, vq, tables, pos.clone()], sc, 4, pos.flip(0),
        "paged_decode_int8")
    args = [(q, *p[:2], tables, pos, *p[2:]) for p in pools]
    rec["ms"] = time_ms(decode, args)
    rec["plain_ms"] = time_ms(decode_plain, args)
    rec["library_ms"] = None
    rec["bf16_ms"] = kern["paged_decode"]["ms"]
    nbytes = (2 * q.numel() * 2 + rows_seen * H * (D + 4) * 2
              + sum(p // BS + 1 for p in DECODE_POS) * 4 + 8 * 4)
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes, rows_seen * H * D * 4, torch.bfloat16)
    rec["shape"] = (f"bf16 q[8,{H},{D}] int8 pool[{NB},{BS},{H},{D}] + "
                    f"scales pos={list(DECODE_POS)}")
    report["paged_decode_int8"] = rec

    def prefill(q, kq_, vq_, t, start, ks_, vs_):
        return da.paged_prefill_attention(q, kq_, vq_, t, start, k_scale=ks_,
                                          v_scale=vs_)

    def prefill_plain(q, kq_, vq_, t, start, ks_, vs_):
        return da.reference_paged_prefill_attention(q, kq_, vq_, t, start,
                                                    k_scale=ks_, v_scale=vs_)

    rec = {"cases": []}
    table = tables[0].contiguous()
    for c, start in PREFILL_CASES:
        q32 = torch.randn((c, H, D), generator=g, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            q = q32.to(dt)
            name = str(dt).split(".")[-1]
            extra = None
            if dt == torch.bfloat16:
                extra = 2 ** -8 * da.reference_paged_prefill_attention(
                    q.float(), kdeq, vdeq.abs(), table, start)
            before = dict(da.LAUNCHES)
            got = da.paged_prefill_attention(q, kq, vq, table, start, **sc)
            want = ("paged_mq_tc_int8" if dt == torch.bfloat16
                    else "paged_mq_simt_int8")
            if {k: da.LAUNCHES[k] - before[k] for k in before} != \
                    {k: int(k == want) for k in before}:
                fail(f"int8 paged prefill {name} did not launch {want} once")
            err = check("int8 paged prefill", got,
                        prefill_plain(q, kq, vq, table, start, ks, vs), name,
                        f"(a) paged_prefill int8 {name:8s} C={c:2d} "
                        f"start={start:3d}", extra=extra)
            rec["cases"].append({"dtype": name, "C": c, "start": start,
                                 "max_abs_err": err, "atol_rtol": TOL[name]})
    c, start = PREFILL_CASES[-1]
    q = q32.bfloat16()
    s_len = start + c
    start_t = torch.full((1,), start, dtype=torch.int32, device=dev)
    rec["deterministic_capturable"] = same_and_capturable(
        "int8 paged prefill", da.paged_prefill_attention,
        [q, kq, vq, table, start_t.clone()], sc, 4, start_t - 900,
        "paged_mq_tc_int8")
    rows = [tables[r].contiguous() for r in range(8)]
    args = [(q, *p[:2], t, start_t, *p[2:]) for p in pools for t in rows]
    rec["ms"] = time_ms(prefill, args)
    rec["plain_ms"] = time_ms(prefill_plain, args)
    rec["library_ms"] = None
    rec["bf16_ms"] = kern["paged_prefill"]["ms"]
    seen = sum(start + i + 1 for i in range(c))
    nbytes = (2 * q.numel() * 2 + s_len * H * (D + 4) * 2
              + (-(-s_len // BS)) * 4 + 4)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, seen * H * D * 4,
                                             torch.bfloat16)
    rec["shape"] = (f"bf16 q[{c},{H},{D}] start={start} int8 "
                    f"pool[{NB},{BS},{H},{D}] + scales")
    report["paged_prefill_int8"] = rec

    # verify (W 5 query rows a sequence; no path of the port calls it yet)
    rec = {"cases": []}
    vpos = pos.clamp(max=MB * BS - INT8_VERIFY_W)
    q32 = torch.randn((8, INT8_VERIFY_W, H, D), generator=g, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        q = q32.to(dt)
        name = str(dt).split(".")[-1]
        extra = None
        if dt == torch.bfloat16:
            extra = 2 ** -8 * da.reference_paged_verify_attention(
                q.float(), kdeq, vdeq.abs(), tables, vpos)
        err = check("int8 paged verify",
                    da.paged_verify_attention(q, kq, vq, tables, vpos, **sc),
                    da.reference_paged_verify_attention(q, kq, vq, tables,
                                                        vpos, **sc),
                    name, f"(a) paged_verify int8 {name:8s} "
                    f"W={INT8_VERIFY_W}", extra=extra)
        rec["cases"].append({"dtype": name, "max_abs_err": err})
    rec["deterministic_capturable"] = same_and_capturable(
        "int8 paged verify", da.paged_verify_attention,
        [q, kq, vq, tables, vpos.clone()], sc, 4, vpos.flip(0),
        "paged_mq_tc_int8")
    report["paged_verify_int8"] = rec
    for name in ("paged_decode_int8", "paged_prefill_int8"):
        r = report[name]
        print(f"  (a) {name}: kernel {r['ms']:.4f} ms (bf16 pool "
              f"{r['bf16_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
              f"none, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
              f"[{r['shape']}]; one launch a call, bit-identical twice, "
              f"CUDA-graph replay exact")
    return report


def phase_int8_engine(dev, which: str, reqs, bf16_outs, bf16_eng,
                      seed: int = 0, new_tokens: int = 64) -> dict:
    """(b) Phase 2's traffic through an `InferenceReplica` at SERVE_CFG
    with ``INT8_ENGINES[which]``: every paged attention launch an int8
    kernel's; the pool gauges against the bf16 engine's (K or V row of
    a position: 2 D bytes against D + 4); logprobs against the bf16
    engine's (bench_infer.py's quality proxy, printed); one
    `update_params` of the same weights (f32 masters from the seed):
    greedy tokens unchanged, quantize_traces unchanged, params_version 1;
    then phase 3's teacher-forced check."""
    import numpy as np
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceReplica

    cfg_kwargs = {**SERVE_CFG, **INT8_ENGINES[which]}
    layers = cfg_kwargs["n_layers"]
    replica = InferenceReplica(cfg_kwargs, slots=8, max_len=1024, seed=seed,
                               engine_kwargs=dict(block_size=16), device=dev)
    eng = replica.engine
    rng = np.random.default_rng(1)
    warm_up(replica.engine)
    eng.reset_stats()
    before = eng.stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    outs = [list(gen) for gen in [replica(p, max_new_tokens=new_tokens,
                                          temperature=t) for p, t in reqs]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    st = eng.stats()
    eng.check_invariants()
    if any(len(o) != new_tokens for o in outs):
        fail(f"int8 engine {which} cut a request short")
    check_paged_launches(launches, layers, st, builds(before, st),
                         int8=True)
    compile_once = check_compile_once(eng, f"int8 engine {which}")
    ratio = bf16_eng["kv_bytes_per_token"] / st["kv_bytes_per_token"]
    want = 2 * D / (D + 4)
    if abs(ratio / want - 1) > 1e-9:
        fail(f"int8 engine {which}: kv_bytes_per_token {ratio:.4f}x "
             f"smaller than bf16's, want {want:.4f}x")
    deltas = [abs(a.logprob - b.logprob)
              for (_, temp), mine, theirs in zip(reqs, outs, bf16_outs)
              if temp == 0 for a, b in zip(mine, theirs)]
    same = [int(a) == int(b) for (_, temp), mine, theirs
            in zip(reqs, outs, bf16_outs) if temp == 0
            for a, b in zip(mine, theirs)]
    # the swap: fresh greedy prompts (no prefix shared with anything
    # cached) before and after one update_params of the same weights
    probe = [rng.integers(0, cfg_kwargs["vocab_size"], 96) for _ in range(2)]
    before = [list(gen) for gen in [replica(p, max_new_tokens=16)
                                    for p in probe]]
    traces = eng.quantize_traces
    version = eng.update_params(gpt.init_params(seed, eng.cfg, dev))
    after = [list(gen) for gen in [replica(p, max_new_tokens=16)
                                   for p in probe]]
    sw = eng.stats()
    if [[int(t) for t in o] for o in after] != \
            [[int(t) for t in o] for o in before]:
        fail(f"int8 engine {which}: greedy tokens changed across a swap of "
             f"the same weights")
    if not (version == sw["params_version"] == 1
            and all(t.params_version == 1 for o in after for t in o)
            and sw["quantize_traces"] == traces
            == int("weight_dtype" in INT8_ENGINES[which])
            and sw["swaps"] == 1):
        fail(f"int8 engine {which}: after the swap params_version "
             f"{sw['params_version']}, quantize_traces "
             f"{sw['quantize_traces']} (was {traces}), swaps {sw['swaps']}")
    eng.check_invariants()
    paged = ("paged_decode_int8", "paged_mq_tc_int8", "paged_mq_tc",
             "paged_mq_simt", "paged_mq_simt_int8")
    out = {k: st[k] for k in (
        "prefill_tokens", "decode_tokens", "prefill_chunks", "decode_steps",
        "prefill_tok_s", "decode_tok_s", "p50_token_latency_ms",
        "p99_token_latency_ms", "prefix_hit_tokens", "cow_copies",
        "pool_bytes", "kv_bytes_per_token", "quantize_traces")}
    out.update(wall_s=wall, launches=launches,
               kv_bytes_ratio_vs_bf16=ratio,
               pool_bytes_ratio_vs_bf16=bf16_eng["pool_bytes"]
               / st["pool_bytes"],
               logprob_delta_vs_bf16_mean=float(np.mean(deltas)),
               logprob_delta_vs_bf16_max=float(np.max(deltas)),
               tokens_same_as_bf16=float(np.mean(same)),
               weight_swap_ms=sw["weight_swap_ms"],
               params_version=sw["params_version"],
               compile_once=check_compile_once(eng, f"int8 engine {which} "
                                               "after the swap"))
    if out["compile_once"] != compile_once:
        fail(f"int8 engine {which}: the swap rebuilt a step: "
             f"{compile_once} -> {out['compile_once']}")
    print(f"  (b) {which}: {len(reqs)} requests in {wall:.2f} s; prefill "
          f"{st['prefill_tok_s']:.1f} tok/s, decode {st['decode_tok_s']:.1f} "
          f"tok/s, decode step p50 {st['p50_token_latency_ms']:.3f} ms p99 "
          f"{st['p99_token_latency_ms']:.3f} ms (bf16 engine "
          f"{bf16_eng['p50_token_latency_ms']:.3f} / "
          f"{bf16_eng['p99_token_latency_ms']:.3f}); kv_bytes_per_token "
          f"{st['kv_bytes_per_token']:.0f} ({ratio:.4f}x under bf16's "
          f"{bf16_eng['kv_bytes_per_token']:.0f}), pool "
          f"{st['pool_bytes'] / 2**20:.1f} MiB; |logprob - bf16 engine's| "
          f"mean {out['logprob_delta_vs_bf16_mean']:.4f} max "
          f"{out['logprob_delta_vs_bf16_max']:.4f}, greedy tokens the same "
          f"{out['tokens_same_as_bf16']:.1%}; launches "
          f"{ {k: launches[k] for k in paged} }; "
          f"swap: tokens unchanged, params_version 1, quantize_traces "
          f"{sw['quantize_traces']}, weight_swap_ms "
          f"{sw['weight_swap_ms']:.1f}")
    del replica, eng
    torch.cuda.empty_cache()
    out["teacher_forced"] = phase_teacher_forced(dev, cfg_kwargs, seed, reqs,
                                                 outs)
    return out


def phase_int8(dev, kern, reqs, bf16_outs, bf16_eng) -> dict:
    """Phase 11: int8 serving, (a) the kernels, (b) the two engines; the
    kernels line's int8 rows read the "kv+w" engine's launches."""
    out = {"kernels": phase_int8_kernels(dev, kern)}
    out["engines"] = {w: phase_int8_engine(dev, w, reqs, bf16_outs, bf16_eng)
                      for w in INT8_ENGINES}
    return out


# Phase 12: speculative decoding. (a) the verify caller of the multi-query
# kernel at the engine's geometry, W = k + 1 for k 1, 4 and 8; (b)
# bench_infer.py's spec traffic (prompts tiling a 4-token motif,
# bench_infer.py:250-256) through engines with spec off, n-gram and a
# 1-layer draft, at SERVE_CFG with k 4; (c) a self-drafting engine on
# peaked weights.
SPEC_K = 4
SPEC_WINDOWS = (2, SPEC_K + 1, 9)
SPEC_PROMPT, SPEC_MOTIF, SPEC_REQUESTS, SPEC_NEW = 128, 4, 16, 64
SPEC_SAMPLED = 3                  # the one request sampled at 0.8
SPEC_DRAFT_LAYERS = 1
SPEC_ENGINES = {"off": {}, "ngram": dict(spec="ngram", spec_k=SPEC_K),
                "draft": dict(spec="draft", spec_k=SPEC_K,
                              draft_layers=SPEC_DRAFT_LAYERS)}
# (c): draft = target at temperature 0 on peaked weights (embed x 8, the
# tests' idiom) must accept nearly everything.
SELF_DRAFT_REQUESTS, SELF_DRAFT_ACCEPT, SELF_DRAFT_TOKENS_PER_STEP = 8, 0.9, 3.0


def phase_verify_kernels(dev) -> dict:
    """(a) `paged_verify_attention` at the engine's geometry (B 8, H 16,
    D 64, block 16, the 513-block pool, 64-entry tables, windows at
    DECODE_POS clamped into the table): W 2, 5 and 9 in bf16
    (`paged_mq_tc`, within an extra 2^-8 P|V|) and f32 (`paged_mq_simt`),
    and an int8 pool at W 5 (f32 and bf16 q), each against its plain
    version, one launch a call by name, bit-identical twice and replayed
    exactly from a CUDA graph with a new pos. Then the bf16 W 5 call's
    device time beside the plain version's, one SDPA call with the
    staircase mask over K/V gathered beforehand (gather not timed), the
    bound, and the five `paged_decode_attention` calls (at pos .. pos + 4)
    that W sequential ticks would launch."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import decode_attention as da
    from ray_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(12)
    k32 = torch.randn((NB, BS, H, D), generator=g, device=dev)
    v32 = torch.randn((NB, BS, H, D), generator=g, device=dev)
    perm = torch.randperm(NB - 1, generator=g, device=dev) + 1
    tables = perm[:8 * MB].view(8, MB).to(torch.int32).contiguous()
    (kq, ks), (vq, vs) = quant.quantize_rows(k32), quant.quantize_rows(v32)
    sc = dict(k_scale=ks, v_scale=vs)
    kdeq, vdeq = quant.dequantize_rows(kq, ks), quant.dequantize_rows(vq, vs)

    def window_pos(w):
        return torch.tensor(DECODE_POS, dtype=torch.int32,
                            device=dev).clamp(max=MB * BS - w)

    rec = {"cases": []}
    cases = [(w, dt, False) for w in SPEC_WINDOWS
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(SPEC_K + 1, dt, True) for dt in (torch.bfloat16, torch.float32)]
    for w, dt, int8 in cases:
        pos = window_pos(w)
        q = torch.randn((8, w, H, D), generator=g, device=dev).to(dt)
        name = str(dt).split(".")[-1]
        want = ("paged_mq_tc" if dt == torch.bfloat16 else "paged_mq_simt") \
            + ("_int8" if int8 else "")
        kp, vp, kw = ((kq, vq, sc) if int8 else
                      (k32.to(dt), v32.to(dt), {}))
        extra = None
        if dt == torch.bfloat16:
            kf, vf = (kdeq, vdeq) if int8 else (kp.float(), vp.float())
            extra = 2 ** -8 * da.reference_paged_verify_attention(
                q.float(), kf, vf.abs(), tables, pos)
        what = f"(a) paged_verify {'int8 ' if int8 else ''}{name:8s} W={w}"
        before = dict(da.LAUNCHES)
        got = da.paged_verify_attention(q, kp, vp, tables, pos, **kw)
        if {k: da.LAUNCHES[k] - before[k] for k in before} != \
                {k: int(k == want) for k in before}:
            fail(f"{what} did not launch {want} once")
        err = check("paged verify", got, da.reference_paged_verify_attention(
            q, kp, vp, tables, pos, **kw), name, what, extra=extra)
        same_and_capturable(what, da.paged_verify_attention,
                            [q, kp, vp, tables, pos.clone()], kw, 4,
                            pos.flip(0), want)
        rec["cases"].append({"W": w, "dtype": name, "int8_pool": int8,
                             "kernel": want, "max_abs_err": err,
                             "atol_rtol": TOL[name]})
    print(f"  (a) {len(cases)} verify cases: one launch a call by name, "
          f"bit-identical twice, CUDA-graph replay with a new pos exact")

    # times at W 5, bf16: TIME_SETS pools (33.6 MB of K+V each)
    w = SPEC_K + 1
    pos = window_pos(w)
    pools = [(k32.bfloat16(), v32.bfloat16())] + [
        tuple(torch.randn((NB, BS, H, D), generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
        for _ in range(TIME_SETS - 1)]
    q = torch.randn((8, w, H, D), generator=g, device=dev).bfloat16()
    args = [(q, kp, vp, tables, pos) for kp, vp in pools]
    rec["ms"] = time_ms(da.paged_verify_attention, args)
    rec["plain_ms"] = time_ms(da.reference_paged_verify_attention, args)
    s_len = MB * BS
    mask = (torch.arange(s_len, device=dev)[None, None, :]
            <= (pos.long()[:, None] + torch.arange(w, device=dev))[:, :, None]
            )[:, None]
    lib_args = [(q.transpose(1, 2).contiguous(),
                 da.gather_kv_pages(kp, tables).transpose(1, 2).contiguous(),
                 da.gather_kv_pages(vp, tables).transpose(1, 2).contiguous(),
                 mask) for kp, vp in pools]
    rec["library_ms"] = time_ms(
        lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=m_), lib_args)
    del lib_args
    qs = [q[:, j].contiguous() for j in range(w)]
    poss = [pos + j for j in range(w)]

    def ticks(qs_, kp, vp, t, poss_):
        for qj, pj in zip(qs_, poss_):
            da.paged_decode_attention(qj, kp, vp, t, pj)

    rec["decode_x5_ms"] = time_ms(ticks, [(qs, kp, vp, tables, poss)
                                          for kp, vp in pools])
    rows_read = sum(p + w for p in pos.tolist())
    seen = sum((p + j + 1) for p in pos.tolist() for j in range(w))
    nbytes = (2 * q.numel() * 2 + rows_read * H * D * 2 * 2
              + sum(-(-(p + w) // BS) for p in pos.tolist()) * 4 + 8 * 4)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, seen * H * D * 4,
                                             torch.bfloat16)
    rec["shape"] = (f"bf16 q[8,{w},{H},{D}] pool[{NB},{BS},{H},{D}] "
                    f"pos={pos.tolist()}")
    print(f"  (a) paged_verify W={w}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, sdpa (gather excluded) "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}), {w} paged_decode calls "
          f"{rec['decode_x5_ms']:.4f} ms [{rec['shape']}]")
    return rec


def spec_traffic(vocab: int, n: int = SPEC_REQUESTS, seed: int = 0):
    """bench_infer.py's spec traffic: ``n`` prompts, each a random 4-token
    motif tiled to SPEC_PROMPT tokens; request SPEC_SAMPLED sampled at
    0.8, the others greedy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(0, vocab, SPEC_MOTIF)
        out.append((np.tile(motif, -(-SPEC_PROMPT // SPEC_MOTIF))
                    [:SPEC_PROMPT].astype(np.int32),
                    0.8 if i == SPEC_SAMPLED else 0.0))
    return out


def tick_profile(eng, vocab: int, ticks: int = 8) -> dict:
    """Where a tick's time goes: every slot takes a SPEC_PROMPT-token motif
    prompt (200 new tokens, so none retires), the prompts are prefilled,
    then ``ticks`` ticks run under `torch.profiler`: wall and device time
    a tick, the device busy share, and device time a tick by kernel
    group (the multi-query kernel: verify; the paged decode kernel: plain
    ticks and draft proposals; cuBLAS GEMMs; the rest: elementwise,
    reduction, copy and index kernels). The requests are cancelled
    after."""
    prompts = spec_traffic(vocab, eng.num_slots, seed=7)
    rids = [eng.submit(p, max_new_tokens=200) for p, _ in prompts]
    chunks = eng.stats()["prefill_chunks"] + sum(
        -(-p.size // eng.prefill_chunk) for p, _ in prompts)
    while eng.stats()["prefill_chunks"] < chunks:
        eng.step()
    spec0 = eng.stats()["spec_steps"]
    _, prof = profile_window(
        lambda: [eng.step() for _ in range(ticks)],
        (("paged_mq_tc (verify)", ("paged_mq_tc_kernel",)),
         ("paged_decode", ("paged_decode_kernel",)), ("gemm", GEMM_NAMES)))
    spec_ticks = eng.stats()["spec_steps"] - spec0
    for r in rids:
        eng.cancel(r)
    return {"ticks": ticks, "spec_ticks": spec_ticks,
            "wall_ms_per_tick": prof["wall_s"] * 1e3 / ticks,
            "device_ms_per_tick": prof["device_ms"] / ticks,
            "device_busy_share": prof["device_busy_share"],
            "device_ms_per_tick_by_group": {
                g: ms / ticks for g, ms in prof["device_ms_by_group"].items()},
            "top_kernels": top_kernels(prof["kernels"], 8)}


def phase_spec_engine(dev, which: str, reqs, seed: int = 0) -> dict:
    """(b) ``reqs`` through an `InferenceReplica` at SERVE_CFG (8 slots,
    block 16, chunk 64) with ``SPEC_ENGINES[which]``, counters zeroed
    just before and read just after: one host sync a prefill chunk and a
    tick (plain or speculative); per spec tick one `paged_mq_tc` launch
    a layer (the verify forward) and, with the draft, W
    `paged_decode_attention` launches a draft layer (the proposal); the
    draft's prefill chunks on `paged_mq_tc` too; no `paged_mq_simt`.
    Then `tick_profile` and phase 3's teacher-forced check of a spec
    engine's greedy tokens."""
    import numpy as np
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.serve import InferenceReplica

    cfg_kwargs = dict(SERVE_CFG)
    layers = cfg_kwargs["n_layers"]
    ek = dict(block_size=16, prefill_chunk=64, **SPEC_ENGINES[which])
    replica = InferenceReplica(cfg_kwargs, slots=8, max_len=1024, seed=seed,
                               engine_kwargs=ek, device=dev)
    eng = replica.engine
    warm_up(replica.engine, spec=which != "off")
    eng.reset_stats()
    before = eng.stats()
    ops.reset_kernel_launches()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        outs = [list(gen) for gen in [
            replica(p, max_new_tokens=SPEC_NEW, temperature=t)
            for p, t in reqs]]
        wall = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    st = eng.stats()
    built = builds(before, st)
    eng.check_invariants()
    if any(len(o) != SPEC_NEW for o in outs):
        fail(f"spec engine {which} cut a request short")
    spec_ticks = st["spec_steps"]
    plain_ticks = st["decode_steps"] - spec_ticks
    dl = SPEC_DRAFT_LAYERS if which == "draft" else 0
    w = SPEC_K + 1
    draft_chunks = sum(-(-p.size // 64) for p, _ in reqs) if dl else 0
    # a step built in the window ran once eagerly before its capture
    verify = spec_ticks + built["verify_traces"]
    prefill = (layers * (st["prefill_chunks"] + built["prefill_traces"])
               + dl * (draft_chunks + built["draft_prefill_traces"]))
    want = {"paged_verify_attention": layers * verify,
            "paged_mq_tc": layers * verify + prefill,
            "paged_prefill_attention": prefill,
            "paged_decode_attention":
                layers * (plain_ticks + built["decode_traces"])
                + dl * w * (spec_ticks + built["draft_traces"]),
            "paged_mq_simt": 0, "paged_decode_int8": 0,
            "paged_mq_tc_int8": 0, "paged_mq_simt_int8": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"spec engine {which}: paged launches {got}, want {want}")
    compile_once = check_compile_once(eng, f"spec engine {which}")
    if which != "off" and spec_ticks <= 0:
        fail(f"spec engine {which} made no speculative tick")
    if syncs != st["decode_steps"] + st["prefill_chunks"] + sum(
            built.values()):
        fail(f"spec engine {which}: {syncs} host syncs for "
             f"{st['decode_steps']} ticks, {st['prefill_chunks']} prefill "
             f"chunks and {built} builds (want one each)")
    per_tick = {}
    if spec_ticks:
        per_tick = {"paged_mq_tc (verify)": want["paged_verify_attention"]
                    / spec_ticks,
                    "paged_decode (proposal)": dl * w}
    out = {k: st[k] for k in (
        "decode_steps", "spec_steps", "prefill_chunks", "decode_tokens",
        "decode_tok_s", "p50_token_latency_ms", "p99_token_latency_ms",
        "tokens_per_step", "acceptance_rate", "pool_bytes")}
    out.update(wall_s=wall, launches=launches, host_syncs=syncs,
               launches_per_spec_tick=per_tick, compile_once=compile_once,
               builds_in_run=built)
    print(f"  (b) {which}: {len(reqs)} requests in {wall:.2f} s; decode "
          f"{st['decode_tok_s']:.1f} tok/s, tick p50 "
          f"{st['p50_token_latency_ms']:.3f} ms p99 "
          f"{st['p99_token_latency_ms']:.3f} ms; {st['decode_steps']} ticks "
          f"({spec_ticks} speculative), tokens_per_step "
          f"{st['tokens_per_step']:.3f}, acceptance_rate "
          f"{st['acceptance_rate']:.3f}; launches per spec tick {per_tick}; "
          f"{syncs} host syncs; compile-once {compile_once}")
    prof = out["tick_profile"] = tick_profile(eng, cfg_kwargs["vocab_size"])
    print(f"  (b) {which} profile: {prof['ticks']} ticks "
          f"({prof['spec_ticks']} speculative), wall "
          f"{prof['wall_ms_per_tick']:.3f} ms a tick, device "
          f"{prof['device_ms_per_tick']:.3f} ms ({prof['device_busy_share']:.1%}"
          f" busy); device ms a tick by group "
          f"{ {k: round(v, 3) for k, v in prof['device_ms_per_tick_by_group'].items()} }")
    eng.check_invariants()
    del replica, eng
    torch.cuda.empty_cache()
    if which != "off":
        out["teacher_forced"] = phase_teacher_forced(dev, cfg_kwargs, seed,
                                                     reqs, outs)
    return out


def phase_spec_self_draft(dev, seed: int = 0) -> dict:
    """(c) Peaked weights (embed x 8) at SERVE_CFG, temperature 0: an
    engine with spec off and one with ``spec="draft"``, draft = target,
    on the same greedy requests: identical tokens, acceptance_rate >=
    SELF_DRAFT_ACCEPT, tokens_per_step >= SELF_DRAFT_TOKENS_PER_STEP;
    then `update_params` of the same weights into target and draft:
    fresh prompts' tokens unchanged, params_version 1."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine

    cfg = gpt.small(**SERVE_CFG)
    tree = gpt.init_params(seed, cfg, dev)
    tree["embed"] = tree["embed"] * 8
    model = gpt.GPT(cfg, tree, device=dev)
    ek = dict(slots=8, max_len=1024, block_size=16, prefill_chunk=64,
              device=dev)
    prompts = [p for p, _ in spec_traffic(cfg.vocab_size,
                                          SELF_DRAFT_REQUESTS, seed=5)]
    probe = [p for p, _ in spec_traffic(cfg.vocab_size, 2, seed=6)]
    toks = {}
    for which, kw in (("off", {}), ("draft", dict(
            spec="draft", spec_k=SPEC_K, draft_params=model, draft_cfg=cfg))):
        eng = InferenceEngine(model, cfg, **ek, **kw)
        rids = [eng.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
        eng.run_until_idle()
        toks[which] = [[int(t) for t in eng.tokens_for(r)] for r in rids]
        eng.check_invariants()
    st = eng.stats()
    if toks["draft"] != toks["off"]:
        same = np.mean([a == b for x, y in zip(toks["draft"], toks["off"])
                        for a, b in zip(x, y)])
        fail(f"(c) self-drafting greedy tokens differ from spec off "
             f"({same:.1%} the same)")
    if not (st["acceptance_rate"] >= SELF_DRAFT_ACCEPT
            and st["tokens_per_step"] >= SELF_DRAFT_TOKENS_PER_STEP):
        fail(f"(c) self-drafting acceptance_rate {st['acceptance_rate']:.3f}"
             f" tokens_per_step {st['tokens_per_step']:.3f}")
    before = [[int(t) for t in eng.generate(p, max_new_tokens=16)]
              for p in probe]
    version = eng.update_params(tree, draft_params=tree)
    after = [eng.generate(p, max_new_tokens=16) for p in probe]
    if [[int(t) for t in o] for o in after] != before or version != 1 \
            or not all(t.params_version == 1 for o in after for t in o):
        fail("(c) a swap of the same weights changed tokens or the version")
    eng.check_invariants()
    print(f"  (c) draft = target, peaked weights, {len(prompts)} greedy "
          f"requests: tokens identical to spec off, acceptance_rate "
          f"{st['acceptance_rate']:.3f} (>= {SELF_DRAFT_ACCEPT}), "
          f"tokens_per_step {st['tokens_per_step']:.3f} (>= "
          f"{SELF_DRAFT_TOKENS_PER_STEP}), {st['spec_steps']} spec ticks; "
          f"update_params(..., draft_params=...) of the same weights: tokens "
          f"unchanged, params_version 1")
    out = {k: st[k] for k in ("acceptance_rate", "tokens_per_step",
                              "spec_steps", "decode_steps",
                              "p50_token_latency_ms", "decode_tok_s")}
    del eng, model
    torch.cuda.empty_cache()
    return out


def phase_spec(dev) -> dict:
    """Phase 12: (a) the verify kernels, (b) the three engines, (c) the
    self-drafting engine; the kernels line's verify row reads (b)'s two
    spec engines' launches."""
    out = {"kernels": phase_verify_kernels(dev)}
    reqs = spec_traffic(SERVE_CFG["vocab_size"])
    out["engines"] = {w: phase_spec_engine(dev, w, reqs)
                      for w in SPEC_ENGINES}
    out["self_draft"] = phase_spec_self_draft(dev)
    return out


# Phase 13: compile-once serving, each engine eager (``_capture = False``)
# and captured: name -> (traffic: phase 2's "serve" or phase 12's "spec"
# prompts, config overrides, engine kwargs).
CAPTURE_ENGINES = {"bf16": ("serve", {}, {}),
                   "int8": ("serve", {"kv_dtype": "int8",
                                      "weight_dtype": "int8"}, {}),
                   "spec off": ("spec", {}, {}),
                   "ngram": ("spec", {}, SPEC_ENGINES["ngram"]),
                   "draft": ("spec", {}, SPEC_ENGINES["draft"])}


def capture_run(dev, name: str, capture: bool) -> dict:
    """One engine of phase 13: built from seed 0 at SERVE_CFG (8 slots,
    block 16, chunk 64), warmed up (`warm_up`), then its traffic (phase
    2's requests, or phase 12's prompts all greedy, 64 new tokens each)
    and `tick_profile`'s 8 profiled ticks with every slot decoding."""
    import torch
    from ray_tpu_torch.serve import InferenceReplica
    traffic, cfg_over, ek = CAPTURE_ENGINES[name]
    cfg_kwargs = {**SERVE_CFG, **cfg_over}
    vocab = cfg_kwargs["vocab_size"]
    replica = InferenceReplica(cfg_kwargs, slots=8, max_len=1024, seed=0,
                               engine_kwargs=dict(block_size=16,
                                                  prefill_chunk=64, **ek),
                               device=dev)
    eng = replica.engine
    eng._capture = capture
    warm_up(replica.engine, spec=bool(ek))
    eng.reset_stats()
    reqs = (make_traffic(vocab, 0) if traffic == "serve" else
            [(p, 0.0) for p, _ in spec_traffic(vocab)])
    t0 = time.perf_counter()
    outs = [list(gen) for gen in [replica(p, max_new_tokens=64,
                                          temperature=t)
                                  for p, t in reqs]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    eng.check_invariants()
    prof = tick_profile(eng, vocab)
    out = {k: st[k] for k in (
        "decode_steps", "spec_steps", "decode_tokens", "decode_tok_s",
        "p50_token_latency_ms", "p99_token_latency_ms", "tokens_per_step",
        "retraces_unexpected", "graph_pool_bytes", *TRACE_KEYS)}
    out.update(wall_s=wall, profile=prof,
               greedy_tokens=[[int(t) for t in o]
                              for (_, temp), o in zip(reqs, outs)
                              if temp == 0])
    if capture:
        out["compile_once"] = check_compile_once(eng, f"phase 13 {name}")
    elif st["graph_pool_bytes"] or eng._captures():
        fail(f"phase 13 {name}: the eager engine captured a graph")
    del replica, eng
    torch.cuda.empty_cache()
    return out


def phase_capture(dev) -> dict:
    """Phase 13: each of `CAPTURE_ENGINES` eager, then captured, on the
    same traffic: greedy tokens must be identical (the same kernels on the
    same inputs), the captured engine built once a step with no unexpected
    retrace; tick p50/p99, decode tok/s and the profiled busy share of
    both printed side by side."""
    out = {}
    for name in CAPTURE_ENGINES:
        runs = {mode: capture_run(dev, name, mode == "captured")
                for mode in ("eager", "captured")}
        same = (runs["eager"]["greedy_tokens"]
                == runs["captured"]["greedy_tokens"])
        if not same:
            fail(f"phase 13 {name}: captured greedy tokens differ from "
                 "eager")
        for mode, r in runs.items():
            p = r["profile"]
            print(f"  {name:8s} {mode:8s}: tick p50 "
                  f"{r['p50_token_latency_ms']:.3f} ms p99 "
                  f"{r['p99_token_latency_ms']:.3f} ms, decode "
                  f"{r['decode_tok_s']:.1f} tok/s, {r['decode_steps']} ticks"
                  f" ({r['spec_steps']} spec), tokens_per_step "
                  f"{r['tokens_per_step']:.3f}; profiled: wall "
                  f"{p['wall_ms_per_tick']:.3f} ms a tick, device "
                  f"{p['device_ms_per_tick']:.3f} ms, busy "
                  f"{p['device_busy_share']:.1%}; traces "
                  f"{ {k: r[k] for k in TRACE_KEYS} }, retraces_unexpected "
                  f"{r['retraces_unexpected']}, graph_pool_bytes "
                  f"{r['graph_pool_bytes']}")
        print(f"  {name}: greedy tokens identical eager/captured: {same}")
        for r in runs.values():
            del r["greedy_tokens"]
        out[name] = {**runs, "greedy_identical": same}
    return out


# Phase 14: scheduling under pressure at SERVE_CFG (8 slots, block 16,
# chunk 64, captured steps). (a) block pressure: a pool of 64 blocks,
# 128-token prompts and 64 new tokens (a 12-block footprint, so 5
# resident streams fill it), 12 class-0 requests and, after 16 ticks, 6
# class-1 ones; (b) the engine.preempt site on spec engines; (c)
# shedding; (d) the watchdog; (e) allocator exhaustion.
PRESSURE_BLOCKS, PRESSURE_PROMPT, PRESSURE_NEW = 64, 128, 64
PRESSURE_LOW, PRESSURE_HIGH, PRESSURE_AFTER = 12, 6, 16
# (b): the plan's seed; its p 0.1 coin fires at engine.preempt visits 9,
# 11, 12, 31, ... (random.Random("3:engine.preempt"))
PRESSURE_PLAN_SEED = 3
# (c): requests shed (at submit, through tokens_for) by 8 class-0 then 4
# class-1 submits on max_queue 4, and by 3 class-0 then 2 class-1 ones on
# a high-water mark of 0.5 over PRESSURE_BLOCKS; tests/test_torch_priority.py
# (SHED_COUNTS) pins the same counts against the JAX engine.
SHED_COUNTS = {"max_queue": (4, 4), "high_water": (1, 2)}


def pressure_models(dev, seed: int = 0) -> dict:
    """SERVE_CFG's model at random weights from ``seed`` (phase 3's
    reference is built from the same seed), on peaked ones (embed x 8:
    decisive argmaxes), and a peaked 1-layer draft from ``seed + 1``."""
    from ray_tpu_torch.models import gpt
    cfg = gpt.small(**SERVE_CFG)
    tree = gpt.init_params(seed, cfg, dev)
    out = {"cfg": cfg, "random": gpt.GPT(cfg, tree, device=dev)}
    tree["embed"] = tree["embed"] * 8
    out["peaked"] = gpt.GPT(cfg, tree, device=dev)
    dcfg = gpt.small(**{**SERVE_CFG, "n_layers": SPEC_DRAFT_LAYERS})
    dtree = gpt.init_params(seed + 1, dcfg, dev)
    dtree["embed"] = dtree["embed"] * 8
    out["draft_cfg"], out["draft"] = dcfg, gpt.GPT(dcfg, dtree, device=dev)
    return out


def pressure_engine(dev, models, weights: str, warm: bool = True, **kw):
    """An engine at SERVE_CFG on ``models[weights]`` (8 slots unless
    ``kw`` says otherwise, block 16, chunk 64), warmed up (`warm_up`: every
    chunk bucket captured, the sentinel armed) and its stats zeroed."""
    from ray_tpu_torch.serve import InferenceEngine
    kw = {"slots": 8, **kw}
    if kw.get("spec") == "draft":
        kw.update(draft_params=models["draft"], draft_cfg=models["draft_cfg"])
    eng = InferenceEngine(models[weights], models["cfg"], max_len=1024,
                          block_size=16, prefill_chunk=64, device=dev, **kw)
    if warm:
        warm_up(eng, spec="spec" in kw)
    eng.reset_stats()
    return eng


def pressure_run(eng, reqs, new: int, late=(), late_class: int = 0,
                 after: int = 0) -> dict:
    """``reqs`` at class 0, then ``late`` at ``late_class`` after ``after``
    ticks, driven tick by tick with `check_invariants` after each: the
    streams, the wall time of each tick (each ends in its host sync), the
    requests seen as resumed (queued or admitted again) and the stats."""
    import torch
    from ray_tpu_torch import ops
    ops.reset_kernel_launches()
    st0 = eng.stats()
    rids = [eng.submit(p, max_new_tokens=new) for p in reqs]
    ticks, resumed = [], set()
    t0 = time.perf_counter()
    while True:
        if len(ticks) == after and late:
            rids += [eng.submit(p, max_new_tokens=new, priority=late_class)
                     for p in late]
        t = time.perf_counter()
        alive = eng.step()
        ticks.append(time.perf_counter() - t)
        eng.check_invariants()
        resumed |= {q.rid for q in eng._pending if q.resumed}
        resumed |= {s.rid for s in eng._slots if s.active and s.resumed}
        if not alive and len(ticks) > after:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    outs = [list(eng.tokens_for(r)) for r in rids]
    eng.check_invariants()
    if any(len(o) != new for o in outs):
        fail(f"phase 14: a stream delivered {[len(o) for o in outs]} "
             f"tokens, wanted {new} each")
    ticks_ms = sorted(x * 1e3 for x in ticks)
    return {"outs": outs, "stats": st, "built": builds(st0, st),
            "launches": ops.kernel_launches(), "wall_s": wall,
            "resumed": [i for i, r in enumerate(rids) if r in resumed],
            "tick_ms_p50": ticks_ms[len(ticks_ms) // 2],
            "tick_ms_p99": ticks_ms[min(len(ticks_ms) - 1,
                                        int(0.99 * len(ticks_ms)))],
            "ticks": len(ticks)}


def free_engine(eng):
    """Drop an engine's device memory (pools, graphs) before the next:
    ``eng`` (None once the caller dropped its own references)."""
    import gc
    import torch
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _greedy(outs) -> list:
    return [[int(t) for t in o] for o in outs]


def pressure_block(dev, models, smi: str) -> dict:
    """(a) The same 18 requests through an unpressured engine (one class,
    default pool) and a pressured one (2 classes, PRESSURE_BLOCKS) on
    peaked weights, then the pressured one at random weights: preemptions,
    64 tokens a stream, invariants every tick, per-class counters as the
    traffic says, nothing built after the warm-up (decode once), peaked
    tokens identical to the unpressured run's, phase 3's check of every
    preempted stream at random weights, the paged kernels' launches (the
    re-prefill's extra prefill chunks among them)."""
    import numpy as np
    vocab, layers = SERVE_CFG["vocab_size"], SERVE_CFG["n_layers"]
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, vocab, PRESSURE_PROMPT).astype(np.int32)
               for _ in range(PRESSURE_LOW + PRESSURE_HIGH)]
    low, high = prompts[:PRESSURE_LOW], prompts[PRESSURE_LOW:]
    runs = {}
    for name, weights, kw in (
            ("calm", "peaked", dict(priority_classes=1)),
            ("pressure", "peaked", dict(priority_classes=2,
                                        cache_blocks=PRESSURE_BLOCKS)),
            ("random", "random", dict(priority_classes=2,
                                      cache_blocks=PRESSURE_BLOCKS))):
        eng = pressure_engine(dev, models, weights, **kw)
        r = runs[name] = pressure_run(eng, low, PRESSURE_NEW, high,
                                      kw["priority_classes"] - 1,
                                      PRESSURE_AFTER)
        st = r["stats"]
        if st["retraces_unexpected"] or st["decode_traces"] != 1 \
                or any(r["built"].values()):
            fail(f"(a) {name}: steps built under pressure {r['built']}, "
                 f"retraces_unexpected {st['retraces_unexpected']}")
        check_paged_launches(r["launches"], layers, st, r["built"])
        pressured = name != "calm"
        if pressured != (st["preemptions"] >= 1):
            fail(f"(a) {name}: {st['preemptions']} preemptions")
        want = {"0": (PRESSURE_LOW + (0 if pressured else PRESSURE_HIGH),
                      st["preemptions"])}
        if pressured:
            want["1"] = (PRESSURE_HIGH, 0)
        got = {c: (row["completed"], row["preemptions"])
               for c, row in st["per_class"].items()}
        if got != want or any(
                row["submitted"] != row["completed"]
                or row["decode_tokens"] != row["completed"] * PRESSURE_NEW
                or row["sheds"] or row["pending"] or row["active"]
                for row in st["per_class"].values()):
            fail(f"(a) {name}: per_class {st['per_class']} against the "
                 f"traffic {want}")
        free_engine(eng)
    if _greedy(runs["pressure"]["outs"]) != _greedy(runs["calm"]["outs"]):
        fail("(a) peaked weights: pressured greedy tokens differ from the "
             "unpressured engine's")
    rnd = runs["random"]
    if not rnd["resumed"]:
        fail("(a) random weights: no preempted stream seen")
    tf = phase_teacher_forced(dev, SERVE_CFG, 0, [(p, 0.0) for p in prompts],
                              rnd["outs"], which=rnd["resumed"])
    reprefill_chunks = (rnd["stats"]["prefill_chunks"]
                        - runs["calm"]["stats"]["prefill_chunks"])
    out = {"card": smi, "teacher_forced": tf,
           "reprefill_chunks": reprefill_chunks,
           "reprefill_launches": layers * reprefill_chunks,
           "launches": rnd["launches"]}
    keys = ("preemptions", "reprefill_blocks", "evicted_blocks",
            "max_admission_stall_ms", "p50_token_latency_ms",
            "p99_token_latency_ms", "decode_tok_s", "prefill_chunks",
            "prefill_time_s", "decode_steps", "cache_block_utilization",
            "ttft_ms_p50", "ttft_ms_p99")
    for name, r in runs.items():
        st = r["stats"]
        out[name] = {**{k: st[k] for k in keys},
                     "per_class": st["per_class"], "wall_s": r["wall_s"],
                     "ticks": r["ticks"], "tick_ms_p50": r["tick_ms_p50"],
                     "tick_ms_p99": r["tick_ms_p99"],
                     "preempted_streams": len(r["resumed"])}
        pcs = "; ".join(
            f"class {c} TTFT p50 {row['queue_wait_ms_p50']:.1f} p99 "
            f"{row['queue_wait_ms_p99']:.1f} ms"
            for c, row in st["per_class"].items())
        print(f"  (a) {name:8s} [{smi}]: {r['ticks']} ticks in "
              f"{r['wall_s']:.2f} s, tick p50 {r['tick_ms_p50']:.3f} p99 "
              f"{r['tick_ms_p99']:.3f} ms, decode step p50 "
              f"{st['p50_token_latency_ms']:.3f} p99 "
              f"{st['p99_token_latency_ms']:.3f} ms, decode "
              f"{st['decode_tok_s']:.1f} tok/s; preemptions "
              f"{st['preemptions']} ({len(r['resumed'])} streams), "
              f"reprefill_blocks {st['reprefill_blocks']}, evicted_blocks "
              f"{st['evicted_blocks']}, max_admission_stall_ms "
              f"{st['max_admission_stall_ms']:.3f}, prefill chunks "
              f"{st['prefill_chunks']} ("
              f"{st['prefill_time_s'] * 1e3 / st['prefill_chunks']:.3f} ms "
              f"a chunk); {pcs}")
    print(f"  (a) peaked tokens pressured = unpressured; re-prefill "
          f"{reprefill_chunks} chunks ({layers * reprefill_chunks} "
          f"paged_mq_tc launches) at random weights")
    return out


def pressure_spec(dev, models, smi: str) -> dict:
    """(b) ``spec="ngram"`` and ``"draft"`` (a 1-layer draft) on peaked
    weights, 8 motif prompts, with and without the engine.preempt plan (p
    0.1, PRESSURE_PLAN_SEED), the plan twice: tokens identical without
    and with it, the same fault log on both runs with it, preemptions,
    nothing built after the warm-up."""
    from ray_tpu_torch.util import faults
    vocab, layers = SERVE_CFG["vocab_size"], SERVE_CFG["n_layers"]
    prompts = [p for p, _ in spec_traffic(vocab, 8, seed=14)]
    out = {}
    for which in ("ngram", "draft"):
        runs = []
        for plan in (False, True, True):
            eng = pressure_engine(dev, models, "peaked",
                                  **{k: v for k, v in
                                     SPEC_ENGINES[which].items()
                                     if k != "draft_layers"})
            if plan:
                faults.install(faults.FaultPlan(PRESSURE_PLAN_SEED).fail(
                    "engine.preempt", p=0.1, times=None))
            try:
                r = pressure_run(eng, prompts, SPEC_NEW)
            finally:
                fired = faults.fired()
                faults.clear()
            r["fired"] = fired
            st = r["stats"]
            if st["retraces_unexpected"] or any(r["built"].values()) \
                    or st["spec_steps"] <= 0:
                fail(f"(b) {which}: built {r['built']}, retraces_unexpected "
                     f"{st['retraces_unexpected']}, spec_steps "
                     f"{st['spec_steps']}")
            runs.append(r)
            free_engine(eng)
        calm, first, second = runs
        if first["stats"]["preemptions"] < 1:
            fail(f"(b) {which}: the plan preempted nothing")
        if _greedy(first["outs"]) != _greedy(calm["outs"]) \
                or _greedy(second["outs"]) != _greedy(calm["outs"]):
            fail(f"(b) {which}: tokens under forced preemption differ")
        if first["fired"] != second["fired"] or not first["fired"]:
            fail(f"(b) {which}: fault logs {first['fired']} and "
                 f"{second['fired']}")
        st, cst = first["stats"], calm["stats"]
        verify = first["launches"]["paged_verify_attention"]
        if verify != layers * st["spec_steps"]:
            fail(f"(b) {which}: {verify} verify launches for "
                 f"{st['spec_steps']} spec ticks")
        out[which] = {"preemptions": st["preemptions"],
                      "fired": len(first["fired"]),
                      "reprefill_blocks": st["reprefill_blocks"],
                      "verify_launches": verify,
                      "tick_ms_p50": first["tick_ms_p50"],
                      "calm_tick_ms_p50": calm["tick_ms_p50"],
                      "decode_tok_s": st["decode_tok_s"],
                      "calm_decode_tok_s": cst["decode_tok_s"],
                      "tokens_per_step": st["tokens_per_step"]}
        print(f"  (b) {which:5s} [{smi}]: {st['preemptions']} forced "
              f"preemptions ({len(first['fired'])} fires, the same log on "
              f"a second run), reprefill_blocks {st['reprefill_blocks']}; "
              f"tokens identical to the run without the plan; tick p50 "
              f"{first['tick_ms_p50']:.3f} ms (without: "
              f"{calm['tick_ms_p50']:.3f}), decode {st['decode_tok_s']:.1f} "
              f"tok/s (without: {cst['decode_tok_s']:.1f}), "
              f"tokens_per_step {st['tokens_per_step']:.3f}; "
              f"{verify} verify launches")
    return out


def pressure_shed(dev, models, smi: str) -> dict:
    """(c) Class-ordered shedding: the OverloadedErrors raised at submit
    and through tokens_for must be SHED_COUNTS; the rest complete."""
    import numpy as np
    from ray_tpu_torch.exceptions import OverloadedError
    vocab = SERVE_CFG["vocab_size"]
    rng = np.random.default_rng(15)
    out = {}
    for name, kw, classes, new in (
            ("max_queue", dict(max_queue=4), [0] * 8 + [1] * 4, 16),
            ("high_water", dict(shed_high_water=0.5,
                                cache_blocks=PRESSURE_BLOCKS),
             [0] * 3 + [1] * 2, PRESSURE_NEW)):
        eng = pressure_engine(dev, models, "random", warm=False,
                              priority_classes=2, **kw)
        rids, at_submit, via_tokens, done = [], 0, 0, 0
        for c in classes:
            try:
                rids.append(eng.submit(
                    rng.integers(0, vocab, PRESSURE_PROMPT),
                    max_new_tokens=new, priority=c))
            except OverloadedError:
                at_submit += 1
        for r in rids:
            try:
                done += len(list(eng.tokens_for(r))) == new
            except OverloadedError:
                via_tokens += 1
        eng.check_invariants()
        st = eng.stats()
        got = (at_submit, via_tokens)
        if got != SHED_COUNTS[name] or st["sheds"] != sum(got) \
                or done != len(classes) - sum(got):
            fail(f"(c) {name}: shed {got} (want {SHED_COUNTS[name]}), "
                 f"sheds {st['sheds']}, {done} completed")
        out[name] = {"at_submit": at_submit, "via_tokens_for": via_tokens,
                     "completed": done, "per_class": st["per_class"]}
        print(f"  (c) {name} [{smi}]: {at_submit} shed at submit, "
              f"{via_tokens} through tokens_for (the CPU test's counts), "
              f"{done} completed")
        free_engine(eng)
    return out


def pressure_watchdog(dev, models, smi: str) -> dict:
    """(d) watchdog_s 0.05 against a 0.25 s engine.tick delay at visit 5:
    a stall counted, the tokens of the same engine without the plan."""
    import numpy as np
    from ray_tpu_torch.util import faults
    vocab = SERVE_CFG["vocab_size"]
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, vocab, PRESSURE_PROMPT).astype(np.int32)
               for _ in range(4)]
    runs = []
    for plan in (False, True):
        eng = pressure_engine(dev, models, "peaked", watchdog_s=0.05)
        if plan:
            faults.install(faults.FaultPlan(1).delay(
                "engine.tick", delay_s=0.25, at=5, times=1))
        try:
            r = pressure_run(eng, prompts, 32)
        finally:
            fired = faults.fired()
            faults.clear()
        r["fired"] = fired
        runs.append(r)
        free_engine(eng)
    calm, stalled = runs
    stalls = stalled["stats"]["watchdog_stalls"]
    if stalls < 1 or ("engine.tick", 5, "delay") not in stalled["fired"]:
        fail(f"(d) watchdog_stalls {stalls}, fired {stalled['fired']}")
    if _greedy(stalled["outs"]) != _greedy(calm["outs"]):
        fail("(d) tokens differ under the tick delay")
    print(f"  (d) [{smi}]: watchdog_stalls {stalls} (without the plan "
          f"{calm['stats']['watchdog_stalls']}), tick p99 "
          f"{stalled['tick_ms_p99']:.1f} ms, tokens identical")
    return {"watchdog_stalls": stalls,
            "calm_watchdog_stalls": calm["stats"]["watchdog_stalls"],
            "tick_ms_p99": stalled["tick_ms_p99"]}


def pressure_alloc(dev, models, smi: str) -> dict:
    """(e) engine.alloc fails at visits 2 and 3 (the class-2 admission's
    first two attempts) with 3 slots and two class-0 streams decoding:
    exactly 2 preemptions, then every stream completes."""
    import numpy as np
    from ray_tpu_torch.util import faults
    vocab = SERVE_CFG["vocab_size"]
    rng = np.random.default_rng(17)
    eng = pressure_engine(dev, models, "random", warm=False, slots=3,
                          priority_classes=3)
    faults.install(faults.FaultPlan(1).fail("engine.alloc", at=2, times=2))
    try:
        low = [eng.submit(rng.integers(0, vocab, PRESSURE_PROMPT),
                          max_new_tokens=16) for _ in range(2)]
        for _ in range(3):
            eng.step()
        high = eng.submit(rng.integers(0, vocab, PRESSURE_PROMPT),
                          max_new_tokens=4, priority=2)
        while eng.step():
            eng.check_invariants()
        fired = faults.fired()
    finally:
        faults.clear()
    lens = [len(list(eng.tokens_for(r))) for r in low + [high]]
    eng.check_invariants()
    st = eng.stats()
    visits = [v for site, v, _ in fired if site == "engine.alloc"]
    if st["preemptions"] != 2 or visits != [2, 3] or lens != [16, 16, 4] \
            or st["per_class"]["0"]["preemptions"] != 2:
        fail(f"(e) preemptions {st['preemptions']}, alloc fires {visits}, "
             f"streams {lens}")
    print(f"  (e) [{smi}]: engine.alloc failed at visits {visits}: "
          f"{st['preemptions']} preemptions, streams {lens}")
    free_engine(eng)
    return {"preemptions": st["preemptions"], "alloc_fires": visits}


def phase_pressure(dev, smi: str) -> dict:
    """Phase 14: scheduling under pressure, (a) to (e), each part's time
    recorded."""
    import torch
    models = pressure_models(dev)
    out, part_s = {}, {}
    for part, fn in (("block", pressure_block), ("spec", pressure_spec),
                     ("shed", pressure_shed), ("watchdog", pressure_watchdog),
                     ("alloc", pressure_alloc)):
        t0 = time.perf_counter()
        out[part] = fn(dev, models, smi)
        part_s[part] = time.perf_counter() - t0
    out["part_s"] = part_s
    del models
    torch.cuda.empty_cache()
    return out


# Phase 15: disaggregated prefill/decode. (a) bench_infer.py's A/B
# (bench_infer.py:383-560) at its TPU defaults (bench_infer.py:213-214):
# slots 8, max_len 1024, block 16, DISAGG_STREAMS decode streams of
# DISAGG_PROMPT + DISAGG_NEW tokens, then DISAGG_LONG prompts of
# DISAGG_LONG_PROMPT tokens with max_new_tokens 1; 1 prefill + 1 decode
# engine against 2 colocated. (b) the backend matrix, (c) the replicas.
DISAGG_STREAMS, DISAGG_PROMPT, DISAGG_NEW = 8, 128, 128
DISAGG_LONG, DISAGG_LONG_PROMPT = 32, 512
# (b) and (c): DISAGG_REQUESTS prompts of DISAGG_PROMPT tokens,
# DISAGG_SHORT_NEW new tokens each
DISAGG_REQUESTS, DISAGG_SHORT_NEW = 8, 32
DISAGG_JOIN_S = 120.0       # the bound on the A/B's threads, all together
DISAGG_REPEATS = 3          # (a)'s rounds of fresh traffic, both modes each


def disagg_engine(dev, models, weights: str, role: str | None = None,
                  cfg=None, **kw):
    """An engine at SERVE_CFG (or ``cfg``) on ``models[weights]``, 8
    slots, max_len 1024, block 16, chunk 64, in ``role``."""
    from ray_tpu_torch.serve import InferenceEngine
    if kw.get("spec") == "draft":
        kw.update(draft_params=models["draft"], draft_cfg=models["draft_cfg"])
    if role is not None:
        kw["role"] = role
    return InferenceEngine(models[weights], cfg or models["cfg"], slots=8,
                           max_len=1024, block_size=16, prefill_chunk=64,
                           device=dev, **kw)


def warm_pair(pre, dec):
    """Every chunk bucket captured on a prefill-role engine (through
    `handoff_for`) and on a decode-role one (imports of those blobs, then
    `warm_up`'s local requests, which capture its decode step), and a
    handoff of each of the A/B's prompt lengths, as `bench_infer.py`'s
    warm-up makes one (their pinned buffers then come from PyTorch's
    host cache); both sentinels armed."""
    import numpy as np
    rng = np.random.default_rng(1)
    for n in WARM_PROMPTS + (DISAGG_PROMPT, DISAGG_LONG_PROMPT):
        blob = pre.handoff_for(pre.submit(
            rng.integers(0, pre.cfg.vocab_size, n), max_new_tokens=8))
        list(dec.tokens_for(dec.import_handoff(blob)))
    warm_up(dec, spec=dec.spec is not None)
    pre.arm_retrace_sentinel()


def ab_traffic(mode: str, engines, streams, longs, new: int) -> dict:
    """bench_infer.py's A/B traffic through ``engines``: ``mode``
    "colocated" spreads the streams and then the long prompts over the
    engines round-robin; "disagg" (``engines`` = prefill, decode) prefills
    each stream on the prefill engine (`handoff_for`), imports it and
    drains it on the decode engine, then hands the long prompts over from
    threads of their own. Each stream is drained by a thread that stamps
    every token on arrival: TTFT from its submit, TPOT the gaps between
    tokens (client side, as bench_infer.py measures). Every thread is
    joined within DISAGG_JOIN_S."""
    import threading
    import numpy as np
    recs, sink, threads = [None] * len(streams), [], []
    kv = {"bytes": 0, "blocks": 0, "import_s": 0.0}
    mu = threading.Lock()

    def drain(e, rid, i, t_submit):
        toks, gaps, ttft, last = [], [], None, t_submit
        for tok in e.tokens_for(rid):
            now = time.perf_counter()
            if ttft is None:
                ttft = (now - t_submit) * 1e3
            else:
                gaps.append((now - last) * 1e3)
            last = now
            toks.append(tok)
        with mu:
            if i is None:
                sink.append(ttft)
            else:
                recs[i] = (ttft, gaps, toks)

    def handoff(pre, dec, prompt, n):
        blob = pre.handoff_for(pre.submit(prompt, max_new_tokens=n))
        ti = time.perf_counter()
        drid = dec.import_handoff(blob)
        with mu:
            kv["import_s"] += time.perf_counter() - ti
            kv["bytes"] += blob["kv_bytes"]
            kv["blocks"] += blob["n_blocks"]
        return drid

    def long_disagg(pre, dec, prompt, t_submit):
        drain(dec, handoff(pre, dec, prompt, 1), None, t_submit)

    def start(fn, *args):
        th = threading.Thread(target=fn, args=args, daemon=True)
        th.start()
        threads.append(th)

    t_all = time.perf_counter()
    for i, p in enumerate(streams):
        t0 = time.perf_counter()
        if mode == "colocated":
            e = engines[i % len(engines)]
            start(drain, e, e.submit(p, max_new_tokens=new), i, t0)
        else:
            start(drain, engines[1], handoff(*engines, p, new), i, t0)
    time.sleep(0.05)         # let the streams reach steady decode
    for j, p in enumerate(longs):
        t0 = time.perf_counter()
        if mode == "colocated":
            e = engines[j % len(engines)]
            start(drain, e, e.submit(p, max_new_tokens=1), None, t0)
        else:
            start(long_disagg, *engines, p, t0)
    deadline = time.perf_counter() + DISAGG_JOIN_S
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.perf_counter()))
    if any(th.is_alive() for th in threads):
        fail(f"phase 15 {mode}: threads still running after "
             f"{DISAGG_JOIN_S} s")
    wall = time.perf_counter() - t_all
    if any(r is None for r in recs) or len(sink) != len(longs):
        fail(f"phase 15 {mode}: a drain thread failed")
    gaps = [g for _, gs, _ in recs for g in gs]
    out = {"wall_s": wall, "outs": [toks for _, _, toks in recs],
           "tpot_ms_p99": float(np.percentile(gaps, 99)),
           "tpot_ms_p50": float(np.percentile(gaps, 50)),
           "ttft_ms_p99": float(np.percentile([t for t, _, _ in recs], 99)),
           "long_ttft_ms_p99": (float(np.percentile(sink, 99))
                                if sink else 0.0)}
    if mode == "disagg":
        out.update(kv_blocks_streamed=kv["blocks"], kv_bytes=kv["bytes"],
                   kv_transfer_gbps=kv["bytes"] / max(kv["import_s"], 1e-9)
                   / 1e9)
    return out


def handoff_probe(pre, dec) -> dict:
    """The handoff alone on a warmed pair, DISAGG_REQUESTS requests of
    each A/B prompt length in turn: each blob is imported and drained
    before the next export, so every export's pinned buffer comes from
    PyTorch's host cache (warm). Per length the export's p50/p99 (gather,
    device-to-host copy, sync) with its rate, and the import's host time.
    Host syncs are counted around the prefill engine's work: one a
    prefill chunk plus ONE an export, or it fails."""
    import numpy as np
    import torch
    rng = np.random.default_rng(151)
    vocab = pre.cfg.vocab_size
    out, syncs, chunks, exports = {}, 0, 0, 0
    for n in (DISAGG_PROMPT, DISAGG_LONG_PROMPT):
        pre.reset_stats()
        dec.reset_stats()
        st0 = pre.stats()
        for _ in range(DISAGG_REQUESTS):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    blob = pre.handoff_for(pre.submit(
                        rng.integers(0, vocab, n), max_new_tokens=2))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs += sum("synchroniz" in str(w.message) for w in caught)
            list(dec.tokens_for(dec.import_handoff(blob)))
            del blob
        ps, ds = pre.stats(), dec.stats()
        if any(builds(st0, ps).values()):
            fail(f"(a) probe: built {builds(st0, ps)}")
        chunks += ps["prefill_chunks"]
        exports += ps["handoffs"]
        per = ps["kv_export_bytes"] / ps["handoffs"]
        out[n] = {"blocks": ps["kv_blocks_exported"] // ps["handoffs"],
                  "bytes": per,
                  **{k: ps[k] for k in ("kv_export_ms_p50",
                                        "kv_export_ms_p99")},
                  **{k: ds[k] for k in ("kv_import_ms_p50",
                                        "kv_import_ms_p99")},
                  "export_gbps_p50": per / ps["kv_export_ms_p50"] / 1e6,
                  "import_gbps_p50": per / ds["kv_import_ms_p50"] / 1e6}
    if syncs != chunks + exports:
        fail(f"phase 15: {syncs} host syncs for {chunks} prefill chunks "
             f"and {exports} exports (want one each)")
    out["host_syncs"] = {"syncs": syncs, "prefill_chunks": chunks,
                         "exports": exports}
    return out


def check_ab_engine(what: str, eng, st0: dict) -> dict:
    """After an A/B run: invariants, nothing built since ``st0`` and no
    unexpected retrace; returns the engine's stats."""
    st = eng.stats()
    eng.check_invariants()
    if any(builds(st0, st).values()) or st["retraces_unexpected"]:
        fail(f"(a) {what}: built {builds(st0, st)}, retraces_unexpected "
             f"{st['retraces_unexpected']}")
    return st


def disagg_ab(dev, models, smi: str) -> dict:
    """(a) The A/B on peaked weights: 2 colocated engines and a prefill +
    a decode engine, all warmed (every step captured, sentinels armed),
    then DISAGG_REPEATS rounds of fresh traffic, each through both
    topologies (alternating which goes first), stats and launch counters
    zeroed around every run: nothing built and no unexpected retrace,
    invariants after, the prefill engine never decodes, the paged
    launches of the pair, each stream's greedy tokens identical between
    the modes; client-side TPOT and TTFT p99 per run, the handoff's
    bytes, blocks and rates; before the rounds, `handoff_probe` on the
    pair. Then the first round's streams through a disaggregated pair at
    random weights, and phase 3's check of two of them against the dense
    f32 reference."""
    import numpy as np
    from ray_tpu_torch import ops
    vocab, layers = SERVE_CFG["vocab_size"], SERVE_CFG["n_layers"]
    rng = np.random.default_rng(15)
    rounds = [([rng.integers(0, vocab, DISAGG_PROMPT).astype(np.int32)
                for _ in range(DISAGG_STREAMS)],
               [rng.integers(0, vocab, DISAGG_LONG_PROMPT).astype(np.int32)
                for _ in range(DISAGG_LONG)])
              for _ in range(DISAGG_REPEATS)]
    engines = [disagg_engine(dev, models, "peaked") for _ in range(2)]
    for e in engines:
        warm_up(e)
    pre = disagg_engine(dev, models, "peaked", role="prefill")
    dec = disagg_engine(dev, models, "peaked", role="decode")
    warm_pair(pre, dec)
    probe = handoff_probe(pre, dec)
    runs = {"colocated": [], "disagg": []}
    for r, (streams, longs) in enumerate(rounds):
        for mode in (("colocated", "disagg") if r % 2 == 0
                     else ("disagg", "colocated")):
            eng = engines if mode == "colocated" else [pre, dec]
            for e in eng:
                e.reset_stats()
            st0 = [e.stats() for e in eng]
            ops.reset_kernel_launches()
            run = ab_traffic(mode, eng, streams, longs, DISAGG_NEW)
            run["launches"] = ops.kernel_launches()
            names = (["colocated 0", "colocated 1"] if mode == "colocated"
                     else ["prefill", "decode"])
            run["engines"] = {n: check_ab_engine(n, e, s0)
                              for n, e, s0 in zip(names, eng, st0)}
            runs[mode].append(run)
        col, dis = runs["colocated"][-1], runs["disagg"][-1]
        ps, ds = dis["engines"]["prefill"], dis["engines"]["decode"]
        if ps["decode_steps"] or ps["decode_traces"] or \
                ("decode", None) in pre._steps:
            fail("(a) the prefill-role engine decoded")
        if not ps["handoffs"] == ds["imports"] == len(streams) + len(longs):
            fail(f"(a) {ps['handoffs']} exports, {ds['imports']} imports")
        launches = dis["launches"]
        want = {"paged_decode_attention": layers * ds["decode_steps"],
                "paged_prefill_attention": layers * (ps["prefill_chunks"]
                                                     + ds["prefill_chunks"]),
                "paged_mq_simt": 0}
        if {k: launches[k] for k in want} != want \
                or not launches["paged_decode_attention"]:
            fail(f"(a) paged launches {launches}, want {want}")
        if _greedy(dis["outs"]) != _greedy(col["outs"]):
            fail(f"(a) round {r}, peaked weights: disaggregated tokens "
                 f"differ from the colocated run's")
    del e, eng, engines, pre, dec
    free_engine(None)

    streams = rounds[0][0]
    pre = disagg_engine(dev, models, "random", role="prefill")
    dec = disagg_engine(dev, models, "random", role="decode")
    rnd = ab_traffic("disagg", (pre, dec), streams, [], DISAGG_NEW)
    pre.check_invariants()
    dec.check_invariants()
    tf = phase_teacher_forced(dev, SERVE_CFG, 0,
                              [(p, 0.0) for p in streams], rnd["outs"])
    del pre, dec
    free_engine(None)

    ekeys = ("decode_steps", "prefill_chunks", "p50_token_latency_ms",
             "p99_token_latency_ms", "max_admission_stall_ms",
             "kv_export_ms_p50", "kv_export_ms_p99", "kv_import_ms_p50",
             "kv_import_ms_p99", "kv_blocks_exported", "kv_blocks_imported",
             "handoffs", "imports")
    out = {"card": smi, "probe": probe, "teacher_forced": tf,
           "launches": runs["disagg"][0]["launches"]}
    for mode, rs in runs.items():
        out[mode] = [{**{k: v for k, v in r.items()
                         if k not in ("outs", "engines", "launches")},
                      "engines": {n: {k: st[k] for k in ekeys}
                                  for n, st in r["engines"].items()}}
                     for r in rs]
    for n, p in probe.items():
        if n == "host_syncs":
            continue
        print(f"  (a) probe [{smi}]: {n}-token prompt, {p['blocks']} blocks "
              f"({p['bytes'] / 1e6:.1f} MB): export p50 "
              f"{p['kv_export_ms_p50']:.3f} p99 {p['kv_export_ms_p99']:.3f}"
              f" ms ({p['export_gbps_p50']:.1f} GB/s), import (host) p50 "
              f"{p['kv_import_ms_p50']:.3f} p99 {p['kv_import_ms_p99']:.3f}"
              f" ms ({p['import_gbps_p50']:.1f} GB/s)")
    print(f"  (a) probe: {probe['host_syncs']} (one a chunk, one an "
          f"export)")
    for r in range(DISAGG_REPEATS):
        for mode in ("colocated", "disagg"):
            x = runs[mode][r]
            steps = "; ".join(
                f"{n} step p50/p99 {st['p50_token_latency_ms']:.3f}/"
                f"{st['p99_token_latency_ms']:.3f} ms"
                for n, st in x["engines"].items() if st["decode_steps"])
            extra = ""
            if mode == "disagg":
                ps, ds = x["engines"]["prefill"], x["engines"]["decode"]
                extra = (f"; {x['kv_blocks_streamed']} blocks, "
                         f"{x['kv_bytes'] / 1e6:.1f} MB, kv_transfer_gbps "
                         f"{x['kv_transfer_gbps']:.2f} (bytes over "
                         f"import_handoff's wall); export p50 "
                         f"{ps['kv_export_ms_p50']:.3f} p99 "
                         f"{ps['kv_export_ms_p99']:.3f} ms, import p50 "
                         f"{ds['kv_import_ms_p50']:.3f} p99 "
                         f"{ds['kv_import_ms_p99']:.3f} ms")
            print(f"  (a) round {r} {mode:9s} [{smi}]: {x['wall_s']:.2f} s,"
                  f" client TPOT p50 {x['tpot_ms_p50']:.3f} p99 "
                  f"{x['tpot_ms_p99']:.3f} ms, TTFT p99 "
                  f"{x['ttft_ms_p99']:.3f} ms, long-prompt TTFT p99 "
                  f"{x['long_ttft_ms_p99']:.3f} ms; {steps}{extra}")
    print(f"  (a) launches of round 0's pair "
          f"{ {k: n for k, n in out['launches'].items() if n} }; peaked "
          f"tokens identical to colocated in every round; random weights: "
          f"phase 3's check passed")
    return out


def disagg_backends(dev, models, smi: str) -> dict:
    """(b) int8 kv + w, ``spec="ngram"`` and ``spec="draft"`` (a 1-layer
    draft), each through a prefill/decode pair on peaked weights against
    a colocated engine of the same backend: identical tokens, the prefill
    engine never decodes, invariants, the decode engine's paged launches
    counted from zero around the pair's run (the verify caller on the
    spec engines)."""
    import dataclasses
    from ray_tpu_torch import ops
    vocab, layers = SERVE_CFG["vocab_size"], SERVE_CFG["n_layers"]
    prompts = [p for p, _ in spec_traffic(vocab, DISAGG_REQUESTS, seed=15)]
    int8 = dataclasses.replace(models["cfg"], kv_dtype="int8",
                               weight_dtype="int8")
    out = {}
    for which, cfg, kw in (("int8", int8, {}),
                           ("ngram", None, dict(spec="ngram", spec_k=SPEC_K)),
                           ("draft", None, dict(spec="draft", spec_k=SPEC_K))):
        col = disagg_engine(dev, models, "peaked", cfg=cfg, **kw)
        rids = [col.submit(p, max_new_tokens=DISAGG_SHORT_NEW)
                for p in prompts]
        col.run_until_idle()
        want = _greedy([list(col.tokens_for(r)) for r in rids])
        del col
        free_engine(None)
        pre = disagg_engine(dev, models, "peaked", "prefill", cfg, **kw)
        dec = disagg_engine(dev, models, "peaked", "decode", cfg, **kw)
        ops.reset_kernel_launches()
        rids = [dec.import_handoff(pre.handoff_for(
            pre.submit(p, max_new_tokens=DISAGG_SHORT_NEW)))
            for p in prompts]
        dec.run_until_idle()
        got = _greedy([list(dec.tokens_for(r)) for r in rids])
        launches = ops.kernel_launches()
        ps, ds = pre.stats(), dec.stats()
        pre.check_invariants()
        dec.check_invariants()
        if got != want:
            fail(f"(b) {which}: disaggregated tokens differ from colocated")
        if ps["decode_steps"] or ds["imports"] != len(prompts):
            fail(f"(b) {which}: prefill decode_steps {ps['decode_steps']}, "
                 f"imports {ds['imports']}")
        verify = launches["paged_verify_attention"]
        if "spec" in kw and (ds["spec_steps"] <= 0 or verify != layers * (
                ds["spec_steps"] + ds["verify_traces"])):
            fail(f"(b) {which}: {verify} verify launches for "
                 f"{ds['spec_steps']} spec ticks")
        if which == "int8" and (launches["paged_decode_int8"] !=
                                launches["paged_decode_attention"] or
                                not launches["paged_mq_tc_int8"]):
            fail(f"(b) int8: launches {launches}")
        out[which] = {"launches": launches, "verify_launches": verify,
                      "spec_steps": ds["spec_steps"],
                      "kv_blocks_exported": ps["kv_blocks_exported"],
                      "kv_export_bytes": ps["kv_export_bytes"],
                      "kv_export_ms_p50": ps["kv_export_ms_p50"],
                      "kv_import_ms_p50": ds["kv_import_ms_p50"]}
        print(f"  (b) {which:5s} [{smi}]: {len(prompts)} streams identical "
              f"to colocated; {ps['kv_blocks_exported']} blocks exported "
              f"({ps['kv_export_bytes'] / 1e6:.1f} MB); spec ticks "
              f"{ds['spec_steps']}, verify launches {verify}")
        del pre, dec
        free_engine(None)
    return out


def disagg_transport(dev, models, smi: str) -> dict:
    """(c) `PrefillReplica` -> `DecodeReplica` over localhost netaddr on
    the card, both on peaked weights (`update_params`): the descriptors'
    streams identical to a colocated replica's; the pulls' p50/p99 and
    rate; a descriptor to a dead address prefilled locally, identical and
    counted; both replicas closed."""
    import numpy as np
    from ray_tpu_torch.serve import (DecodeReplica, InferenceReplica,
                                     PrefillReplica)
    vocab = SERVE_CFG["vocab_size"]
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, vocab, DISAGG_PROMPT).astype(np.int32)
               for _ in range(DISAGG_REQUESTS)]
    kw = dict(slots=8, max_len=1024, seed=0, device=dev,
              engine_kwargs=dict(block_size=16, prefill_chunk=64))
    # listeners bind 0.0.0.0 and advertise this host's loopback address
    node_ip = os.environ.get("RAY_TPU_NODE_IP")
    os.environ["RAY_TPU_NODE_IP"] = "127.0.0.1"
    pre = dec = None
    try:
        pre = PrefillReplica(SERVE_CFG, **kw)
        dec = DecodeReplica(SERVE_CFG, **kw)
        local = InferenceReplica(SERVE_CFG, **kw)
        for eng in (pre.engine, dec.engine, local.engine):
            eng.update_params(models["peaked"])
        want = [_greedy([list(local(p, max_new_tokens=DISAGG_SHORT_NEW))])[0]
                for p in prompts]
        descs = [pre(p, max_new_tokens=DISAGG_SHORT_NEW) for p in prompts]
        got = [_greedy([list(dec(d))])[0] for d in descs]
        st = dec.stats()
        if got != want or st["imports"] != len(prompts) \
                or st["handoff_fallbacks"]:
            fail(f"(c) pulled streams differ from colocated (imports "
                 f"{st['imports']}, fallbacks {st['handoff_fallbacks']})")
        # a pull's frames land in one pinned buffer that the import
        # copies from directly (the blob's kv_host)
        blob = dec._pull_blob(pre(prompts[1], max_new_tokens=DISAGG_SHORT_NEW))
        if not blob["kv_host"].is_pinned() or _greedy([list(
                dec.engine.tokens_for(dec.engine.import_handoff(blob)))])[0] \
                != want[1]:
            fail("(c) a pulled blob's pinned kv_host import")
        dead = dict(descs[0], handoff_addr="127.0.0.1:9")
        if _greedy([list(dec(dead))])[0] != want[0] or \
                dec.stats()["handoff_fallbacks"] != 1:
            fail("(c) the dead-address fallback")
        pre.engine.check_invariants()
        dec.engine.check_invariants()
        out = {k: st[k] for k in ("handoff_pull_ms_p50",
                                  "handoff_pull_ms_p99", "kv_transfer_gbps",
                                  "kv_pulled_bytes", "kv_import_ms_p50")}
        out["kv_export_ms_p50"] = pre.stats()["kv_export_ms_p50"]
        print(f"  (c) [{smi}]: {len(prompts)} descriptors pulled over "
              f"localhost, streams identical to colocated; pull p50 "
              f"{st['handoff_pull_ms_p50']:.3f} p99 "
              f"{st['handoff_pull_ms_p99']:.3f} ms, kv_transfer_gbps "
              f"{st['kv_transfer_gbps']:.2f} ({st['kv_pulled_bytes'] / 1e6:.1f}"
              f" MB); dead address: local prefill, identical, 1 fallback")
    finally:
        for r in (pre, dec):
            if r is not None:
                r.close()
        if node_ip is None:
            os.environ.pop("RAY_TPU_NODE_IP", None)
        else:
            os.environ["RAY_TPU_NODE_IP"] = node_ip
    if pre._accept_thread.is_alive():
        fail("(c) the block server's accept thread outlived close()")
    return out


def phase_disagg(dev, smi: str) -> dict:
    """Phase 15: disaggregated prefill/decode, (a) to (c), each part's
    time recorded."""
    import torch
    models = pressure_models(dev)
    out, part_s = {}, {}
    for part, fn in (("ab", disagg_ab), ("backends", disagg_backends),
                     ("transport", disagg_transport)):
        t0 = time.perf_counter()
        out[part] = fn(dev, models, smi)
        part_s[part] = time.perf_counter() - t0
    out["part_s"] = part_s
    del models
    torch.cuda.empty_cache()
    return out


# Phase 16: the RL flywheel and the telemetry plane. (a) bench_infer.py's
# model learning from its own rollouts: bench_infer.py's rollout probe
# (bench_infer.py:325-348: 8 prompts of 128 tokens an iteration, 128 new
# tokens at temperature 1), padded to 256, through a captured engine of
# 8 slots, block 16, chunk 64; FLY_ITERS iterations of spmd.Adam(FLY_LR),
# a publish every iteration. (b) tests/test_flywheel.py::_flywheel's
# tiny configuration on the card. (c) the flight recorder's cost on phase
# 2's traffic.
FLY_PROMPTS, FLY_PROMPT, FLY_NEW, FLY_PAD = 8, 128, 128, 256
FLY_ITERS, FLY_LR = 6, 1e-5
# (b): the reward rise tests/test_flywheel.py::test_flywheel_e2e_smoke
# asserts, mean of the last 4 iterations over the first 4
FLY_TINY_ITERS, FLY_TINY_RISE = 12, 0.15
# (c): rounds, each phase 2's traffic TELEMETRY_REPEAT times through
# each engine, the order alternating
TELEMETRY_ROUNDS, TELEMETRY_REPEAT = 8, 3


def half_vocab_reward(vocab: int):
    """Reward = the share of completion tokens in the lower half of the
    vocabulary: at random weights about 0.5 with a spread over a batch,
    so the advantages (and the first gradients) are not zero."""
    import numpy as np

    def reward(prompt, completion):
        comp = np.asarray(completion)
        return float((comp < vocab // 2).mean()) if comp.size else 0.0
    return reward


def flywheel_full_width(dev, smi: str) -> dict:
    """(a): see FLY_*. Held to: nothing built after the warm-up and no
    unexpected retrace on the engine or the loop; the first learner
    step's loss and gradients with flash against plain attention from the
    same masters (phase 6's limits), on an extra rollout from the initial
    weights; that rollout's behaviour logprobs against
    `completion_logprobs` on the same weights (phase 3's 0.1); after the
    run, peaked final weights published and greedy tokens identical to a
    fresh engine built on them."""
    import collections
    import dataclasses

    import numpy as np
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.rl.flywheel import FlywheelLoop, surrogate_loss
    from ray_tpu_torch.serve import InferenceEngine
    from ray_tpu_torch.train import spmd

    cfg = gpt.small(**SERVE_CFG)
    vocab = cfg.vocab_size
    ekw = dict(slots=FLY_PROMPTS, max_len=FLY_PAD, block_size=16,
               prefill_chunk=64)
    t0 = time.perf_counter()
    fly = FlywheelLoop(
        cfg, lambda rng: rng.integers(0, vocab, FLY_PROMPT).astype(np.int32),
        half_vocab_reward(vocab), optimizer=spmd.Adam(FLY_LR),
        prompts_per_iter=FLY_PROMPTS, max_new_tokens=FLY_NEW,
        temperature=1.0, pad_to=FLY_PAD, seed=0, engine_kwargs=ekw,
        device=dev)
    eng, model = fly.engine, fly.state.params
    warm_up(eng)
    st0 = eng.stats()
    out = {"build_and_warm_s": time.perf_counter() - t0}

    # The first learner step, checked on an extra rollout from the
    # initial weights: flash against plain attention; the behaviour
    # logprobs against the recompute. The first rollout's baseline is its
    # own mean reward, so its advantages sum to zero and so does the
    # surrogate, near enough: the check runs on the raw rewards instead
    # (the advantages plus that mean), an O(1) loss, and also holds the
    # per-token logprobs of the two paths to phase 3's limit.
    pre = fly._collect()
    live = pre["mask"] > 0
    raw = {**pre, "advantage": pre["advantage"]
           + fly.history[-1]["reward_mean"]}
    res, lps = {}, {}
    for impl in ("flash", "xla"):
        loss, (lps[impl], *_) = surrogate_loss(
            model, raw, dataclasses.replace(cfg, attn_impl=impl), FLY_NEW,
            0.2)
        res[impl] = (loss.item(),
                     torch.autograd.grad(loss, list(model.parameters())))
    cmp = _compare_runs("(a) first learner step on the raw rewards, flash "
                        "vs plain attention", model, res["flash"],
                        res["xla"])
    if not abs(res["flash"][0]) >= 0.1:
        fail(f"(a) the raw-reward loss {res['flash'][0]} is not O(1)")
    path_gap = (lps["flash"] - lps["xla"]).detach().abs()[live]
    cmp.update(logprob_gap_max=path_gap.max().item(),
               logprob_gap_mean=path_gap.mean().item())
    print(f"      completion_logprobs, flash vs plain attention: max|diff| "
          f"{cmp['logprob_gap_max']:.4f} (limit {LOGPROB_TOL}), mean "
          f"{cmp['logprob_gap_mean']:.5f}")
    if not cmp["logprob_gap_max"] <= LOGPROB_TOL:
        fail(f"(a) flash logprobs off plain attention's by "
             f"{cmp['logprob_gap_max']}")
    lp = lps["flash"].detach()
    del res, lps, raw
    gap = (lp - pre["behavior_logp"]).abs()[live]
    gap_max, gap_mean = gap.max().item(), gap.mean().item()
    ratio0 = torch.exp(lp - pre["behavior_logp"])[live]
    print(f"  (a) behaviour logprobs (bf16 paged engine) vs "
          f"completion_logprobs (bf16 flash forward), {int(live.sum())} "
          f"tokens: max|diff| {gap_max:.4f} (limit {LOGPROB_TOL}), mean "
          f"{gap_mean:.5f}; ratio mean {ratio0.mean().item():.5f}, range "
          f"{ratio0.min().item():.4f}-{ratio0.max().item():.4f}")
    if not gap_max <= LOGPROB_TOL:
        fail(f"(a) behaviour logprobs off the recompute by {gap_max}")
    del pre, lp

    # The run: each dispatch (the learner's step) timed with events and
    # its launches counted apart from the rollouts'.
    learner = collections.Counter()
    events, swap_ms = [], []
    dispatch, collect = fly.loop._dispatch, fly._collect

    def timed(state, batch):
        before = ops.kernel_launches()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        got = dispatch(state, batch)
        e1.record()
        events.append((e0, e1))
        learner.update({k: n - before[k]
                        for k, n in ops.kernel_launches().items()})
        return got

    def collected():
        got = collect()
        swap_ms.append(eng.stats()["weight_swap_ms"])
        return got

    fly.loop._dispatch, fly._collect = timed, collected
    ops.reset_kernel_launches()
    st_run = eng.stats()
    # Every host sync of the run is recorded: the rollouts' one a tick
    # and a chunk, the metrics ring's drain, and nothing for the learner
    # step or the publish (stream order alone puts the publish's copy
    # after the optimizer's update and before the next rollout).
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        state, metrics = fly.run(FLY_ITERS)
        wall = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    fly.loop._dispatch, fly._collect = dispatch, collect
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    total = ops.kernel_launches()
    learner = {k: learner.get(k, 0) for k in total}
    engine_l = {k: total[k] - learner[k] for k in total}
    step_ms = [a.elapsed_time(b) for a, b in events]
    flops = spmd.train_flops_per_token(cfg, FLY_PAD) * FLY_PROMPTS * FLY_PAD
    step_p50 = statistics.median(step_ms)
    st = eng.stats()
    built = builds(st0, st)
    hist = fly.history[1:]          # [0] is the extra rollout
    tok_s = [h["rollout_tok_s"] for h in hist]
    swaps = swap_ms[1:]             # the window after each publish
    ls = fly.loop.stats()
    if any(built.values()) or st["retraces_unexpected"] or \
            ls["retraces_unexpected"]:
        fail(f"(a) built after the warm-up {built}, retraces_unexpected "
             f"engine {st['retraces_unexpected']} loop "
             f"{ls['retraces_unexpected']}")
    rollout_syncs = (st["decode_steps"] - st_run["decode_steps"]
                     + st["prefill_chunks"] - st_run["prefill_chunks"])
    fetches = fly.loop.last_ring.fetches
    if syncs != rollout_syncs + fetches:
        fail(f"(a) {syncs} host syncs in the run: the rollouts' ticks and "
             f"chunks make {rollout_syncs}, the metrics ring {fetches} "
             "(want nothing else)")
    if st["swaps"] != FLY_ITERS or fly.published_version != FLY_ITERS:
        fail(f"(a) {st['swaps']} swaps, published version "
             f"{fly.published_version}, want {FLY_ITERS}")
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        if learner[name] <= 0 or engine_l[name]:
            fail(f"(a) {name}: learner {learner[name]}, engine "
                 f"{engine_l[name]}")
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        if engine_l[name] <= 0 or learner[name]:
            fail(f"(a) {name}: engine {engine_l[name]}, learner "
                 f"{learner[name]}")
    check_flash_backward_launches(learner, FLY_ITERS, cfg.n_layers)
    if len(metrics) != FLY_ITERS or not all(
            np.isfinite(float(m["loss"])) for m in metrics):
        fail(f"(a) learner metrics {metrics}")
    stale = [h["staleness"] for h in hist]
    print(f"  (a) [{smi}] {FLY_ITERS} iterations in {wall:.2f} s: "
          f"rollout_tok_s {[round(x) for x in tok_s]} (p50 "
          f"{statistics.median(tok_s):.0f}); learner step (events) "
          f"{[round(x, 2) for x in step_ms]} ms, p50 {step_p50:.2f} ms, MFU "
          f"{flops / (step_p50 * 1e-3) / BF16_OPS_PER_S:.4f}; loop MFU "
          f"{ls['mfu']:.4f}, shares rollout {ls['prefetch_share']:.3f} "
          f"learner {ls['dispatch_share']:.3f} publish "
          f"{ls['publish_share']:.4f}; weight_swap_ms "
          f"{[round(x, 2) for x in swaps]} (p50 "
          f"{statistics.median(swaps):.2f}); staleness {stale}; first "
          f"mean_ratio {float(metrics[0]['mean_ratio']):.5f}; host syncs "
          f"{syncs} = {rollout_syncs} rollout ticks and chunks + {fetches} "
          "metric fetch")
    print(f"      launches: learner "
          f"{ {k: v for k, v in learner.items() if v} }, engine "
          f"{ {k: v for k, v in engine_l.items() if v} }")

    # Where a learner step's time goes: one more step (on a fresh
    # rollout) under torch.profiler, device time by kernel group (flash
    # kernels, cuBLAS GEMMs, the rest: elementwise, reduction, copy and
    # index kernels) and the device's busy share of the step's wall.
    batch = fly._collect()
    (fly.state, _), prof = profile_window(
        lambda: fly.loop._dispatch(fly.state, batch),
        (("flash", ("flash_",)), ("gemm", GEMM_NAMES)))
    prof = {**{k: v for k, v in prof.items() if k != "kernels"},
            "wall_ms": prof["wall_s"] * 1e3,
            "top_kernels": top_kernels(prof["kernels"], 8)}
    print(f"      one learner step profiled: wall {prof['wall_ms']:.2f} ms, "
          f"device busy {prof['device_ms']:.2f} ms "
          f"({prof['device_busy_share']:.1%}), by group "
          f"{ {k: round(v, 2) for k, v in prof['device_ms_by_group'].items()} }"
          f", {prof['launches']} kernel launches")

    # Peaked final weights, published; a fresh engine built on them.
    final = gpt.param_tree(model)
    peaked = {**{k: v.detach().clone() for k, v in final.items()
                 if k != "layers"},
              "embed": final["embed"].detach() * 8,
              "layers": {k: v.detach().clone()
                         for k, v in final["layers"].items()}}
    eng.update_params(peaked)
    fresh = InferenceEngine(gpt.GPT(cfg, peaked, device=dev), cfg,
                            device=dev, **ekw)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (64, 128, 100, 128)]
    got = [_greedy([eng.generate(p, max_new_tokens=32)])[0] for p in prompts]
    want = [_greedy([fresh.generate(p, max_new_tokens=32)])[0]
            for p in prompts]
    st2 = eng.stats()
    if got != want or any(builds(st0, st2).values()) or \
            st2["retraces_unexpected"]:
        fail(f"(a) post-publish greedy tokens differ from a fresh engine's "
             f"on the peaked final weights, or the publish built "
             f"{builds(st0, st2)}")
    compile_once = check_compile_once(eng, "phase 16 (a) engine")
    print(f"      peaked final weights published (version "
          f"{eng.params_version}): {len(prompts)} greedy streams identical "
          f"to a fresh engine's; compile-once {compile_once}")
    out.update(
        wall_s=wall, iterations=FLY_ITERS, rollout_tok_s=tok_s,
        rollout_tok_s_p50=statistics.median(tok_s), learner_step_ms=step_ms,
        learner_step_ms_p50=step_p50,
        learner_mfu=flops / (step_p50 * 1e-3) / BF16_OPS_PER_S,
        learner_flops_per_step=flops, loop_stats=ls,
        weight_swap_ms=swaps, weight_swap_ms_p50=statistics.median(swaps),
        staleness=stale, first_step=cmp, logprob_gap_max=gap_max,
        logprob_gap_mean=gap_mean, first_mean_ratio=float(
            metrics[0]["mean_ratio"]),
        launches_learner=learner, launches_engine=engine_l,
        host_syncs=syncs, rollout_syncs=rollout_syncs,
        compile_once=compile_once, learner_profile=prof,
        rewards=[h["reward_mean"] for h in hist],
        losses=[float(m["loss"]) for m in metrics])
    del fly, eng, model, state, fresh, final, peaked, batch
    free_engine(None)
    return out


def flywheel_tiny(dev, smi: str):
    """(b): tests/test_flywheel.py::_flywheel's configuration on the card
    (vocab 32, d_model 32, 2 layers, f32, spmd.Adam(5e-2), 8 prompts of 3
    tokens, 5 new), a second engine fed by ``publish_to``. Held to the
    e2e smoke's checks. Returns the record and the loop (kept alive for
    (c)'s scrape)."""
    import numpy as np
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.rl.flywheel import FlywheelLoop, motif_reward
    from ray_tpu_torch.serve import InferenceEngine

    cfg = gpt.GPTConfig(vocab_size=32, d_model=32, n_layers=2, n_heads=2,
                        d_ff=64, max_seq_len=64, dtype="float32")
    ekw = dict(slots=4, max_len=32, prefill_buckets=(8,), block_size=8)
    replica_like = InferenceEngine(
        gpt.GPT(cfg, gpt.init_params(0, cfg, dev), device=dev), cfg,
        device=dev, **ekw)
    t0 = time.perf_counter()
    fly = FlywheelLoop(cfg, lambda rng: [1, 2, int(rng.integers(3, 9))],
                       motif_reward(7), lr=5e-2, prompts_per_iter=8,
                       max_new_tokens=5, temperature=1.0, pad_to=16, seed=0,
                       engine_kwargs=ekw, publish_to=[replica_like],
                       device=dev)
    state, metrics = fly.run(FLY_TINY_ITERS)
    wall = time.perf_counter() - t0
    st = fly.engine.stats()
    rw = [h["reward_mean"] for h in fly.history]
    rise = float(np.mean(rw[-4:]) - np.mean(rw[:4]))
    fresh = InferenceEngine(gpt.GPT(cfg, gpt.param_tree(state.params),
                                    device=dev), cfg, device=dev, **ekw)
    same = all(_greedy([fly.engine.generate(p, max_new_tokens=5)])
               == _greedy([fresh.generate(p, max_new_tokens=5)])
               for p in ([1, 2, 3], [1, 2, 8]))
    print(f"  (b) [{smi}] tiny flywheel, {FLY_TINY_ITERS} iterations in "
          f"{wall:.2f} s: rewards {[round(x, 3) for x in rw]}, last 4 - "
          f"first 4 = {rise:.3f} (want > {FLY_TINY_RISE}); swaps "
          f"{st['swaps']}, decode_traces {st['decode_traces']}, "
          f"retraces_unexpected {st['retraces_unexpected']}, publish_to "
          f"version {replica_like.params_version}; post-swap greedy "
          f"identical to a fresh engine: {same}")
    if not (rise > FLY_TINY_RISE and st["swaps"] == FLY_TINY_ITERS
            and st["decode_traces"] == 1 and st["retraces_unexpected"] == 0
            and replica_like.params_version == FLY_TINY_ITERS and same
            and fly.engine.decode_traces == 1):
        fail("(b) the tiny flywheel did not learn or rebuilt a step")
    return {"rewards": rw, "rise": rise, "wall_s": wall,
            "swaps": st["swaps"], "decode_traces": st["decode_traces"],
            "fanout_version": replica_like.params_version,
            "greedy_identical": same}, fly


def recorder_cost(dev, smi: str, keep) -> dict:
    """(c): phase 2's traffic through two captured engines of phase 2's
    model, ``telemetry_sample`` 1.0 and 0.0: TELEMETRY_ROUNDS rounds, in
    each TELEMETRY_REPEAT runs of fresh traffic through each engine, the
    order alternating; trace_overhead_pct as bench_infer.py:295-300
    computes it (the wall of `run_until_idle`; here over all rounds, and
    per round with its mean and standard error). Then one more run
    through each engine with every `on_*` hook of its recorder timed:
    the hooks' host time with the recorder on less with it off, over the
    unsampled run's wall, is the recorder's cost read without the
    host clock's run-to-run noise. Each engine's host syncs a tick
    (phase 2's rule), its spans recorded and dropped,
    `check_invariants`, the Prometheus text (engine, train-loop and
    flywheel series, every line parsing), and a `PrefillReplica` ->
    `DecodeReplica` pull's export, import and handoff spans."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import (DecodeReplica, InferenceEngine,
                                     PrefillReplica)
    from ray_tpu_torch.util import metrics, telemetry, tracing

    cfg = gpt.small(**SERVE_CFG)
    model = gpt.GPT(cfg, gpt.init_params(0, cfg, dev), device=dev)
    engines = {}
    for sample in (1.0, 0.0):
        e = InferenceEngine(model, cfg, slots=8, max_len=1024, block_size=16,
                            prefill_chunk=64, telemetry_sample=sample,
                            device=dev)
        warm_up(e)
        e._recorder.clear()
        engines[sample] = e
    syncs_ok = {}

    def serve(sample, seed):
        """Phase 2's traffic (``seed``) through one engine: the wall of
        its `run_until_idle`, its host syncs checked."""
        e = engines[sample]
        st0 = e.stats()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for p, t in make_traffic(cfg.vocab_size, seed=seed):
                e.submit(p, max_new_tokens=64, temperature=t)
            t0 = time.perf_counter()
            e.run_until_idle()
            wall = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode("default")
        st = e.stats()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        ticks = (st["decode_steps"] - st0["decode_steps"]
                 + st["prefill_chunks"] - st0["prefill_chunks"])
        if syncs != ticks or any(builds(st0, st).values()):
            fail(f"(c) sample {sample}: {syncs} host syncs for {ticks} "
                 f"ticks and chunks, builds {builds(st0, st)}")
        syncs_ok[sample] = syncs_ok.get(sample, 0) + syncs
        e.check_invariants()
        return wall

    walls = {1.0: [], 0.0: []}
    for r in range(TELEMETRY_ROUNDS):
        for sample in ((1.0, 0.0) if r % 2 == 0 else (0.0, 1.0)):
            walls[sample].append(sum(
                serve(sample, 100 + TELEMETRY_REPEAT * r + k)
                for k in range(TELEMETRY_REPEAT)))
    per_round = [(a - b) / max(b, 1e-9) * 100.0
                 for a, b in zip(walls[1.0], walls[0.0])]
    pct = (sum(walls[1.0]) - sum(walls[0.0])) / sum(walls[0.0]) * 100.0
    pct_se = statistics.stdev(per_round) / len(per_round) ** 0.5

    # The hooks' own host time: one run through each engine with every
    # hook wrapped (the wrapper's cost, the same on both, cancels in the
    # difference).
    by_hook, hooks, hook_walls = {}, {}, {}
    for sample in (1.0, 0.0):
        rec = engines[sample]._recorder
        names = [n for n in dir(type(rec)) if n.startswith("on_")]
        spent = by_hook[sample] = {n: [0, 0] for n in names}

        def timed(f, acc):
            def hook(*a, **k):
                t = time.perf_counter_ns()
                try:
                    return f(*a, **k)
                finally:
                    acc[0] += time.perf_counter_ns() - t
                    acc[1] += 1
            return hook

        for n in names:
            setattr(rec, n, timed(getattr(rec, n), spent[n]))
        try:
            hook_walls[sample] = serve(sample, 999)
        finally:
            for n in names:
                delattr(rec, n)
        hooks[sample] = {"ns": sum(v[0] for v in spent.values()),
                         "calls": sum(v[1] for v in spent.values())}
    hook_pct = ((hooks[1.0]["ns"] - hooks[0.0]["ns"]) * 1e-9
                / hook_walls[0.0] * 100.0)
    # each hook's calls and mean host us, with the recorder on and off
    per_hook = {n: {str(k): (v[n][1], v[n][0] / max(v[n][1], 1) * 1e-3)
                    for k, v in by_hook.items()}
                for n in by_hook[1.0] if by_hook[1.0][n][1]}
    on, off = engines[1.0]._recorder, engines[0.0]._recorder
    if off.get_spans() or off.requests_traced or not on.get_spans():
        fail("(c) the recorders recorded the wrong requests")
    # the handoff's spans: a replica pair over localhost at the tiny
    # config
    node_ip = os.environ.get("RAY_TPU_NODE_IP")
    os.environ["RAY_TPU_NODE_IP"] = "127.0.0.1"
    tiny = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                max_seq_len=64, dtype="float32")
    pre = dec = None
    try:
        pre = PrefillReplica(tiny, slots=2, max_len=64, seed=0, device=dev)
        dec = DecodeReplica(tiny, slots=2, max_len=64, seed=0, device=dev)
        toks = list(dec.resume_from(pre(list(range(3, 20)),
                                        max_new_tokens=4)))
        handoff_spans = sorted(
            {s["name"] for s in pre.engine._recorder.get_spans()}
            | {s["name"] for s in dec.engine._recorder.get_spans()})
    finally:
        for rep in (pre, dec):
            if rep is not None:
                rep.close()
        if node_ip is None:
            os.environ.pop("RAY_TPU_NODE_IP", None)
        else:
            os.environ["RAY_TPU_NODE_IP"] = node_ip
    if len(toks) != 4 or not {"kv_export", "kv_import",
                              "handoff"} <= set(handoff_spans):
        fail(f"(c) the handoff's spans: {handoff_spans}")
    telemetry.check_invariants()
    text = metrics.render_prometheus(metrics.snapshot())
    for line in text.splitlines():
        if line and not line.startswith("#"):
            m = telemetry._PROM_SAMPLE.match(line)
            if not m:
                fail(f"(c) unparseable exposition line {line!r}")
            float(m.group(1))
    want = [f'ray_tpu_engine_decode_tokens{{source="{engines[1.0].name}"}}',
            f'ray_tpu_flywheel_iterations{{source="{keep.name}"}}',
            f'ray_tpu_train_dispatch_s{{source="{keep.loop.name}"}}',
            f'ray_tpu_engine_ttft_ms_bucket{{source="{engines[1.0].name}"']
    missing = [w for w in want if w not in text]
    if missing:
        fail(f"(c) the Prometheus text lacks {missing}")
    out = {"wall_on_s": walls[1.0], "wall_off_s": walls[0.0],
           "trace_overhead_pct": pct,
           "trace_overhead_pct_by_round": per_round,
           "trace_overhead_pct_round_mean": statistics.mean(per_round),
           "trace_overhead_pct_round_se": pct_se,
           "hook_ns": {str(k): v["ns"] for k, v in hooks.items()},
           "hook_calls": {str(k): v["calls"] for k, v in hooks.items()},
           "hook_run_wall_s": {str(k): v for k, v in hook_walls.items()},
           "hook_overhead_pct": hook_pct, "hook_calls_and_us": per_hook,
           "spans_recorded": len(on.get_spans()),
           "spans_dropped": on.dropped_spans,
           "requests_traced": on.requests_traced,
           "host_syncs": syncs_ok, "handoff_spans": handoff_spans,
           "prometheus_lines": len(text.splitlines()),
           "disabled_span_ns": tracing.probe_disabled_overhead_ns()}
    print(f"  (c) [{smi}] phase 2's traffic x {TELEMETRY_REPEAT} a round, "
          f"{TELEMETRY_ROUNDS} rounds: wall sampled "
          f"{[round(x, 3) for x in walls[1.0]]} s, unsampled "
          f"{[round(x, 3) for x in walls[0.0]]} s: trace_overhead_pct "
          f"{pct:.2f} (by round {[round(x, 2) for x in per_round]}, mean "
          f"{statistics.mean(per_round):.2f} +- {pct_se:.2f} s.e.); the "
          f"hooks' host time {hooks[1.0]['ns'] * 1e-6:.2f} ms on "
          f"({hooks[1.0]['calls']} calls) and {hooks[0.0]['ns'] * 1e-6:.2f} "
          f"ms off ({hooks[0.0]['calls']}) in runs of "
          f"{hook_walls[1.0]:.3f} and {hook_walls[0.0]:.3f} s: "
          f"{hook_pct:.3f} % of the wall (calls, mean us on; off: "
          f"{ {n: (v['1.0'][0], round(v['1.0'][1], 2), round(v['0.0'][1], 2)) for n, v in per_hook.items()} }); "
          f"{out['spans_recorded']} spans, {out['spans_dropped']} dropped, "
          f"{on.requests_traced} requests traced; host syncs = ticks + "
          f"chunks on both; handoff spans {handoff_spans}; "
          f"{out['prometheus_lines']} exposition lines parse; a disabled "
          f"span {out['disabled_span_ns']:.0f} ns")
    del engines, model, on, off
    free_engine(None)
    return out


def phase_flywheel(dev, smi: str) -> dict:
    """Phase 16: the RL flywheel and the telemetry plane, (a) to (c), each
    part's time recorded."""
    out, part_s = {}, {}
    t0 = time.perf_counter()
    out["full_width"] = flywheel_full_width(dev, smi)
    part_s["full_width"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tiny"], keep = flywheel_tiny(dev, smi)
    part_s["tiny"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["recorder"] = recorder_cost(dev, smi, keep)
    part_s["recorder"] = time.perf_counter() - t0
    out["part_s"] = part_s
    del keep
    free_engine(None)
    return out


# ---------------------------------------------------------------------------
# phase 17: fault-tolerant training and the other model families
# ---------------------------------------------------------------------------

# (b)'s trainer child: bench.py's GPT at full width and FT_LAYERS layers,
# FT_BATCH x 1024 tokens a step, FT_UNROLL steps a dispatch; a victim
# checkpointing every FT_EVERY steps SIGKILLs itself once its feed
# reaches batch FT_CRASH_AT and a commit exists (tests/test_chaos.py's
# numbers).
FT_STEPS, FT_EVERY, FT_CRASH_AT = 12, 3, 8
FT_LAYERS, FT_BATCH, FT_UNROLL = 2, 8, 2
FT_CHILD_TIMEOUT_S = 300
# (c) MoEConfig() at batch 8, (d) ViTConfig() and resnet50(1000) at 32
MOE_BATCH, MOE_STEPS = 8, 6
VISION_BATCH, VISION_STEPS = 32, 3


class thread_syncs:
    """Counts host-sync warnings (`torch.cuda.set_sync_debug_mode`) by the
    thread that raised them; ``main`` is the calling thread's count."""

    def __enter__(self):
        import threading

        import torch
        self.main_ident = threading.get_ident()
        self.seen = []
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")

        def show(message, *args, **kwargs):
            # a host sync's warning, not the mode's own "prototype" notice
            if "synchroniz" in str(message) and \
                    "debug mode" not in str(message):
                self.seen.append(threading.get_ident())
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)

    @property
    def main(self) -> int:
        return sum(t == self.main_ident for t in self.seen)

    @property
    def other(self) -> int:
        return len(self.seen) - self.main


def _leaf_mismatches(a, b) -> list:
    """Names of the train-state leaves (parameters, both moments, the
    count and the step) where two `spmd.TrainState`s differ in any bit."""
    import torch
    bad = [n for (n, x), y in zip(a.params.named_parameters(),
                                  b.params.parameters())
           if not torch.equal(x, y)]
    for k in ("mu", "nu"):
        bad += [f"{k}[{i}]" for i, (x, y) in enumerate(
            zip(a.opt_state[k], b.opt_state[k])) if not torch.equal(x, y)]
    for name, x, y in (("count", a.opt_state["count"], b.opt_state["count"]),
                       ("step", a.step, b.step)):
        if not torch.equal(x, y):
            bad.append(name)
    return bad


def _commit_record(ckpt) -> list:
    """Prints and returns each commit's split (`ft.AsyncCheckpointer.
    timings`; the device times are None for a state on the CPU)."""
    def ms(x):
        return "n/a" if x is None else f"{x:.2f}"
    for r in ckpt.timings:
        print(f"      commit of step {r['step']}: clone "
              f"{ms(r['clone_ms'])} ms (device), to host {ms(r['d2h_ms'])} "
              f"ms (device; the writer waited {r['fetch_s'] * 1e3:.1f} ms), "
              f"sha256 {r['hash_s'] * 1e3:.1f} ms, write + fsync "
              f"{r['write_s'] * 1e3:.1f} ms, {r['bytes'] / 1e9:.3f} GB, "
              f"commit {r['commit_s'] * 1e3:.1f} ms")
    return list(ckpt.timings)


def _restore_and_step(dev, cfg, state, step_fn, trainer, batches, root,
                      steps: int) -> tuple:
    """Force a snapshot of the live ``state``, flush, restore it into a
    trainer built with ``init_state=False`` (``trainer``), check every leaf
    bit for bit, then ``steps`` more steps from each state on the same
    batches: the losses must be bit-identical. Returns (record, the live
    state after those steps)."""
    import torch
    from ray_tpu_torch.train import ft
    pc = time.perf_counter
    ckpt = ft.AsyncCheckpointer(root, every=1, keep=1)
    step = int(state.step)
    t0 = pc()
    ckpt.maybe_snapshot(state, step, force=True)
    ckpt.flush()
    ckpt.close()
    commit = _commit_record(ckpt)
    t1 = pc()
    tree, got_step = ft.restore_resharded(root, dev)
    torch.cuda.synchronize()
    t2 = pc()
    _, step2, _ = trainer(cfg, device=dev, init_state=False)
    back = ft.state_from_tree(tree, cfg, dev)
    del tree
    bad = _leaf_mismatches(state, back)
    if got_step != step or bad:
        fail(f"restored step {got_step} (want {step}), leaves differing: "
             f"{bad[:8]}")
    la, lb = [], []
    for _ in range(steps):
        b = next(batches)
        state, ma = step_fn(state, b)
        back, mb = step2(back, b)
        la.append(ma["loss"])
        lb.append(mb["loss"])
    la, lb = [x.item() for x in la], [x.item() for x in lb]
    print(f"      forced snapshot of step {step}: commit {t1 - t0:.2f} s, "
          f"restore {t2 - t1:.2f} s; every leaf bit for bit; {steps} more "
          f"steps: live {la}, restored {lb}")
    if la != lb:
        fail(f"losses after the restore differ: {la} vs {lb}")
    del back, step2
    return {"step": step, "snapshot_commit_s": t1 - t0,
            "restore_s": t2 - t1, "commit": commit, "losses_live": la,
            "losses_restored": lb}, state


def ckpt_region(dev, smi: str) -> dict:
    """(a) bench.py's checkpoint region on phase 8's configuration: a clean
    FUSED_STEPS-step region, the same loop again with an AsyncCheckpointer
    (every max(unroll, steps // 2), 2 in flight, keep 1), then a forced
    snapshot restored into a fresh trainer."""
    import shutil
    import tempfile

    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.train import ft, loop, spmd
    from ray_tpu_torch.util import tracing

    cfg = _train_cfg(loss_impl="fused")
    batch, unroll, prefetch, interval = 24, 4, 2, 10
    steps = FUSED_STEPS
    every = max(unroll, steps // 2)
    pc = time.perf_counter
    state, step_fn, place = spmd.make_gpt_trainer(cfg, seed=0, device=dev)
    flops_step = spmd.train_flops_per_token(cfg, cfg.max_seq_len) \
        * batch * cfg.max_seq_len
    batches = loop.DevicePrefetcher(_host_batches(cfg, batch, seed=31),
                                    place, depth=prefetch, group=unroll)
    train = loop.TrainLoop(step_fn, unroll=unroll, metrics_interval=interval,
                           flops_per_step=flops_step, device=dev)
    state, _ = train.run(state, batches, num_steps=FUSED_WARMUP)
    snap_bytes = sum(t.numel() * t.element_size() for t in
                     ft.tree_leaves(ft.state_to_tree(state)))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    fs = subprocess.run(["df", "-T", root], capture_output=True,
                        text=True).stdout.strip().splitlines()[-1]
    print(f"  (a) snapshot {snap_bytes / 1e9:.3f} GB (f32 masters + mu + nu "
          f"+ counts); checkpoint dir on: {fs}")
    out = {"card": smi, "batch": batch, "unroll": unroll, "steps": steps,
           "every": every, "snapshot_bytes": snap_bytes, "filesystem": fs}
    try:
        with thread_syncs() as clean_syncs:
            t0 = pc()
            state, hist = train.run(state, batches, num_steps=steps)
            dt = pc() - t0
        clean = dict(train.last_breakdown)
        tracing.enable_tracing()
        tracing.clear_spans()
        ckpt = ft.AsyncCheckpointer(root, every=every, max_in_flight=2,
                                    keep=1)
        flush_s = []
        real_flush = ckpt.flush

        def timed_flush():
            t = pc()
            real_flush()
            flush_s.append(pc() - t)
        ckpt.flush = timed_flush
        train.checkpointer = ckpt
        ops.reset_kernel_launches()
        with thread_syncs() as ckpt_syncs:
            t0 = pc()
            state, hist2 = train.run(state, batches, num_steps=steps)
            dt_ckpt = pc() - t0
        launches = ops.kernel_launches()
        train.checkpointer = None
        ckpt.check_invariants()
        ckpt.close()
        spans = [(s["end_ns"] - s["start_ns"]) * 1e-6
                 for s in tracing.get_spans()
                 if s["name"] == "ft.checkpoint_commit"]
        losses = [float(m["loss"]) for m in hist + hist2]
        if ckpt.commits <= 0 or not all(map(math.isfinite, losses)):
            fail(f"checkpoint region: {ckpt.commits} commits, losses "
                 f"{losses}")
        overhead = (dt_ckpt - dt) / dt * 100.0
        print(f"      clean {steps} steps {dt:.3f} s, with the "
              f"checkpointer {dt_ckpt:.3f} s: checkpoint_overhead_pct "
              f"{overhead:.2f} (end-of-run flush {sum(flush_s):.3f} s; "
              f"without it {(dt_ckpt - sum(flush_s) - dt) / dt * 100:.2f} "
              f"%); snapshots {ckpt.snapshots}, commits {ckpt.commits}, "
              f"stalls {ckpt.stalls}; ft.checkpoint_commit spans "
              f"{[round(x, 1) for x in spans]} ms")
        commits = _commit_record(ckpt)
        print(f"      host syncs on the training thread: clean "
              f"{clean_syncs.main}, checkpoint region {ckpt_syncs.main} "
              f"(writer thread {ckpt_syncs.other}); metric fetches "
              f"{train.last_ring.fetches}")
        print(f"      breakdown (checkpoint region) "
              f"{json.dumps(train.last_breakdown)}")
        if ckpt_syncs.main != clean_syncs.main:
            fail(f"the checkpoint region synced the training thread "
                 f"{ckpt_syncs.main} times, the clean region "
                 f"{clean_syncs.main}")
        check_flash_backward_launches(launches, steps, cfg.n_layers)
        out.update(clean_s=dt, ckpt_s=dt_ckpt,
                   checkpoint_overhead_pct=overhead, flush_s=sum(flush_s),
                   snapshots=ckpt.snapshots, commits=ckpt.commits,
                   stalls=ckpt.stalls, commit_span_ms=spans,
                   commit_split=commits,
                   host_syncs_clean=clean_syncs.main,
                   host_syncs_ckpt=ckpt_syncs.main,
                   host_syncs_writer=ckpt_syncs.other,
                   breakdown_clean=clean,
                   step_breakdown=dict(train.last_breakdown),
                   launches=launches, losses=losses)
        del ckpt
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        more = (place(b) for b in _host_batches(cfg, batch, seed=32))
        out["restore"], state = _restore_and_step(
            dev, cfg, state, step_fn, spmd.make_gpt_trainer, more, root, 4)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state, step_fn, batches, train
    torch.cuda.empty_cache()
    return out


def _ft_child_batches(cfg, start: int = 0):
    """(b)'s data stream: the batch of global step i is a function of i
    alone (tests/ft_train_child.py), so a resumed run replays the killed
    run's batches."""
    import numpy as np
    idx = start
    while True:
        rng = np.random.default_rng(1234 + idx)
        toks = rng.integers(0, cfg.vocab_size, (FT_BATCH, cfg.max_seq_len + 1)
                            ).astype(np.int32)
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        idx += 1


def ft_child() -> int:
    """``--ft-child``: (b)'s trainer, configured by FT_ROOT, FT_OUT,
    FT_MODE (train | resume), FT_EVERY (0: no checkpointer) and
    FT_CRASH_AT (SIGKILL itself once its feed reaches this batch and a
    checkpoint is committed), as tests/ft_train_child.py."""
    import signal

    import torch
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import ft, loop, spmd
    from ray_tpu_torch.models import gpt
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = gpt.resolve_device()
    root, out = os.environ["FT_ROOT"], os.environ.get("FT_OUT")
    every = int(os.environ.get("FT_EVERY", "0"))
    crash_at = int(os.environ.get("FT_CRASH_AT", "-1"))
    t0 = time.perf_counter()
    cfg = _train_cfg(loss_impl="fused", n_layers=FT_LAYERS)
    opt = spmd.default_optimizer(learning_rate=3e-4, warmup_steps=2,
                                 total_steps=FT_STEPS)
    if os.environ.get("FT_MODE", "train") == "resume":
        _, step_fn, place = spmd.make_gpt_trainer(
            cfg, optimizer=opt, device=dev, init_state=False)
        tree, start = ft.restore_resharded(root, dev)
        state = ft.state_from_tree(tree, cfg, dev)
        del tree
        host = ft.fast_forward(_ft_child_batches(cfg), start)
    else:
        state, step_fn, place = spmd.make_gpt_trainer(
            cfg, optimizer=opt, device=dev)
        start, host = 0, _ft_child_batches(cfg)
    ckpt = None
    if every > 0:
        ckpt = ft.AsyncCheckpointer(root, every=every, max_in_flight=2,
                                    keep=2)
    if crash_at >= 0:
        def killing(inner):
            for idx, b in enumerate(inner):
                if idx >= crash_at:
                    deadline = time.time() + 120
                    while ckpt.commits < 1 and time.time() < deadline:
                        time.sleep(0.01)
                    os.kill(os.getpid(), signal.SIGKILL)
                yield b
        host = killing(host)
    batches = loop.DevicePrefetcher(host, place, depth=2, group=FT_UNROLL)
    train = loop.TrainLoop(step_fn, unroll=FT_UNROLL, metrics_interval=4,
                           checkpointer=ckpt)
    setup_s = time.perf_counter() - t0
    state, metrics = train.run(state, batches, num_steps=FT_STEPS,
                               start_step=start)
    if ckpt is not None:
        ckpt.check_invariants()
        ckpt.close()
    if out:
        with open(out, "w") as f:
            json.dump({"start": int(start),
                       "steps": [int(m["step"]) for m in metrics],
                       "losses": [float(m["loss"]) for m in metrics],
                       "setup_s": setup_s, "train_s": train.last_breakdown[
                           "total_s"],
                       "commits": None if ckpt is None else ckpt.timings},
                      f)
    return 0


def ft_kill_resume(dev, smi: str) -> dict:
    """(b) tests/test_chaos.py's kill/resume on the card: a control child
    with no checkpointer, a victim that SIGKILLs itself, a resume from its
    last committed step; the resumed losses equal the control's from that
    step on, bit for bit."""
    import shutil
    import signal
    import tempfile

    from ray_tpu_torch.train import ft
    base = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    pc = time.perf_counter
    procs = []

    def start(**env_over):
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        env.update({k: str(v) for k, v in env_over.items()})
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--ft-child"], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        procs.append(p)
        return p, pc()

    def finish(child, what: str):
        p, t0 = child
        try:
            _, err = p.communicate(timeout=FT_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"(b) the {what} child ran past {FT_CHILD_TIMEOUT_S} s")
        return p.returncode, err, pc() - t0

    try:
        root = os.path.join(base, "ckpts")
        # the control and the victim are independent: they run at once
        ctl = start(FT_ROOT=os.path.join(base, "unused"),
                    FT_OUT=os.path.join(base, "control.json"))
        victim = start(FT_ROOT=root, FT_EVERY=FT_EVERY,
                       FT_CRASH_AT=FT_CRASH_AT)
        rc, err, t_ctl = finish(ctl, "control")
        if rc != 0:
            fail(f"(b) control child failed:\n{err[-3000:]}")
        with open(os.path.join(base, "control.json")) as f:
            control = json.load(f)
        rc, err, t_victim = finish(victim, "victim")
        if rc != -signal.SIGKILL:
            fail(f"(b) victim exited {rc}, not by SIGKILL:\n{err[-3000:]}")
        latest = ft.latest_checkpoint(root)
        if latest is None:
            fail("(b) the kill left no committed checkpoint")
        step = ft.validate_checkpoint(latest)["step"]
        rc, err, t_resume = finish(
            start(FT_ROOT=root, FT_EVERY=FT_EVERY, FT_MODE="resume",
                  FT_OUT=os.path.join(base, "resume.json")), "resume")
        if rc != 0:
            fail(f"(b) resume child failed:\n{err[-3000:]}")
        with open(os.path.join(base, "resume.json")) as f:
            res = json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(base, ignore_errors=True)
    same = res["losses"] == control["losses"][step:]
    print(f"  (b) kill/resume ({FT_LAYERS} layers at full width, batch "
          f"{FT_BATCH}): control {len(control['losses'])} steps "
          f"({t_ctl:.1f} s, {control['setup_s']:.1f} s of it in the child "
          f"before its first step), victim killed with step {step} "
          f"committed ({t_victim:.1f} s, at once with the control), resume "
          f"from {res['start']} ({t_resume:.1f} s); resumed losses {res['losses']} vs control "
          f"{control['losses'][step:]}: {'bit for bit' if same else 'DIFFER'}")
    if res["start"] != step or \
            res["steps"] != list(range(step + 1, FT_STEPS + 1)) or not same:
        fail("(b) the resumed run does not continue the control's "
             "trajectory bit for bit")
    return {"card": smi, "layers": FT_LAYERS, "batch": FT_BATCH,
            "restored_step": step, "control_losses": control["losses"],
            "resumed_losses": res["losses"], "resume_commits":
            res["commits"], "child_s": {"control": t_ctl,
                                        "victim": t_victim,
                                        "resume": t_resume}}


def _moe_picks(model, inputs, cfg) -> list:
    """Each layer's [tokens, experts] pick mask (the dispatch summed over
    the capacity slots) of one no-grad forward."""
    import torch
    from ray_tpu_torch.models import moe
    got = []
    real = moe._route

    def spy(h, router_w, c, *split):
        out = real(h, router_w, c, *split)
        got.append(out[0].sum(2) > 0)
        return out
    moe._route = spy
    try:
        with torch.no_grad():
            moe.forward(model, inputs, cfg)
    finally:
        moe._route = real
    return got


def moe_full_width(dev, smi: str) -> dict:
    """(c) MoEConfig() trained through make_moe_trainer on the card: the
    flash kernels against plain at its shape, the step-0 loss, flash
    against plain attention on one batch, MOE_STEPS timed steps with
    their launches, a profiled window, the peak memory, then a checkpoint
    restored with a bit-identical next step."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.train import loop, spmd

    cfg = moe.MoEConfig()
    g = torch.Generator(device=dev).manual_seed(17)
    flash = flash_case(g, dev, MOE_BATCH, cfg.max_seq_len, cfg.n_heads,
                       cfg.head_dim, True, cfg.dtype)
    state, step_fn, place = spmd.make_moe_trainer(cfg, seed=0, device=dev)
    model = state.params
    n_params = moe.num_params(model)
    hb = (place(b) for b in _host_batches(cfg, MOE_BATCH, seed=41))
    b0 = next(hb)
    with torch.no_grad():
        logits, aux = moe.forward(model, b0["inputs"])
        ce = spmd.softmax_xent(logits, b0["targets"]).mean().item()
    del logits
    want0 = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    print(f"  (c) MoEConfig(): {n_params / 1e6:.1f} M params; step-0 cross "
          f"entropy {ce:.4f}, expected {want0:.4f} (limit {STEP0_LOSS_TOL}); "
          f"aux {aux.item():.4f}")
    if not abs(ce - want0) <= STEP0_LOSS_TOL:
        fail(f"MoE step-0 loss {ce} is not near {want0}")
    # Flash against plain attention on one batch from the same masters. In
    # f32 both paths route every token alike: phase 6's limits. In bf16
    # (the main path) one rounding of the attention output flips the top-k
    # picks of near-tied tokens, more of them deeper in the stack, and
    # each flip moves every gradient upstream of its layer: the loss is
    # held to phase 6's limit, the flips and the gradients' gap are
    # reported.
    cmp = {}
    for dtype in ("float32", "bfloat16"):
        res, picks = {}, {}
        for impl in ("flash", "xla"):
            c = dataclasses.replace(cfg, attn_impl=impl, dtype=dtype)
            picks[impl] = _moe_picks(model, b0["inputs"], c)
            loss = spmd.moe_loss_fn(model, b0, c)
            res[impl] = (loss.item(), torch.autograd.grad(
                loss, list(model.parameters())))
        flips = [int((a != b).any(1).sum()) for a, b in
                 zip(picks["flash"], picks["xla"])]
        what = f"(c) MoE flash vs plain attention, {dtype}"
        if dtype == "float32":
            cmp[dtype] = _compare_runs(what, model, res["flash"],
                                       res["xla"])
        else:
            dloss = abs(res["flash"][0] - res["xla"][0])
            rel = _grad_rel(model, res["flash"][1], res["xla"][1])
            worst = max(rel, key=rel.get)
            print(f"  {what}: loss {res['flash'][0]:.6f} vs "
                  f"{res['xla'][0]:.6f}, |diff| {dloss:.2e} (limit "
                  f"{TRAIN_LOSS_TOL}); worst leaf gradient rel. gap "
                  f"{rel[worst]:.2e} ({worst}; reported)")
            if not dloss <= TRAIN_LOSS_TOL:
                fail(f"{what}: losses differ by {dloss}")
            cmp[dtype] = {"loss": res["flash"][0],
                          "loss_plain": res["xla"][0],
                          "loss_abs_diff": dloss, "grad_rel_gap": rel,
                          "grad_rel_gap_max": rel[worst]}
        cmp[dtype]["tokens_flipped_by_layer"] = flips
        print(f"      tokens whose top-{cfg.top_k} picks differ, by layer: "
              f"{flips} of {b0['inputs'].numel()}")
        del res, picks
        torch.cuda.empty_cache()

    tokens_per_step = MOE_BATCH * cfg.max_seq_len
    train = loop.TrainLoop(step_fn, metrics_interval=10)
    batches = loop.DevicePrefetcher(
        _host_batches(cfg, MOE_BATCH, seed=42), place, depth=2)
    state, _ = train.run(state, batches, num_steps=1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    state, hist = train.run(state, batches, num_steps=MOE_STEPS)
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in hist]
    per_step = {k: launches[k] / MOE_STEPS for k in
                ("flash_forward", "flash_fwd_tc", "flash_dq", "flash_dkv")}
    print(f"      {MOE_STEPS} steps in {wall:.3f} s: "
          f"{wall / MOE_STEPS * 1e3:.1f} ms/step, "
          f"{tokens_per_step * MOE_STEPS / wall:.0f} tok/s; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak memory {peak:.1f} "
          f"GiB; flash launches a step {per_step}")
    if not all(map(math.isfinite, losses)):
        fail(f"MoE losses {losses}")
    want = {"flash_forward": 2 * cfg.n_layers, "flash_fwd_tc":
            2 * cfg.n_layers, "flash_dq": cfg.n_layers,
            "flash_dkv": cfg.n_layers}
    if per_step != {k: float(v) for k, v in want.items()}:
        fail(f"MoE flash launches a step {per_step}, want {want}")
    check_flash_backward_launches(launches, MOE_STEPS, cfg.n_layers)
    (state, _), prof = profile_window(
        lambda: train.run(state, batches, num_steps=2),
        (("flash", ("flash_",)), ("gemm", GEMM_NAMES)))
    groups = prof["device_ms_by_group"]
    print(f"      profiled 2 steps: wall {prof['wall_s'] * 1e3:.1f} ms, "
          f"device busy {prof['device_ms']:.1f} ms "
          f"({prof['device_busy_share']:.1%}); by group "
          f"{ {k: round(v, 1) for k, v in groups.items()} }")
    for n, t, c in prof["kernels"][:10]:
        print(f"    {t:9.3f} ms  {c:6d}  {n[:80]}")
    root = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        restore, state = _restore_and_step(dev, cfg, state, step_fn,
                                           spmd.make_moe_trainer, hb, root,
                                           1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"card": smi, "config": dataclasses.asdict(cfg),
           "params": n_params, "batch": MOE_BATCH, "flash_cases": flash,
           "step0_ce": ce, "step0_expected": want0,
           "flash_vs_plain": cmp, "steps": MOE_STEPS, "wall_s": wall,
           "step_ms": wall / MOE_STEPS * 1e3,
           "tok_s": tokens_per_step * MOE_STEPS / wall, "losses": losses,
           "peak_mem_gib": peak, "launches": launches,
           "launches_per_step": per_step,
           "profile": {"wall_s": prof["wall_s"],
                       "device_busy_s": prof["device_ms"] * 1e-3,
                       "device_busy_share": prof["device_busy_share"],
                       "device_ms_by_group": groups,
                       "top_kernels": top_kernels(prof["kernels"], 16)},
           "restore": restore}
    del state, step_fn, model, train, batches, b0
    torch.cuda.empty_cache()
    return out


def _vision_train(name, model, loss_fn, batch, smi) -> dict:
    """VISION_STEPS steps of ``spmd.Adam(1e-4)`` on one repeated batch:
    per-step times (synchronised), images/s after the first, the losses,
    which must be finite and fall."""
    import torch
    from ray_tpu_torch.train import spmd
    opt = spmd.Adam(1e-4)
    state = spmd.TrainState(model, opt.init(model),
                            torch.zeros((), dtype=torch.int32,
                                        device=model.device))
    step_fn = spmd.make_train_step(loss_fn, opt)
    losses, times = [], []
    for _ in range(VISION_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
    n = next(iter(batch.values())).shape[0]
    ips = n * (VISION_STEPS - 1) / sum(times[1:])
    print(f"  (d) {name}: {VISION_STEPS} steps at batch {n}, "
          f"{[round(t * 1e3, 1) for t in times]} ms; {ips:.0f} images/s "
          f"after the first; losses {[round(x, 4) for x in losses]}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"{name}: losses {losses} are not finite and falling")
    return {"card": smi, "batch": n, "step_s": times, "images_per_s": ips,
            "losses": losses}


def _predict_round_trip(name, data, apply_fn, images, own, dev) -> None:
    """Checkpoint.from_dict(data) -> to_directory -> from_directory ->
    TorchPredictor: its predictions equal ``own`` bit for bit."""
    import shutil
    import tempfile

    import numpy as np
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.predictor import TorchPredictor
    d = tempfile.mkdtemp(prefix="chip_smoke_pred_")
    try:
        ck = Checkpoint.from_directory(
            Checkpoint.from_dict(data).to_directory(os.path.join(d, "ck")))
        pred = TorchPredictor.from_checkpoint(ck, apply_fn=apply_fn,
                                              device=dev)
        got = pred.predict(images.cpu().numpy())["predictions"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    own = own.float().cpu().numpy()
    print(f"      {name} predictor after a directory round trip: "
          f"{got.shape}, max |diff| {np.abs(got - own).max():.3e}")
    if not np.array_equal(got, own):
        fail(f"{name}: the predictor's outputs differ from the model's")


def vision(dev, smi: str) -> dict:
    """(d) ViTConfig() and resnet50(1000) at 224^2, bf16, batch
    VISION_BATCH: training, the predictor round trip, and ResNet's batch
    statistics."""
    import torch
    from ray_tpu_torch.models import _stacked, resnet, vit
    from ray_tpu_torch.train import spmd
    g = torch.Generator(device=dev).manual_seed(23)
    out = {}
    vcfg = vit.ViTConfig()
    images = torch.randn((VISION_BATCH, vcfg.image_size, vcfg.image_size,
                          vcfg.channels), generator=g, device=dev)
    labels = torch.randint(0, vcfg.num_classes, (VISION_BATCH,),
                           generator=g, device=dev)
    batch = {"images": images, "labels": labels}
    model = vit.ViT(vcfg, vit.init_params(0, vcfg, dev), device=dev,
                    dtype=torch.float32, trainable=True)
    out["vit"] = _vision_train("ViTConfig()", model,
                               lambda m, b: vit.loss_fn(m, b, vcfg), batch,
                               smi)
    out["vit"]["params"] = vit.num_params(model)
    with torch.no_grad():
        own = vit.forward(model, images)
    _predict_round_trip(
        "ViT", {"params": _stacked.param_tree(model)},
        lambda p, x: vit.forward(vit.ViT(vcfg, p, device=dev,
                                         dtype=torch.float32), x),
        images, own, dev)
    del model, own
    torch.cuda.empty_cache()

    model = resnet.resnet50(1000, device=dev)
    before = {n: b.clone() for n, b in model.named_buffers()}
    out["resnet50"] = _vision_train(
        "resnet50(1000)", model,
        lambda m, b: spmd.softmax_xent(m(b["images"], train=True),
                                       b["labels"]).mean(), batch, smi)
    out["resnet50"]["params"] = sum(p.numel() for p in model.parameters())
    moved = sum(not torch.equal(before[n], b)
                for n, b in model.named_buffers())
    with torch.no_grad():
        own = model(images, train=False)
        saved = {n: b.clone() for n, b in model.named_buffers()}
        for n, b in model.named_buffers():
            b.copy_(before[n])
        stale = model(images, train=False)
        for n, b in model.named_buffers():
            b.copy_(saved[n])
    print(f"      resnet50 batch statistics changed in training: {moved} of "
          f"{len(before)} buffers; eval with them vs with the initial "
          f"ones: max |diff| {(own - stale).abs().max().item():.3e}")
    if moved != len(before) or torch.equal(own, stale):
        fail("resnet50's batch statistics did not change in training or "
             "are not used in eval")
    eval_model = resnet.resnet50(1000, device=dev)
    _predict_round_trip(
        "resnet50", {"params": resnet.params_to_numpy(model)},
        lambda v, x: resnet.params_from_numpy(v, eval_model)(x, train=False),
        images, own, dev)
    out["resnet50"]["buffers_changed"] = moved
    del model, eval_model, own, stale, images, batch
    torch.cuda.empty_cache()
    return out


def phase_ft_models(dev, smi: str) -> dict:
    """Phase 17: fault-tolerant training and the other model families,
    (a) to (d), each part's time recorded."""
    out, part_s = {}, {}
    for key, fn in (("ckpt_region", ckpt_region),
                    ("kill_resume", ft_kill_resume),
                    ("moe", moe_full_width), ("vision", vision)):
        t0 = time.perf_counter()
        out[key] = fn(dev, smi)
        part_s[key] = time.perf_counter() - t0
        print(f"  phase 17 {key} took {part_s[key]:.1f} s")
    out["part_s"] = part_s
    return out


# phase 18: SPMD training on a mesh. (a) a mesh of one against no mesh at
# bench.py's width; (b) two ranks on the one card (gloo: NCCL refuses two
# ranks on one device), `--mesh-child` children, each mesh from the same
# seed and the same global batches, against (a)'s trainer at its depth
MESH_SEED, MESH_STEPS, MESH_BATCH = 18, 3, 8
# bf16 limits from (b)'s readings, with room: each step's loss and
# grad_norm, and after the last step every leaf gathered whole from the
# ranks' blocks against (a)'s leaf, the gap's norm over the norm of (a)'s
# update of that leaf (a lost update reads 1). The largest element gap is
# printed and not held: Adam moves an element by about the learning rate
# whatever its gradient's size, so an element whose bf16 gradient is
# summation noise may move the other way, by up to 2 lr a step
MESH_LOSS_TOL, MESH_GN_REL_TOL, MESH_UPDATE_REL_TOL = 2e-3, 2e-2, 0.25
MESH_CHILD_TIMEOUT_S = 420
MESH_RUNS = (("tensor=2", dict(data=1, tensor=2), 12, "trainer"),
             ("data=2", dict(data=2), 4, "trainer"),
             ("seq=2", dict(data=1, seq=2), 4, "trainer"),
             ("pipe=2", dict(data=1, pipe=2), 4, "pipeline"))


def _mesh_cfg(layers: int):
    """bench.py's GPT with the fused loss and attn "auto" (flash on one
    card and per tensor rank, the ring over seq)."""
    return _train_cfg(loss_impl="fused", attn_impl="auto", n_layers=layers)


def _mesh_batches(cfg) -> list:
    import itertools
    return list(itertools.islice(_host_batches(cfg, MESH_BATCH, MESH_SEED),
                                 MESH_STEPS))


def _mesh_optimizer(spmd):
    return spmd.default_optimizer(warmup_steps=0)


def _mesh_steps(state, step, place, batches) -> tuple:
    """MESH_STEPS steps, the kernel counters and collective stats zeroed
    just before and read just after: losses, grad norms, each step's
    wall time (synchronised), collective seconds and host copies, the
    launches by kernel name and this process's peak device memory.
    Returns them and the state after the last step."""
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import collectives as col
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    col.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, place(b))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "step_s": step_s,
            "collectives": col.stats(),
            "launches": {k: v for k, v in ops.kernel_launches().items()
                         if v},
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}, state


def _mesh_ref_path(ref_dir: str, layers: int) -> str:
    return os.path.join(ref_dir, f"params_{layers}.pt")


def _flat_params(tree: dict) -> dict:
    """An `init_params` tree by the model's parameter names."""
    return {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


def _save_params(model, path: str) -> None:
    import torch
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               path)


def _mesh_param_gaps(model, mesh, ref_path: str, init: dict, dev) -> dict:
    """Every leaf of a mesh trainer's state gathered whole (all ranks
    call it) against the single-card trainer's leaf (``ref_path``, by
    `_save_params`) after as many steps: the largest element gap, and
    the gap's norm over the norm of the single card's update (its leaf
    less ``init``'s, the seed's initial leaves by name); the worst leaf
    of each, and each leaf's gap over its update (``by_leaf``)."""
    import torch
    from ray_tpu_torch.parallel import sharding
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    out = {"max_abs": -1.0, "update_rel": -1.0, "leaves": len(ref),
           "by_leaf": {}}
    for name, p in model.named_parameters():
        full = sharding.gather_full(p.detach(), model.specs[name], mesh)
        want = ref[name].to(dev)
        update = float(torch.linalg.vector_norm(want - init[name]))
        if not update > 0:
            fail(f"the single-card trainer's {name} did not move")
        gap = (full.float() - want).abs()
        for key, v in (("max_abs", float(gap.max())),
                       ("update_rel",
                        float(torch.linalg.vector_norm(gap)) / update)):
            if key == "update_rel":
                out["by_leaf"][name] = v
            if v > out[key]:
                out[key], out[f"{key}_leaf"] = v, name
        del full, want, gap
    return out


def _free():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def mesh_one(dev, smi: str, ref_dir: str) -> dict:
    """(a) `make_gpt_trainer(cfg, mesh=single_device_mesh())` against
    `make_gpt_trainer(cfg)` at 12 layers from one seed: losses bit for
    bit and the same launches by name; then the 4-layer single-card
    reference of (b)'s data, seq and pipe runs. The single-card
    trainers' leaves after the last step go to ``ref_dir`` for (b)."""
    import torch
    from ray_tpu_torch.parallel import single_device_mesh
    from ray_tpu_torch.train import spmd
    out = {}
    for layers, meshes in ((12, (("none", None),
                                 ("one", single_device_mesh()))),
                           (4, (("none", None),))):
        cfg = _mesh_cfg(layers)
        batches = _mesh_batches(cfg)
        for label, mesh in meshes:
            state, step, place = spmd.make_gpt_trainer(
                cfg, seed=MESH_SEED, optimizer=_mesh_optimizer(spmd),
                device=dev, mesh=mesh)
            out[f"{layers}_{label}"], state = _mesh_steps(
                state, step, place, batches)
            if mesh is None:
                _save_params(state.params, _mesh_ref_path(ref_dir, layers))
            del state, step
            _free()
    a, b = out["12_none"], out["12_one"]
    print(f"  (a) 12 layers, batch {MESH_BATCH}: mesh=None losses "
          f"{a['losses']}, mesh of one {b['losses']}; launches "
          f"{a['launches']} ({smi})")
    if a["losses"] != b["losses"] or a["launches"] != b["launches"]:
        fail("(a) a mesh of one is not the single-card trainer bit for bit")
    print(f"  (a) 4-layer reference: losses {out['4_none']['losses']}, grad "
          f"norms {out['4_none']['grad_norms']}")
    return out


def mesh_child() -> int:
    """``--mesh-child``: one rank of a two-rank gloo world on the card
    (MESH_RANK, MESH_WORLD, MESH_PORT, MESH_OUT): phase 18 (b)'s runs,
    with MESH_PHASE=19 phase 19's (`serve_mesh_child`), with
    MESH_PHASE=20 phase 20's (`roles_mesh_child`), with MESH_PHASE=21
    phase 21's (a), (b) and (d) (`train_rest_child`), with
    MESH_PHASE=21c phase 21 (c) on one of four ranks
    (`pipe_rest_child`)."""
    import datetime

    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.train import spmd
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rank, world = int(os.environ["MESH_RANK"]), int(os.environ["MESH_WORLD"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MESH_PORT']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    res = {"rank": rank, "backend": dist.get_backend(),
           "host_staged": col.stages_through_host(dist.group.WORLD, dev)}
    phase = os.environ.get("MESH_PHASE", "18")
    runs = MESH_RUNS if phase == "18" else ()
    if phase == "19":
        res.update(serve_mesh_child(dev))
    if phase == "20":
        res.update(roles_mesh_child(dev))
    if phase == "21":
        res.update(train_rest_child(dev))
    if phase == "21c":
        res.update(pipe_rest_child(dev))
    for label, kw, layers, kind in runs:
        mesh = MeshSpec(**kw).build()
        cfg = _mesh_cfg(layers)
        if kind == "pipeline":
            state, step, place = spmd.make_gpt_pipeline_trainer(
                cfg, mesh, num_microbatches=2, seed=MESH_SEED,
                optimizer=_mesh_optimizer(spmd), device=dev)
        else:
            state, step, place = spmd.make_gpt_trainer(
                cfg, seed=MESH_SEED, optimizer=_mesh_optimizer(spmd),
                device=dev, mesh=mesh)
        batches = _mesh_batches(cfg)
        res[label], state = _mesh_steps(state, step, place, batches)
        res[label]["params"] = _mesh_param_gaps(
            state.params, mesh,
            _mesh_ref_path(os.environ["MESH_REF_DIR"], layers),
            _flat_params(gpt.init_params(MESH_SEED, cfg, dev)), dev)
        if label == "tensor=2":
            res["xent_shard"] = _shard_xent_check(state.params, batches[0],
                                                  mesh, dev)
        del state, step
        _free()
    dist.barrier()
    dist.destroy_process_group()
    with open(os.environ["MESH_OUT"], "w") as f:
        json.dump(res, f)
    return 0


def _shard_xent_check(model, batch, mesh, dev) -> dict:
    """In the tensor=2 run: this rank's fused-xent kernels on its
    vocabulary shard (V / 2 = 25,152 rows, D 1024, bf16) with the batch's
    own target ids shifted by the shard's base (at or above V / 2 on rank
    0's shard, below 0 on rank 1's), against the plain versions under
    phase 7's XENT_TOL; then each rank in turn times the forward and the
    backward (the other waits at a barrier)."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.ops import fused_xent as fx
    v_loc = model.embed.shape[0]
    base = mesh.axis_index("tensor") * v_loc
    t = torch.as_tensor(batch["targets"]).reshape(-1).to(dev) - base
    t = t.to(torch.int32).contiguous()
    below, above = int((t < 0).sum()), int((t >= v_loc).sum())
    g = torch.Generator(device=dev).manual_seed(MESH_SEED + 1)
    n = t.numel()
    x = torch.randn((n, XD), generator=g, device=dev).to(torch.bfloat16)
    e = model.embed.detach().to(torch.bfloat16).contiguous()
    lse, tgt = fx.fused_xent_fwd(x, e, t)
    ref_lse, ref_tgt = fx.lse_target_reference(x, e, t)
    err = {"lse": _xent_check("(b) shard lse", lse, ref_lse),
           "tgt": _xent_check("(b) shard target logit", tgt, ref_tgt)}
    if not (torch.all(tgt[t < 0] == 0) and torch.all(tgt[t >= v_loc] == 0)):
        fail("(b) an id outside the shard gave a nonzero target logit")
    cl = torch.rand((n,), generator=g, device=dev) / n
    args = (x, e, t, ref_lse, cl, -cl)
    dx, de = fx.fused_xent_bwd(*args)
    ref_dx, ref_de = fx.xent_backward_reference(*args)
    bx, be = fx.xent_backward_abs_bound(*args)
    err["dx"] = _xent_check("(b) shard dx", dx, ref_dx, bx)
    err["de"] = _xent_check("(b) shard dE", de, ref_de, be)
    times = {}
    for r in range(mesh.size):
        dist.barrier()
        if r == mesh.axis_index("tensor"):
            times = {"fwd_ms": time_long_ms(fx.fused_xent_fwd, (x, e, t)),
                     "bwd_ms": time_long_ms(fx.fused_xent_bwd, args),
                     "plain_fwd_ms": time_long_ms(fx.lse_target_reference,
                                                  (x, e, t))}
    dist.barrier()
    return {"n": n, "v_loc": v_loc, "below": below, "above": above,
            "max_abs_err": err, **times}


def _mesh_children(phase: str, env: dict, timeout_s: float,
                   n: int = 2) -> tuple:
    """``n`` `--mesh-child` ranks of phase ``phase`` on the card (gloo
    over a free localhost port, ``env`` added to each one's environment),
    each printing its lines; returns (their results in rank order, the
    seconds until all ended). A rank that fails or outlives
    ``timeout_s`` fails the phase; every child is stopped."""
    import shutil
    import socket
    import tempfile
    base = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, res = [], []
    try:
        for r in range(n):
            child_env = dict(os.environ, MESH_RANK=str(r), MESH_WORLD=str(n),
                             MESH_PORT=str(port), MESH_PHASE=phase,
                             MESH_OUT=os.path.join(base, f"rank{r}.json"),
                             **env)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-child"],
                env=child_env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        t0 = time.perf_counter()
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"phase {phase}: rank {r} ran past {timeout_s} s")
            if p.returncode != 0:
                fail(f"phase {phase}: rank {r} failed ({p.returncode}):\n"
                     f"{out[-2000:]}\n{err[-4000:]}")
            for line in out.splitlines():
                print(f"  [rank {r}] {line.strip()}")
            with open(os.path.join(base, f"rank{r}.json")) as f:
                res.append(json.load(f))
        child_s = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(base, ignore_errors=True)
    return res, child_s


def mesh_ranks(dev, smi: str, ref: dict, ref_dir: str) -> dict:
    """(b) two `--mesh-child` ranks on the card, every mesh of MESH_RUNS,
    each against (a)'s single-card run at its depth (its leaves in
    ``ref_dir``)."""
    res, child_s = _mesh_children("18", {"MESH_REF_DIR": ref_dir},
                                  MESH_CHILD_TIMEOUT_S)
    print(f"  (b) backend {res[0]['backend']}, collectives staged through "
          f"the host: {res[0]['host_staged']} (two ranks share one card); "
          f"{child_s:.1f} s for both children ({smi})")
    out = {"backend": res[0]["backend"], "host_staged": res[0]["host_staged"],
           "child_s": child_s, "runs": {}}
    for label, _, layers, _ in MESH_RUNS:
        want = ref[f"{layers}_none"]
        runs = [r[label] for r in res]
        dl = max(abs(a - b) for run in runs
                 for a, b in zip(run["losses"], want["losses"]))
        dg = max(abs(a - b) / abs(b) for run in runs
                 for a, b in zip(run["grad_norms"], want["grad_norms"]))
        for r, run in enumerate(runs):
            c = run["collectives"]
            print(f"  (b) {label} ({layers} layers) rank {r}: losses "
                  f"{[round(x, 5) for x in run['losses']]}, grad norms "
                  f"{[round(x, 4) for x in run['grad_norms']]}, step s "
                  f"{[round(x, 3) for x in run['step_s']]}, collectives "
                  f"{c['seconds']:.3f} s in {c['calls']} calls "
                  f"({c['host_copies']} host copies, "
                  f"{c['host_bytes'] / 2 ** 20:.1f} MiB), peak "
                  f"{run['peak_gb']:.2f} GiB, launches {run['launches']}")
        gaps = max((run["params"] for run in runs),
                   key=lambda g: g["update_rel"])
        pa_run = max((run["params"] for run in runs),
                     key=lambda g: g["max_abs"])
        pa = pa_run["max_abs"]
        print(f"  (b) {label}: worst |dloss| {dl:.3e} (limit "
              f"{MESH_LOSS_TOL}), worst relative dgrad_norm {dg:.3e} (limit "
              f"{MESH_GN_REL_TOL}) against (a)'s {layers}-layer trainer; "
              f"after step {MESH_STEPS}, {gaps['leaves']} leaves: largest "
              f"element gap {pa:.3e} ({pa_run['max_abs_leaf']}), gap over "
              f"(a)'s update {gaps['update_rel']:.3e} "
              f"({gaps['update_rel_leaf']}; limit {MESH_UPDATE_REL_TOL})")
        if runs[0]["losses"] != runs[1]["losses"]:
            fail(f"(b) {label}: the ranks report different losses")
        if not (dl <= MESH_LOSS_TOL and dg <= MESH_GN_REL_TOL):
            fail(f"(b) {label} disagrees with the single-card trainer")
        if not gaps["update_rel"] <= MESH_UPDATE_REL_TOL:
            fail(f"(b) {label}: the leaves after step {MESH_STEPS} are not "
                 "the single-card trainer's")
        out["runs"][label] = {"layers": layers, "ranks": runs,
                              "worst_dloss": dl, "worst_rel_dgrad_norm": dg,
                              "worst_param_abs": pa,
                              "worst_update_rel": gaps["update_rel"]}
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        for label in ("tensor=2", "data=2", "pipe=2"):
            if out["runs"][label]["ranks"][0]["launches"].get(name, 0) <= 0:
                fail(f"{name} was not launched on phase 18 (b)'s {label}")
    for name in ("fused_xent_fwd", "xent_dx", "xent_de"):
        if out["runs"]["tensor=2"]["ranks"][0]["launches"].get(name, 0) <= 0:
            fail(f"{name} was not launched on phase 18 (b)'s vocab shard")
    out["xent_shard"] = [r["xent_shard"] for r in res]
    # rank 0's shard holds the low half of the vocabulary and rank 1's the
    # high half: between them, ids fall below a shard and above one
    below = sum(xs["below"] for xs in out["xent_shard"])
    above = sum(xs["above"] for xs in out["xent_shard"])
    if below <= 0 or above <= 0:
        fail(f"(b) the shards saw {below} ids below them and {above} above: "
             "both must be > 0")
    for r, xs in enumerate(out["xent_shard"]):
        print(f"  (b) rank {r} vocab shard {xs['v_loc']} rows x D {XD}, "
              f"N {xs['n']}: ids below {xs['below']}, above {xs['above']}; "
              f"max|kernel-plain| {xs['max_abs_err']}; fwd "
              f"{xs['fwd_ms']:.3f} ms, bwd {xs['bwd_ms']:.3f} ms, plain fwd "
              f"{xs['plain_fwd_ms']:.3f} ms ({smi})")
    return out


def phase_mesh(dev, smi: str) -> dict:
    """Phase 18: SPMD training on a mesh, (a) and (b)."""
    import shutil
    import tempfile
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ref_")
    try:
        t0 = time.perf_counter()
        one = mesh_one(dev, smi, ref_dir)
        t1 = time.perf_counter()
        ranks = mesh_ranks(dev, smi, one, ref_dir)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    print(f"  phase 18 (a) took {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s")
    return {"card": smi, "one": one, "ranks": ranks,
            "part_s": {"one": t1 - t0, "ranks": t2 - t1}}


# phase 19: serving, RL and MoE on a mesh. Two `--mesh-child` ranks
# (MESH_PHASE=19) on the one card over gloo, as phase 18 (b): (a) the
# paged engine at bench_infer.py's width on tensor=2 (8 of the 16 heads a
# rank), (b) the unpaged cache on it, (c) the flywheel on it, (d)
# MoEConfig()'s width on expert=2 against a single-rank run in the parent
SERVE_MESH_REQS = (0, 1, 7, 8, 11, 16)   # of make_traffic's 17 (cut)
SERVE_MESH_NEW = 32                      # new tokens a request (cut)
SERVE_MESH_SPEC = 4                      # spec_traffic's requests (cut)
# the greedy requests of the cut traffic held to phase 3's rule: a shared
# prefix's first and the 300-token prompt (5 chunks)
SERVE_MESH_CHECKED = (0, 5)
UNPAGED_MESH_STEPS = 32
FLY_MESH_ITERS, FLY_MESH_PROMPTS, FLY_MESH_NEW, FLY_MESH_PAD = 3, 4, 16, 64
MOE_MESH_LAYERS, MOE_MESH_BATCH, MOE_MESH_STEPS = 4, 2, 2
SERVE_MESH_TIMEOUT_S = 600


def _window(dev):
    """Zero the launch counters, the collectives' stats and the peak
    memory: what a phase-19 path reports is its own."""
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import collectives as col
    torch.cuda.synchronize(dev)
    ops.reset_kernel_launches()
    col.reset_stats()
    torch.cuda.reset_peak_memory_stats(dev)


def _window_read(dev) -> dict:
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import collectives as col
    torch.cuda.synchronize(dev)
    return {"launches": {k: v for k, v in ops.kernel_launches().items()
                         if v},
            "collectives": col.stats(),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def _serve_mesh_engine(dev, mesh, model, cfg, reqs, new, which, axis="tensor",
                       **kw):
    """One engine on the mesh (2 ranks on ``axis``) through ``reqs``: the
    launches of each decode tick, prefill chunk and verify tick (one a
    layer, the kernel named by the pool's dtype; a draft model's one a
    draft layer for each of a verify tick's W proposal steps and each
    draft prefill chunk), the ticks' wall p50/p99, the collectives and
    peak memory of the run. Returns (engine, outputs, summary)."""
    from ray_tpu_torch.serve import InferenceEngine
    eng = InferenceEngine(model, cfg, slots=8, max_len=1024, block_size=16,
                          prefill_chunk=64, seed=0, device=dev, mesh=mesh,
                          **kw)
    _window(dev)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new, temperature=t)
            for p, t in reqs]
    eng.run_until_idle()
    outs = [list(eng.tokens_for(r)) for r in rids]
    wall = time.perf_counter() - t0
    got = _window_read(dev)
    st = eng.stats()
    eng.check_invariants()
    for i, o in enumerate(outs):
        if len(o) != new:
            fail(f"(a) {which}: request {i} ended with {len(o)} tokens")
    if st["captured"] is not False or st["mesh"][axis] != 2:
        fail(f"(a) {which}: stats say captured {st['captured']}, mesh "
             f"{st['mesh']}")
    layers = cfg.n_layers
    ticks = st["decode_steps"] - st["spec_steps"]
    chunks, verifies = st["prefill_chunks"], st["spec_steps"]
    int8 = cfg.kv_dtype == "int8"
    # the draft model's proposal steps and its pool's prefill chunks (it
    # shares no prefixes: every prompt's every chunk)
    dl = 0 if eng.draft_model is None else eng.draft_cfg.n_layers
    dsteps = dl * eng.spec_window * verifies
    dchunks = dl * sum(-(-len(p) // eng.prefill_chunk) for p, _ in reqs)
    want = {"paged_decode_attention": layers * ticks + dsteps,
            "paged_prefill_attention": layers * chunks + dchunks,
            "paged_verify_attention": layers * verifies,
            "paged_decode_int8": layers * ticks * int8,
            "paged_mq_tc": (layers * (chunks + verifies) + dchunks)
            * (not int8),
            "paged_mq_tc_int8": layers * chunks * int8,
            "paged_mq_simt": 0, "paged_mq_simt_int8": 0}
    launches = got["launches"]
    if {k: launches.get(k, 0) for k in want} != want:
        fail(f"(a) {which}: paged launches {launches}, want {want}")
    if kw.get("spec") and verifies <= 0:
        fail(f"(a) {which}: no verify tick ran")
    summary = {k: st[k] for k in (
        "decode_steps", "spec_steps", "prefill_chunks", "decode_tokens",
        "p50_token_latency_ms", "p99_token_latency_ms", "decode_tok_s",
        "prefix_hit_tokens", "cow_copies", "captured", "mesh",
        "acceptance_rate", "decode_traces", "prefill_traces",
        "verify_traces")}
    summary.update(wall_s=wall, **got,
                   tokens=[[int(t) for t in o] for o in outs],
                   logprobs=[[float(t.logprob) for t in o] for o in outs])
    return eng, outs, summary


def _in_turn(mesh, fn):
    """``fn()`` on each rank in turn, the other waiting at a barrier, so
    the ranks' timings do not share the card."""
    import torch.distributed as dist
    out = None
    for r in range(mesh.size):
        dist.barrier()
        if r == mesh.axis_index("tensor"):
            out = fn()
    dist.barrier()
    return out


def _h8_kernels(dev, eng, eng8, mesh) -> dict:
    """Each paged kernel at the rank's 8 heads on the rank's own pools
    (the 12 layers of the bf16 and int8 engines' pools, through two
    scrambled tables, as 24 timing sets: a bf16 decode call reads 6.9
    MB, so 159 MB pass between two uses of a set), held against its plain
    version, then timed, in turn with the other rank, beside the plain
    version, SDPA over K/V gathered beforehand and the bound, as phases
    1, 11 (a) and 12 (a) time them at 16 heads."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import decode_attention as da
    from ray_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(19)
    layers, nb, bs, h, d = eng.cache["k"].shape
    mb = 1024 // bs
    tabs = [(torch.randperm(nb - 1, generator=g, device=dev) + 1)
            [:8 * mb].view(8, mb).to(torch.int32).contiguous()
            for _ in range(2)]
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    c16 = [(eng.cache["k"][i], eng.cache["v"][i], t)
           for i in range(layers) for t in tabs]
    c8 = [(eng8.cache["k"][i], eng8.cache["v"][i], t,
           eng8.cache["k_scale"][i], eng8.cache["v_scale"][i])
          for i in range(layers) for t in tabs]

    def sdpa(q_, k_, v_, m_):
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_)

    def one(name, fn, plain, args, nbytes, ops, lib=None, extra=None):
        err = check(name, fn(*args[0]), plain(*args[0]), "bfloat16",
                    f"(a) {name} at H {h} on the rank's pool", extra=extra)
        rec = _in_turn(mesh, lambda: {
            "ms": time_ms(fn, args), "plain_ms": time_ms(plain, args),
            "library_ms": None if lib is None else time_ms(sdpa, lib)})
        rec["max_abs_err"] = err
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, torch.bfloat16)
        rec["heads"] = h
        return rec

    def gathered(k, v, t, s=None):
        k, v = (da.gather_kv_pages(x, t) for x in (k, v))
        if s is not None:
            k, v = k[:, :s], v[:, :s]
        return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    out = {}
    # decode: 8 rows at DECODE_POS
    q = torch.randn((8, h, d), generator=g, device=dev).bfloat16()
    seen = sum(p + 1 for p in DECODE_POS)
    blocks = sum(p // bs + 1 for p in DECODE_POS) * 4 + 8 * 4
    mask = (torch.arange(mb * bs, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    out["paged_decode"] = one(
        "paged_decode", da.paged_decode_attention,
        da.reference_paged_decode_attention,
        [(q, k, v, t, pos) for k, v, t in c16],
        2 * q.numel() * 2 + seen * h * d * 2 * 2 + blocks, seen * h * d * 4,
        [(q[:, :, None], *gathered(k, v, t), mask) for k, v, t in c16])
    out["paged_decode_int8"] = one(
        "paged_decode_int8",
        lambda q_, k, v, t, ks, vs: da.paged_decode_attention(
            q_, k, v, t, pos, k_scale=ks, v_scale=vs),
        lambda q_, k, v, t, ks, vs: da.reference_paged_decode_attention(
            q_, k, v, t, pos, k_scale=ks, v_scale=vs),
        [(q, *s) for s in c8],
        2 * q.numel() * 2 + seen * h * (d + 4) * 2 + blocks,
        seen * h * d * 4)
    # prefill: a 64-token chunk at 960 through a table's rows
    c, start = 64, 960
    s_len = start + c
    qc = torch.randn((c, h, d), generator=g, device=dev).bfloat16()
    start_t = torch.full((1,), start, dtype=torch.int32, device=dev)
    seen = sum(start + i + 1 for i in range(c))
    blocks = (-(-s_len // bs)) * 4 + 4
    rows = [(k, v, t[r].contiguous()) for k, v, t in c16 for r in (0, 5)]
    cmask = (torch.arange(s_len, device=dev)[None, :]
             <= start + torch.arange(c, device=dev)[:, None])
    k0, v0, t0 = rows[0]
    out["paged_prefill"] = one(
        "paged_prefill", da.paged_prefill_attention,
        da.reference_paged_prefill_attention,
        [(qc, k, v, t, start_t) for k, v, t in rows],
        2 * qc.numel() * 2 + s_len * h * d * 2 * 2 + blocks,
        seen * h * d * 4,
        [(qc.transpose(0, 1)[None].contiguous(),
          *gathered(k, v, t[None], s_len), cmask) for k, v, t in rows],
        2 ** -8 * da.reference_paged_prefill_attention(
            qc.float(), k0.float(), v0.float().abs(), t0, start))
    k8, v8, t8, ks8, vs8 = c8[0]
    rows8 = [(k, v, t[r].contiguous(), ks, vs) for k, v, t, ks, vs in c8
             for r in (0, 5)]
    out["paged_prefill_int8"] = one(
        "paged_prefill_int8",
        lambda q_, k, v, t, ks, vs: da.paged_prefill_attention(
            q_, k, v, t, start_t, k_scale=ks, v_scale=vs),
        lambda q_, k, v, t, ks, vs: da.reference_paged_prefill_attention(
            q_, k, v, t, start_t, k_scale=ks, v_scale=vs),
        [(qc, *s) for s in rows8],
        2 * qc.numel() * 2 + s_len * h * (d + 4) * 2 + blocks,
        seen * h * d * 4,
        extra=2 ** -8 * da.reference_paged_prefill_attention(
            qc.float(), quant.dequantize_rows(k8, ks8),
            quant.dequantize_rows(v8, vs8).abs(), t8[0].contiguous(), start))
    # verify: the n-gram engine's W 5 window at DECODE_POS
    w = SPEC_K + 1
    vpos = pos.clamp(max=mb * bs - w)
    qv = torch.randn((8, w, h, d), generator=g, device=dev).bfloat16()
    rows_read = sum(p + w for p in vpos.tolist())
    seen = sum(p + j + 1 for p in vpos.tolist() for j in range(w))
    vmask = (torch.arange(mb * bs, device=dev)[None, None, :]
             <= (vpos.long()[:, None] + torch.arange(w, device=dev))
             [:, :, None])[:, None]
    out["paged_verify"] = one(
        "paged_verify", da.paged_verify_attention,
        da.reference_paged_verify_attention,
        [(qv, k, v, t, vpos) for k, v, t in c16],
        2 * qv.numel() * 2 + rows_read * h * d * 2 * 2
        + sum(-(-(p + w) // bs) for p in vpos.tolist()) * 4 + 8 * 4,
        seen * h * d * 4,
        [(qv.transpose(1, 2).contiguous(), *gathered(k, v, t), vmask)
         for k, v, t in c16],
        2 ** -8 * da.reference_paged_verify_attention(
            qv.float(), c16[0][0].float(), c16[0][1].float().abs(),
            c16[0][2], vpos))
    return out


def _serve_mesh_unpaged(dev, mesh, model, cfg) -> dict:
    """(b) `init_kv_cache(mesh=)` ([L, 8, 1024, 8, 64] a rank), phase 9
    (b)'s 8 prompts prefilled, then UNPAGED_MESH_STEPS greedy
    `decode_step`s: 12 `decode_attention` launches a step; rows 0 and 1
    held to phase 3's rule on rank 0; then the contiguous decode kernel
    at the rank's 8 heads on its cache (the 12 layers as timing sets)
    against its plain version, timed in turn, with SDPA and the bound."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import decode_attention as da
    from ray_tpu_torch.serve import TokenEvent
    lens, prompts, _, _ = unpaged_traffic(cfg.vocab_size)
    cache = gpt.init_kv_cache(cfg, 8, 1024, dev, mesh=mesh)
    t = int(max(lens))
    toks = torch.zeros((8, t), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p)
    lengths = torch.as_tensor(lens)
    _window(dev)
    t0 = time.perf_counter()
    step_s = []
    outs = [[] for _ in range(8)]
    with torch.inference_mode():
        logits, cache = gpt.prefill(model, toks.to(dev), cache,
                                    lengths=lengths.to(dev))
        pos = lengths.to(dev).int()
        for i in range(UNPAGED_MESH_STEPS + 1):
            lp = torch.log_softmax(logits.float(), dim=-1)
            nxt = torch.argmax(logits, dim=-1)
            lpn = lp.gather(1, nxt[:, None])[:, 0]
            for r, (a, b) in enumerate(zip(nxt.tolist(), lpn.tolist())):
                outs[r].append(TokenEvent(a, b))
            if i == UNPAGED_MESH_STEPS:
                break
            s0 = time.perf_counter()
            logits, cache = gpt.decode_step(model, nxt, cache, pos)
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - s0)
            pos = pos + 1
    wall = time.perf_counter() - t0
    got = _window_read(dev)
    want = cfg.n_layers * UNPAGED_MESH_STEPS
    if got["launches"].get("decode_attention", 0) != want:
        fail(f"(b) decode_attention launches {got['launches']}, want {want}")
    heads = cfg.n_heads // mesh.axis_size("tensor")
    if tuple(cache["k"].shape) != (cfg.n_layers, 8, 1024, heads,
                                   cfg.head_dim):
        fail(f"(b) the rank's cache block is {tuple(cache['k'].shape)}")
    tf = None
    if mesh.axis_index("tensor") == 0:
        reqs = [(np.asarray(p, np.int32), 0.0) for p in prompts]
        tf = phase_teacher_forced(dev, SERVE_CFG, 0, reqs, outs, (0, 1))
    # the contiguous decode kernel at 8 heads on the rank's cache
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((8, heads, cfg.head_dim), generator=g, device=dev
                    ).bfloat16()
    p = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    sets = [(q, cache["k"][i], cache["v"][i], p)
            for i in range(cfg.n_layers)]
    err = check("decode", da.decode_attention(*sets[0]),
                da.reference_decode_attention(*sets[0]), "bfloat16",
                f"(b) decode at H {heads} on the rank's cache")
    rec = _in_turn(mesh, lambda: decode_record(
        dev, da.decode_attention, da.reference_decode_attention, sets,
        sum(x + 1 for x in DECODE_POS)))
    rec.update(max_abs_err=err, heads=heads)
    st = sorted(step_s)
    return {**got, "wall_s": wall, "teacher_forced": tf, "kernel": rec,
            "step_ms_p50": st[len(st) // 2] * 1e3,
            "step_ms_p99": st[min(len(st) - 1, int(0.99 * len(st)))] * 1e3,
            "tokens": [[int(x) for x in o] for o in outs]}


def _serve_mesh_flywheel(dev, mesh) -> dict:
    """(c) `FlywheelLoop(mesh=tensor=2)` on (a)'s model from seed 0,
    FLY_MESH_ITERS iterations of FLY_MESH_PROMPTS prompts: after each
    publish every leaf of the rank's engine equals the rank's learner
    block in the engine's dtype; the engine's and the learner's launches
    together, the iterations' wall."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.rl import FlywheelLoop
    cfg = gpt.GPTConfig(**SERVE_CFG)
    vocab = cfg.vocab_size

    def prompt_fn(rng):
        return rng.integers(0, vocab, 16).astype(np.int32)

    fly = FlywheelLoop(cfg, prompt_fn, half_vocab_reward(vocab),
                       params=gpt.init_params(0, cfg, dev), mesh=mesh,
                       prompts_per_iter=FLY_MESH_PROMPTS,
                       max_new_tokens=FLY_MESH_NEW, pad_to=FLY_MESH_PAD,
                       lr=1e-4, device=dev,
                       engine_kwargs=dict(slots=FLY_MESH_PROMPTS,
                                          max_len=FLY_MESH_PAD,
                                          block_size=16, prefill_chunk=64))
    _window(dev)
    iter_s, losses = [], []
    for _ in range(FLY_MESH_ITERS):
        t0 = time.perf_counter()
        _, metrics = fly.run(1)
        torch.cuda.synchronize(dev)
        iter_s.append(time.perf_counter() - t0)
        losses.append(float(metrics[-1]["loss"]) if metrics else None)
        learner = dict(fly.state.params.named_parameters())
        for name, e in fly.engine.model.named_parameters():
            if not torch.equal(e, learner[name].detach().to(e.dtype)):
                fail(f"(c) the engine's {name} is not the learner's block "
                     "after the publish")
    got = _window_read(dev)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "flash_forward", "flash_dq", "flash_dkv"):
        if got["launches"].get(name, 0) <= 0:
            fail(f"(c) {name} was not launched on the flywheel's path")
    if fly.engine.params_version != FLY_MESH_ITERS:
        fail(f"(c) {fly.engine.params_version} publishes, want "
             f"{FLY_MESH_ITERS}")
    return {**got, "iter_s": iter_s, "losses": losses,
            "history": [{k: h[k] for k in ("reward_mean", "staleness",
                                            "engine_version")}
                        for h in fly.history],
            "wq_block": list(fly.state.params.layers["wq"].shape)}


def _moe_mesh_cfg(dtype: str = "bfloat16"):
    import dataclasses
    from ray_tpu_torch.models import moe
    return dataclasses.replace(moe.MoEConfig(), n_layers=MOE_MESH_LAYERS,
                               dtype=dtype)


def _moe_mesh_batches(cfg) -> list:
    import numpy as np
    rng = np.random.default_rng(MESH_SEED + 19)
    out = []
    for _ in range(MOE_MESH_STEPS):
        toks = rng.integers(0, cfg.vocab_size,
                            (MOE_MESH_BATCH, cfg.max_seq_len + 1))
        out.append({"inputs": toks[:, :-1].astype(np.int32),
                    "targets": toks[:, 1:].astype(np.int32)})
    return out


def _moe_mesh_run(dev, mesh, ref_dir: str,
                  dtype: str = "bfloat16") -> dict:
    """(d) `make_moe_trainer` at MoEConfig()'s width cut to
    MOE_MESH_LAYERS layers, batch MOE_MESH_BATCH, from MESH_SEED, in
    ``dtype``: `_mesh_steps`' record (losses, grad norms, step times,
    collectives, launches, peak memory) on ``mesh``. With ``mesh`` None
    (the single card) its leaves after the last step go to ``ref_dir``;
    on a mesh each leaf is held against them (`_mesh_param_gaps`)."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.train import spmd
    cfg = _moe_mesh_cfg(dtype)
    state, step, place = spmd.make_moe_trainer(
        cfg, seed=MESH_SEED, optimizer=_mesh_optimizer(spmd), device=dev,
        mesh=mesh)
    rec, state = _mesh_steps(state, step, place, _moe_mesh_batches(cfg))
    rec["w_up_block"] = list(state.params.layers["w_up"].shape)
    path = os.path.join(ref_dir, "moe_params.pt" if dtype == "bfloat16"
                        else f"moe_params_{dtype}.pt")
    if mesh is None:
        _save_params(state.params, path)
    else:
        rec["params"] = _mesh_param_gaps(
            state.params, mesh, path,
            _flat_params(moe.init_params(MESH_SEED, cfg, dev)), dev)
    del state, step
    _free()
    return rec


def serve_mesh_child(dev) -> dict:
    """Phase 19 on this rank: (a)-(d) on tensor=2 (and expert=2 for (d));
    every path's counters zeroed just before it and read just after."""
    import numpy as np
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec
    mesh = MeshSpec(data=1, tensor=2).build()
    rank = mesh.axis_index("tensor")
    res = {}
    cfg = gpt.GPTConfig(**SERVE_CFG)
    # (a) the paged engine: bf16 and int8 pools, then n-gram
    full = make_traffic(cfg.vocab_size, 0)
    reqs = [full[i] for i in SERVE_MESH_REQS]
    model = gpt.GPT(cfg, gpt.init_params(0, cfg, dev), device=dev,
                    mesh=mesh)
    _free()
    engines = {}
    for which, c, kw, traffic in (
            ("bf16", cfg, {}, reqs),
            ("int8_pool", gpt.GPTConfig(**{**SERVE_CFG, "kv_dtype": "int8"}),
             {}, reqs),
            ("ngram", cfg, dict(spec="ngram", spec_k=SPEC_K),
             [(p, 0.0) for p, _ in spec_traffic(cfg.vocab_size,
                                                SERVE_MESH_SPEC)])):
        eng, outs, res[which] = _serve_mesh_engine(
            dev, mesh, model, c, traffic, SERVE_MESH_NEW, which, **kw)
        if rank == 0:
            checked = (SERVE_MESH_CHECKED if which != "ngram"
                       else tuple(range(SERVE_MESH_SPEC)))
            res[which]["teacher_forced"] = phase_teacher_forced(
                dev, SERVE_CFG, 0, traffic, outs, checked)
        engines[which] = eng
    res["h8"] = _h8_kernels(dev, engines["bf16"], engines["int8_pool"], mesh)
    del engines, eng
    _free()
    # (b) the unpaged cache
    res["unpaged"] = _serve_mesh_unpaged(dev, mesh, model, cfg)
    del model
    _free()
    # (c) the flywheel
    res["flywheel"] = _serve_mesh_flywheel(dev, mesh)
    _free()
    # (d) MoE on expert=2
    res["moe"] = _moe_mesh_run(dev, MeshSpec(data=1, expert=2).build(),
                               os.environ["MESH_REF_DIR"])
    res["tokens_digest"] = int(np.asarray(
        [t for w in ("bf16", "int8_pool", "ngram")
         for o in res[w]["tokens"] for t in o]).sum())
    return res


def phase_serve_mesh(dev, smi: str) -> dict:
    """Phase 19: serving, RL and MoE on a mesh. (d)'s single-rank MoE
    reference first, then two `--mesh-child` ranks on the card
    (MESH_PHASE=19), each running `serve_mesh_child`; both ranks'
    outputs must be equal, and (d)'s losses, grad norms and leaves after
    the last step within phase 18 (b)'s limits of the reference."""
    import shutil
    import tempfile
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_moe_ref_")
    try:
        t0 = time.perf_counter()
        ref = _moe_mesh_run(dev, None, ref_dir)
        print(f"  (d) single-card MoE reference ({MOE_MESH_LAYERS} layers, "
              f"batch {MOE_MESH_BATCH}): losses {ref['losses']}, grad norms "
              f"{ref['grad_norms']}, step s "
              f"{[round(x, 3) for x in ref['step_s']]}, peak "
              f"{ref['peak_gb']:.2f} GiB")
        t1 = time.perf_counter()
        res, child_s = _mesh_children("19", {"MESH_REF_DIR": ref_dir},
                                      SERVE_MESH_TIMEOUT_S)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    a, b = res
    for key in ("bf16", "int8_pool", "ngram"):
        if a[key]["tokens"] != b[key]["tokens"]:
            fail(f"(a) {key}: the ranks served different tokens")
    if a["unpaged"]["tokens"] != b["unpaged"]["tokens"]:
        fail("(b) the ranks decoded different tokens")
    if a["flywheel"]["history"] != b["flywheel"]["history"]:
        fail("(c) the ranks' flywheel histories differ")
    for r, x in enumerate(res):
        for key in ("bf16", "int8_pool", "ngram"):
            s = x[key]
            c = s["collectives"]
            print(f"  (a) rank {r} {key}: {s['decode_steps']} ticks "
                  f"({s['spec_steps']} verify), {s['prefill_chunks']} "
                  f"chunks, tick p50 {s['p50_token_latency_ms']:.2f} ms p99 "
                  f"{s['p99_token_latency_ms']:.2f} ms, decode "
                  f"{s['decode_tok_s']:.1f} tok/s, wall {s['wall_s']:.2f} s; "
                  f"collectives {c['seconds']:.3f} s in {c['calls']} calls, "
                  f"{c['host_bytes'] / 2 ** 20:.1f} MiB through the host; "
                  f"peak {s['peak_gb']:.2f} GiB; captured {s['captured']}; "
                  f"launches {s['launches']}")
        for name, k in x["h8"].items():
            print(f"  (a) rank {r} {name} at H {k['heads']}: kernel "
                  f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, sdpa "
                  f"{k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
                  f"({k['bound_by']}), max|kernel-plain| "
                  f"{k['max_abs_err']:.3e} ({smi})")
        u = x["unpaged"]
        print(f"  (b) rank {r}: {UNPAGED_MESH_STEPS} decode steps, step p50 "
              f"{u['step_ms_p50']:.2f} ms p99 {u['step_ms_p99']:.2f} ms; "
              f"collectives {u['collectives']['seconds']:.3f} s, "
              f"{u['collectives']['host_bytes'] / 2 ** 20:.1f} MiB; peak "
              f"{u['peak_gb']:.2f} GiB; decode kernel at H "
              f"{u['kernel']['heads']} "
              f"{u['kernel']['ms']:.4f} ms, plain {u['kernel']['plain_ms']:.4f}"
              f" ms, bound {u['kernel']['bound_ms']:.4f} ms; launches "
              f"{u['launches']}")
        f = x["flywheel"]
        print(f"  (c) rank {r}: iterations {[round(s, 2) for s in f['iter_s']]}"
              f" s, losses {f['losses']}, history {f['history']}; "
              f"collectives {f['collectives']['seconds']:.3f} s, "
              f"{f['collectives']['host_bytes'] / 2 ** 20:.1f} MiB; peak "
              f"{f['peak_gb']:.2f} GiB; launches {f['launches']}")
        m = x["moe"]
        print(f"  (d) rank {r} expert=2 (w_up block {m['w_up_block']}): "
              f"losses {m['losses']}, grad norms {m['grad_norms']}, step s "
              f"{[round(s, 3) for s in m['step_s']]}; collectives "
              f"{m['collectives']['seconds']:.3f} s in "
              f"{m['collectives']['calls']} calls, "
              f"{m['collectives']['host_bytes'] / 2 ** 20:.1f} MiB; peak "
              f"{m['peak_gb']:.2f} GiB; launches {m['launches']}")
    for r in range(2):
        tf = [res[r][w].get("teacher_forced") for w in ("bf16", "int8_pool",
                                                         "ngram")]
        tf.append(res[r]["unpaged"]["teacher_forced"])
        if r == 0 and not all(tf):
            fail("rank 0 held no path to phase 3's rule")
    runs = [x["moe"] for x in res]
    dl = max(abs(p - q) for run in runs
             for p, q in zip(run["losses"], ref["losses"]))
    dg = max(abs(p - q) / abs(q) for run in runs
             for p, q in zip(run["grad_norms"], ref["grad_norms"]))
    gaps = max((run["params"] for run in runs),
               key=lambda g: g["update_rel"])
    pa_run = max((run["params"] for run in runs), key=lambda g: g["max_abs"])
    print(f"  (d) worst |dloss| {dl:.3e} (limit {MESH_LOSS_TOL}), worst "
          f"relative dgrad_norm {dg:.3e} (limit {MESH_GN_REL_TOL}) against "
          f"the single card; after step {MOE_MESH_STEPS}, {gaps['leaves']} "
          f"leaves: largest element gap {pa_run['max_abs']:.3e} "
          f"({pa_run['max_abs_leaf']}), gap over the single card's update "
          f"{gaps['update_rel']:.3e} ({gaps['update_rel_leaf']}; limit "
          f"{MESH_UPDATE_REL_TOL})")
    if not (dl <= MESH_LOSS_TOL and dg <= MESH_GN_REL_TOL):
        fail("(d) MoE on expert=2 disagrees with the single card")
    if not gaps["update_rel"] <= MESH_UPDATE_REL_TOL:
        fail(f"(d) the leaves after step {MOE_MESH_STEPS} are not the "
             "single card's")
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        if any(x["moe"]["launches"].get(name, 0) <= 0 for x in res):
            fail(f"(d) {name} was not launched on a rank")
    print(f"  phase 19: reference {t1 - t0:.1f} s, children {child_s:.1f} s "
          f"({t2 - t1:.1f} s with the spawn)")
    return {"card": smi, "moe_ref": ref, "ranks": res,
            "moe_worst_dloss": dl, "moe_worst_rel_dgrad_norm": dg,
            "moe_worst_param_abs": pa_run["max_abs"],
            "moe_worst_update_rel": gaps["update_rel"],
            "part_s": {"ref": t1 - t0, "ranks": t2 - t1}}


# phase 20: the rest of serving on a mesh. Two `--mesh-child` ranks
# (MESH_PHASE=20) on the one card over gloo, as phase 19, on its model at
# tensor=2 (8 heads a rank) and phase 19's cut requests: (a) int8 weights
# with the int8 pool, (b) the 1-layer draft proposer, (c) prefill ->
# decode roles on the mesh and a single card's blobs into the mesh, (d)
# seq=2 (16 heads a rank, the step repeated): the engine and
# `completion_logprobs` against one card
LP_MESH_B, LP_MESH_T, LP_MESH_W = 2, 256, 64
ROLES_MESH_TIMEOUT_S = 600


def _int8_blocks_equal(dev, eng, tree) -> int:
    """(a) Each of the rank's int8 and scale blocks against its cut of
    the single card's `quantize_params` of the same bf16 weights, bit for
    bit; returns the leaves held."""
    import torch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import sharding
    whole = gpt.quantize_params(gpt.GPT(eng.cfg, tree, device=dev))
    held = 0
    for name, block in eng.model.layers.items():
        if not name.startswith(gpt.QUANTIZED_WEIGHTS):
            continue
        want = sharding.local_shard(whole.layers[name],
                                    eng.model.specs["layers." + name],
                                    eng.mesh)
        if block.dtype != want.dtype or not torch.equal(block, want):
            fail(f"(a) the rank's {name} block is not the cut of the single "
                 "card's quantize_params")
        held += 1
    del whole
    _free()
    return held


def _roles_mesh_run(dev, mesh, model, cfg, reqs, new, single) -> dict:
    """(c) Every greedy request of ``reqs`` through a prefill-role engine
    on the mesh, its blob imported by a decode-role engine on the mesh
    (the launches: one multi-query a layer per chunk on the prefill side,
    one paged decode a layer per tick on the decode side, nothing else);
    then a single card's blobs (``single``: the mesh's first rank exports
    them on one card and sends them to every rank) into a second
    decode-role engine on the mesh. Per engine: ticks p50/p99, export
    and import ms, the collectives, peak memory, launches. Returns the
    record and the decode engine (its pool feeds the kernel checks)."""
    import torch.distributed as dist
    from ray_tpu_torch.serve import InferenceEngine
    kw = dict(slots=8, max_len=1024, block_size=16, prefill_chunk=64,
              seed=0, device=dev)
    greedy = [(p, t) for p, t in reqs if t == 0.0]
    out = {}

    def decode(blobs, which):
        dec = InferenceEngine(model, cfg, role="decode", mesh=mesh, **kw)
        _window(dev)
        t0 = time.perf_counter()
        rids = [dec.import_handoff(b) for b in blobs]
        dec.run_until_idle()
        outs = [list(dec.tokens_for(r)) for r in rids]
        rec = {**_window_read(dev), "wall_s": time.perf_counter() - t0}
        st = dec.stats()
        dec.check_invariants()
        want = {"paged_decode_attention": cfg.n_layers * st["decode_steps"],
                "paged_prefill_attention": 0}
        if {k: rec["launches"].get(k, 0) for k in want} != want:
            fail(f"(c) {which} decode: launches {rec['launches']}, want "
                 f"{want}")
        if any(len(o) != new for o in outs):
            fail(f"(c) {which}: a stream ended early")
        rec.update({k: st[k] for k in (
            "decode_steps", "p50_token_latency_ms", "p99_token_latency_ms",
            "kv_import_ms_p50", "kv_import_ms_p99", "imports",
            "kv_import_bytes", "captured")},
            tokens=[[int(t) for t in o] for o in outs])
        return dec, outs, rec

    pre = InferenceEngine(model, cfg, role="prefill", mesh=mesh, **kw)
    _window(dev)
    t0 = time.perf_counter()
    rids = [pre.submit(p, max_new_tokens=new) for p, _ in greedy]
    blobs = [pre.handoff_for(r) for r in rids]
    rec = {**_window_read(dev), "wall_s": time.perf_counter() - t0}
    st = pre.stats()
    want = {"paged_prefill_attention": cfg.n_layers * st["prefill_chunks"],
            "paged_mq_tc": cfg.n_layers * st["prefill_chunks"],
            "paged_decode_attention": 0}
    if {k: rec["launches"].get(k, 0) for k in want} != want:
        fail(f"(c) prefill role: launches {rec['launches']}, want {want}")
    heads = blobs[0]["payload"][0]["k"].shape[2]
    if heads != cfg.n_heads:
        fail(f"(c) the mesh's blob holds {heads} heads, not the whole "
             f"{cfg.n_heads}")
    rec.update({k: st[k] for k in (
        "prefill_chunks", "handoffs", "kv_export_ms_p50",
        "kv_export_ms_p99", "kv_export_bytes")}, blob_heads=heads)
    out["prefill"] = rec
    del pre
    dec, outs, out["decode"] = decode(blobs, "mesh")
    out["outs"] = outs
    del blobs
    _free()
    # a single card's blobs, made on the first rank and sent to both
    box = [single() if mesh.axis_index(mesh.axis_names) == 0 else None]
    dist.broadcast_object_list(box, src=mesh.group(mesh.axis_names)[1][0])
    _, out["single_outs"], out["single_to_mesh"] = decode(box[0], "single")
    out["greedy"] = greedy
    return out, dec


def _seq_mesh_logprobs(dev, tree, cfg) -> dict:
    """(d) `completion_logprobs` of LP_MESH_B rows of LP_MESH_T tokens
    over a seq=2 split (the rank's half of each row's positions: the seq
    offset and the ring) against one card's on the whole rows, bf16
    weights, f32 log-probabilities; the ring's launches."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec, sharding
    mesh = MeshSpec(data=1, seq=2).build()
    rng = np.random.default_rng(20)
    toks = rng.integers(0, cfg.vocab_size, (LP_MESH_B, LP_MESH_T))
    start = np.array([17, LP_MESH_T - LP_MESH_W], np.int64)[:LP_MESH_B]
    one = gpt.GPT(cfg, tree, device=dev)
    with torch.inference_mode():
        want = gpt.completion_logprobs(one, torch.from_numpy(toks).to(dev),
                                       torch.from_numpy(start), LP_MESH_W)
    del one
    model = gpt.GPT(cfg, tree, device=dev, mesh=mesh)
    rows = sharding.shard_batch(toks, mesh)
    _window(dev)
    with torch.inference_mode():
        got = gpt.completion_logprobs(model, torch.from_numpy(rows).to(dev),
                                      torch.from_numpy(start), LP_MESH_W)
    rec = _window_read(dev)
    gap = float((got - want).abs().max())
    if tuple(got.shape) != (LP_MESH_B, LP_MESH_W) or not gap <= LOGPROB_TOL:
        fail(f"(d) completion_logprobs over seq=2: shape "
             f"{tuple(got.shape)}, max|mesh - one card| {gap:.4f} (limit "
             f"{LOGPROB_TOL})")
    return {**rec, "max_abs_gap": gap, "rows_block": list(rows.shape),
            "logprobs": got.float().cpu().tolist()}


def roles_mesh_child(dev) -> dict:
    """Phase 20 on this rank: (a)-(d); every path's counters zeroed just
    before it and read just after."""
    import numpy as np
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.serve import InferenceEngine
    mesh = MeshSpec(data=1, tensor=2).build()
    rank = mesh.axis_index("tensor")
    res = {}
    cfg = gpt.GPTConfig(**SERVE_CFG)
    full = make_traffic(cfg.vocab_size, 0)
    reqs = [full[i] for i in SERVE_MESH_REQS]
    tree = gpt.init_params(0, cfg, dev)
    model = gpt.GPT(cfg, tree, device=dev, mesh=mesh)
    _free()
    # (a) int8 weights with the int8 pool
    c8 = {**SERVE_CFG, "kv_dtype": "int8", "weight_dtype": "int8"}
    eng8, outs, res["int8"] = _serve_mesh_engine(
        dev, mesh, model, gpt.GPTConfig(**c8), reqs, SERVE_MESH_NEW,
        "int8 w+kv")
    res["int8"]["blocks_held"] = _int8_blocks_equal(dev, eng8, tree)
    if rank == 0:
        res["int8"]["teacher_forced"] = phase_teacher_forced(
            dev, c8, 0, reqs, outs, SERVE_MESH_CHECKED)
    # (b) the draft proposer: a 1-layer draft of whole weights, cut by
    # the engine
    dcfg = gpt.GPTConfig(**{**SERVE_CFG, "n_layers": SPEC_DRAFT_LAYERS})
    draft = gpt.GPT(dcfg, gpt.init_params(1, dcfg, dev), device=dev)
    spec = [(p, 0.0) for p, _ in spec_traffic(cfg.vocab_size,
                                              SERVE_MESH_SPEC)]
    eng, outs, res["draft"] = _serve_mesh_engine(
        dev, mesh, model, cfg, spec, SERVE_MESH_NEW, "draft",
        spec="draft", spec_k=SPEC_K, draft_params=draft, draft_cfg=dcfg)
    res["draft"]["draft_heads"] = eng.draft_cache["k"].shape[3]
    if rank == 0:
        res["draft"]["teacher_forced"] = phase_teacher_forced(
            dev, SERVE_CFG, 0, spec, outs, tuple(range(len(spec))))
    del eng, draft
    _free()

    # (c) the roles, then a single card's blobs into the mesh

    def single():
        one = InferenceEngine(gpt.GPT(cfg, tree, device=dev), cfg,
                              role="prefill", slots=8, max_len=1024,
                              block_size=16, prefill_chunk=64, seed=0,
                              device=dev)
        rids = [one.submit(p, max_new_tokens=SERVE_MESH_NEW)
                for p, t in reqs if t == 0.0]
        return [one.handoff_for(r) for r in rids]
    roles, dec = _roles_mesh_run(dev, mesh, model, cfg, reqs,
                                 SERVE_MESH_NEW, single)
    if rank == 0:
        for key in ("outs", "single_outs"):
            roles[key + "_teacher_forced"] = phase_teacher_forced(
                dev, SERVE_CFG, 0, roles["greedy"], roles[key])
    res["roles"] = {k: v for k, v in roles.items()
                    if k not in ("outs", "single_outs", "greedy")}
    res["h8"] = _h8_kernels(dev, dec, eng8, mesh)
    del dec, eng8, model
    _free()
    # (d) seq=2: the step repeated on both ranks, and the logprobs
    smesh = MeshSpec(data=1, seq=2).build()
    smodel = gpt.GPT(cfg, tree, device=dev, mesh=smesh)
    eng, outs, res["seq"] = _serve_mesh_engine(
        dev, smesh, smodel, cfg, reqs, SERVE_MESH_NEW, "seq=2", axis="seq")
    if rank == 0:
        res["seq"]["teacher_forced"] = phase_teacher_forced(
            dev, SERVE_CFG, 0, reqs, outs, SERVE_MESH_CHECKED)
    del eng, smodel
    _free()
    res["logprobs"] = _seq_mesh_logprobs(dev, tree, cfg)
    res["tokens_digest"] = int(np.asarray(
        [t for w in ("int8", "draft", "seq") for o in res[w]["tokens"]
         for t in o]).sum())
    return res


def phase_serve_mesh_roles(dev, smi: str) -> dict:
    """Phase 20: the rest of serving on a mesh, two `--mesh-child` ranks
    on the card (MESH_PHASE=20), each running `roles_mesh_child`; both
    ranks' outputs must be equal."""
    t0 = time.perf_counter()
    res, child_s = _mesh_children("20", {}, ROLES_MESH_TIMEOUT_S)
    a, b = res
    for key in ("int8", "draft", "seq"):
        if a[key]["tokens"] != b[key]["tokens"]:
            fail(f"{key}: the ranks served different tokens")
    for key in ("decode", "single_to_mesh"):
        if a["roles"][key]["tokens"] != b["roles"][key]["tokens"]:
            fail(f"(c) {key}: the ranks decoded different tokens")
    if a["logprobs"]["logprobs"] != b["logprobs"]["logprobs"]:
        fail("(d) the ranks' completion_logprobs differ")
    for r, x in enumerate(res):
        for key, part in (("int8", "(a) int8 w+kv"), ("draft", "(b) draft"),
                          ("seq", "(d) seq=2")):
            s = x[key]
            c = s["collectives"]
            print(f"  {part} rank {r}: {s['decode_steps']} ticks "
                  f"({s['spec_steps']} verify, acceptance "
                  f"{s['acceptance_rate']}), {s['prefill_chunks']} chunks, "
                  f"tick p50 {s['p50_token_latency_ms']:.2f} ms p99 "
                  f"{s['p99_token_latency_ms']:.2f} ms, wall "
                  f"{s['wall_s']:.2f} s; collectives {c['seconds']:.3f} s "
                  f"({c['seconds'] / s['wall_s']:.1%} of the wall) in "
                  f"{c['calls']} calls, {c['host_bytes'] / 2 ** 20:.1f} MiB "
                  f"through the host; peak {s['peak_gb']:.2f} GiB; launches "
                  f"{s['launches']}")
        print(f"  (a) rank {r}: {x['int8']['blocks_held']} int8 and scale "
              "blocks the cut of one card's quantize_params, bit for bit; "
              f"(b) draft pool {x['draft']['draft_heads']} heads a rank")
        ro = x["roles"]
        for key in ("prefill", "decode", "single_to_mesh"):
            s = ro[key]
            c = s["collectives"]
            extra = (f"{s['prefill_chunks']} chunks, {s['handoffs']}"
                     f" exports of {s['blob_heads']} heads, export ms p50 "
                     f"{s['kv_export_ms_p50']:.2f} p99 "
                     f"{s['kv_export_ms_p99']:.2f}"
                     if key == "prefill" else
                     f"{s['decode_steps']} ticks, tick p50 "
                     f"{s['p50_token_latency_ms']:.2f} ms p99 "
                     f"{s['p99_token_latency_ms']:.2f} ms, "
                     f"{s['imports']} imports, import ms p50 "
                     f"{s['kv_import_ms_p50']:.2f} p99 "
                     f"{s['kv_import_ms_p99']:.2f}")
            print(f"  (c) rank {r} {key}: {extra}, wall {s['wall_s']:.2f} s; "
                  f"collectives {c['seconds']:.3f} s "
                  f"({c['seconds'] / s['wall_s']:.1%}) in {c['calls']} calls, "
                  f"{c['host_bytes'] / 2 ** 20:.1f} MiB; peak "
                  f"{s['peak_gb']:.2f} GiB; launches {s['launches']}")
        for name, k in x["h8"].items():
            print(f"  (c) rank {r} {name} at H {k['heads']}: kernel "
                  f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, sdpa "
                  f"{k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
                  f"({k['bound_by']}), max|kernel-plain| "
                  f"{k['max_abs_err']:.3e} ({smi})")
        lp = x["logprobs"]
        print(f"  (d) rank {r} completion_logprobs over seq=2 (rows block "
              f"{lp['rows_block']}): max|mesh - one card| "
              f"{lp['max_abs_gap']:.4f} (limit {LOGPROB_TOL}); collectives "
              f"{lp['collectives']['seconds']:.3f} s; launches "
              f"{lp['launches']}")
    tf = [res[0][w].get("teacher_forced") for w in ("int8", "draft", "seq")]
    tf += [res[0]["roles"].get(k + "_teacher_forced")
           for k in ("outs", "single_outs")]
    if not all(tf):
        fail("rank 0 held a path to no rule")
    total = time.perf_counter() - t0
    print(f"  phase 20: children {child_s:.1f} s ({total:.1f} s with the "
          "spawn)")
    return {"card": smi, "ranks": res, "part_s": {"ranks": total}}


# phase 21: the rest of training on a mesh. Two `--mesh-child` ranks
# (MESH_PHASE=21) on the one card over gloo, as phase 18 (b): (a)
# MoEConfig()'s width over seq=2 and over pipe=2, (b) ViTConfig()'s over
# pipe=2, (d) the async checkpointer on tensor=2; then four ranks
# (MESH_PHASE=21c) for (c), the GPipe trainer on pipe=2 x tensor=2. The
# single-card references run in the parent first.
TRAIN_REST_TIMEOUT_S = 600
VIT_MESH_BATCH, VIT_MESH_STEPS = 8, 2
CKPT_MESH_LAYERS, CKPT_MESH_STEPS = 4, 2
PIPE_MESH_LAYERS, PIPE_MICROBATCHES = 4, 2
# (label, mesh, dtype, held): MoE over seq in f32 and in bf16, over pipe
# in bf16. A top-k router turns a last-bit difference into another
# expert, and Adam's first steps move an element by about the learning
# rate whatever its gradient's size: over seq the ranks sum their
# rows' bf16-rounded gradient blocks where one card rounds the total, so
# in bf16 the gap to one card measures those roundings, not the route
# (the f32 run's gap is the route's). The f32 run is held to phase 18
# (b)'s limits, the bf16 one printed; the pipe ranks repeat one card's
# step exactly.
TRAIN_REST_MOE = (("seq=2 f32", dict(data=1, seq=2), "float32", True),
                  ("seq=2", dict(data=1, seq=2), "bfloat16", False),
                  ("pipe=2", dict(data=1, pipe=2), "bfloat16", True))


def _vit_mesh_cfg():
    from ray_tpu_torch.models import vit
    return vit.ViTConfig()


def _vit_mesh_run(dev, mesh, ref_dir: str) -> dict:
    """(b) ViTConfig() trained VIT_MESH_STEPS steps at batch
    VIT_MESH_BATCH from MESH_SEED (`_mesh_optimizer`, rows placed by the
    ``"batch"`` rule alone: a batch of images has no length axis), with
    `_mesh_steps`' record. With ``mesh`` None the leaves after the last
    step go to ``ref_dir``; on a mesh each is held against them."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.train import spmd
    cfg = _vit_mesh_cfg()
    rng = np.random.default_rng(MESH_SEED + 21)
    batches = [{"images": rng.standard_normal(
                    (VIT_MESH_BATCH, cfg.image_size, cfg.image_size,
                     cfg.channels)).astype(np.float32),
                "labels": rng.integers(0, cfg.num_classes,
                                       VIT_MESH_BATCH).astype(np.int32)}
               for _ in range(VIT_MESH_STEPS)]

    def place(b):
        if mesh is not None:
            b = sharding.shard_batch(b, mesh, logical=("batch",))
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
    opt = _mesh_optimizer(spmd)
    model = vit.ViT(cfg, vit.init_params(MESH_SEED, cfg, dev), device=dev,
                    dtype=torch.float32, trainable=True, mesh=mesh)
    state = spmd.TrainState(model, opt.init(model),
                            torch.zeros((), dtype=torch.int32, device=dev))
    step = spmd.make_train_step(lambda m, b: vit.loss_fn(m, b, cfg), opt)
    rec, state = _mesh_steps(state, step, place, batches)
    path = os.path.join(ref_dir, "vit_params.pt")
    if mesh is None:
        _save_params(state.params, path)
    else:
        rec["batch_axes"] = list(spmd.batch_axes(state.params))
        rec["params"] = _mesh_param_gaps(
            state.params, mesh, path,
            _flat_params(vit.init_params(MESH_SEED, cfg, dev)), dev)
    del state, step
    _free()
    return rec


def _ckpt_mesh_run(dev, root: str) -> dict:
    """(d) `make_gpt_trainer` at bench.py's width cut to CKPT_MESH_LAYERS
    layers on tensor=2 with an `AsyncCheckpointer` snapshotting every
    step: the host time of each `maybe_snapshot` on the training thread,
    the clones' device ms, the writer's gather and commit seconds, the
    commits, the manifest's specs against `ft.state_specs`, the next
    step's loss, and that loss again from the checkpoint restored onto
    the same mesh. Launches counted from zero around the checkpointed
    steps."""
    import torch
    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.train import ft, spmd
    mesh = MeshSpec(data=1, tensor=2).build()
    cfg = _mesh_cfg(CKPT_MESH_LAYERS)
    state, step, place = spmd.make_gpt_trainer(
        cfg, seed=MESH_SEED, optimizer=_mesh_optimizer(spmd), device=dev,
        mesh=mesh)
    batches = [place(b) for b in _mesh_batches(cfg)]
    ckpt = ft.AsyncCheckpointer(root, every=1, keep=CKPT_MESH_STEPS + 1)
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    col.reset_stats()
    snap_ms, losses = [], []
    for i in range(CKPT_MESH_STEPS):
        state, m = step(state, batches[i])
        t0 = time.perf_counter()
        ckpt.maybe_snapshot(state, i + 1)
        snap_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = {k: v for k, v in ops.kernel_launches().items() if v}
    t0 = time.perf_counter()
    ckpt.flush()
    flush_s = time.perf_counter() - t0
    manifest = ft.load_manifest(ft.latest_checkpoint(root))
    specs_equal = ([e["spec"] for e in manifest["shards"]]
                   == ft.state_specs(state))
    nxt = float(step(state, batches[CKPT_MESH_STEPS])[1]["loss"])
    ckpt.close()
    rec = {"losses": losses, "next_loss": nxt, "snapshot_ms": snap_ms,
           "timings": ckpt.timings, "commits": ckpt.commits,
           "snapshots": ckpt.snapshots, "flush_s": flush_s,
           "steps": [s for s, _ in ft.committed_steps(root)],
           "specs_equal": specs_equal,
           "split_specs": sum(any(e["spec"]) for e in manifest["shards"]),
           "shards": len(manifest["shards"]), "launches": launches}
    del state
    _free()
    tree, at = ft.restore_resharded(root, dev, mesh=mesh)
    back = ft.state_from_tree(tree, cfg, dev, mesh=mesh)
    rec["restored_at"] = at
    rec["mesh_next_loss"] = float(step(back, batches[CKPT_MESH_STEPS])[1][
        "loss"])
    del tree, back, step
    _free()
    return rec


def train_rest_child(dev) -> dict:
    """Phase 21 (a), (b) and (d) on this rank of two; every path's
    counters zeroed just before it and read just after."""
    from ray_tpu_torch.parallel import MeshSpec
    ref_dir = os.environ["MESH_REF_DIR"]
    res = {"moe": {}}
    for label, kw, dtype, _ in TRAIN_REST_MOE:
        res["moe"][label] = _moe_mesh_run(dev, MeshSpec(**kw).build(),
                                          ref_dir, dtype)
    res["vit"] = _vit_mesh_run(dev, MeshSpec(data=1, pipe=2).build(),
                               ref_dir)
    res["ckpt"] = _ckpt_mesh_run(dev, os.path.join(ref_dir, "ckpt"))
    return res


def pipe_rest_child(dev) -> dict:
    """Phase 21 (c) on this rank of four: `make_gpt_pipeline_trainer` at
    bench.py's width cut to PIPE_MESH_LAYERS layers on pipe=2 x tensor=2
    (each stage's blocks whole on both tensor ranks, flash on all 16
    heads), `_mesh_steps`' record and the leaves against the parent's
    single-card trainer; then the three flash kernels against their plain
    versions at a stage's shapes ([MESH_BATCH / PIPE_MICROBATCHES, T, 16,
    64], bf16, causal), on each rank in turn."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import spmd
    mesh = MeshSpec(data=1, pipe=2, tensor=2).build()
    cfg = _mesh_cfg(PIPE_MESH_LAYERS)
    state, step, place = spmd.make_gpt_pipeline_trainer(
        cfg, mesh, num_microbatches=PIPE_MICROBATCHES, seed=MESH_SEED,
        optimizer=_mesh_optimizer(spmd), device=dev)
    res, state = _mesh_steps(state, step, place, _mesh_batches(cfg))
    res["wq_block"] = list(state.params.layers["wq"].shape)
    res["params"] = _mesh_param_gaps(
        state.params, mesh,
        _mesh_ref_path(os.environ["MESH_REF_DIR"], PIPE_MESH_LAYERS),
        _flat_params(gpt.init_params(MESH_SEED, cfg, dev)), dev)
    del state, step
    _free()
    g = torch.Generator(device=dev).manual_seed(MESH_SEED + dist.get_rank())
    for r in range(mesh.size):
        dist.barrier()
        if r == dist.get_rank():
            res["flash"] = flash_case(
                g, dev, MESH_BATCH // PIPE_MICROBATCHES, cfg.max_seq_len,
                cfg.n_heads, cfg.head_dim, True, "bfloat16")
    dist.barrier()
    return res


def _print_mesh_run(part: str, label: str, runs: list, ref: dict,
                    steps: int, smi: str, held: bool = True) -> dict:
    """Each rank's record of one mesh run against the single card's
    ``ref`` (losses, grad norms, leaves), printed and (``held``) held to
    phase 18 (b)'s limits; all ranks' losses equal. Returns the worst
    gaps."""
    dl = max(abs(a - b) for run in runs
             for a, b in zip(run["losses"], ref["losses"]))
    dg = max(abs(a - b) / abs(b) for run in runs
             for a, b in zip(run["grad_norms"], ref["grad_norms"]))
    for r, run in enumerate(runs):
        c = run["collectives"]
        print(f"  {part} {label} rank {r}: losses "
              f"{[round(x, 5) for x in run['losses']]}, grad norms "
              f"{[round(x, 4) for x in run['grad_norms']]}, step s "
              f"{[round(x, 3) for x in run['step_s']]}, collectives "
              f"{c['seconds']:.3f} s in {c['calls']} calls, "
              f"{c['host_bytes'] / 2 ** 20:.1f} MiB through the host; peak "
              f"{run['peak_gb']:.2f} GiB; launches {run['launches']}")
    gaps = max((run["params"] for run in runs),
               key=lambda g: g["update_rel"])
    pa_run = max((run["params"] for run in runs), key=lambda g: g["max_abs"])
    named = {k: max(run["params"]["by_leaf"][k] for run in runs)
             for k in runs[0]["params"]["by_leaf"]}
    picked = {k: v for k, v in named.items()
              if k in ("layers.router", "layers.w_up", "layers.wq")}
    print(f"  {part} {label}: worst |dloss| {dl:.3e} (limit {MESH_LOSS_TOL}),"
          f" worst relative dgrad_norm {dg:.3e} (limit {MESH_GN_REL_TOL}) "
          f"against the single card; after step {steps}, {gaps['leaves']} "
          f"leaves: largest element gap {pa_run['max_abs']:.3e} "
          f"({pa_run['max_abs_leaf']}), gap over the single card's update "
          f"{gaps['update_rel']:.3e} ({gaps['update_rel_leaf']}; limit "
          f"{MESH_UPDATE_REL_TOL}); by leaf {picked}"
          f"{'' if held else ' (printed, not held)'} ({smi})")
    if any(run["losses"] != runs[0]["losses"] for run in runs):
        fail(f"{part} {label}: the ranks report different losses")
    if held and not (dl <= MESH_LOSS_TOL and dg <= MESH_GN_REL_TOL):
        fail(f"{part} {label} disagrees with the single card")
    if held and not gaps["update_rel"] <= MESH_UPDATE_REL_TOL:
        fail(f"{part} {label}: the leaves after step {steps} are not the "
             "single card's")
    return {"held": held, "worst_dloss": dl, "worst_rel_dgrad_norm": dg,
            "worst_param_abs": pa_run["max_abs"],
            "worst_update_rel": gaps["update_rel"], "by_leaf": named}


def phase_train_mesh_rest(dev, smi: str) -> dict:
    """Phase 21: the rest of training on a mesh. The single-card
    references in the parent (MoE, ViT, the 4-layer GPT), two
    `--mesh-child` ranks (MESH_PHASE=21, `train_rest_child`) for (a),
    (b) and (d), four (MESH_PHASE=21c, `pipe_rest_child`) for (c); then
    (d)'s checkpoint restored onto this one card."""
    import shutil
    import tempfile
    from ray_tpu_torch.train import ft, spmd
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_rest_ref_")
    out = {"card": smi}
    try:
        t0 = time.perf_counter()
        refs = {"moe": _moe_mesh_run(dev, None, ref_dir),
                "moe_f32": _moe_mesh_run(dev, None, ref_dir, "float32"),
                "vit": _vit_mesh_run(dev, None, ref_dir)}
        cfg = _mesh_cfg(PIPE_MESH_LAYERS)
        state, step, place = spmd.make_gpt_trainer(
            cfg, seed=MESH_SEED, optimizer=_mesh_optimizer(spmd), device=dev)
        refs["gpt"], state = _mesh_steps(state, step, place,
                                         _mesh_batches(cfg))
        _save_params(state.params, _mesh_ref_path(ref_dir, PIPE_MESH_LAYERS))
        del state, step
        _free()
        for k, v in refs.items():
            print(f"  single-card {k}: losses {v['losses']}, grad norms "
                  f"{v['grad_norms']}, launches {v['launches']}")
        t1 = time.perf_counter()
        res, child_s = _mesh_children("21", {"MESH_REF_DIR": ref_dir},
                                      TRAIN_REST_TIMEOUT_S)
        t2 = time.perf_counter()
        res_c, child_c_s = _mesh_children("21c", {"MESH_REF_DIR": ref_dir},
                                          TRAIN_REST_TIMEOUT_S, n=4)
        t3 = time.perf_counter()
        out["moe"] = {label: _print_mesh_run(
            "(a) MoE", label, [x["moe"][label] for x in res],
            refs["moe" if dtype == "bfloat16" else "moe_f32"],
            MOE_MESH_STEPS, smi, held)
            for label, _, dtype, held in TRAIN_REST_MOE}
        if any(x["moe"]["pipe=2"]["launches"].get(k, 0) <= 0
               for x in res for k in ("flash_forward", "flash_dq",
                                      "flash_dkv")):
            fail("(a) a flash kernel was not launched on MoE's pipe=2 ranks")
        out["vit"] = _print_mesh_run("(b) ViT", "pipe=2",
                                     [x["vit"] for x in res], refs["vit"],
                                     VIT_MESH_STEPS, smi)
        if any(x["vit"]["batch_axes"] for x in res):
            fail("(b) ViT on pipe=2 sums over an axis whose ranks repeat")
        out["pipe"] = _print_mesh_run("(c) GPipe", "pipe=2 x tensor=2",
                                      res_c, refs["gpt"], MESH_STEPS, smi)
        for r, x in enumerate(res_c):
            fl = {k: x["launches"].get(k, 0) for k in (
                "flash_forward", "flash_dq", "flash_dkv", "flash_fwd_tc",
                "flash_dq_tc", "flash_dkv_tc")}
            print(f"  (c) rank {r}: wq block {x['wq_block']} (the stage's "
                  f"layers, heads split for storage); flash launches {fl}; "
                  f"at the stage's shapes "
                  f"{ {k: v['max_abs_err'] for k, v in x['flash'].items()} }")
            if min(fl.values()) <= 0:
                fail(f"(c) rank {r}: a flash kernel was not launched")
        # (d) one commit a snapshot, the specs, a restore onto this card
        ck = [x["ckpt"] for x in res]
        for r, c in enumerate(ck):
            t = c["timings"]
            print(f"  (d) tensor=2 rank {r}: losses {c['losses']}, next "
                  f"{c['next_loss']}, from the checkpoint on the mesh "
                  f"{c['mesh_next_loss']}; {c['snapshots']} snapshots, "
                  f"{c['commits']} commits, committed steps {c['steps']}; "
                  f"maybe_snapshot on the training thread "
                  f"{[round(v, 3) for v in c['snapshot_ms']]} ms; clones "
                  f"{[round(x['clone_ms'] or 0, 3) for x in t]} device ms; "
                  f"gather {[round(x.get('gather_s', 0), 3) for x in t]} s; "
                  f"commit {[round(x['commit_s'], 3) for x in t]} s; "
                  f"flush {c['flush_s']:.3f} s; specs equal to state_specs: "
                  f"{c['specs_equal']} ({c['split_specs']} of "
                  f"{c['shards']} split); launches {c['launches']}")
        if [c["commits"] for c in ck] != [CKPT_MESH_STEPS, 0]:
            fail(f"(d) commits {[c['commits'] for c in ck]}: one rank must "
                 "commit each snapshot")
        if not all(c["specs_equal"] and c["split_specs"] > 0 for c in ck):
            fail("(d) the manifest's specs are not the state's")
        if any(c["steps"] != list(range(1, CKPT_MESH_STEPS + 1))
               or c["mesh_next_loss"] != c["next_loss"] for c in ck):
            fail("(d) the checkpoint does not restore the mesh's state")
        cfg = _mesh_cfg(CKPT_MESH_LAYERS)
        tree, at = ft.restore_resharded(os.path.join(ref_dir, "ckpt"), dev)
        state = ft.state_from_tree(tree, cfg, dev)
        _, step, place = spmd.make_gpt_trainer(
            cfg, optimizer=_mesh_optimizer(spmd), device=dev,
            init_state=False)
        one = float(step(state, place(_mesh_batches(cfg)[CKPT_MESH_STEPS]))[
            1]["loss"])
        del tree, state, step
        _free()
        print(f"  (d) restored onto one card at step {at}: next loss {one} "
              f"against the mesh's {ck[0]['next_loss']} (limit "
              f"{MESH_LOSS_TOL})")
        if not (at == CKPT_MESH_STEPS
                and abs(one - ck[0]["next_loss"]) <= MESH_LOSS_TOL):
            fail("(d) the checkpoint restored onto one card does not "
                 "continue the mesh's run")
        out.update(refs=refs, ranks=res, pipe_ranks=res_c, ckpt_one=one)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    print(f"  phase 21: references {t1 - t0:.1f} s, two ranks {child_s:.1f}"
          f" s ({t2 - t1:.1f} s with the spawn), four ranks {child_c_s:.1f} "
          f"s ({t3 - t2:.1f} s)")
    out["part_s"] = {"refs": t1 - t0, "ranks": t2 - t1, "ranks4": t3 - t2}
    return out


def _readable_kernel(mangled: str):
    """A readable name for an instantiation of a tensor-core kernel or of
    a split-K decode kernel (``flash_dq_tc_kernel<64, true>``,
    ``paged_mq_tc_kernel<64>``, ``paged_mq_tc_kernel<64, int8>``,
    ``paged_decode_kernel<bf16, 8, 1>``, ``paged_decode_kernel<bf16,
    int8, 8, 1>``, ``decode_kernel<bf16, 8, 1>``), or None for the
    others."""
    k = re.search(r"((?:flash|xent)_[a-z_]*?tc_kernel)(?:ILi(\d+)ELb([01])E)?",
                  mangled)
    if k:
        return k.group(1) + (
            f"<{k.group(2)}, {'true' if k.group(3) == '1' else 'false'}>"
            if k.group(2) else "")
    k = re.search(r"paged_mq_tc_kernelILi(\d+)ELb([01])E", mangled)
    if k:
        return (f"paged_mq_tc_kernel<{k.group(1)}"
                f"{', int8' if k.group(2) == '1' else ''}>")
    # the paged kernel's second type is its pool's: T again (f, or a
    # substitution S_, S0_, ... for bf16) or int8_t (a)
    k = re.search(r"(paged_|\d)decode_kernelI(f|13__nv_bfloat16)"
                  r"(f|a|S\d*_)?Li(\d+)ELi(\d+)E", mangled)
    if k:
        name = "paged_decode" if k.group(1) == "paged_" else "decode"
        dt = "f32" if k.group(2) == "f" else "bf16"
        pool = ", int8" if k.group(3) == "a" else ""
        return f"{name}_kernel<{dt}{pool}, {k.group(4)}, {k.group(5)}>"
    return None


def kernel_registers(ptxas: str) -> dict:
    """Registers and spilled bytes (stores + loads) of each instantiation
    of the tensor-core kernels and of the split-K decode kernels, from
    nvcc's ptxas report, by a readable name (`_readable_kernel`)."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _readable_kernel(m.group(1))
            if name:
                out[name] = {"registers": None, "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def decode_times(root: str) -> dict:
    """``--decode-times``: the device time per call (`time_ms`, inputs
    cold in L2) of the two decode kernels of the checkout at ``root``,
    bf16 at the serving shapes (8 rows, 16 heads of 64), through their
    public wrappers: `decode_attention` over [8, 1024, 16, 64] caches at
    DECODE_POS and at phase 9 (b)'s contexts (`unpaged_contexts`), and
    `paged_decode_attention` over pools of NB blocks of BS through
    scrambled MB-entry tables at DECODE_POS and at phase 4's contexts
    (every row at PROFILE_PROMPT + i for i up to PROFILE_NEW). Each
    kernel is held against its plain version first. The checkout builds
    its own kernels; nothing of this repo's ``ray_tpu_torch`` is
    imported."""
    import torch
    sys.path.insert(0, root)
    from ray_tpu_torch.ops import decode_attention as da
    if not os.path.abspath(da.__file__).startswith(root + os.sep):
        fail(f"imported {da.__file__}, not {root}'s")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b = 8

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    def pos_sets(rows):
        return [torch.tensor(p, dtype=torch.int32, device=dev) for p in rows]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    out = {"root": root, "card": smi.strip().splitlines()[0]}
    q = randn(b, H, D)
    caches = [(randn(b, MB * BS, H, D), randn(b, MB * BS, H, D))
              for _ in range(TIME_SETS)]
    paged_steps = range(0, PROFILE_NEW, PROFILE_NEW // TIME_SETS)
    for name, rows in (
            ("decode_pos", [DECODE_POS] * TIME_SETS),
            ("contexts", unpaged_contexts(SERVE_CFG["vocab_size"]))):
        sets = [(q, k, v, p) for (k, v), p in zip(caches, pos_sets(rows))]
        check("decode", da.decode_attention(*sets[-1]),
              da.reference_decode_attention(*sets[-1]), "bfloat16",
              f"decode {name}")
        out[f"decode_{name}_ms"] = time_ms(da.decode_attention, sets)
    del caches
    pools = [(randn(NB, BS, H, D), randn(NB, BS, H, D))
             for _ in range(TIME_SETS)]
    perm = torch.randperm(NB - 1, generator=g, device=dev) + 1
    tables = perm[:b * MB].view(b, MB).to(torch.int32).contiguous()
    for name, rows in (
            ("decode_pos", [DECODE_POS] * TIME_SETS),
            ("phase4_contexts", [[PROFILE_PROMPT + i] * b
                                 for i in paged_steps])):
        sets = [(q, kp, vp, tables, p)
                for (kp, vp), p in zip(pools, pos_sets(rows))]
        check("paged_decode", da.paged_decode_attention(*sets[-1]),
              da.reference_paged_decode_attention(*sets[-1]), "bfloat16",
              f"paged decode {name}")
        out[f"paged_{name}_ms"] = time_ms(da.paged_decode_attention, sets)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--decode-times"] and len(sys.argv) <= 3:
        root = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else
                               os.path.dirname(__file__))
        print(json.dumps(decode_times(root)))
        return 0
    if sys.argv[1:] == ["--ft-child"]:
        return ft_child()
    if sys.argv[1:] == ["--mesh-child"]:
        return mesh_child()
    if len(sys.argv) > 1:
        fail(f"unknown arguments {sys.argv[1:]} (see the docstring)")
    from ray_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    nvcc = nvcc.strip().splitlines()[-1]
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, nvcc: {nvcc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.perf_counter()
    libs, ptxas = _build.build()
    build_s = time.perf_counter() - t0
    print(f"built {', '.join(os.path.relpath(p) for p in libs)} in "
          f"{build_s:.1f} s")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", ptxas))
    if regs:
        print(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes spilled")
    kern_regs = kernel_registers(ptxas)
    for name, r in kern_regs.items():
        print(f"  ptxas {name}: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled")
    _build.load()

    result = {"card": smi, "torch": torch.__version__,
              "torch_cuda": torch.version.cuda, "nvcc": nvcc,
              "build_s": build_s, "ptxas_kernels": kern_regs,
              "phase_s": {}}
    cfg_kwargs = dict(SERVE_CFG)

    def phase(n, title, fn, *args):
        print(f"phase {n}: {title}")
        t0 = time.perf_counter()
        got = fn(*args)
        result["phase_s"][n] = time.perf_counter() - t0
        print(f"  phase {n} took {result['phase_s'][n]:.1f} s")
        return got

    kern = phase(1, "paged kernels vs plain", phase_kernels, dev, kern_regs)
    replica, reqs, outs, eng = phase(2, "engine at full width",
                                     phase_engine, dev, cfg_kwargs, 0)
    tf = phase(3, "teacher-forced logprobs vs dense f32 forward",
               phase_teacher_forced, dev, cfg_kwargs, 0, reqs, outs)
    prof = phase(4, "engine under torch.profiler", phase_profile, replica,
                 cfg_kwargs["vocab_size"], cfg_kwargs["n_layers"])
    del replica
    torch.cuda.empty_cache()
    flash = phase(5, "flash kernels vs plain", phase_flash, dev)
    train = phase(6, "training at full width", phase_train, dev)
    xent = phase(7, "fused cross-entropy kernels vs plain", phase_xent, dev)
    fused = phase(8, "bench.py's training configuration (fused loss, "
                  "batch 24)", phase_fused_train, dev)
    unpaged = phase(9, "unpaged KV-cache path at full width", phase_unpaged,
                    dev, cfg_kwargs, kern_regs)
    c1 = phase(10, "head dims 96, 100, 256, pool block 64, loss widths 384, "
               "1600, 4096; head dims 264, 512, 520, 1024", phase_c1, dev)
    int8 = phase(11, "int8 serving (int8 pool, int8 weights)", phase_int8,
                 dev, kern, reqs, outs, eng)
    spec = phase(12, "speculative decoding (verify kernel, n-gram and draft "
                 "engines)", phase_spec, dev)
    capture = phase(13, "compile-once serving: eager against captured "
                    "engines", phase_capture, dev)
    pressure = phase(14, "scheduling under pressure (preemption, shedding, "
                     "watchdog, fault sites)", phase_pressure, dev, smi)
    disagg = phase(15, "disaggregated prefill/decode (bench_infer.py's A/B, "
                   "backends, the replicas over netaddr)", phase_disagg, dev,
                   smi)
    flywheel = phase(16, "the RL flywheel and the telemetry plane (full "
                     "width, tiny, the flight recorder's cost)",
                     phase_flywheel, dev, smi)
    ft_models = phase(17, "fault-tolerant training (bench.py's checkpoint "
                      "region, kill/resume) and the other model families "
                      "(MoE, ViT, ResNet)", phase_ft_models, dev, smi)
    mesh = phase(18, "SPMD training on a mesh (a mesh of one; two ranks on "
                 "the card: tensor, data, seq, pipe)", phase_mesh, dev, smi)
    serve_mesh = phase(19, "serving, RL and MoE on a mesh (two ranks on the "
                       "card: the paged engine and the unpaged cache at 8 "
                       "heads a rank, the flywheel, MoE on expert=2)",
                       phase_serve_mesh, dev, smi)
    roles_mesh = phase(20, "the rest of serving on a mesh (two ranks on the "
                       "card: int8 weights, the draft proposer, prefill/"
                       "decode roles and the handoff at 8 heads a rank; "
                       "seq=2)", phase_serve_mesh_roles, dev, smi)
    train_rest = phase(21, "the rest of training on a mesh (two ranks on "
                       "the card: MoE over seq and pipe, ViT over pipe, the "
                       "async checkpointer on tensor=2; four ranks: the "
                       "GPipe trainer on pipe=2 x tensor=2)",
                       phase_train_mesh_rest, dev, smi)
    result.update(kernels=kern, engine=eng, teacher_forced=tf, profile=prof,
                  flash=flash, train=train, xent=xent, fused_train=fused,
                  unpaged=unpaged, c1=c1, int8=int8, spec=spec,
                  capture=capture, pressure=pressure, disagg=disagg,
                  flywheel=flywheel, ft_models=ft_models, mesh=mesh,
                  serve_mesh=serve_mesh, roles_mesh=roles_mesh,
                  train_rest=train_rest)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    rows = []
    # launches: each kernel's count over its own path's main run (phase 2
    # for serving, phase 6 (c) for training with the dense loss, phase 8
    # (c) for bench.py's fused-loss training, phase 9 (b) for the unpaged
    # path, phase 11 (b)'s "kv+w" engine for int8 serving, phase 12 (b)'s
    # n-gram and draft engines for the verify caller), counters zeroed
    # just before
    verify = {"paged_verify_attention": sum(
        spec["engines"][w]["launches"]["paged_verify_attention"]
        for w in ("ngram", "draft"))}
    # phase 14's own paths, each counted from zero around its run: (a)'s
    # pressured engine at random weights (decode and prefill, the
    # re-prefill chunks among the latter) and (b)'s spec engines under
    # the engine.preempt plan (verify)
    pressure_launches = pressure["block"]["launches"]
    pressure_verify = sum(pressure["spec"][w]["verify_launches"]
                          for w in ("ngram", "draft"))
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        if pressure_launches[name] <= 0:
            fail(f"{name} was not launched on phase 14's path")
    if pressure_verify <= 0:
        fail("paged_verify_attention was not launched on phase 14's path")
    # phase 15's own paths, each counted from zero around its run: (a)'s
    # disaggregated pair (prefill on the prefill-role engine, decode on
    # the decode-role one) and (b)'s n-gram and draft decode-role engines
    # (verify)
    disagg_launches = disagg["ab"]["launches"]
    disagg_verify = sum(disagg["backends"][w]["verify_launches"]
                        for w in ("ngram", "draft"))
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        if disagg_launches[name] <= 0:
            fail(f"{name} was not launched on phase 15's path")
    if disagg_verify <= 0:
        fail("paged_verify_attention was not launched on phase 15's path")
    # phase 16 (a)'s flywheel, counted from zero around its run: the
    # engine's rollouts (paged decode and prefill) and the learner's
    # steps (flash forward, dQ, dK/dV) apart
    fly_engine = flywheel["full_width"]["launches_engine"]
    fly_learner = flywheel["full_width"]["launches_learner"]
    # phase 17's paths, each counted from zero around its run: (a)'s
    # checkpoint region (bench.py's fused-loss GPT: flash and fused xent)
    # and (c)'s MoE training (flash)
    ckpt_launches = ft_models["ckpt_region"]["launches"]
    moe_launches = ft_models["moe"]["launches"]
    for name in ("flash_forward", "flash_dq", "flash_dkv", "fused_xent_fwd",
                 "xent_dx", "xent_de"):
        if ckpt_launches[name] <= 0:
            fail(f"{name} was not launched on phase 17 (a)'s path")
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        if moe_launches[name] <= 0:
            fail(f"{name} was not launched on phase 17 (c)'s path")
    # phase 18's paths, each counted from zero around its run: (a)'s mesh
    # of one and (b)'s meshes on rank 0 (flash on its heads or its rows,
    # the fused-xent kernels on its vocabulary shard)
    mesh_runs = {label: run["ranks"][0]["launches"]
                 for label, run in mesh["ranks"]["runs"].items()}
    mesh_one_launches = mesh["one"]["12_one"]["launches"]

    def mesh_paths(wrapper, labels):
        return {"phase 18 (a)": mesh_one_launches.get(wrapper, 0),
                **{f"phase 18 (b) {lb} rank 0": mesh_runs[lb].get(wrapper, 0)
                   for lb in labels}}
    for key, wrapper, replaces, rec, launches, src in (
            ("paged_decode", "paged_decode_attention",
             "ray_tpu/ops/decode_attention.py:282", kern["paged_decode"],
             eng["launches"], "paged_attention.cu"),
            ("paged_prefill", "paged_prefill_attention",
             "ray_tpu/ops/decode_attention.py:424", kern["paged_prefill"],
             eng["launches"], "paged_attention.cu"),
            ("flash_forward", "flash_forward",
             "ray_tpu/ops/flash_attention.py:63", flash["fwd"],
             train["launches"], "flash_attention.cu"),
            ("flash_dq", "flash_dq", "ray_tpu/ops/flash_attention.py:189",
             flash["dq"], train["launches"], "flash_attention.cu"),
            ("flash_dkv", "flash_dkv", "ray_tpu/ops/flash_attention.py:219",
             flash["dkv"], train["launches"], "flash_attention.cu"),
            ("fused_xent_fwd", "fused_xent_fwd",
             "ray_tpu/ops/fused_xent.py:138", xent["fwd"], fused["launches"],
             "fused_xent.cu"),
            ("fused_xent_dx", "xent_dx",
             "ray_tpu/ops/fused_xent.py:187", xent["dx"], fused["launches"],
             "fused_xent.cu"),
            ("fused_xent_de", "xent_de",
             "ray_tpu/ops/fused_xent.py:206", xent["de"], fused["launches"],
             "fused_xent.cu"),
            ("decode", "decode_attention",
             "ray_tpu/ops/decode_attention.py:110", unpaged["kernel"],
             unpaged["launches"], "paged_attention.cu"),
            ("paged_decode_int8", "paged_decode_int8",
             "ray_tpu/ops/decode_attention.py:282",
             int8["kernels"]["paged_decode_int8"],
             int8["engines"]["kv+w"]["launches"], "paged_attention.cu"),
            ("paged_prefill_int8", "paged_mq_tc_int8",
             "ray_tpu/ops/decode_attention.py:424",
             int8["kernels"]["paged_prefill_int8"],
             int8["engines"]["kv+w"]["launches"], "paged_attention.cu"),
            ("paged_verify", "paged_verify_attention",
             "ray_tpu/ops/decode_attention.py:424", spec["kernels"], verify,
             "paged_attention.cu")):
        rows.append({"name": key, "route": "cuda",
                     "source": f"ray_tpu_torch/ops/csrc/{src}",
                     "replaces": replaces, "launches": launches[wrapper],
                     "max_abs_err": max(c["max_abs_err"]
                                        for c in rec["cases"]),
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
        if key in ("fused_xent_dx", "fused_xent_de"):
            # the bf16 backward: this row's product kernel and half of the
            # dlog kernel that both rows share (phase 7)
            rows[-1].update(kernels=[f"{wrapper}_kernel", "xent_dlog_kernel"],
                            dlog_launches=launches["xent_dlog"],
                            launches_by_path={
                                "phase 8 (c)": launches[wrapper],
                                "phase 17 (a)": ckpt_launches[wrapper],
                                **mesh_paths(wrapper, ("tensor=2",))})
        elif key in ("flash_forward", "flash_dq", "flash_dkv"):
            # bf16 at D 64: the tensor-core kernel (phase 5)
            kname = {"flash_forward": "flash_fwd_tc", "flash_dq":
                     "flash_dq_tc", "flash_dkv": "flash_dkv_tc"}[key]
            rows[-1].update(kernels=[f"{kname}_kernel"],
                            kernel_launches={kname: launches[kname]},
                            launches_by_path={
                                "phase 6 (c)": launches[wrapper],
                                "phase 16 (a)": fly_learner[wrapper],
                                "phase 17 (a)": ckpt_launches[wrapper],
                                "phase 17 (c)": moe_launches[wrapper],
                                **mesh_paths(wrapper, ("tensor=2", "data=2",
                                                       "pipe=2"))})
        elif key in ("paged_decode", "decode"):
            # bf16 and f32: the split-K kernel, one launch per call (the
            # two share one body)
            rows[-1].update(kernels=[f"{key}_kernel"], split=rec["split"],
                            ptxas=rec["ptxas"])
            if key == "paged_decode":
                rows[-1]["launches_by_path"] = {
                    "phase 2": launches[wrapper],
                    "phase 14 (a)": pressure_launches[wrapper],
                    "phase 15 (a)": disagg_launches[wrapper],
                    "phase 16 (a)": fly_engine[wrapper]}
            if key == "decode":
                rows[-1]["contexts"] = {
                    k: rec["contexts"][k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")}
        elif key in ("paged_decode_int8", "paged_prefill_int8"):
            # the int8 branch of the TPU kernel (an int8 pool, bf16 q):
            # the kernel's int8 instance, one launch per call, and the
            # bf16-pool kernel's time on the same shapes (phase 1)
            rows[-1].update(
                kernels=["paged_decode_kernel<bf16, int8>"
                         if key == "paged_decode_int8"
                         else "paged_mq_tc_kernel<int8>"],
                bf16_pool_ms=rec["bf16_ms"])
        elif key == "paged_verify":
            # the verify caller at W 5, bf16: the tensor-core kernel, one
            # launch per call, beside the W paged decode calls that W
            # sequential ticks would make
            rows[-1].update(kernels=["paged_mq_tc_kernel"], W=SPEC_K + 1,
                            decode_x5_ms=rec["decode_x5_ms"],
                            launches_by_engine={
                                w: spec["engines"][w]["launches"][
                                    "paged_verify_attention"]
                                for w in ("ngram", "draft")},
                            launches_by_path={
                                "phase 12 (b)": launches[wrapper],
                                "phase 14 (b)": pressure_verify,
                                "phase 15 (b)": disagg_verify})
        elif key == "paged_prefill":
            # bf16: the tensor-core split-K kernel, one launch per call
            rows[-1].update(kernels=["paged_mq_tc_kernel"],
                            kernel_launches={
                                k: launches[k]
                                for k in ("paged_mq_tc", "paged_mq_simt")},
                            split=rec["split"], ptxas=rec["ptxas"],
                            launches_by_path={
                                "phase 2": launches[wrapper],
                                "phase 14 (a)": pressure_launches[wrapper],
                                "phase 15 (a)": disagg_launches[wrapper],
                                "phase 16 (a)": fly_engine[wrapper]},
                            reprefill_launches=pressure["block"][
                                "reprefill_launches"])
        elif key == "fused_xent_fwd":
            # bf16: the tile kernel and the merge, one launch each per call
            rows[-1].update(kernels=["xent_fwd_tc_kernel",
                                     "xent_fwd_merge_kernel"],
                            kernel_launches={
                                k: launches[k]
                                for k in ("xent_fwd_tc", "xent_fwd_merge")},
                            kernel_ms={k: v["ms"]
                                       for k, v in rec["kernels"].items()},
                            launches_by_path={
                                "phase 8 (c)": launches[wrapper],
                                "phase 17 (a)": ckpt_launches[wrapper],
                                **mesh_paths(wrapper, ("tensor=2",))})
    # phase 19's paths on rank 0, each counted from zero around its run:
    # (a)'s engines (bf16 and int8 pools, n-gram), (b)'s unpaged decode,
    # (c)'s flywheel (engine and learner), (d)'s MoE on expert=2; and the
    # attention kernels at the rank's 8 heads on its own pools
    r0 = serve_mesh["ranks"][0]
    mesh19 = {"paged_decode": ("paged_decode_attention",
                               ("bf16", "ngram", "flywheel")),
              "paged_prefill": ("paged_prefill_attention",
                                ("bf16", "ngram", "flywheel")),
              "paged_verify": ("paged_verify_attention", ("ngram",)),
              "paged_decode_int8": ("paged_decode_int8", ("int8_pool",)),
              "paged_prefill_int8": ("paged_mq_tc_int8", ("int8_pool",)),
              "decode": ("decode_attention", ("unpaged",)),
              "flash_forward": ("flash_forward", ("flywheel", "moe")),
              "flash_dq": ("flash_dq", ("flywheel", "moe")),
              "flash_dkv": ("flash_dkv", ("flywheel", "moe"))}
    part = {"bf16": "(a) bf16", "int8_pool": "(a) int8 pool",
            "ngram": "(a) n-gram", "unpaged": "(b)", "flywheel": "(c)",
            "moe": "(d)"}
    for row in rows:
        if row["name"] not in mesh19:
            continue
        wrapper, paths = mesh19[row["name"]]
        row.setdefault("launches_by_path", {}).update({
            f"phase 19 {part[p]} rank 0": r0[p]["launches"].get(wrapper, 0)
            for p in paths})
        h8 = (r0["unpaged"]["kernel"] if row["name"] == "decode"
              else r0["h8"].get(row["name"]))
        if h8 is not None:
            row["mesh_h8"] = {k: h8[k] for k in (
                "heads", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}
    # phase 20's paths on rank 0, each counted from zero around its run:
    # (a) int8 weights and pool, (b) the draft proposer (the target's and
    # the draft's launches), (c) the prefill-role engine, the decode-role
    # engines on the mesh's and on a single card's blobs, (d) seq=2
    p0 = roles_mesh["ranks"][0]
    paths20 = {"(a)": p0["int8"], "(b)": p0["draft"],
               "(c) prefill role": p0["roles"]["prefill"],
               "(c) decode role": p0["roles"]["decode"],
               "(c) single-card blobs": p0["roles"]["single_to_mesh"],
               "(d) seq=2": p0["seq"]}
    mesh20 = {"paged_decode": "paged_decode_attention",
              "paged_prefill": "paged_prefill_attention",
              "paged_verify": "paged_verify_attention",
              "paged_decode_int8": "paged_decode_int8",
              "paged_prefill_int8": "paged_mq_tc_int8"}
    for row in rows:
        wrapper = mesh20.get(row["name"])
        if wrapper is None:
            continue
        got = {f"phase 20 {k} rank 0": v["launches"].get(wrapper, 0)
               for k, v in paths20.items() if v["launches"].get(wrapper)}
        if not got:
            fail(f"{wrapper} was not launched on phase 20's paths")
        row.setdefault("launches_by_path", {}).update(got)
    # phase 21's paths on rank 0, each counted from zero around its run:
    # (a) MoE over pipe=2 (flash; over seq=2 the ring, plain in both
    # packages), (c) the GPipe trainer on pipe=2 x tensor=2 (flash at 16
    # heads), (d) the checkpointed steps on tensor=2 (flash at 8 heads,
    # the fused-xent kernels on the vocabulary shard)
    r21 = train_rest["ranks"][0]
    paths21 = {"(a) MoE pipe=2": r21["moe"]["pipe=2"]["launches"],
               "(c) pipe=2 x tensor=2":
                   train_rest["pipe_ranks"][0]["launches"],
               "(d) tensor=2": r21["ckpt"]["launches"]}
    mesh21 = {"flash_forward": ("flash_forward", paths21),
              "flash_dq": ("flash_dq", paths21),
              "flash_dkv": ("flash_dkv", paths21),
              "fused_xent_fwd": ("fused_xent_fwd", ("(d) tensor=2",)),
              "fused_xent_dx": ("xent_dx", ("(d) tensor=2",)),
              "fused_xent_de": ("xent_de", ("(d) tensor=2",))}
    for row in rows:
        if row["name"] not in mesh21:
            continue
        wrapper, paths = mesh21[row["name"]]
        got = {f"phase 21 {p} rank 0": paths21[p].get(wrapper, 0)
               for p in paths}
        if min(got.values()) <= 0:
            fail(f"{wrapper} was not launched on one of phase 21's paths "
                 f"{got}")
        row.setdefault("launches_by_path", {}).update(got)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
