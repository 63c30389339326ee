#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments

Builds the port's CUDA kernels from ``ray_tpu_torch/ops/csrc/`` with nvcc
(sm_90a, one nvcc per source, all at once) and drives its two paths,
serving and training, end to end:

1. kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the same inputs at the serving shapes (H=16, D=64,
   block 16, 513 pool blocks, 64-entry tables), in bf16 and f32, with
   its device time per call, the plain version's, one PyTorch library
   call's (``scaled_dot_product_attention`` over K/V gathered
   beforehand, the gather not timed) and the least time the card could
   take (the bound);
2. the engine: `InferenceReplica` at the width of the model
   ``bench_infer.py`` serves (vocab 50304, d_model 1024, 12 layers, 16
   heads, d_ff 4096, bf16, random weights from a seed) answers 17
   requests (a shared 64-token prefix, a repeated prompt that forces a
   copy-on-write, a 300-token prompt prefilled in several chunks, one
   sampled request), with every kernel's launch counter read around it;
3. teacher-forced check: a dense float32 forward with plain attention
   over two greedy requests' prompt + output must reproduce the
   engine's per-token logprobs;
4. profile: a short engine run under ``torch.profiler``, device time by
   kernel name and the device's busy share of the wall time;
5. flash kernels vs plain: forward (out, lse), dQ and dK/dV against
   their plain versions at the training shape (B 8, T 1024, H 16, D 64)
   in bf16 and f32, causal and full, and at a ragged T of 1000; device
   time, bound, plain time and the library time
   (``scaled_dot_product_attention`` forward, and its backward through
   autograd for the two backward kernels);
6. training at the width of ``bench.py``'s GPT (the model above, bf16
   activations over f32 masters, flash attention, bf16 logits, remat
   "dots", dense loss, batch 8 x 1024): (a) loss and every gradient
   leaf with flash attention against plain attention from the same
   masters; (b) the step-0 loss near ln(vocab) + sigma^2/2, the
   expected loss of the init's logits; (c) `make_gpt_trainer`
   + `DevicePrefetcher` + `TrainLoop` on fresh host batches: tok/s, MFU,
   the loop's breakdown, host syncs, flash launch counts, and the
   device busy share from a short profiled window; (d) 25 steps on one
   repeated batch (5 of them warm-up) must lower the loss by at least
   1 nat.

Any failed phase raises, so the exit code is non-zero. The last two
lines of stdout are a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
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
TIME_SETS = 8
LOGPROB_TOL = 0.1


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


def bound(bytes_moved: float, ops: float, dtype) -> tuple[float, str]:
    import torch
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name, got, ref, dtype_name, what, tol=None, extra=None) -> float:
    atol, rtol = (tol or TOL)[dtype_name]
    diff = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if extra is not None:
        limit = limit + extra
    over = (diff - limit).max().item()
    err = diff.max().item()
    print(f"  {what}: max|kernel-plain| = {err:.3e} "
          f"(limit {atol} + {rtol:.4g}*|plain|"
          f"{' + 2^-8*P|V|' if extra is not None else ''})")
    if not over <= 0:
        fail(f"{name} kernel disagrees with plain ({what})")
    return err


def phase_kernels(dev) -> dict:
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
            err = check("paged prefill",
                        da.paged_prefill_attention(q, kp, vp, table, start),
                        da.reference_paged_prefill_attention(q, kp, vp,
                                                             table, start),
                        name,
                        f"paged_prefill {name:8s} C={c:2d} start={start:3d}")
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
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{r['shape']}]")
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
    # Warm-up (cuBLAS handles, allocator) outside the measured run.
    rng = np.random.default_rng(1)
    for g in [replica(rng.integers(0, cfg_kwargs["vocab_size"], 128),
                      max_new_tokens=8) for _ in range(2)]:
        list(g)
    eng.reset_stats()

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
    eng.check_invariants()
    for i, o in enumerate(outs):
        if len(o) != new_tokens:
            fail(f"request {i} finished with {len(o)} tokens, "
                 f"wanted {new_tokens}")
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the main path")
    if st["prefix_hit_tokens"] <= 0 or st["cow_copies"] <= 0:
        fail(f"prefix sharing / copy-on-write did not run: "
             f"hit {st['prefix_hit_tokens']} cow {st['cow_copies']}")
    if st["blocks_in_use"] != st["cached_prefix_blocks"]:
        fail("blocks leaked after every request finished")
    if syncs != st["decode_steps"] + st["prefill_chunks"]:
        fail(f"{syncs} host syncs for {st['decode_steps']} decode ticks "
             f"and {st['prefill_chunks']} prefill chunks (want one each)")
    print(f"  {len(reqs)} requests, {st['decode_tokens']} decode tokens in "
          f"{wall:.2f} s wall; prefill {st['prefill_tok_s']:.1f} tok/s, "
          f"decode {st['decode_tok_s']:.1f} tok/s, decode step "
          f"p50 {st['p50_token_latency_ms']:.3f} ms "
          f"p99 {st['p99_token_latency_ms']:.3f} ms; launches {launches}; "
          f"{syncs} host syncs")
    keep = ("prefill_tokens", "decode_tokens", "prefill_chunks",
            "decode_steps", "prefill_time_s", "decode_time_s",
            "prefill_tok_s", "decode_tok_s", "p50_token_latency_ms",
            "p99_token_latency_ms", "ttft_ms_p50", "ttft_ms_p99",
            "prefix_hit_tokens", "cow_copies", "slot_occupancy")
    summary = {k: st[k] for k in keep}
    summary.update(requests=len(reqs), wall_s=wall, launches=launches,
                   host_syncs=syncs)
    return replica, reqs, outs, summary


def phase_teacher_forced(dev, cfg_kwargs, seed, reqs, outs) -> dict:
    """Engine logprobs (bf16, paged, kernels) vs a dense f32 forward with
    plain attention over prompt + emitted tokens, for two greedy
    requests. Where the f32 reference's top-2 margin exceeds twice the
    tolerance, the engine's greedy token must be its argmax."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import gpt

    cfg = gpt.small(**{**cfg_kwargs, "dtype": "float32", "attn_impl": "xla"})
    ref = gpt.GPT(cfg, gpt.init_params(seed, cfg, dev))
    worst, checked, decisive = 0.0, 0, 0
    for i in (0, len(reqs) - 1):
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


def phase_profile(replica, vocab: int, seed: int = 2) -> dict:
    """Where the engine's time goes: 8 requests of 128 prompt + 32 new
    tokens under `torch.profiler`, device time summed by kernel name, and
    the device busy share (summed kernel time over wall time; one stream,
    so kernels do not overlap)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = replica.engine
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, 128) for _ in range(8)]
    eng.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=32)
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_us = sum(t for _, t, _ in kernels)
    st = eng.stats()
    out = {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
           "device_busy_share": busy_us * 1e-6 / wall,
           "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"],
           "top_kernels": [{"name": k[:80], "device_ms": t * 1e-3,
                            "calls": n} for k, t, n in kernels[:12]]}
    print(f"  wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us * 1e-3:.1f} ms ({out['device_busy_share']:.1%}); "
          f"{st['decode_steps']} decode ticks, {st['prefill_chunks']} "
          f"prefill chunks")
    for k in out["top_kernels"]:
        print(f"    {k['device_ms']:9.3f} ms  {k['calls']:6d}  {k['name']}")
    return out


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


def phase_flash(dev) -> dict:
    """Phase 5: the three flash kernels against their plain versions at
    the training shape, then their times beside bound, plain and SDPA."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(5)
    rec = {k: {"cases": []} for k in ("fwd", "dq", "dkv")}
    for t, causal, dt in ((FT, True, torch.bfloat16),
                          (FT, False, torch.bfloat16),
                          (FT, True, torch.float32),
                          (FT, False, torch.float32),
                          (FLASH_RAGGED_T, True, torch.bfloat16),
                          (FLASH_RAGGED_T, False, torch.float32)):
        name = str(dt).split(".")[-1]
        q, k, v, do = (torch.randn((FB, t, FH, FD), generator=g,
                                   device=dev).to(dt) for _ in range(4))
        what = f"{name:8s} T={t} causal={causal!s:5s}"
        out, lse = fa.flash_forward(q, k, v, causal=causal)
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v,
                                                      causal=causal)
        extra = None
        if dt == torch.bfloat16:
            extra = 2 ** -8 * fa.flash_forward_reference(
                q.float(), k.float(), v.float().abs(), causal=causal)[0]
        errs = [check("flash forward", out, ref_out, name,
                      f"flash fwd out {what}", FLASH_TOL, extra),
                check("flash forward", lse, ref_lse, "float32",
                      f"flash fwd lse {what}", FLASH_TOL)]
        rec["fwd"]["cases"].append({"dtype": name, "T": t, "causal": causal,
                                    "max_abs_err": max(errs)})
        del extra
        delta = fa.attention_delta(ref_out, do)
        dq = fa.flash_dq(q, k, v, do, ref_lse, delta, causal=causal)
        dk, dv = fa.flash_dkv(q, k, v, do, ref_lse, delta, causal=causal)
        rdq, rdk, rdv = fa.flash_backward_reference(q, k, v, do, ref_lse,
                                                    delta, causal=causal)
        e = check("flash dq", dq, rdq, name, f"flash dq      {what}",
                  FLASH_TOL)
        rec["dq"]["cases"].append({"dtype": name, "T": t, "causal": causal,
                                   "max_abs_err": e})
        e = max(check("flash dkv", dk, rdk, name, f"flash dk      {what}",
                      FLASH_TOL),
                check("flash dkv", dv, rdv, name, f"flash dv      {what}",
                      FLASH_TOL))
        rec["dkv"]["cases"].append({"dtype": name, "T": t, "causal": causal,
                                    "max_abs_err": e})
        del q, k, v, do, out, lse, ref_out, ref_lse, delta, dq, dk, dv
        del rdq, rdk, rdv
        torch.cuda.empty_cache()

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


def phase_train(dev) -> dict:
    """Phase 6: training at full width (see the module docstring)."""
    import dataclasses
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    leaves = [(n, p) for n, p in model.named_parameters()]
    b0 = place(next(_host_batches(cfg, batch, seed=1)))
    res = {}
    for impl in ("flash", "xla"):
        loss = spmd.gpt_loss_fn(model, b0,
                                dataclasses.replace(cfg, attn_impl=impl))
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        res[impl] = (loss.item(), grads)
    dloss = abs(res["flash"][0] - res["xla"][0])
    rel = {n: ((gf.float() - gx.float()).norm()
               / gx.float().norm().clamp_min(1e-30)).item()
           for (n, _), gf, gx in zip(leaves, res["flash"][1], res["xla"][1])}
    worst = max(rel, key=rel.get)
    print(f"  (a) loss flash {res['flash'][0]:.6f} vs plain "
          f"{res['xla'][0]:.6f}: |diff| {dloss:.2e} (limit "
          f"{TRAIN_LOSS_TOL}); worst leaf gradient rel. error "
          f"{rel[worst]:.2e} ({worst}, limit {TRAIN_GRAD_REL_TOL})")
    if not dloss <= TRAIN_LOSS_TOL:
        fail(f"flash vs plain-attention loss differ by {dloss}")
    if not rel[worst] <= TRAIN_GRAD_REL_TOL:
        fail(f"flash vs plain-attention gradient of {worst} off by "
             f"{rel[worst]}")
    ln_v = math.log(cfg.vocab_size)
    want0 = ln_v + cfg.d_model * 0.02 ** 2 / 2
    print(f"  (b) step-0 loss {res['flash'][0]:.4f}: ln(vocab) {ln_v:.4f}, "
          f"+ sigma^2/2 of the init's logits = {want0:.4f} (limit "
          f"{STEP0_LOSS_TOL})")
    if not abs(res["flash"][0] - want0) <= STEP0_LOSS_TOL:
        fail(f"step-0 loss {res['flash'][0]} is not near {want0}")
    out.update(loss_flash=res["flash"][0], loss_plain=res["xla"][0],
               loss_abs_diff=dloss, grad_rel_err=rel,
               grad_rel_err_max=rel[worst], step0_loss=res["flash"][0],
               step0_expected=want0, ln_vocab=ln_v)
    del res, grads, loss
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
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the training path")
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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train.run(state, batches, num_steps=unroll)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_us = sum(t for _, t, _ in kernels)
    flash_us = sum(t for n, t, _ in kernels if "flash_" in n)
    print(f"      profiled {unroll} steps: wall {pwall * 1e3:.1f} ms, device"
          f" busy {busy_us * 1e-3:.1f} ms ({busy_us * 1e-6 / pwall:.1%}); "
          f"flash kernels {flash_us * 1e-3:.1f} ms "
          f"({flash_us / max(busy_us, 1e-9):.1%} of device time)")
    for n, t, c in kernels[:12]:
        print(f"    {t * 1e-3:9.3f} ms  {c:6d}  {n[:80]}")
    out["profile"] = {
        "wall_s": pwall, "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / pwall,
        "flash_share_of_device": flash_us / max(busy_us, 1e-9),
        "top_kernels": [{"name": n[:80], "device_ms": t * 1e-3, "calls": c}
                        for n, t, c in kernels[:16]]}
    del state, step_fn, model, batches, train, prof, leaves, b0
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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
    _build.load()

    result = {"card": smi, "torch": torch.__version__,
              "torch_cuda": torch.version.cuda, "nvcc": nvcc,
              "build_s": build_s, "phase_s": {}}
    cfg_kwargs = dict(vocab_size=50304, d_model=1024, n_layers=12,
                      n_heads=16, d_ff=4096, max_seq_len=1024,
                      dtype="bfloat16")

    def phase(n, title, fn, *args):
        print(f"phase {n}: {title}")
        t0 = time.perf_counter()
        got = fn(*args)
        result["phase_s"][n] = time.perf_counter() - t0
        print(f"  phase {n} took {result['phase_s'][n]:.1f} s")
        return got

    kern = phase(1, "paged kernels vs plain", phase_kernels, dev)
    replica, reqs, outs, eng = phase(2, "engine at full width",
                                     phase_engine, dev, cfg_kwargs, 0)
    tf = phase(3, "teacher-forced logprobs vs dense f32 forward",
               phase_teacher_forced, dev, cfg_kwargs, 0, reqs, outs)
    prof = phase(4, "engine under torch.profiler", phase_profile, replica,
                 cfg_kwargs["vocab_size"])
    del replica
    torch.cuda.empty_cache()
    flash = phase(5, "flash kernels vs plain", phase_flash, dev)
    train = phase(6, "training at full width", phase_train, dev)
    result.update(kernels=kern, engine=eng, teacher_forced=tf, profile=prof,
                  flash=flash, train=train)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    rows = []
    # launches: each kernel's count over its own path's main run (phase 2
    # for serving, phase 6 (c) for training), counters zeroed just before
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
             flash["dkv"], train["launches"], "flash_attention.cu")):
        rows.append({"name": key, "route": "cuda",
                     "source": f"ray_tpu_torch/ops/csrc/{src}",
                     "replaces": replaces, "launches": launches[wrapper],
                     "max_abs_err": max(c["max_abs_err"]
                                        for c in rec["cases"]),
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
