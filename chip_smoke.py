#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments

Builds the port's CUDA kernels from ``ray_tpu_torch/ops/csrc/`` with nvcc
(sm_90a) and drives the serving path end to end:

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
   kernel name and the device's busy share of the wall time.

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


def check(name, got, ref, dtype_name, what) -> float:
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - ref.float()).abs()
    over = (diff - atol - rtol * ref.float().abs()).max().item()
    err = diff.max().item()
    print(f"  {what}: max|kernel-plain| = {err:.3e} "
          f"(limit {atol} + {rtol:.4g}*|plain|)")
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
    from ray_tpu_torch.ops import decode_attention as da
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
    da.reset_kernel_launches()
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
    launches = da.kernel_launches()
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
    lib, ptxas = _build.build()
    build_s = time.perf_counter() - t0
    print(f"built {os.path.relpath(lib)} in {build_s:.1f} s")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", ptxas))
    if regs:
        print(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes spilled")
    _build.load()

    print("phase 1: kernels vs plain")
    kern = phase_kernels(dev)
    result = {"card": smi, "torch": torch.__version__,
              "torch_cuda": torch.version.cuda, "nvcc": nvcc,
              "build_s": build_s, "kernels": kern}
    cfg_kwargs = dict(vocab_size=50304, d_model=1024, n_layers=12,
                      n_heads=16, d_ff=4096, max_seq_len=1024,
                      dtype="bfloat16")
    print("phase 2: engine at full width")
    replica, reqs, outs, eng = phase_engine(dev, cfg_kwargs, seed=0)
    launches = eng["launches"]
    print("phase 3: teacher-forced logprobs vs dense f32 forward")
    tf = phase_teacher_forced(dev, cfg_kwargs, 0, reqs, outs)
    print("phase 4: engine under torch.profiler")
    prof = phase_profile(replica, cfg_kwargs["vocab_size"])
    result.update(engine=eng, teacher_forced=tf, profile=prof)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    src = "ray_tpu_torch/ops/csrc/paged_attention.cu"
    rows = []
    for key, wrapper, replaces in (
            ("paged_decode", "paged_decode_attention",
             "ray_tpu/ops/decode_attention.py:282"),
            ("paged_prefill", "paged_prefill_attention",
             "ray_tpu/ops/decode_attention.py:424")):
        k = kern[key]
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[wrapper],
                     "max_abs_err": max(c["max_abs_err"]
                                        for c in k["cases"]),
                     "ms": k["ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
