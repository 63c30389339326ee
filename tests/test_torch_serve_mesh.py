"""Serving on a device mesh: the port's `InferenceEngine(mesh=)` and the
unpaged KV-cache path on a mesh (one process per rank) against the JAX
package's on the same mesh (one process over the 8-device CPU mesh of
`tests/conftest.py`), with `gpt.small(dtype="float32")` params carried
across by the mesh-aware `params_from_numpy` (peaked: embed x 8, as
`tests/test_torch_engine.py`, so near-ties cannot flip a greedy argmax).

The JAX side runs in the parent, its engines in threads, while one 4-rank
gloo world for the module (`test_torch_parallel.World`) runs the port's;
every rank returns what it served. The mesh is ``data=2 x tensor=2``:
each rank holds 2 of the 4 heads, and the data ranks repeat the step.

- engine traffic (chunked prefill, a shared prefix ending mid-block with
  its copy-on-write copy, an int8 pool, n-gram speculation, a small pool
  that forces a preemption, `update_params` mid-stream): greedy tokens
  identical on every rank, logprobs within 1e-4, ``params_version`` tags
  equal; the same trace counters as the JAX engine, and ``captured``
  false on a mesh;
- the serving specs (`kv_pool_specs` with and without ``quantized``,
  `kv_cache_specs`, `engine_io_shardings`' names) equal the JAX ones, and
  each rank allocates its heads' slice;
- `init_kv_cache(mesh=)` + `prefill` + `decode_step` equal the JAX
  unpaged path (logits within 1e-4, the same greedy tokens);
- a mesh of one rank is ``mesh=None``, bit for bit;
- a rank given a diverging input, or a request submitted on one rank
  alone, makes every rank raise `MeshDivergenceError` naming the field,
  and nothing hangs;
- what a mesh once refused constructs (int8 weights, a quantized `GPT`,
  the draft proposer, the prefill role, an import, the ``seq`` axis;
  their numbers are `tests/test_torch_serve_mesh_roles.py`'s and
  `tests/test_torch_mesh_axes.py`'s), and what stays refused (MoE and
  ViT over ``seq`` or ``pipe``) names ROADMAP A6 (c).

This module imports no JAX at its top: the spawned ranks import it to
find their entry point.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import World, block  # noqa: E402

MESH = dict(data=2, tensor=2)
ENGINE = dict(slots=2, max_len=48, prefill_buckets=(8, 16), block_size=8,
              prefill_chunk=8)
NEW = 6
# engine kwargs by case (on top of ENGINE)
CASES = {
    "chunked_cow": {},
    "int8_pool": {"kv_dtype": "int8"},
    "ngram": {"spec": "ngram", "spec_k": 3},
    "preempt": {"slots": 3, "cache_blocks": 7, "priority_classes": 2,
                "priority_aging_s": 1e6},
    "swap": {},
}
UNPAGED_B, UNPAGED_T, UNPAGED_STEPS = 4, 12, 4


def _cfg_kw(case: str) -> dict:
    return {"kv_dtype": "int8"} if case == "int8_pool" else {}


def _engine_kw(case: str) -> dict:
    return {k: v for k, v in {**ENGINE, **CASES[case]}.items()
            if k != "kv_dtype"}


def _traffic(case: str):
    """``[(prompt, priority)]``: five requests for two slots, B sharing
    A's first 12 tokens (a match ending mid-block), B and C longer than
    the 8-token chunk; n-gram traffic repeats a motif so the lookup
    proposes; the preemption case sends two class-0 requests, then a
    class-1 one the 7-block pool cannot hold beside them (a third slot is
    free, so the class-1 request preempts instead of waiting)."""
    rng = np.random.default_rng(1)
    if case == "ngram":
        motif = rng.integers(0, 512, 4)
        return [(np.concatenate([np.tile(motif, 3), rng.integers(0, 512, 2)]),
                 0) for _ in range(3)]
    if case == "preempt":
        return [(rng.integers(0, 512, 14), 0), (rng.integers(0, 512, 14), 0),
                (rng.integers(0, 512, 10), 1)]
    prefix = rng.integers(0, 512, 12)
    return [(np.concatenate([prefix, rng.integers(0, 512, 4)]), 0),
            (np.concatenate([prefix, rng.integers(0, 512, 6)]), 0),
            (rng.integers(0, 512, 20), 0), (rng.integers(0, 512, 5), 0),
            (rng.integers(0, 512, 9), 0)]


def _peaked(tree, scale=8.0):
    return {**tree, "embed": tree["embed"] * scale}


def _drive(eng, case, swap_tree=None):
    """Submit the case's traffic and drain it; the swap case publishes
    ``swap_tree`` after three ticks. Returns each request's events as
    (token, logprob, params_version) and the engine's stats."""
    rids = []
    for i, (p, pri) in enumerate(_traffic(case)):
        rids.append(eng.submit(p, max_new_tokens=NEW, priority=pri))
        if case == "preempt" and i == 1:
            for _ in range(4):
                eng.step()
    if case == "swap":
        for _ in range(3):
            eng.step()
        eng.update_params(swap_tree)
    eng.run_until_idle()
    outs = [[(int(t), float(t.logprob), int(t.params_version))
             for t in eng.tokens_for(r)] for r in rids]
    eng.check_invariants()
    return outs, eng.stats()


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _serve_jobs(rank, payload):
    import torch

    from ray_tpu_torch.exceptions import MeshDivergenceError
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec, sharding, single_device_mesh
    from ray_tpu_torch.serve import InferenceEngine
    tree, swap_tree, unpaged = payload
    out = {}
    mesh = MeshSpec(**MESH).build()
    out["coords"] = (mesh.shape, mesh.coords)

    def engine(case, mesh=mesh, **kw):
        cfg = gpt.small(dtype="float32", **_cfg_kw(case))
        model = gpt.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
        return InferenceEngine(model, cfg, device="cpu", mesh=mesh,
                               **{**_engine_kw(case), **kw})

    for case in CASES:
        eng = engine(case)
        outs, st = _drive(eng, case, swap_tree)
        out[("engine", case)] = (outs, {k: st[k] for k in (
            "decode_traces", "prefill_traces", "verify_traces", "captured",
            "mesh", "cow_copies", "preemptions", "prefix_hit_tokens",
            "params_version")}, {k: tuple(v.shape)
                                 for k, v in eng.cache.items()})

    out["specs"] = {
        "pool": {k: tuple(v) for k, v in sharding.kv_pool_specs(mesh).items()},
        "pool_q": {k: tuple(v) for k, v in sharding.kv_pool_specs(
            mesh, quantized=True).items()},
        "cache": {k: tuple(v) for k, v in
                  sharding.kv_cache_specs(mesh).items()},
        "io": sorted(sharding.engine_io_shardings(mesh)),
        "io_specs": {tuple(v) for v in
                     sharding.engine_io_shardings(mesh).values()}}

    # the unpaged cache: prefill, then greedy decode steps
    cfg = gpt.small(dtype="float32")
    model = gpt.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    toks, lengths = unpaged
    cache = gpt.init_kv_cache(cfg, UNPAGED_B, 32, "cpu", mesh=mesh)
    logits, cache = gpt.prefill(model, torch.from_numpy(toks), cache,
                                lengths=torch.from_numpy(lengths))
    steps = [logits.numpy()]
    pos = torch.from_numpy(lengths).int()
    for _ in range(UNPAGED_STEPS):
        nxt = torch.argmax(logits, dim=-1)
        logits, cache = gpt.decode_step(model, nxt, cache, pos)
        pos = pos + 1
        steps.append(logits.numpy())
    slot_logits, cache = gpt.prefill(model, torch.from_numpy(toks[1:2]),
                                     cache, slot=3)
    steps.append(slot_logits.numpy())
    out["unpaged"] = (steps, tuple(cache["k"].shape),
                      cache["k"][:, :, :UNPAGED_T].numpy())

    # a rank given a diverging input: every rank raises at the same
    # collective
    eng = engine("chunked_cow")
    p = _traffic("chunked_cow")[0][0]
    eng.submit((p + (1 if rank == 1 else 0)) % 512, max_new_tokens=2)
    try:
        eng.run_until_idle()
        out["diverge"] = None
    except MeshDivergenceError as e:
        out["diverge"] = str(e)
    # a step's inputs diverging (a slot's temperature) past an agreed
    # tick
    eng = engine("chunked_cow")
    eng.submit(p, max_new_tokens=4)
    eng.step()
    if rank == 2:
        next(s for s in eng._slots if s.active).temperature = 0.5
    try:
        eng.run_until_idle()
        out["diverge_step"] = None
    except MeshDivergenceError as e:
        out["diverge_step"] = str(e)
    # a request submitted on one rank alone: the others find nothing to
    # run and meet it at their idle header
    eng = engine("chunked_cow")
    if rank == 3:
        eng.submit(p, max_new_tokens=2)
    try:
        eng.run_until_idle()
        out["diverge_idle"] = None
    except MeshDivergenceError as e:
        out["diverge_idle"] = str(e)

    # what a mesh once refused constructs; what stays refused on a mesh
    # (ROADMAP A6 (c))
    from ray_tpu_torch.models import moe, vit
    errs = []
    seq_mesh = MeshSpec(data=2, seq=2).build()
    pipe_mesh = MeshSpec(data=2, pipe=2).build()
    cfg_w8 = gpt.small(dtype="float32", weight_dtype="int8")
    pre = engine("chunked_cow", role="prefill")
    blob = pre.handoff_for(pre.submit(p, max_new_tokens=2))
    for fn in (lambda: InferenceEngine(
                   gpt.params_from_numpy(tree, cfg_w8, "cpu"), cfg_w8,
                   device="cpu", mesh=mesh, **ENGINE),
               lambda: gpt.GPT(cfg, _quantized_tree(gpt, tree, cfg),
                               device="cpu", mesh=mesh),
               lambda: engine("chunked_cow", spec="draft",
                              draft_params=gpt.params_from_numpy(
                                  tree, cfg, "cpu"), draft_cfg=cfg),
               lambda: engine("chunked_cow", role="prefill"),
               lambda: engine("chunked_cow").import_handoff(blob),
               lambda: InferenceEngine(gpt.params_from_numpy(
                   tree, cfg, "cpu"), cfg, device="cpu", mesh=seq_mesh,
                   **ENGINE),
               lambda: moe.MoE(moe.small(), moe.init_params(
                   0, moe.small(), "cpu"), device="cpu", mesh=seq_mesh),
               lambda: vit.ViT(vit.small(), vit.init_params(
                   0, vit.small(), "cpu"), device="cpu", mesh=pipe_mesh)):
        try:
            fn()
            errs.append(None)
        except NotImplementedError as e:
            errs.append(str(e))
    out["refusals"] = errs

    # a mesh of one rank is the single-card engine, bit for bit
    if rank == 0:
        runs = []
        for m in (None, single_device_mesh()):
            cfg = gpt.small(dtype="float32")
            eng = InferenceEngine(gpt.params_from_numpy(tree, cfg, "cpu"),
                                  cfg, device="cpu", mesh=m, **ENGINE)
            runs.append(_drive(eng, "chunked_cow")[0])
        out["one"] = runs
    return out


def _quantized_tree(gpt, tree, cfg):
    """The reference-format tree of the int8-weight model of ``tree``."""
    q = gpt.quantize_params(gpt.params_from_numpy(tree, cfg, "cpu"))
    return gpt.param_tree(q)


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The ranks start first; the JAX engines run meanwhile, each in a
    thread. Returns (the JAX side, the ranks' results)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import MeshSpec, tree_shardings
    from ray_tpu.parallel import sharding as jsh
    from ray_tpu.serve.engine import InferenceEngine as JaxEngine

    cfg0 = jgpt.small(dtype="float32")
    # one compilation, not one per leaf
    init = jax.jit(jgpt.init_params, static_argnums=1)
    tree, swap_tree = (_peaked(jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(seed), cfg0))) for seed in (0, 1))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (UNPAGED_B, UNPAGED_T)).astype(np.int32)
    lengths = np.array([12, 7, 9, 3], np.int32)
    world = World(__name__, "_serve_jobs", (tree, swap_tree,
                                            (toks, lengths)))

    mesh = MeshSpec(**MESH).build(jax.devices()[:4])
    axes = jgpt.param_logical_axes(cfg0)

    def placed(t):
        return jax.device_put(t, tree_shardings(mesh, axes))

    def serve(case):
        cfg = jgpt.small(dtype="float32", **_cfg_kw(case))
        eng = JaxEngine(placed(tree), cfg, mesh=mesh, **_engine_kw(case))
        outs, st = _drive(eng, case, placed(swap_tree))
        return outs, st

    with ThreadPoolExecutor(len(CASES)) as pool:
        served = dict(zip(CASES, pool.map(serve, CASES)))

    params = placed(tree)
    cache = jgpt.init_kv_cache(cfg0, UNPAGED_B, 32, mesh=mesh)
    prefill = jax.jit(lambda p, t, c, **kw: jgpt.prefill(p, t, c, cfg0, mesh,
                                                         **kw))
    decode = jax.jit(lambda p, t, c, pos: jgpt.decode_step(p, t, c, pos,
                                                           cfg0, mesh))
    logits, cache = prefill(params, jnp.asarray(toks), cache,
                            lengths=jnp.asarray(lengths))
    steps = [np.asarray(logits)]
    pos = jnp.asarray(lengths)
    for _ in range(UNPAGED_STEPS):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = decode(params, nxt, cache, pos)
        pos = pos + 1
        steps.append(np.asarray(logits))
    slot_logits, cache = prefill(params, jnp.asarray(toks[1:2]), cache,
                                 slot=3)
    steps.append(np.asarray(slot_logits))

    specs = {
        "pool": {k: tuple(v) for k, v in jsh.kv_pool_specs(mesh).items()},
        "pool_q": {k: tuple(v) for k, v in jsh.kv_pool_specs(
            mesh, quantized=True).items()},
        "cache": {k: tuple(v) for k, v in jsh.kv_cache_specs(mesh).items()},
        "io": sorted(jsh.engine_io_shardings(mesh)),
        "io_specs": {tuple(v.spec) for v in
                     jsh.engine_io_shardings(mesh).values()}}
    jax_side = dict(served=served, unpaged=(steps, np.asarray(cache["k"])),
                    specs=specs)
    return jax_side, world.results()


@pytest.fixture(scope="module")
def jax_side(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world(runs):
    return runs[1]


@pytest.mark.parametrize("case", list(CASES))
def test_engine_on_a_mesh_matches_jax(world, jax_side, case):
    want, jst = jax_side["served"][case]
    assert sum(len(o) for o in want) > 0
    for res in world:
        got, st, _ = res[("engine", case)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert [t for t, _, _ in g] == [t for t, _, _ in w]
            assert [v for _, _, v in g] == [v for _, _, v in w]
            np.testing.assert_allclose([lp for _, lp, _ in g],
                                       [lp for _, lp, _ in w], atol=1e-4,
                                       rtol=0)
        for key in ("decode_traces", "prefill_traces", "verify_traces",
                    "cow_copies", "preemptions", "prefix_hit_tokens",
                    "params_version"):
            assert st[key] == jst[key], (case, key)
        assert st["captured"] is False
        assert st["mesh"]["data"] == 2 and st["mesh"]["tensor"] == 2
    # what each case is there for happened
    st = world[0][("engine", case)][1]
    if case == "chunked_cow":
        assert st["cow_copies"] > 0 and st["prefix_hit_tokens"] > 0
    if case == "preempt":
        assert st["preemptions"] > 0
    if case == "swap":
        assert st["params_version"] == 1


def test_each_rank_allocates_its_heads(world):
    """A pool of ``[L, n_blocks + sink, ...]`` rows seen as blocks: 2 of
    the 4 heads a rank, every block; an int8 pool's scales follow their
    heads."""
    for res in world:
        shapes = res[("engine", "int8_pool")][2]
        assert shapes["k"][3:] == (2, 32) and shapes["k_scale"][3:] == (2,)
        assert shapes["k"][1] == shapes["k_scale"][1]
        assert res[("engine", "chunked_cow")][2]["v"][3:] == (2, 32)


def test_serving_specs_match_jax(world, jax_side):
    want = jax_side["specs"]
    assert want["pool"]["k"][:4] == (None, None, None, "tensor")
    for res in world:
        for key in ("pool", "pool_q", "cache", "io", "io_specs"):
            got = res["specs"][key]
            if isinstance(got, dict):
                got = {k: tuple(v) + (None,) * (len(want[key][k]) - len(v))
                       for k, v in got.items()}
                norm = {k: tuple(v) + (None,) * (len(got[k]) - len(v))
                        for k, v in want[key].items()}
                assert got == norm, key
            else:
                assert got == want[key], key


def test_unpaged_cache_on_a_mesh_matches_jax(world, jax_side):
    """Batch prefill of 4 ragged prompts (each data rank its 2 rows, each
    tensor rank its 2 heads), 4 greedy decode steps, then a slot prefill
    into row 3: the logits every rank returns against JAX's, and each
    rank's cache block against its slice of JAX's cache."""
    want, want_cache = jax_side["unpaged"]
    spec = (None, "data", None, "tensor", None)
    for res in world:
        steps, shape, kblock = res["unpaged"]
        assert len(steps) == len(want)
        for g, w in zip(steps, want):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
        shape_mesh, coords = res["coords"]
        wk = block(want_cache, spec, shape_mesh, coords)
        assert shape == wk.shape
        np.testing.assert_allclose(kblock, wk[:, :, :UNPAGED_T], atol=1e-5,
                                   rtol=0)


def test_mesh_of_one_is_the_single_card_engine(world):
    off, one = world[0]["one"]
    assert off == one


def test_diverging_rank_raises_on_every_rank(world):
    for res in world:
        msg = res["diverge"]
        assert msg is not None and "queue" in msg and "rank 1" in msg, msg
        msg = res["diverge_step"]
        assert msg is not None and "temps" in msg and "rank 2" in msg, msg


def test_a_rank_left_idle_raises_on_every_rank(world):
    for res in world:
        msg = res["diverge_idle"]
        assert msg is not None and "phase" in msg and "queue" in msg \
            and "rank 3" in msg, msg


def test_what_stays_refused_names_a6c(world):
    """int8 weights, a quantized `GPT`, the draft proposer, the prefill
    role, an import and the ``seq`` axis construct on a mesh; MoE over
    ``seq`` and ViT over ``pipe`` still raise, naming A6 (c) and the
    axis."""
    for res in world:
        errs = res["refusals"]
        assert errs[:6] == [None] * 6, errs
        assert all(e is not None and "A6 (c)" in e for e in errs[6:]), errs
        assert "MoE" in errs[6] and "'seq'" in errs[6]
        assert "ViT" in errs[7] and "'pipe'" in errs[7]
