"""Serving and RL on the ``seq``, ``expert`` and ``pipe`` axes: the
port's `InferenceEngine(mesh=)`, the unpaged KV-cache path,
`completion_logprobs` and `FlywheelLoop(mesh=)` on ``tensor=2`` x each of
``seq``, ``expert``, ``pipe`` = 2 (one process per rank) against the
JAX package's on the same meshes (one process over the 8-device CPU mesh
of `tests/conftest.py`), f32 `gpt.small` params carried across by the
mesh-aware `params_from_numpy` (peaked: embed x 8, so near-ties cannot
flip a greedy argmax).

No GPT leaf, cache or pool axis sits on ``seq``, ``expert`` or ``pipe``
(the reference's `kv_cache_logical_axes`, `kv_pool_logical_axes`), so
the serving ranks along them repeat the step; `completion_logprobs` is
the training forward over the ``seq`` split (the seq offset and the
ring), its target log-probabilities gathered over ``seq``.

The JAX side runs in the parent, its pieces in threads, while one 4-rank
gloo world for the module (`test_torch_parallel.World`) runs the
port's. Cases:

- the engine on each mesh (chunked prefill, a shared prefix ending
  mid-block): greedy tokens identical on every rank and to JAX's,
  logprobs within 1e-4, ``params_version`` tags and trace counters
  equal;
- `kv_cache_specs` and `kv_pool_specs` equal JAX's on each mesh;
- `init_kv_cache(mesh=)` + `prefill` + `decode_step` on each mesh: logits
  within 1e-4 of JAX's and the same greedy tokens;
- `completion_logprobs` on ``tensor=2 x seq=2`` within 1e-4 of JAX's,
  and the parameter gradients of a weighted sum, summed over ``seq`` and
  gathered, within 1e-4;
- two greedy `FlywheelLoop(mesh=)` iterations on ``tensor=2 x seq=2``
  against the JAX loop on that mesh (params placed by `tree_shardings`,
  ROADMAP C's oracle caveat): the histories equal and the learner's
  params within a tenth of the learning rate a step;
- a rank whose request differs from its ``seq`` neighbour's makes every
  rank raise `MeshDivergenceError`.

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
from test_torch_serve_mesh import (ENGINE, UNPAGED_B, UNPAGED_STEPS,  # noqa
                                   UNPAGED_T, _drive, _peaked, _traffic)

MESHES = {"seq": dict(data=1, tensor=2, seq=2),
          "expert": dict(data=1, tensor=2, expert=2),
          "pipe": dict(data=1, tensor=2, pipe=2)}
B, T, W = 4, 16, 6
FLY_LR = 1e-2
FLY_ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=8)
TRACES = ("decode_traces", "prefill_traces", "verify_traces",
          "cow_copies", "prefix_hit_tokens", "params_version")


def _lp_batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 512, (B, T)).astype(np.int32),
            np.array([3, 5, 8, 12], np.int32),
            rng.normal(0, 1, (B, W)).astype(np.float32))


def _unpaged_inputs():
    rng = np.random.default_rng(2)
    return (rng.integers(0, 512, (UNPAGED_B, UNPAGED_T)).astype(np.int32),
            np.array([12, 7, 9, 3], np.int32))


def _prompt(r):
    return [1, 2, int(r.integers(3, 9))]


def _reward(prompt, completion):
    """The share of completion tokens divisible by 3: it varies across
    the greedy rollouts, so the advantages (and gradients) are not 0."""
    return float((np.asarray(completion) % 3 == 0).mean())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _axes_jobs(rank, tree):
    import torch

    from ray_tpu_torch.exceptions import MeshDivergenceError
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec, sharding
    from ray_tpu_torch.rl.flywheel import FlywheelLoop
    from ray_tpu_torch.serve import InferenceEngine
    from ray_tpu_torch.train import spmd
    cfg = gpt.small(dtype="float32")
    out = {}
    meshes = {name: MeshSpec(**kw).build() for name, kw in MESHES.items()}
    for name, mesh in meshes.items():
        model = gpt.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
        eng = InferenceEngine(model, cfg, device="cpu", mesh=mesh, **ENGINE)
        outs, st = _drive(eng, "chunked_cow")
        out[("engine", name)] = (outs, {k: st[k] for k in TRACES},
                                 st["captured"], st["mesh"],
                                 tuple(eng.cache["k"].shape))
        out[("specs", name)] = (
            {k: tuple(v) for k, v in sharding.kv_cache_specs(mesh).items()},
            {k: tuple(v) for k, v in sharding.kv_pool_specs(
                mesh, quantized=True).items()})

        toks, lengths = _unpaged_inputs()
        cache = gpt.init_kv_cache(cfg, UNPAGED_B, 32, "cpu", mesh=mesh)
        logits, cache = gpt.prefill(model, torch.from_numpy(toks), cache,
                                    lengths=torch.from_numpy(lengths))
        steps = [logits.numpy()]
        pos = torch.from_numpy(lengths).int()
        for _ in range(UNPAGED_STEPS):
            logits, cache = gpt.decode_step(
                model, torch.argmax(logits, dim=-1), cache, pos)
            pos = pos + 1
            steps.append(logits.numpy())
        out[("unpaged", name)] = (steps, tuple(cache["k"].shape))
    out["coords"] = {name: (m.shape, m.coords) for name, m in meshes.items()}

    # completion_logprobs over the seq split: this rank's positions
    mesh = meshes["seq"]
    toks, start, wsum = _lp_batch()
    model = gpt.params_from_numpy(tree, cfg, "cpu", torch.float32, True,
                                  mesh=mesh)
    rows = sharding.shard_batch(toks, mesh)
    lp = gpt.completion_logprobs(model, torch.from_numpy(rows),
                                 torch.from_numpy(start), W)
    grads = spmd.sync_grads(torch.autograd.grad(
        (lp * torch.from_numpy(wsum)).sum(), list(model.parameters())),
        model)
    out["logprobs"] = (rows.shape, lp.detach().numpy(), {
        n: sharding.gather_full(g, model.specs[n], mesh).numpy()
        for (n, _), g in zip(model.named_parameters(), grads)})

    # two greedy flywheel iterations
    fly = FlywheelLoop(cfg, _prompt, _reward, params=tree, mesh=mesh,
                       lr=FLY_LR, clip=0.2, max_new_tokens=W, pad_to=T,
                       temperature=0.0, device="cpu", engine_kwargs=FLY_ENGINE)
    _, metrics = fly.run(2)
    out["flywheel"] = ([{k: v for k, v in h.items() if k != "rollout_tok_s"}
                        for h in fly.history],
                       [{k: float(v) for k, v in m.items()
                         if k in ("loss", "mean_logprob", "mean_ratio")}
                        for m in metrics],
                       gpt.params_to_numpy(fly.state.params))

    # a rank whose request differs from its seq neighbour's
    eng = InferenceEngine(gpt.params_from_numpy(tree, cfg, "cpu", mesh=mesh),
                          cfg, device="cpu", mesh=mesh, **ENGINE)
    p = _traffic("chunked_cow")[0][0]
    eng.submit((p + mesh.axis_index("seq")) % 512, max_new_tokens=2)
    try:
        eng.run_until_idle()
        out["diverge"] = None
    except MeshDivergenceError as e:
        out["diverge"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The ranks start first; the JAX pieces run meanwhile, in threads.
    Returns (the JAX side, the ranks' results)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import MeshSpec, tree_shardings
    from ray_tpu.parallel import sharding as jsh
    from ray_tpu.rl import flywheel as jfly
    from ray_tpu.serve.engine import InferenceEngine as JaxEngine

    cfg = jgpt.small(dtype="float32")
    tree = _peaked(jax.tree.map(np.asarray, jax.jit(
        jgpt.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)))
    world = World(__name__, "_axes_jobs", tree)

    devs = jax.devices()[:4]
    meshes = {name: MeshSpec(**kw).build(devs) for name, kw in MESHES.items()}

    def placed(mesh):
        return jax.device_put(tree, tree_shardings(
            mesh, jgpt.param_logical_axes(cfg)))

    def serve(name):
        mesh = meshes[name]
        outs, st = _drive(JaxEngine(placed(mesh), cfg, mesh=mesh, **ENGINE),
                          "chunked_cow")
        specs = ({k: tuple(v) for k, v in jsh.kv_cache_specs(mesh).items()},
                 {k: tuple(v) for k, v in jsh.kv_pool_specs(
                     mesh, quantized=True).items()})
        return outs, {k: st[k] for k in TRACES}, specs

    def unpaged(name):
        mesh = meshes[name]
        toks, lengths = _unpaged_inputs()
        params = placed(mesh)
        cache = jgpt.init_kv_cache(cfg, UNPAGED_B, 32, mesh=mesh)
        prefill = jax.jit(lambda p, t, c, n: jgpt.prefill(
            p, t, c, cfg, mesh, lengths=n))
        decode = jax.jit(lambda p, t, c, pos: jgpt.decode_step(
            p, t, c, pos, cfg, mesh))
        logits, cache = prefill(params, jnp.asarray(toks), cache,
                                jnp.asarray(lengths))
        steps = [np.asarray(logits)]
        pos = jnp.asarray(lengths)
        for _ in range(UNPAGED_STEPS):
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            logits, cache = decode(params, nxt, cache, pos)
            pos = pos + 1
            steps.append(np.asarray(logits))
        return steps

    def logprobs():
        mesh = meshes["seq"]
        toks, start, wsum = _lp_batch()

        def f(p):
            lp = jgpt.completion_logprobs(p, jnp.asarray(toks),
                                          jnp.asarray(start), W, cfg, mesh)
            return (lp * wsum).sum(), lp
        (_, lp), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            placed(mesh))
        return np.asarray(lp), _flat(jax.tree.map(np.asarray, grads))

    def flywheel():
        mesh = meshes["seq"]
        fly = jfly.FlywheelLoop(
            cfg, _prompt, _reward, params=placed(mesh),
            mesh=mesh, lr=FLY_LR, clip=0.2, max_new_tokens=W, pad_to=T,
            temperature=0.0, engine_kwargs=FLY_ENGINE,
            optimizer=optax.adam(FLY_LR))
        _, metrics = fly.run(2)
        return ([{k: v for k, v in h.items() if k != "rollout_tok_s"}
                 for h in fly.history],
                [{k: float(v) for k, v in m.items()
                  if k in ("loss", "mean_logprob", "mean_ratio")}
                 for m in metrics],
                _flat(jax.tree.map(np.asarray, fly.state.params)))

    jobs = {"logprobs": logprobs, "flywheel": flywheel,
            **{("engine", n): (lambda n=n: serve(n)) for n in MESHES},
            **{("unpaged", n): (lambda n=n: unpaged(n)) for n in MESHES}}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        jax_side = {k: f.result() for k, f in futs.items()}
    return jax_side, world.results()


@pytest.fixture(scope="module")
def jax_side(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world(runs):
    return runs[1]


@pytest.mark.parametrize("axis", list(MESHES))
def test_engine_on_the_axis_matches_jax(world, jax_side, axis):
    want, jst, _ = jax_side[("engine", axis)]
    assert sum(len(o) for o in want) > 0
    for res in world:
        got, st, captured, shape, pool = res[("engine", axis)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert [t for t, _, _ in g] == [t for t, _, _ in w]
            assert [v for _, _, v in g] == [v for _, _, v in w]
            np.testing.assert_allclose([lp for _, lp, _ in g],
                                       [lp for _, lp, _ in w], atol=1e-4,
                                       rtol=0)
        assert st == jst
        assert captured is False and shape[axis] == 2 and shape["tensor"] == 2
        assert pool[3:] == (2, 32)       # 2 of the 4 heads a rank
    assert world[0][("engine", axis)][1]["cow_copies"] > 0


@pytest.mark.parametrize("axis", list(MESHES))
def test_serving_specs_on_the_axis_match_jax(world, jax_side, axis):
    want = jax_side[("engine", axis)][2]
    for res in world:
        got = res[("specs", axis)]
        for g, w in zip(got, want):
            assert {k: tuple(v) + (None,) * (len(w[k]) - len(v))
                    for k, v in g.items()} == \
                {k: tuple(v) + (None,) * (len(g[k]) - len(v))
                 for k, v in w.items()}


@pytest.mark.parametrize("axis", list(MESHES))
def test_unpaged_cache_on_the_axis_matches_jax(world, jax_side, axis):
    """Batch prefill of 4 ragged prompts (whole rows on every rank of the
    axis, each tensor rank its 2 heads), then 4 greedy decode steps."""
    want = jax_side[("unpaged", axis)]
    for res in world:
        steps, shape = res[("unpaged", axis)]
        assert shape == (2, UNPAGED_B, 32, 2, 32)
        assert len(steps) == len(want)
        for g, w in zip(steps, want):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_completion_logprobs_over_seq_match_jax(world, jax_side):
    want, want_grads = jax_side["logprobs"]
    for res in world:
        shape, lp, grads = res["logprobs"]
        assert shape == (B, T // 2)      # the rank's half of the positions
        np.testing.assert_allclose(lp, want, atol=1e-4, rtol=0)
        assert set(grads) == set(want_grads)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want_grads[k], atol=1e-4, rtol=0,
                                       err_msg=k)


def test_flywheel_over_seq_matches_jax(world, jax_side):
    """Greedy rollouts are token-identical, so both loops see the same
    batches: the histories agree exactly, the metrics within 1e-4 and
    the learner's params within 0.1 lr a step."""
    want_hist, want_metrics, want_params = jax_side["flywheel"]
    assert len(want_hist) == 2 and want_hist[-1]["engine_version"] == 1
    assert len({h["reward_mean"] for h in want_hist}) == 2
    assert abs(want_metrics[-1]["loss"]) > 1e-3
    for res in world:
        hist, metrics, params = res["flywheel"]
        assert hist == want_hist
        for m, w in zip(metrics, want_metrics):
            for k, v in w.items():
                assert abs(m[k] - v) <= 1e-4, (k, m[k], v)
        got = _flat(params)
        assert set(got) == set(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(got[k], v, atol=0.2 * FLY_LR,
                                       rtol=0, err_msg=k)


def test_a_diverging_seq_rank_raises_on_every_rank(world):
    for res in world:
        msg = res["diverge"]     # ranks 2 and 3 sit at seq 1
        assert msg is not None and "queue" in msg and "rank 2" in msg \
            and "rank 1 " not in msg, msg


def test_mesh_coordinates(world):
    """Each mesh puts ``tensor`` innermost and the other axis outside
    it, as the reference lays devices out."""
    for r, res in enumerate(world):
        for name in MESHES:
            shape, coords = res["coords"][name]
            assert coords["tensor"] == r % 2 and coords[name] == r // 2
            assert block(np.arange(4), (name,), shape, coords).tolist() == \
                [2 * (r // 2), 2 * (r // 2) + 1]
