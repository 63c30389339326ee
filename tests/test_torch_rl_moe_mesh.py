"""RL and MoE on a device mesh: the port's `completion_logprobs(mesh=)`,
`FlywheelLoop(mesh=)`, the MoE trainer's expert axis and ViT on a mesh
(one process per rank) against the JAX package's on the same meshes (one
process over the 8-device CPU mesh of `tests/conftest.py`), on the same
numpy inputs made from seeds, params carried across by the mesh-aware
``params_from_numpy``.

The JAX side runs in the parent, its pieces in threads, while one 4-rank
gloo world for the module (`test_torch_parallel.World`) runs the port's.
f32 throughout. Cases:

- `completion_logprobs` on ``data=2 x tensor=2`` (each rank its rows and
  its vocabulary block): values within 1e-5 of JAX's, the parameter
  gradients of a weighted sum, summed over the data ranks and gathered,
  within 1e-4;
- the `FlywheelLoop(mesh=)` learner step on a fixed batch against the
  JAX flywheel's jitted step with placed params (``optax.adam``): the
  loss and metrics within 1e-5, the updated params within a tenth of
  the learning rate, as `tests/test_torch_spmd_mesh.py` holds its
  leaves (Adam's first step moves an element by lr * g / (|g| + eps),
  so an element whose gradient is near eps swings with summation noise:
  one of 131,072 ``w_down`` elements moved 2.1e-4 more than JAX's, while
  a lost or wrong gradient sum moves elements by up to 2 lr; the
  gradients themselves are held to 1e-4 by the case above); then two
  iterations of the loop on the mesh: every rank's history equal, and
  every rank's engine blocks equal to its learner's after the publish
  (sampled rollouts are compared only in distribution: threefry is not
  torch's generator, so they are not compared with JAX's);
- `make_moe_trainer` on ``data=2 x expert=2`` and ``tensor=2 x
  expert=2`` (heads, the experts' columns and the vocabulary split too)
  for 2 steps at a capacity factor that drops tokens (so the route's
  global order is what is tested): loss within 1e-5 and ``grad_norm``
  within 1e-4 relative at each step, every leaf after step 2 within a
  tenth of the learning rate;
- `param_logical_axes` of MoE and ViT equal JAX's;
- ViT's loss on ``data=2 x tensor=2`` within 1e-5.

This module imports no JAX at its top: the spawned ranks import it to
find their entry point.
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import World, block  # noqa: E402

MESH = dict(data=2, tensor=2)
MOE_MESHES = {"data2_expert2": dict(data=2, expert=2),
              "tensor2_expert2": dict(data=1, tensor=2, expert=2)}
ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=8)
B, T, W = 4, 16, 6
LR = 3e-4
FLY_LR = 1e-2               # the flywheel's default Adam learning rate
PARAM_ATOL = 0.1 * LR       # as tests/test_torch_spmd_mesh.py
# a capacity factor that drops picks: 4 experts, top-2, so each expert
# holds a quarter of the tokens while the picks ask for half
MOE_KW = dict(dtype="float32", attn_impl="xla", n_experts=4,
              capacity_factor=0.5, remat=False)
MOE_B, MOE_T = 4, 16
VIT_B = 8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(seed=0, lp=None):
    """A fixed learner batch: random sequences, ragged starts (one window
    running past T), behaviour logprobs near ``lp`` (some ratios beyond
    the clip range), a ragged mask and advantages."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (B, T)).astype(np.int32)
    start = np.array([3, 5, 8, 12], np.int32)
    mask = np.ones((B, W), np.float32)
    mask[1, 4:] = 0.0
    mask[3, 4:] = 0.0
    base = np.full((B, W), -6.0, np.float32) if lp is None else lp
    return {"tokens": tokens, "start": start,
            "behavior_logp": (base + rng.normal(0, 0.3, (B, W))
                              ).astype(np.float32),
            "mask": mask,
            "advantage": rng.normal(0, 1, (B,)).astype(np.float32)}


def _moe_batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        toks = rng.integers(0, 512, (MOE_B, MOE_T + 1)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _vit_batch():
    rng = np.random.default_rng(0)
    return {"images": rng.normal(size=(VIT_B, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, VIT_B).astype(np.int32)}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _mesh_jobs(rank, payload):
    import torch

    from ray_tpu_torch.models import _stacked, gpt, moe, vit
    from ray_tpu_torch.parallel import MeshSpec, collectives, sharding
    from ray_tpu_torch.rl.flywheel import FlywheelLoop, motif_reward
    from ray_tpu_torch.train import spmd
    tree, lp_batch, wsum, fly_batch, moe_tree, vit_tree = payload
    out = {}
    mesh = MeshSpec(**MESH).build()
    out["coords"] = (mesh.shape, mesh.coords)
    cfg = gpt.small(dtype="float32")

    # completion_logprobs: this rank's rows, its vocabulary block
    model = gpt.params_from_numpy(tree, cfg, "cpu", torch.float32, True,
                                  mesh=mesh)
    rows = sharding.shard_batch({"tokens": lp_batch["tokens"],
                                 "start": lp_batch["start"], "w": wsum},
                                mesh)
    lp = gpt.completion_logprobs(model, torch.from_numpy(rows["tokens"]),
                                 torch.from_numpy(rows["start"]), W)
    loss = (lp * torch.from_numpy(rows["w"])).sum()
    grads = spmd.sync_grads(torch.autograd.grad(
        loss, list(model.parameters())), model)
    out["logprobs"] = (lp.detach().numpy(), {
        n: sharding.gather_full(g, model.specs[n], mesh).numpy()
        for (n, _), g in zip(model.named_parameters(), grads)})

    # the flywheel's learner step on a fixed batch, then the loop
    fly = FlywheelLoop(cfg, lambda r: [1, 2, int(r.integers(3, 9))],
                       motif_reward(7), params=tree, mesh=mesh, lr=FLY_LR,
                       clip=0.2, max_new_tokens=W, pad_to=T, device="cpu",
                       engine_kwargs=ENGINE)
    state, metrics = fly._step(fly.state, fly._place(fly_batch))
    out["learner"] = ({k: float(v) for k, v in metrics.items()},
                      gpt.params_to_numpy(state.params),
                      fly.state.params.layers["wq"].shape)
    fly.run(2)
    same = all(torch.equal(e, l.detach()) for e, l in zip(
        fly.engine.model.parameters(), fly.state.params.parameters()))
    out["loop"] = ([{k: v for k, v in h.items() if k != "rollout_tok_s"}
                    for h in fly.history], same, fly.engine.params_version,
                   fly.engine.stats()["captured"])

    # the MoE trainer on the expert meshes
    mcfg = moe.small(**MOE_KW)
    for name, kw in MOE_MESHES.items():
        mmesh = MeshSpec(**kw).build()
        opt = spmd.default_optimizer(learning_rate=LR, warmup_steps=0)
        _, step, place = spmd.make_moe_trainer(mcfg, optimizer=opt,
                                               device="cpu",
                                               init_state=False, mesh=mmesh)
        mstate = spmd.create_sharded_state(
            lambda d: moe.params_from_numpy(moe_tree, mcfg, d,
                                            torch.float32, True,
                                            mesh=mmesh), opt, "cpu")
        metrics = []
        for b in _moe_batches():
            mstate, m = step(mstate, place(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[("moe", name)] = (metrics,
                              _stacked.params_to_numpy(mstate.params),
                              {n: tuple(p.shape) for n, p in
                               mstate.params.named_parameters()})

    # ViT's loss on data=2 x tensor=2
    vcfg = vit.small(dtype="float32", remat=False)
    vmodel = vit.params_from_numpy(vit_tree, vcfg, "cpu", torch.float32,
                                   mesh=mesh)
    vb = sharding.shard_batch(_vit_batch(), mesh)
    with torch.no_grad():
        vloss = vit.loss_fn(vmodel, {k: torch.from_numpy(v)
                                     for k, v in vb.items()})
        vloss = collectives.psum(vloss, sharding.token_axes(mesh), mesh)
    out["vit"] = (float(vloss), vmodel.layers["wq"].shape,
                  vmodel.layers["w_up"].shape)
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
    from ray_tpu.models import moe as jmoe
    from ray_tpu.models import vit as jvit
    from ray_tpu.parallel import MeshSpec, tree_shardings
    from ray_tpu.rl import flywheel as jfly
    from ray_tpu.train import spmd as jspmd

    def host(t):
        return jax.tree.map(np.asarray, t)

    def init(family, seed, cfg):
        # one compilation, not one per leaf
        return host(jax.jit(family.init_params, static_argnums=1)(
            jax.random.PRNGKey(seed), cfg))

    cfg = jgpt.small(dtype="float32")
    tree = init(jgpt, 0, cfg)
    lp_batch = _batch(0)
    wsum = np.random.default_rng(5).normal(0, 1, (B, W)).astype(np.float32)
    fly_batch = _batch(1)
    mcfg = jmoe.small(**MOE_KW)
    moe_tree = init(jmoe, 1, mcfg)
    vcfg = jvit.small(dtype="float32", remat=False)
    vit_tree = init(jvit, 2, vcfg)
    world = World(__name__, "_mesh_jobs", (tree, lp_batch, wsum, fly_batch,
                                           moe_tree, vit_tree))

    devs = jax.devices()[:4]
    mesh = MeshSpec(**MESH).build(devs)
    shardings = tree_shardings(mesh, jgpt.param_logical_axes(cfg))
    params = jax.device_put(tree, shardings)
    # the flywheel's step donates its state: the learner gets its own
    fly_params = jax.device_put(tree, shardings)

    def logprobs():
        def f(p):
            lp = jgpt.completion_logprobs(
                p, jnp.asarray(lp_batch["tokens"]),
                jnp.asarray(lp_batch["start"]), W, cfg, mesh)
            return (lp * wsum).sum(), lp
        (_, lp), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        return np.asarray(lp), _flat(host(grads))

    def learner():
        fly = jfly.FlywheelLoop(
            cfg, lambda r: [1, 2, 3], jfly.motif_reward(7),
            params=fly_params,
            mesh=mesh, lr=FLY_LR, clip=0.2, max_new_tokens=W, pad_to=T,
            engine_kwargs=ENGINE, optimizer=optax.adam(FLY_LR))
        state, metrics = fly._step(fly.state,
                                   jax.tree.map(jnp.asarray, fly_batch))
        return ({k: float(v) for k, v in metrics.items()},
                _flat(host(state.params)))

    def moe_trainer(name):
        mmesh = MeshSpec(**MOE_MESHES[name]).build(devs)
        opt = jspmd.default_optimizer(learning_rate=LR, warmup_steps=0)
        _, step, shard = jspmd.make_moe_trainer(mcfg, mmesh, optimizer=opt,
                                                init_state=False)
        p = jax.device_put(moe_tree, tree_shardings(
            mmesh, jmoe.param_logical_axes(mcfg)))
        state = jspmd.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32))
        metrics = []
        for b in _moe_batches():
            state, m = step(state, shard(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, _flat(host(state.params))

    def vit_loss():
        p = jax.device_put(vit_tree, tree_shardings(
            mesh, jvit.param_logical_axes(vcfg)))
        b = jax.tree.map(jnp.asarray, _vit_batch())
        return float(jax.jit(lambda p, b: jvit.loss_fn(p, b, vcfg))(p, b))

    jobs = {"logprobs": logprobs, "learner": learner, "vit": vit_loss,
            **{("moe", name): (lambda n=name: moe_trainer(n))
               for name in MOE_MESHES}}
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


def test_completion_logprobs_on_a_mesh_match_jax(world, jax_side):
    want, want_grads = jax_side["logprobs"]
    for res in world:
        lp, grads = res["logprobs"]
        shape, coords = res["coords"]
        np.testing.assert_allclose(
            lp, block(want, (("data", "fsdp"),), shape, coords), atol=1e-5,
            rtol=0)
        assert set(grads) == set(want_grads)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want_grads[k], atol=1e-4, rtol=0,
                                       err_msg=k)


def test_flywheel_learner_step_on_a_mesh_matches_jax(world, jax_side):
    want_metrics, want_params = jax_side["learner"]
    for res in world:
        metrics, params, wq_shape = res["learner"]
        assert wq_shape[-1] == 64        # 2 of the 4 heads a rank
        assert set(metrics) == set(want_metrics)
        for k, v in want_metrics.items():
            assert abs(metrics[k] - v) <= 1e-5, (k, metrics[k], v)
        got = _flat(params)
        for k, v in want_params.items():
            np.testing.assert_allclose(got[k], v, atol=0.1 * FLY_LR,
                                       rtol=0, err_msg=k)


def test_flywheel_loop_on_a_mesh_runs_in_step(world):
    """Two iterations on the mesh: every rank drew the same prompts and
    got the same rollouts (the histories agree), the engine serves the
    learner's published blocks, uncaptured."""
    history, same, version, captured = world[0]["loop"]
    assert len(history) == 2 and version == 2 and captured is False
    assert all(np.isfinite(h["reward_mean"]) for h in history)
    for res in world:
        h, s, v, _ = res["loop"]
        assert h == history and s and v == version


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_moe_trainer_on_data_and_expert_axes_matches_jax(world, jax_side,
                                                         name):
    want, want_params = jax_side[("moe", name)]
    tensor = MOE_MESHES[name].get("tensor", 1)
    for res in world:
        got, params, shapes = res[("moe", name)]
        assert shapes["layers.w_up"][1] == 2        # 2 of the 4 experts
        assert shapes["layers.w_up"][-1] == 256 // tensor
        assert shapes["layers.router"][-1] == 2
        assert shapes["embed"][0] == 512 // tensor
        for (gl, gn), (wl, wn) in zip(got, want):
            assert abs(gl - wl) <= 1e-5, (gl, wl)
            assert abs(gn - wn) <= 1e-4 * abs(wn), (gn, wn)
        got = _flat(params)
        assert set(got) == set(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)


def test_moe_route_drops_picks_at_this_capacity():
    """The MoE case is there for the global order: at its capacity
    factor the route drops picks on the global batch."""
    import torch

    from ray_tpu_torch.models import moe
    cfg = moe.small(**MOE_KW)
    tree = moe.init_params(1, cfg, "cpu")
    x = torch.randn(MOE_B * MOE_T, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    dispatch, _, _ = moe._route(x, tree["layers"]["router"][0], cfg)
    assert dispatch.sum() < cfg.top_k * MOE_B * MOE_T


def test_param_logical_axes_match_jax():
    from ray_tpu.models import moe as jmoe
    from ray_tpu.models import vit as jvit
    from ray_tpu_torch.models import moe, vit
    assert moe.param_logical_axes(moe.small()) == \
        jmoe.param_logical_axes(jmoe.small())
    assert vit.param_logical_axes(vit.small()) == \
        jvit.param_logical_axes(jvit.small())


def test_vit_loss_on_a_mesh_matches_jax(world, jax_side):
    want = jax_side["vit"]
    for res in world:
        loss, wq_shape, up_shape = res["vit"]
        assert wq_shape[-1] == 64 and up_shape[-1] == 128
        assert abs(loss - want) <= 1e-5, (loss, want)


def test_moe_trainer_mesh_of_one_is_the_single_card_trainer():
    """A mesh of one rank builds the single-card MoE trainer."""
    import torch

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import single_device_mesh
    from ray_tpu_torch.train import spmd
    cfg = dataclasses.replace(moe.small(**MOE_KW), n_layers=1)
    runs = []
    for mesh in (None, single_device_mesh()):
        state, step, place = spmd.make_moe_trainer(cfg, device="cpu",
                                                   mesh=mesh)
        assert state.params.mesh is None
        losses = [float(step(state, place(b))[1]["loss"])
                  for b in _moe_batches()]
        runs.append((losses, [p.detach().clone()
                              for p in state.params.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_params_to_numpy_returns_copies():
    """A repair found with this slice: on the CPU `params_to_numpy` (GPT's
    and the stacked families') returned numpy views of f32 parameters,
    so a tree taken before a step changed with the step (the flywheel's
    host publish holds such a tree). Now each leaf is a copy."""
    import torch

    from ray_tpu_torch.models import _stacked, gpt, moe
    cfg = gpt.small(dtype="float32", n_layers=1)
    model = gpt.GPT(cfg, gpt.init_params(0, cfg, "cpu"), device="cpu",
                    dtype=torch.float32, trainable=True)
    mcfg = dataclasses.replace(moe.small(**MOE_KW), n_layers=1)
    mmodel = moe.MoE(mcfg, moe.init_params(0, mcfg, "cpu"), device="cpu",
                     dtype=torch.float32, trainable=True)
    for m, to_numpy in ((model, gpt.params_to_numpy),
                        (mmodel, _stacked.params_to_numpy)):
        tree = _flat(to_numpy(m))
        before = {k: v.copy() for k, v in tree.items()}
        with torch.no_grad():
            for p in m.parameters():
                p.add_(1.0)
        for k, v in tree.items():
            np.testing.assert_array_equal(v, before[k], err_msg=k)

