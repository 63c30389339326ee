"""The rest of training on a mesh: the port (`ray_tpu_torch`, one
process per rank over `torch.distributed`) against the JAX package (one
process over the 8-device CPU mesh of `tests/conftest.py`), on the same
numpy inputs and params, made from seeds.

One 4-rank gloo world for the module (`test_torch_parallel.World`); the
JAX side runs in the parent meanwhile, its compilations in threads.
Cases and tolerances (f32):

- MoE's route (`moe._route`) on ``data=2 x seq=2`` and ``seq=2 x
  expert=2`` at a capacity that drops picks: each rank's dispatch is its
  block of JAX's, exactly (the same picks kept and dropped, in the same
  buffer slots), its combine within 1e-6 and the aux within 1e-6;
- the MoE trainer (`spmd.make_moe_trainer`) on those meshes and on
  ``data=2 x pipe=2``, 2 steps: loss within 1e-5 and ``grad_norm`` within
  1e-4 relative at each step, every leaf after step 2 within a tenth of
  the learning rate (`tests/test_torch_spmd_mesh.py`'s tolerances;
  every trainer here runs `default_optimizer`'s AdamW with ``eps``
  1e-3, `EPS`, so that a leaf's update follows its gradient's size);
- ViT on ``data=2 x pipe=2`` and ``data=2 x seq=2`` (its ranks on pipe
  and seq repeat the step): the loss within 1e-5 and every leaf's
  gradient, summed by `spmd.sync_grads` and gathered whole, within 1e-5
  of `jax.grad` of the reference's loss over the whole batch (a
  gradient summed over a repeating axis would be twice its size);
- the GPipe trainer (`spmd.make_gpt_pipeline_trainer`) on ``pipe=2 x
  tensor=2`` and ``pipe=2 x seq=2``: 3 losses within 1e-5, every leaf
  after step 1 within a tenth of the learning rate;
- C10, `ft.AsyncCheckpointer` on ``data=2 x tensor=2``: one commit a
  snapshot (the lowest rank's), the manifest's specs equal to
  `ft.state_specs` and, for the parameters, splitting the same live
  axes as the specs the JAX package's checkpointer records for the same
  tree on the same mesh;
  a restore onto the mesh and onto one rank whose next loss is the
  mesh's next loss within 1e-5;
- `parallel.global_from_local` and `parallel.replicate_tree`: each
  rank's tensors equal the shard that JAX's place on the device at the
  same coordinates, exactly.

This module imports no JAX at its top: the spawned ranks import it to
find their entry point, and run the port alone.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import World, block  # noqa: E402

LR = 3e-4
PARAM_ATOL = 0.1 * LR       # as tests/test_torch_spmd_mesh.py
# Adam's eps. At optax's 1e-8 a first step moves each element by
# g / (|g| + eps) x LR, about LR whatever the gradient's size: it hides a
# gradient's scale (a doubled one passes) and turns an element whose
# gradient is summation noise (the pipeline's wo holds one at these
# seeds) into a coin flip of up to 2 LR. At 1e-3, near these gradients'
# size, a step follows the gradient's size.
EPS = 1e-3
# 4 experts, top-2, capacity factor 0.5: each expert holds a quarter of
# the tokens while the picks ask for half, so picks are dropped
MOE_KW = dict(dtype="float32", attn_impl="xla", n_experts=4,
              capacity_factor=0.5, remat=False)
MOE_B, MOE_T = 4, 16
MOE_MESHES = {"data2_seq2": dict(data=2, seq=2),
              "seq2_expert2": dict(data=1, seq=2, expert=2),
              "data2_pipe2": dict(data=2, pipe=2)}
ROUTE_MESHES = ("data2_seq2", "seq2_expert2")
VIT_MESHES = {"data2_pipe2": dict(data=2, pipe=2),
              "data2_seq2": dict(data=2, seq=2)}
VIT_B = 8
PIPE_MESHES = {"pipe2_tensor2": dict(data=1, pipe=2, tensor=2),
               "pipe2_seq2": dict(data=1, pipe=2, seq=2)}
CKPT_MESH = dict(data=2, tensor=2)
INGEST_MESH = dict(data=2, tensor=2)
ROW_SPEC = (("data", "fsdp"),)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _moe_batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        toks = rng.integers(0, 512, (MOE_B, MOE_T + 1)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _route_inputs(d, e):
    rng = np.random.default_rng(11)
    h = rng.standard_normal((MOE_B, MOE_T, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    return h, w


def _vit_batch():
    rng = np.random.default_rng(0)
    return {"images": rng.normal(size=(VIT_B, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, VIT_B).astype(np.int32)}


def _lm_batch(vocab, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (4, 33)).astype(
        np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _ingest_batch():
    rng = np.random.default_rng(4)
    return {"x": rng.standard_normal((8, 3)).astype(np.float32),
            "y": rng.integers(0, 9, (8,)).astype(np.int32)}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _optimizer(spmd):
    """`default_optimizer`'s AdamW (no warmup) with ``eps`` `EPS`, in the
    package of ``spmd``: the port's `spmd.AdamW`, or the reference's
    optax chain written out."""
    if hasattr(spmd, "AdamW"):
        return spmd.AdamW(learning_rate=LR, warmup_steps=0, eps=EPS)
    import optax
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, 0, 10_000)
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(sched, b1=0.9, b2=0.95, eps=EPS,
                                   weight_decay=0.1))


def _mesh_jobs(rank, payload):
    import torch

    from ray_tpu_torch.models import _stacked, gpt, moe, vit
    from ray_tpu_torch.parallel import (MeshSpec, PartitionSpec as P,
                                        global_from_local, local_shard,
                                        replicate_tree, sharding)
    from ray_tpu_torch.train import ft, spmd
    moe_tree, vit_tree, gpt_tree, ckpt_root = payload
    out = {}
    mcfg = moe.small(**MOE_KW)

    # the route's dispatch over seq (and expert)
    h, w = _route_inputs(mcfg.d_model, mcfg.n_experts)
    for name in ROUTE_MESHES:
        mesh = MeshSpec(**MOE_MESHES[name]).build()
        hl = torch.from_numpy(local_shard(h, P(("data", "fsdp"), "seq"),
                                          mesh))
        wl = torch.from_numpy(local_shard(w, P(None, "expert"), mesh))
        split = moe._Split(mesh, hl.shape[0], hl.shape[1])
        with torch.no_grad():
            dispatch, combine, aux = moe._route(
                hl.reshape(-1, hl.shape[-1]), wl, mcfg, split)
            aux = moe.col.reduce_from(aux, split.expert, mesh)
        out[("route", name)] = (mesh.shape, mesh.coords, dispatch.numpy(),
                                combine.numpy(), float(aux))

    # the MoE trainer over seq, expert and pipe
    for name, kw in MOE_MESHES.items():
        mesh = MeshSpec(**kw).build()
        opt = _optimizer(spmd)
        _, step, place = spmd.make_moe_trainer(mcfg, optimizer=opt,
                                               device="cpu",
                                               init_state=False, mesh=mesh)
        state = spmd.create_sharded_state(
            lambda d: moe.params_from_numpy(moe_tree, mcfg, d, torch.float32,
                                            True, mesh=mesh), opt, "cpu")
        metrics = []
        for b in _moe_batches():
            state, m = step(state, place(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[("moe", name)] = (metrics,
                              _stacked.params_to_numpy(state.params))

    # ViT over pipe and seq: the loss and the synced gradients
    vcfg = vit.small(dtype="float32", remat=False)
    for name, kw in VIT_MESHES.items():
        mesh = MeshSpec(**kw).build()
        model = vit.params_from_numpy(vit_tree, vcfg, "cpu", torch.float32,
                                      True, mesh=mesh)
        b = sharding.shard_batch(_vit_batch(), mesh, logical=("batch",))
        loss = vit.loss_fn(model, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        grads = spmd.sync_grads(torch.autograd.grad(
            loss, list(model.parameters())), model)
        total = moe.col.psum(loss.detach(), spmd.batch_axes(model), mesh)
        out[("vit", name)] = (float(total), spmd.batch_axes(model), {
            n: sharding.gather_full(g, model.specs[n], mesh).numpy()
            for (n, _), g in zip(model.named_parameters(), grads)})

    # the GPipe trainer beside tensor and seq
    cfg = gpt.small(dtype="float32", attn_impl="xla")
    for name, kw in PIPE_MESHES.items():
        mesh = MeshSpec(**kw).build()
        opt = _optimizer(spmd)
        _, step, place = spmd.make_gpt_pipeline_trainer(
            cfg, mesh, num_microbatches=2, optimizer=opt, device="cpu")
        state = spmd.create_sharded_state(
            lambda d: gpt.GPT(cfg, gpt_tree, device=d, dtype=torch.float32,
                              trainable=True, mesh=mesh,
                              logical_axes=spmd.pipeline_logical_axes(cfg)),
            opt, "cpu")
        b = place(_lm_batch(cfg.vocab_size))
        losses, after1 = [], None
        for i in range(3):
            losses.append(float(step(state, b)[1]["loss"]))
            if i == 0:
                after1 = gpt.params_to_numpy(state.params)
        out[("pipe", name)] = (losses, after1)

    # C10: the async checkpointer on data=2 x tensor=2
    cfg = gpt.small(dtype="float32")
    mesh = MeshSpec(**CKPT_MESH).build()
    opt = _optimizer(spmd)
    _, step, place = spmd.make_gpt_trainer(cfg, optimizer=opt, device="cpu",
                                           init_state=False, mesh=mesh)
    state = spmd.create_sharded_state(
        lambda d: gpt.params_from_numpy(gpt_tree, cfg, d, torch.float32,
                                        True, mesh=mesh), opt, "cpu")
    b = place(_lm_batch(cfg.vocab_size, seed=5))
    ckpt = ft.AsyncCheckpointer(ckpt_root, every=1, keep=3)
    for i in range(2):
        state, _ = step(state, b)
        ckpt.maybe_snapshot(state, i + 1)
    ckpt.flush()
    steps = [s for s, _ in ft.committed_steps(ckpt_root)]
    manifest = ft.load_manifest(ft.latest_checkpoint(ckpt_root))
    next_loss = float(step(state, b)[1]["loss"])
    ckpt.close()
    tree, at = ft.restore_resharded(ckpt_root, "cpu", mesh=mesh)
    back = ft.state_from_tree(tree, cfg, "cpu", mesh=mesh)
    out["ckpt"] = dict(
        commits=ckpt.commits, snapshots=ckpt.snapshots, steps=steps,
        manifest_specs=[e["spec"] for e in manifest["shards"]],
        state_specs=ft.state_specs(state), next_loss=next_loss,
        restored_at=at, mesh_next=float(step(back, b)[1]["loss"]),
        n_params=len(list(state.params.parameters())))

    # the multi-host ingest helpers
    mesh = MeshSpec(**INGEST_MESH).build()
    local = {k: local_shard(v, P(*ROW_SPEC), mesh)
             for k, v in _ingest_batch().items()}
    placed = global_from_local(mesh, local, device="cpu")
    rep = replicate_tree(mesh, _ingest_batch(), device="cpu")
    out["ingest"] = (mesh.shape, mesh.coords,
                     {k: v.numpy() for k, v in placed.items()},
                     {k: v.numpy() for k, v in rep.items()})
    return out


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start first; the JAX pieces run meanwhile, in threads.
    Returns (the JAX side, the ranks' results, the checkpoint root)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import moe as jmoe
    from ray_tpu.models import vit as jvit
    from ray_tpu.parallel import (MeshSpec, global_from_local,
                                  replicate_tree, tree_shardings)
    from ray_tpu.train import ft as jft
    from ray_tpu.train import spmd as jspmd

    def host(t):
        return jax.tree.map(np.asarray, t)

    def init(family, seed, cfg):
        return host(jax.jit(family.init_params, static_argnums=1)(
            jax.random.PRNGKey(seed), cfg))

    mcfg = jmoe.small(**MOE_KW)
    moe_tree = init(jmoe, 1, mcfg)
    vcfg = jvit.small(dtype="float32", remat=False)
    vit_tree = init(jvit, 2, vcfg)
    cfg = jgpt.small(dtype="float32", attn_impl="xla")
    gpt_tree = init(jgpt, 0, cfg)
    ckpt_root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    world = World(__name__, "_mesh_jobs",
                  (moe_tree, vit_tree, gpt_tree, ckpt_root))
    devs = jax.devices()[:4]

    def route():
        h, w = _route_inputs(mcfg.d_model, mcfg.n_experts)
        d, c, a = jax.jit(lambda h, w: jmoe._route(h, w, mcfg))(
            h.reshape(-1, h.shape[-1]), w)
        return np.asarray(d), np.asarray(c), float(a)

    def moe_trainer(name):
        mesh = MeshSpec(**MOE_MESHES[name]).build(devs)
        opt = _optimizer(jspmd)
        _, step, shard = jspmd.make_moe_trainer(mcfg, mesh, optimizer=opt,
                                                init_state=False)
        p = jax.device_put(moe_tree, tree_shardings(
            mesh, jmoe.param_logical_axes(mcfg)))
        state = jspmd.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32))
        metrics = []
        for b in _moe_batches():
            state, m = step(state, shard(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, _flat(host(state.params))

    def vit_grads():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jvit.loss_fn(p, b, vcfg)))(
                vit_tree, jax.tree.map(jnp.asarray, _vit_batch()))
        return float(loss), _flat(host(grads))

    def pipe_trainer(name):
        mesh = MeshSpec(**PIPE_MESHES[name]).build(devs)
        state, step, shard = jspmd.make_gpt_pipeline_trainer(
            cfg, mesh, num_microbatches=2, optimizer=_optimizer(jspmd))
        params = jax.tree.map(lambda a, b: jax.device_put(b, a.sharding),
                              state.params, gpt_tree)
        state = jspmd.TrainState(params, state.opt_state, state.step)
        b = shard(_lm_batch(cfg.vocab_size))
        losses, after1 = [], None
        for i in range(3):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if i == 0:
                after1 = _flat(host(state.params))
        return losses, after1

    def ckpt_specs():
        # the parameters' specs the reference's checkpointer records for
        # the same tree on a mesh of the same shape
        mesh = MeshSpec(**CKPT_MESH).build(devs)
        p = jax.device_put(gpt_tree, tree_shardings(
            mesh, jgpt.param_logical_axes(cfg)))
        root = str(tmp_path_factory.mktemp("jax_mesh_ckpt"))
        opt = jspmd.default_optimizer()
        ck = jft.AsyncCheckpointer(root, every=1)
        ck.maybe_snapshot(jspmd.TrainState(p, opt.init(p),
                                           jnp.zeros((), jnp.int32)), 1,
                          force=True)
        ck.flush()
        ck.close()
        mf = jft.load_manifest(jft.latest_checkpoint(root))
        return [e["spec"] for e in mf["shards"]]

    def ingest():
        mesh = MeshSpec(**INGEST_MESH).build(devs)
        placed = global_from_local(mesh, _ingest_batch())
        rep = replicate_tree(mesh, _ingest_batch())
        grid = np.asarray(mesh.devices)

        def by_coords(tree):
            out = {}
            for k, arr in tree.items():
                for s in arr.addressable_shards:
                    idx = np.argwhere(grid == s.device)[0]
                    coords = dict(zip(mesh.axis_names, map(int, idx)))
                    key = tuple(sorted(coords.items()))
                    out.setdefault(key, {})[k] = np.asarray(s.data)
            return out
        return by_coords(placed), by_coords(rep)

    jobs = {"route": route, "vit": vit_grads, "ckpt_specs": ckpt_specs,
            "ingest": ingest,
            **{("moe", n): (lambda n=n: moe_trainer(n)) for n in MOE_MESHES},
            **{("pipe", n): (lambda n=n: pipe_trainer(n))
               for n in PIPE_MESHES}}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        jax_side = {k: f.result() for k, f in futs.items()}
    return jax_side, world.results(), ckpt_root


@pytest.fixture(scope="module")
def jax_side(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world(runs):
    return runs[1]


# ---------------------------------------------------------------------------
# MoE and ViT over seq and pipe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ROUTE_MESHES)
def test_moe_route_over_seq_drops_the_same_picks_as_jax(world, jax_side,
                                                        name):
    """Each rank's dispatch is its (rows, positions) block of JAX's over
    the whole batch: the same picks kept, the same dropped, in the same
    slots of each expert's buffer."""
    d, c, aux = jax_side["route"]
    e, cap = d.shape[1:]
    assert d.sum() < MOE_B * MOE_T * MOE_KW.get("top_k", 2), "no drop"
    d4, c4 = (z.reshape(MOE_B, MOE_T, e, cap) for z in (d, c))
    spec = (("data", "fsdp"), "seq")
    for res in world:
        shape, coords, gd, gc, gaux = res[("route", name)]
        np.testing.assert_array_equal(
            gd, block(d4, spec, shape, coords).reshape(-1, e, cap))
        np.testing.assert_allclose(
            gc, block(c4, spec, shape, coords).reshape(-1, e, cap),
            atol=1e-6, rtol=0)
        assert abs(gaux - aux) <= 1e-6, (gaux, aux)


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_moe_trainer_metrics_over_seq_and_pipe_match_jax(world, jax_side,
                                                         name):
    want, _ = jax_side[("moe", name)]
    for res in world:
        got, _ = res[("moe", name)]
        for (gl, gn), (wl, wn) in zip(got, want):
            assert abs(gl - wl) <= 1e-5, (gl, wl)
            assert abs(gn - wn) <= 1e-4 * abs(wn), (gn, wn)


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_moe_trainer_params_over_seq_and_pipe_match_jax(world, jax_side,
                                                        name):
    """Every leaf gathered whole after step 2."""
    _, want = jax_side[("moe", name)]
    for res in world:
        got = _flat(res[("moe", name)][1])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("name", list(VIT_MESHES))
def test_vit_over_pipe_and_seq_matches_jax(world, jax_side, name):
    """The loss summed over the ranks that hold other rows (data only:
    the pipe and seq ranks repeat the step), and every leaf's gradient
    after `sync_grads`, none summed over a repeating axis."""
    loss, grads = jax_side["vit"]
    for res in world:
        got_loss, axes, got = res[("vit", name)]
        assert axes == ("data",)
        assert abs(got_loss - loss) <= 1e-5, (got_loss, loss)
        got = _flat(got)
        assert set(got) == set(grads)
        for k in grads:
            np.testing.assert_allclose(got[k], grads[k], atol=1e-5, rtol=0,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the GPipe trainer beside tensor and seq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PIPE_MESHES))
def test_pipeline_trainer_losses_beside_tensor_and_seq_match_jax(
        world, jax_side, name):
    want, _ = jax_side[("pipe", name)]
    for res in world:
        np.testing.assert_allclose(res[("pipe", name)][0], want, atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("name", list(PIPE_MESHES))
def test_pipeline_trainer_params_beside_tensor_and_seq_match_jax(
        world, jax_side, name):
    """Every leaf gathered whole after step 1: a tensor rank's update is
    its block of the whole leaf's, a seq rank's gradient its positions'
    share."""
    _, want = jax_side[("pipe", name)]
    for res in world:
        got = _flat(res[("pipe", name)][1])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL,
                                       rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# C10: the async checkpointer on a mesh
# ---------------------------------------------------------------------------

def test_async_checkpointer_commits_once_a_snapshot_on_a_mesh(world):
    """Two snapshots on every rank, two committed steps, both by the
    lowest rank: no other rank writes into a step directory."""
    commits = [res["ckpt"]["commits"] for res in world]
    assert commits == [2, 0, 0, 0]
    for res in world:
        assert res["ckpt"]["snapshots"] == 2
        assert res["ckpt"]["steps"] == [1, 2]


def _live(spec):
    """A recorded spec's entries without the mesh's axes of size 1 (JAX
    records what XLA's copy leaves of them, which keeps some and drops
    others; either restores the same blocks)."""
    out = []
    for entry in spec:
        axes = [] if entry is None else [entry] if isinstance(
            entry, str) else list(entry)
        axes = [a for a in axes if CKPT_MESH.get(a, 1) > 1]
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return out


def test_async_checkpointer_records_the_mesh_specs(world, jax_side):
    """The manifest's spec list is `ft.state_specs` of the state, and its
    parameters' specs split the same live axes as the ones the JAX
    package records for the same tree on the same mesh."""
    want = jax_side["ckpt_specs"]
    for res in world:
        c = res["ckpt"]
        assert c["manifest_specs"] == c["state_specs"]
        assert any("tensor" in str(s) for s in c["manifest_specs"])
        n = c["n_params"]
        assert [_live(s) for s in c["manifest_specs"][:n]] == \
            [_live(s) for s in want[:n]]


def test_async_checkpoint_on_a_mesh_restores_onto_one_rank_and_the_mesh(
        world, runs):
    """Restored onto the same mesh, each rank's next loss is the mesh's;
    restored onto one rank (here, the test process), too."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import ft, loop, spmd
    for res in world:
        c = res["ckpt"]
        assert c["restored_at"] == 2
        assert abs(c["mesh_next"] - c["next_loss"]) <= 1e-5
    cfg = gpt.small(dtype="float32")
    tree, at = ft.restore_resharded(runs[2], "cpu")
    state = ft.state_from_tree(tree, cfg, "cpu")
    step = spmd.make_train_step(lambda m, b: spmd.gpt_loss_fn(m, b, cfg),
                                _optimizer(spmd))
    batch = loop.make_placer("cpu")(_lm_batch(cfg.vocab_size, seed=5))
    _, m = step(state, batch)
    assert at == 2
    assert abs(float(m["loss"]) - world[0]["ckpt"]["next_loss"]) <= 1e-5


# ---------------------------------------------------------------------------
# the multi-host ingest helpers
# ---------------------------------------------------------------------------

def test_global_from_local_matches_reference(world, jax_side):
    """A rank given its rows holds the shard JAX's global array places
    on the device at its coordinates."""
    want, _ = jax_side["ingest"]
    for res in world:
        shape, coords, placed, _ = res["ingest"]
        key = tuple(sorted(coords.items()))
        for k, v in want[key].items():
            np.testing.assert_array_equal(placed[k], v, err_msg=k)
            assert placed[k].dtype == v.dtype


def test_replicate_tree_matches_reference(world, jax_side):
    _, want = jax_side["ingest"]
    for res in world:
        _, coords, _, rep = res["ingest"]
        for k, v in want[tuple(sorted(coords.items()))].items():
            np.testing.assert_array_equal(rep[k], v, err_msg=k)
            assert rep[k].shape == _ingest_batch()[k].shape


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
