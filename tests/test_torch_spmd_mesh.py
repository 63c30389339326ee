"""The port's mesh trainers (`ray_tpu_torch.train.spmd` with ``mesh=``,
one process per rank) against the JAX package's (`ray_tpu.train.spmd`
over the 8-device CPU mesh), on `gpt.small(dtype="float32")` with the JAX
params carried across by the mesh-aware `params_from_numpy`.

The JAX side runs in the parent; the port's in one 4-rank gloo world
for the module (`test_torch_parallel.run_world`), each rank pickling
back what it holds. Cases:

- `make_gpt_trainer` on ``fsdp=2 x tensor=2`` and ``data=2 x seq=2``
  (the ring), dense and fused loss, `default_optimizer(warmup_steps=0)`
  (learning rate 3e-4), 2 steps (the fused loss's on masked batches):
  loss within 1e-5 and ``grad_norm`` within 1e-4 relative at each step,
  every leaf gathered after step 2 within a tenth of the learning rate;
- `ft.restore_resharded(mesh=)` of a JAX checkpoint written from
  ``data=2 x fsdp=4``: every rank's blocks equal the slices of the JAX
  leaves under `valid_spec_for` of the recorded specs, bit for bit;
- a port mesh state saved (`ft.write_sharded_state`) and restored onto
  one rank, bit for bit; `make_placer(mesh=)`'s blocks; a mesh of one
  rank equal to ``mesh=None`` bit for bit; the refusals that stay.
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import World, block  # noqa: E402

MESHES = {"fsdp2_tensor2": dict(data=1, fsdp=2, tensor=2),
          "data2_seq2": dict(data=2, seq=2)}
LOSSES = ("dense", "fused")
B, T = 4, 32


def _batches(vocab, masked: bool):
    """Two steps' batches, both with a padding mask or both without (one
    trace a JAX trainer)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        toks = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
        b = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if masked:
            b["mask"] = (rng.random((B, T)) < 0.7).astype(np.float32)
        out.append(b)
    return out


LR = 3e-4
# Adam moves every element by about the learning rate whatever its
# gradient's size, so an element whose gradient is near summation noise
# moves by up to noise / |g| x LR more in one package than in the other:
# the leaves are held to a tenth of LR, far below a lost or wrong update
PARAM_ATOL = 0.1 * LR


def _optimizer(spmd):
    return spmd.default_optimizer(learning_rate=LR, warmup_steps=0)


def _flat(tree, prefix="", conv=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", conv))
        else:
            out[prefix + k] = conv(v)
    return out


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _mesh_jobs(rank, payload):
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec, single_device_mesh
    from ray_tpu_torch.train import ft, loop, spmd
    tree, jax_root, port_root = payload
    cfg0 = gpt.small(dtype="float32")
    out = {}

    def trainer(cfg, mesh, tree):
        opt = _optimizer(spmd)
        _, step, place = spmd.make_gpt_trainer(cfg, optimizer=opt,
                                               device="cpu", init_state=False,
                                               mesh=mesh)
        state = spmd.create_sharded_state(
            lambda d: gpt.params_from_numpy(tree, cfg, d, torch.float32, True,
                                            mesh=mesh), opt, "cpu")
        return state, step, place

    for name, kw in MESHES.items():
        for loss in LOSSES:
            cfg = dataclasses.replace(cfg0, loss_impl=loss)
            mesh = MeshSpec(**kw).build()
            state, step, place = trainer(cfg, mesh, tree)
            metrics = []
            for b in _batches(cfg.vocab_size, loss == "fused"):
                state, m = step(state, place(b))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            out[("train", name, loss)] = (metrics,
                                          gpt.params_to_numpy(state.params))
            if name == "fsdp2_tensor2" and loss == "fused":
                # saved from the mesh, restored onto one rank
                ft.write_sharded_state(port_root, 2, state)
                whole = ft.state_to_tree(state)
                back, step_no = ft.restore_resharded(port_root, "cpu")
                leaves = list(zip(ft.tree_leaves(whole),
                                  ft.tree_leaves(back)))
                out["saved"] = (step_no, len(leaves), all(
                    a.dtype == b.dtype and torch.equal(a.cpu(), b)
                    for a, b in leaves))

    # a JAX checkpoint restored onto a mesh of this world
    mesh = MeshSpec(data=1, fsdp=2, tensor=2).build()
    restored, step_no = ft.restore_resharded(jax_root, "cpu", mesh=mesh)
    adam = restored.opt_state[1][0]
    out["restored"] = (mesh.shape, mesh.coords, step_no,
                       _flat({"params": restored.params, "mu": adam.mu,
                              "nu": adam.nu}),
                       int(adam.count), int(restored.step))
    # the recorded specs are not the model's: the state comes from the
    # whole leaves, each rank keeping the model's blocks
    whole, _ = ft.restore_resharded(jax_root, "cpu")
    st = ft.state_from_tree(whole, cfg0, "cpu", mesh=mesh)
    out["restored_state"] = {
        n: (p.detach().numpy(), m.numpy()) for (n, p), m in zip(
            st.params.named_parameters(), st.opt_state["mu"])}

    out["specs"] = {n: tuple(s) for n, s in st.params.specs.items()}

    # make_placer(mesh=): the rank's ("batch", "length") block of each
    # microbatch, and the trainer's placer is it
    out["placed"] = []
    for kw, accum in ((dict(data=2, tensor=2), 1), (dict(data=2, seq=2), 2)):
        mesh = MeshSpec(**kw).build()
        b = _batches(cfg0.vocab_size, True)[1]
        placed = loop.make_placer("cpu", mesh=mesh, accum=accum)(b)
        _, _, place = spmd.make_gpt_trainer(cfg0, device="cpu", mesh=mesh,
                                            accum=accum, init_state=False)
        out["placed"].append((mesh.shape, mesh.coords, accum,
                              {k: v.numpy() for k, v in placed.items()},
                              {k: v.numpy() for k, v in place(b).items()}))

    # the refusals that stay, and the ones a mesh adds (on the last
    # placer's data=2 x seq=2 mesh)
    model = gpt.params_from_numpy(tree, cfg0, "cpu", torch.float32, True,
                                  mesh=mesh)
    errs = []
    for fn in (lambda: gpt.completion_logprobs(
                   model, torch.zeros((1, 8), dtype=torch.long), [1], 2),
               lambda: gpt.loss_fn(model, {"tokens": torch.zeros(
                   (2, 9), dtype=torch.long)}),
               lambda: spmd.make_gpt_pipeline_trainer(cfg0, mesh,
                                                      device="cpu"),
               lambda: gpt.init_kv_cache(cfg0, 2, 8, "cpu", mesh=mesh)):
        try:
            fn()
            errs.append(None)
        except (ValueError, NotImplementedError) as e:
            errs.append((type(e).__name__, str(e)))
    out["refusals"] = errs

    # a mesh of one rank is the single-card trainer, bit for bit
    if rank == 0:
        runs = []
        for mesh in (None, single_device_mesh()):
            cfg = dataclasses.replace(cfg0, loss_impl="fused")
            state, step, place = trainer(cfg, mesh, tree)
            losses = [float(step(state, place(b))[1]["loss"])
                      for b in _batches(cfg.vocab_size, True)]
            runs.append((losses, gpt.params_to_numpy(state.params)))
        out["one"] = runs
    return out


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX checkpoint and initial params first; then the ranks start,
    and the JAX trainers run while they do. Returns (the JAX side, the
    ranks' results)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import MeshSpec, tree_shardings
    from ray_tpu.train import ft as jft
    from ray_tpu.train import spmd as jspmd

    devs = jax.devices()
    cfg0 = jgpt.small(dtype="float32")
    tree = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(0),
                                                     cfg0))
    # a checkpoint written from data=2 x fsdp=4, moments made non-zero
    mesh8 = MeshSpec(data=2, fsdp=4).build(devs)
    opt = jspmd.default_optimizer()
    params = jax.device_put(tree, tree_shardings(
        mesh8, jgpt.param_logical_axes(cfg0)))
    opt_state = jax.tree.map(
        lambda z: z + 0.5 if jnp.issubdtype(z.dtype, jnp.floating) else z + 3,
        opt.init(params))
    step = jax.device_put(jnp.asarray(3, jnp.int32),
                          NamedSharding(mesh8, jax.sharding.PartitionSpec()))
    jax_root = str(tmp_path_factory.mktemp("jax_ckpt"))
    ckpt = jft.AsyncCheckpointer(jax_root, every=1)
    ckpt.maybe_snapshot(jspmd.TrainState(params, opt_state, step), 3,
                        force=True)
    ckpt.flush()
    ckpt.close()
    port_root = str(tmp_path_factory.mktemp("port_ckpt"))
    world = World(__name__, "_mesh_jobs", (tree, jax_root, port_root))

    def train(name, loss):
        mesh = MeshSpec(**MESHES[name]).build(devs[:4])
        cfg = dataclasses.replace(cfg0, loss_impl=loss)
        opt = _optimizer(jspmd)
        _, step_fn, shard = jspmd.make_gpt_trainer(
            cfg, mesh, optimizer=opt, init_state=False)
        params = jax.device_put(tree, tree_shardings(
            mesh, jgpt.param_logical_axes(cfg0)))
        state = jspmd.TrainState(params, opt.init(params),
                                 jnp.zeros((), jnp.int32))
        metrics = []
        for b in _batches(cfg.vocab_size, loss == "fused"):
            state, m = step_fn(state, shard(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, _flat(jax.tree.map(np.asarray, state.params))

    # the four compilations overlap in threads
    keys = [(name, loss) for name in MESHES for loss in LOSSES]
    with ThreadPoolExecutor(len(keys)) as pool:
        trained = dict(zip(keys, pool.map(lambda k: train(*k), keys)))

    manifest = jft.load_manifest(jft.latest_checkpoint(jax_root))
    jax_side = dict(runs=trained, jax_root=jax_root, manifest=manifest,
                    count=int(opt_state[1][0].count))
    return jax_side, world.results()


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world(runs):
    return runs[1]


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_trainer_metrics_match_jax(world, jax_runs, name, loss):
    want, _ = jax_runs["runs"][(name, loss)]
    for res in world:
        got, _ = res[("train", name, loss)]
        for (gl, gn), (wl, wn) in zip(got, want):
            assert abs(gl - wl) <= 1e-5, (gl, wl)
            assert abs(gn - wn) <= 1e-4 * abs(wn), (gn, wn)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_trainer_params_match_jax(world, jax_runs, name, loss):
    """Every leaf gathered from the ranks' blocks after step 2 (the masked
    batch)."""
    _, want = jax_runs["runs"][(name, loss)]
    for res in world:
        _, got = res[("train", name, loss)]
        got = _flat(got)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL,
                                       rtol=0, err_msg=k)


def test_jax_checkpoint_restores_onto_a_mesh_bit_for_bit(world, jax_runs):
    """Each rank's block of every parameter and moment is the shard that
    the JAX package's own `restore_resharded` places on the device at the
    same coordinates of a JAX mesh of the same shape (the leaf's slice
    under `valid_spec_for` of its recorded spec)."""
    import jax

    from ray_tpu.parallel import MeshSpec
    from ray_tpu.train import ft as jft
    specs = [s["spec"] for s in jax_runs["manifest"]["shards"]]
    assert any(any(s) for s in specs), "no split leaf in the checkpoint"
    jmesh = MeshSpec(data=1, fsdp=2, tensor=2).build(jax.devices()[:4])
    restored, _ = jft.restore_resharded(jax_runs["jax_root"], jmesh)
    adam = restored.opt_state[1][0]
    want = _flat({"params": restored.params, "mu": adam.mu, "nu": adam.nu},
                 conv=lambda a: a)
    for res in world:
        _, coords, step, leaves, count, step2 = res["restored"]
        assert step == step2 == 3 and count == jax_runs["count"]
        assert set(leaves) == set(want)
        dev = np.asarray(jmesh.devices)[tuple(
            coords[a] for a in jmesh.axis_names)]
        for k, arr in want.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(leaves[k], np.asarray(shard.data),
                                          err_msg=k)
        for n, (p, m) in res["restored_state"].items():
            spec = res["specs"][n]
            np.testing.assert_array_equal(
                p, block(np.asarray(want["params." + n]), spec,
                         res["restored"][0], coords), err_msg=n)
            np.testing.assert_array_equal(
                m, block(np.asarray(want["mu." + n]), spec,
                         res["restored"][0], coords), err_msg=n)


def test_mesh_state_saved_restores_onto_one_rank_bit_for_bit(world):
    for res in world:
        step, n_leaves, same = res["saved"]
        assert step == 2 and n_leaves > 20 and same


def test_make_placer_keeps_the_ranks_rows(world):
    """The rank's ("batch", "length") block of each of the ``accum``
    microbatches (the reference's step splits the global batch into
    them), on a data x tensor mesh and on a data x seq mesh with
    accum=2; `make_gpt_trainer`'s placer places the same blocks."""
    batch = _batches(512, True)[1]
    for res in world:
        for shape, coords, accum, placed, trainers in res["placed"]:
            for k, v in batch.items():
                mb = v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                want = block(mb, (None, ("data", "fsdp"), "seq"), shape,
                             coords)
                want = want.reshape((-1,) + want.shape[2:])
                np.testing.assert_array_equal(placed[k], want, err_msg=k)
                np.testing.assert_array_equal(trainers[k], want, err_msg=k)
            assert placed["inputs"].shape == (
                B // (shape["data"] * shape["fsdp"]), T // shape["seq"])


def test_mesh_of_one_is_the_single_card_trainer(world):
    (l0, p0), (l1, p1) = world[0]["one"]
    assert l0 == l1
    for k, v in _flat(p0).items():
        np.testing.assert_array_equal(v, _flat(p1)[k], err_msg=k)


def test_refusals_on_a_mesh(world):
    """On a data=2 x seq=2 mesh: `completion_logprobs` (its rows' block
    of positions, the log-probabilities gathered over seq) and
    `init_kv_cache` (whole rows on the seq ranks) construct; `loss_fn`
    slices tokens and refuses the split seq axis; the pipeline trainer
    refuses it."""
    for res in world:
        errs = res["refusals"]
        assert errs[0] is None and errs[3] is None, errs
        assert errs[1][0] == "ValueError" and "seq" in errs[1][1]
        assert errs[2][0] == "ValueError" and "seq=2" in errs[2][1]


def test_train_step_takes_an_optimizer_without_a_norm():
    """Off a mesh the step calls ``optimizer.update(grads, state,
    model)`` as before: `spmd.Adam` (no clip, no norm, the vision
    trainers' and the flywheel's optimizer) runs through it."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import spmd
    cfg = gpt.GPTConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                        d_ff=32, max_seq_len=16, dtype="float32")
    model = gpt.GPT(cfg, gpt.init_params(0, cfg, "cpu"), device="cpu",
                    dtype=torch.float32, trainable=True)
    opt = spmd.Adam(1e-2)
    state = spmd.TrainState(model, opt.init(model),
                            torch.zeros((), dtype=torch.int32))
    before = model.embed.detach().clone()
    step = spmd.make_train_step(lambda m, b: spmd.gpt_loss_fn(m, b), opt)
    toks = torch.randint(0, 64, (2, 9))
    state, m = step(state, {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    assert m["grad_norm"] is None and int(m["step"]) == 1
    assert not torch.equal(model.embed.detach(), before)
