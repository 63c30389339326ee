"""The port's parallelism layer (`ray_tpu_torch.parallel`, one process
per rank over `torch.distributed`) against the JAX package's
(`ray_tpu.parallel`, one process over the 8-device CPU mesh of
`tests/conftest.py`).

In-process: `MeshSpec.resolve` and its errors, `logical_to_spec` over the
reference's cases, `tree_shardings`, the multislice rank layout against
JAX's device ids, and the checkpoint spec helpers.

Across ranks: one 4-rank gloo world for the module (`run_world`, spawned
once; every mesh shape is built inside it, and each rank pickles its
blocks back to the parent). The JAX side runs in the parent on the same
numpy inputs, made from seeds; each rank's block is compared with its
slice of the JAX result. f32 tolerances: ring attention 2e-5 and its
q/k/v gradients 1e-4 (`tests/test_parallel.py`'s), the pipeline's
outputs and the gradients of x and of every stage's parameters 1e-5, the
GPipe trainer's 3 losses on data=2 x pipe=2 1e-5, the vocab-sharded loss
1e-4 and its dx, dE 1e-3 (`tests/test_fused_xent.py`'s).

This module imports no JAX at its top: the spawned ranks import it to
find their entry point, and run the port alone.
"""

import datetime
import importlib
import multiprocessing as mp
import os
import pickle
import sys
import tempfile

import numpy as np
import pytest
import torch

WORLD = 4
WORLD_TIMEOUT_S = 150


# ---------------------------------------------------------------------------
# the 4-rank world
# ---------------------------------------------------------------------------

def _world_main(rank, n, store, out_dir, module, target, payload):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=90))
    try:
        res = getattr(importlib.import_module(module), target)(rank, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


class World:
    """``n`` ranks of a gloo world on the CPU, spawned at construction;
    rank r runs ``module.target(r, payload)``. `results` waits for them
    and returns each rank's result, in rank order; a rank that fails or
    outlives `WORLD_TIMEOUT_S` fails it (every rank is stopped)."""

    def __init__(self, module: str, target: str, payload, n: int = WORLD):
        self.tmp = tempfile.TemporaryDirectory(prefix="torch_world_")
        store = os.path.join(self.tmp.name, "store")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_world_main, args=(
            r, n, store, self.tmp.name, module, target, payload))
            for r in range(n)]
        for p in self.procs:
            p.start()

    def results(self) -> list:
        try:
            for p in self.procs:
                p.join(WORLD_TIMEOUT_S)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        try:
            codes = [p.exitcode for p in self.procs]
            assert codes == [0] * len(codes), f"rank exit codes {codes}"
            out = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.tmp.name, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.tmp.cleanup()


def run_world(module: str, target: str, payload, n: int = WORLD) -> list:
    """`World` started and waited for."""
    return World(module, target, payload, n).results()


def block(arr, spec, shape: dict, coords: dict):
    """The block of the whole numpy ``arr`` that a rank at ``coords`` of a
    mesh of ``shape`` holds under ``spec`` (the test's own slicing)."""
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in axes:
            n *= shape[a]
            idx = idx * shape[a] + coords[a]
        size = arr.shape[i] // n
        arr = np.take(arr, np.arange(idx * size, (idx + 1) * size), axis=i)
    return arr


# ---------------------------------------------------------------------------
# inputs (the same seeds on both sides)
# ---------------------------------------------------------------------------

XENT_MESHES = {"tensor4": dict(data=1, tensor=4),
               "data2_tensor2": dict(data=2, tensor=2),
               "fsdp2_tensor2": dict(data=1, fsdp=2, tensor=2)}
X_SPEC = (("data", "fsdp"), "seq", None)
T_SPEC = (("data", "fsdp"), "seq")
E_SPEC = ("tensor", None)
# (mesh kwargs, recorded spec, shape) for valid_spec_for
VALID_CASES = [
    (dict(data=2, fsdp=2), ["data", None], (8, 3)),
    (dict(data=2, fsdp=2), [["data", "fsdp"], None], (8, 3)),
    (dict(data=2, fsdp=2), [["data", "fsdp"], None], (6, 3)),
    (dict(data=1, fsdp=4), ["fsdp", "fsdp"], (8, 8)),
    (dict(data=4), [None, "tensor"], (4, 4)),
    (dict(data=2, tensor=2), ["tensor", "missing"], (2, 4)),
    (dict(data=1, seq=4), ["seq"], (3,)),
]


def _ring_inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
            for _ in range(4)]


def _pipe_inputs():
    rng = np.random.default_rng(2)
    d = 16
    ws = [(rng.standard_normal((d, d)) * 0.1).astype(np.float32)
          for _ in range(4)]
    x = rng.standard_normal((8, d)).astype(np.float32)
    ct = rng.standard_normal((8, d)).astype(np.float32)
    return ws, x, ct


def _xent_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    emb = (rng.standard_normal((512, 64)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, 512, (4, 16)).astype(np.int32)
    return x, emb, tgt


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _optimizer(spmd):
    return spmd.default_optimizer(learning_rate=1e-4, warmup_steps=0)


def _pipe_batch(vocab):
    toks = np.random.default_rng(3).integers(0, vocab, (4, 33)).astype(
        np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _parallel_jobs(rank, payload):
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import fused_xent as fx
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.parallel import (MeshSpec, PartitionSpec as P,
                                        collectives as col, local_shard,
                                        pipeline_apply, ring_attention,
                                        sharding)
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    # ring attention at seq=4
    mesh = MeshSpec(data=1, seq=4).build()
    q, k, v, ct = _ring_inputs()
    spec = P(None, "seq")
    for causal in (False, True):
        ql, kl, vl = (local_shard(t(a), spec, mesh).requires_grad_()
                      for a in (q, k, v))
        o = ring_attention(ql, kl, vl, mesh, causal=causal)
        (o * local_shard(t(ct), spec, mesh)).sum().backward()
        out[("ring", causal)] = (mesh.shape, mesh.coords, o.detach().numpy(),
                                 ql.grad.numpy(), kl.grad.numpy(),
                                 vl.grad.numpy())

    # the pipeline at pipe=4
    mesh = MeshSpec(data=1, pipe=4).build()
    ws, x, ct = _pipe_inputs()
    params = [{"w": t(w).requires_grad_()} for w in ws]
    xt = t(x).requires_grad_()
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), params, xt,
                       mesh=mesh, num_microbatches=4)
    (y * t(ct)).sum().backward()
    s = mesh.axis_index("pipe")
    out["pipe"] = (s, y.detach().numpy(), xt.grad.numpy(),
                   params[s]["w"].grad.numpy())

    # the GPipe trainer on data=2 x pipe=2 from the JAX params
    mesh = MeshSpec(data=2, pipe=2).build()
    cfg = gpt.small(dtype="float32", attn_impl="xla")
    opt = _optimizer(spmd)
    _, step, place = spmd.make_gpt_pipeline_trainer(
        cfg, mesh, num_microbatches=2, optimizer=opt, device="cpu")
    state = spmd.create_sharded_state(
        lambda d: gpt.GPT(cfg, payload, device=d, dtype=torch.float32,
                          trainable=True, mesh=mesh,
                          logical_axes=spmd.pipeline_logical_axes(cfg)),
        opt, "cpu")
    b = _pipe_batch(cfg.vocab_size)
    out["pipe_trainer"] = [float(step(state, place(b))[1]["loss"])
                           for _ in range(3)]

    # the vocab-sharded fused loss
    x, emb, tgt = _xent_inputs()
    for name, kw in XENT_MESHES.items():
        mesh = MeshSpec(**kw).build()
        xs = local_shard(t(x), P(*X_SPEC), mesh).requires_grad_()
        es = local_shard(t(emb), P(*E_SPEC), mesh).requires_grad_()
        ts = local_shard(t(tgt), P(*T_SPEC), mesh)
        nll = fx.fused_softmax_xent(xs, es, ts, vocab_chunk=128, mesh=mesh)
        (nll.sum() / tgt.size).backward()
        v_loc = es.shape[0]
        base = mesh.axis_index("tensor") * v_loc
        outside = (int((ts < base).sum()), int((ts >= base + v_loc).sum()))
        out[("xent", name)] = (mesh.shape, mesh.coords, nll.detach().numpy(),
                               xs.grad.numpy(), es.grad.numpy(), outside)

    # valid_spec_for on meshes of this world
    for i, (kw, spec, shape) in enumerate(VALID_CASES):
        mesh = MeshSpec(**kw).build()
        out[("valid", i)] = sharding.spec_to_json(sharding.valid_spec_for(
            mesh, sharding.spec_from_json(spec), shape))

    # the collectives' layout over two axes: gather, scatter, index, psum
    mesh = MeshSpec(data=2, tensor=2).build()
    me = torch.full((2,), float(rank))
    out["collectives"] = dict(
        coords=mesh.coords,
        index=(mesh.axis_index(("data", "tensor")),
               mesh.axis_index(("tensor", "data"))),
        gather=col.all_gather(me, ("data", "tensor"), mesh).numpy(),
        gather_t=col.all_gather(me, ("tensor", "data"), mesh).numpy(),
        scatter=col.reduce_scatter(torch.arange(8.0) * (rank + 1),
                                   ("data", "tensor"), mesh).numpy(),
        psum=float(col.psum(torch.tensor(float(rank)), "data", mesh)),
        pmax=float(col.pmax(torch.tensor(float(rank)), "tensor", mesh)),
        ppermute=col.ppermute(me, "data", mesh, [(0, 1)]).numpy(),
        size=col.psum(1, ("data", "tensor"), mesh),
        multislice=MeshSpec(data=2, seq=2).multislice_rank_array(2).tolist())
    return out


# ---------------------------------------------------------------------------
# the parent's side: the JAX results
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The ranks start first; the JAX side runs while they do."""
    import jax

    from ray_tpu.models import gpt as jgpt
    cfg = jgpt.small(dtype="float32", attn_impl="xla")
    pipe_tree = jax.tree.map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(0), cfg))
    world = World(__name__, "_parallel_jobs", pipe_tree)
    return _jax_side(pipe_tree), world.results()


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world(runs):
    return runs[1]


def _jax_side(pipe_tree):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.ops.fused_xent import fused_softmax_xent
    from ray_tpu.parallel import MeshSpec, pipeline_apply, ring_attention
    from ray_tpu.train import spmd as jspmd

    devs = jax.devices()[:WORLD]
    ref = {}
    q, k, v, ct = _ring_inputs()
    mesh = MeshSpec(data=1, seq=4).build(devs)
    for causal in (False, True):
        def f(q, k, v, causal=causal):
            return ring_attention(q, k, v, mesh, causal=causal)
        out = jax.jit(f)(q, k, v)
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * ct),
                                 argnums=(0, 1, 2)))(q, k, v)
        ref[("ring", causal)] = (np.asarray(out),
                                 *(np.asarray(g) for g in grads))

    ws, x, ct = _pipe_inputs()
    mesh = MeshSpec(data=1, pipe=4).build(devs)

    def pipe(ws, x):
        return pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"]),
                              [{"w": w} for w in ws], x, mesh=mesh,
                              num_microbatches=4)
    gw, gx = jax.jit(jax.grad(lambda ws, x: jnp.sum(pipe(ws, x) * ct),
                              argnums=(0, 1)))(ws, x)
    ref["pipe"] = (np.asarray(jax.jit(pipe)(ws, x)), np.asarray(gx),
                   [np.asarray(g) for g in gw])

    x, emb, tgt = _xent_inputs()
    for name, kw in XENT_MESHES.items():
        mesh = MeshSpec(**kw).build(devs)

        def nll(x, e, mesh=mesh):
            return fused_softmax_xent(x, e, tgt, vocab_chunk=128, mesh=mesh)
        grads = jax.jit(jax.grad(lambda x, e: nll(x, e).mean(),
                                 argnums=(0, 1)))(x, emb)
        ref[("xent", name)] = (np.asarray(jax.jit(nll)(x, emb)),
                               *(np.asarray(g) for g in grads))

    # the GPipe trainer, from the params the ranks were given
    mesh = MeshSpec(data=2, pipe=2).build(devs)
    cfg = jgpt.small(dtype="float32", attn_impl="xla")
    state, step_fn, shard = jspmd.make_gpt_pipeline_trainer(
        cfg, mesh, num_microbatches=2, optimizer=_optimizer(jspmd))
    params = jax.tree.map(lambda a, b: jax.device_put(b, a.sharding),
                          state.params, pipe_tree)
    state = jspmd.TrainState(params, state.opt_state, state.step)
    b = _pipe_batch(cfg.vocab_size)
    ref["pipe_trainer"] = []
    for _ in range(3):
        state, m = step_fn(state, shard(b))
        ref["pipe_trainer"].append(float(m["loss"]))
    return ref


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,n", [
    (dict(data=-1, tensor=2), 8), (dict(data=2, fsdp=2, tensor=2), 8),
    (dict(data=-1, pipe=2, seq=2), 4), (dict(data=3), 8),
    (dict(data=-1, tensor=-1), 8), (dict(data=-1, tensor=3), 8)])
def test_mesh_spec_resolve_matches_reference(kw, n):
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu_torch.parallel import MeshSpec
    try:
        want = JMeshSpec(**kw).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshSpec(**kw).resolve(n)
        assert str(got.value) == str(e)
        return
    assert MeshSpec(**kw).resolve(n) == want


LOGICAL_CASES = [
    ("batch", "length", "embed"), ("mlp", "embed"), ("embed", "mlp"),
    ("vocab", "embed"), (None, "heads", "embed"), ("batch", "batch"),
    ("expert", "embed", "mlp"), ("stage", None), ("kv",), ()]


@pytest.mark.parametrize("axes", LOGICAL_CASES)
@pytest.mark.parametrize("rules", [None, {"batch": "data",
                                          "embed": ("fsdp", "tensor"),
                                          "mlp": "tensor"}])
def test_logical_to_spec_matches_reference(axes, rules):
    from ray_tpu.parallel import logical_to_spec as jl
    from ray_tpu_torch.parallel import logical_to_spec
    assert tuple(logical_to_spec(axes, rules)) == tuple(jl(axes, rules))


def test_logical_to_spec_on_a_mesh_and_tree_shardings():
    """The reference's cases (`tests/test_parallel.py`): fsdp consumed by
    batch, mlp -> tensor; `tree_shardings` gives specs."""
    from ray_tpu_torch.parallel import (MeshSpec, PartitionSpec as P,
                                        logical_to_spec, tree_shardings)
    spec = logical_to_spec(("batch", "length", "embed"))
    assert spec == P(("data", "fsdp"), "seq", None)
    mesh = MeshSpec(data=1).build([0])
    assert logical_to_spec(("mlp", "embed"), mesh=mesh) == P("tensor", "fsdp")
    sh = tree_shardings(mesh, {"w": ("embed", "mlp"), "b": ("mlp",)})
    assert sh == {"w": P("fsdp", "tensor"), "b": P("tensor")}


@pytest.mark.parametrize("kw,slices,n", [
    (dict(data=4, seq=2), 2, 8), (dict(data=2, fsdp=2, tensor=2), 2, 8),
    (dict(data=1, pipe=2, tensor=4), 2, 8), (dict(data=4), 4, 4),
    (dict(data=3, tensor=2), 2, 6)])
def test_multislice_rank_map_matches_jax_device_ids(kw, slices, n):
    import jax

    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu_torch.parallel import MeshSpec
    devs = jax.devices()[:n]
    try:
        want = np.vectorize(lambda d: d.id)(np.asarray(
            JMeshSpec(**kw).build_multislice(slices, devs).devices))
    except ValueError as e:
        with pytest.raises(ValueError, match="slices"):
            MeshSpec(**kw).multislice_rank_array(slices, range(n))
        assert "slices" in str(e)
        return
    got = MeshSpec(**kw).multislice_rank_array(slices, range(n))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", [(), (None,), ("data", None),
                                  (("data", "fsdp"), "seq", None),
                                  (None, ("tensor",))])
def test_spec_json_roundtrip_matches_reference(spec):
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.parallel import sharding as js
    from ray_tpu_torch.parallel import sharding as ts
    assert ts.spec_to_json(ts.PartitionSpec(*spec)) == \
        js.spec_to_json(JP(*spec))
    entries = js.spec_to_json(JP(*spec))
    assert tuple(ts.spec_from_json(entries)) == \
        tuple(js.spec_from_json(entries))


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(VALID_CASES)))
def test_valid_spec_for_matches_reference(world, i):
    import jax

    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import sharding as js
    kw, spec, shape = VALID_CASES[i]
    mesh = JMeshSpec(**kw).build(jax.devices()[:WORLD])
    want = js.spec_to_json(js.valid_spec_for(mesh, js.spec_from_json(spec),
                                             shape))
    for res in world:
        assert res[("valid", i)] == want


def test_collectives_layout_over_two_axes(world):
    """all_gather / reduce_scatter / axis_index order ranks row-major over
    the axes as given, psum/pmax reduce over one axis, ppermute delivers
    along pairs (zeros elsewhere)."""
    for rank, res in enumerate(world):
        c = res["collectives"]
        d, t = c["coords"]["data"], c["coords"]["tensor"]
        assert rank == 2 * d + t
        assert c["index"] == (2 * d + t, 2 * t + d)
        np.testing.assert_array_equal(c["gather"],
                                      np.repeat(np.arange(4.0), 2))
        np.testing.assert_array_equal(
            c["gather_t"], np.repeat(np.array([0.0, 2.0, 1.0, 3.0]), 2))
        np.testing.assert_array_equal(
            c["scatter"], np.arange(8.0)[2 * rank:2 * rank + 2] * 10)
        assert c["psum"] == t + (2 + t)
        assert c["pmax"] == 2 * d + 1
        np.testing.assert_array_equal(
            c["ppermute"], np.full(2, float(t)) if d == 1 else np.zeros(2))
        assert c["size"] == 4
        assert c["multislice"] == np.arange(4).reshape(
            1, 2, 1, 2, 1, 1).tolist()


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(world, jax_ref, causal):
    ref = jax_ref[("ring", causal)]
    for res in world:
        shape, coords, out = res[("ring", causal)][:3]
        np.testing.assert_allclose(
            out, block(ref[0], (None, "seq"), shape, coords), atol=2e-5,
            rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grads_match_jax(world, jax_ref, causal):
    ref = jax_ref[("ring", causal)]
    for res in world:
        shape, coords = res[("ring", causal)][:2]
        for got, want in zip(res[("ring", causal)][3:], ref[1:]):
            np.testing.assert_allclose(
                got, block(want, (None, "seq"), shape, coords), atol=1e-4,
                rtol=0)


def test_pipeline_outputs_match_jax(world, jax_ref):
    out, _, _ = jax_ref["pipe"]
    for res in world:
        np.testing.assert_allclose(res["pipe"][1], out, atol=1e-5, rtol=0)


def test_pipeline_trainer_matches_jax(world, jax_ref):
    """`make_gpt_pipeline_trainer` on data=2 x pipe=2, 2 microbatches,
    from the same params: 3 losses within 1e-5."""
    for res in world:
        np.testing.assert_allclose(res["pipe_trainer"],
                                   jax_ref["pipe_trainer"], atol=1e-5,
                                   rtol=0)


def test_pipeline_grads_match_jax(world, jax_ref):
    """dx on every stage, and each stage's own dW."""
    _, gx, gw = jax_ref["pipe"]
    for res in world:
        s, _, dx, dw = res["pipe"]
        np.testing.assert_allclose(dx, gx, atol=1e-5, rtol=0)
        np.testing.assert_allclose(dw, gw[s], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(XENT_MESHES))
def test_vocab_sharded_xent_matches_jax(world, jax_ref, name):
    """Every rank's nll, dx and dE blocks; each vocabulary shard sees
    target ids below and above it (the shifted ids fall outside
    [0, V / n) on both sides)."""
    nll, dx, de = jax_ref[("xent", name)]
    below = above = 0
    for res in world:
        shape, coords, got_nll, got_dx, got_de, outside = res[("xent", name)]
        np.testing.assert_allclose(got_nll, block(nll, T_SPEC, shape, coords),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got_dx, block(dx, X_SPEC, shape, coords),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(got_de, block(de, E_SPEC, shape, coords),
                                   atol=1e-3, rtol=0)
        below += outside[0]
        above += outside[1]
    assert below > 0 and above > 0


def test_mesh_refusals():
    """A mesh of several ranks needs a process group; a rank twice, or an
    unknown axis, raises."""
    from ray_tpu_torch.parallel import Mesh, MeshSpec, single_device_mesh
    with pytest.raises(RuntimeError, match="torch.distributed"):
        MeshSpec(data=2).build([0, 1])
    with pytest.raises(ValueError, match="twice"):
        Mesh(np.zeros((1, 2, 1, 1, 1, 1), np.int64))
    mesh = single_device_mesh()
    assert mesh.size == 1 and mesh.axis_index("data") == 0
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.live_axes("model")


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
