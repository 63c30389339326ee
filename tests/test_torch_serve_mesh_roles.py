"""The rest of serving on a device mesh: int8 weights, the draft-model
proposer, and prefill/decode roles with the head-split handoff, the
port's `InferenceEngine(mesh=)` (one process per rank) against the JAX
package's engine on the same mesh (one process over the 8-device CPU
mesh of `tests/conftest.py`), f32 `gpt.small` params carried across by
the mesh-aware `params_from_numpy` (peaked: embed x 8, so near-ties
cannot flip a greedy argmax).

The JAX side runs in the parent, its engines in threads, while one
4-rank gloo world for the module (`test_torch_parallel.World`) runs the
port's; the JAX prefill engine's blobs are made first, since the ranks
import them. The JAX engines of the int8-weight cases serve the tree of
the reference's `quantize_params`, unplaced (``tree_shardings`` has no
axes for its scales), under ``weight_dtype="f32"``: the reference's
int8 engine quantizes under `jax.jit`, whose scales differ from the
function's by an ulp (XLA multiplies by the reciprocal of 127), enough
to flip int8 pool rows (ROADMAP C's oracle caveats); the port's
quantize is the function's, bit for bit. Meshes: ``data=2 x tensor=2``
(each rank 2 of the 4 heads, the data ranks repeat the step) and
``fsdp=2 x tensor=2`` (the int8 blocks split over both). Tolerances:
greedy tokens identical on every rank and to the JAX engine's,
logprobs within 1e-4, ``params_version`` tags equal. Cases:

- int8 weights, and int8 weights with an int8 pool, on ``data=2 x
  tensor=2``;
- int8 weights on ``fsdp=2 x tensor=2``: each rank's int8 and scale
  blocks equal the cut of `ray_tpu.models.gpt.quantize_params`'s tree
  bit for bit, at construction, after an `update_params` of f32 masters
  mid-stream (its tokens against JAX's), and after an `update_params`
  of the reference's int8 tree;
- the draft proposer with a 1-layer draft (the target's first layer, as
  `bench_infer.py`'s default);
- prefill -> decode roles on the mesh, plain, with the draft and with
  int8 weights and pool, against the JAX colocated engines;
- blobs in every direction: a single-card port blob into the mesh, a
  mesh blob into a single-card engine (a single-card export's layout,
  whole heads, and its values within 1e-5), a JAX mesh blob into the
  port's mesh;
- a rank given a different blob makes every rank raise
  `MeshDivergenceError`.

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
from test_torch_serve_mesh import (ENGINE, NEW, _drive, _peaked,  # noqa
                                   _traffic)

MESH = dict(data=2, tensor=2)
FSDP_MESH = dict(data=1, fsdp=2, tensor=2)
SPEC_K = 3
QUANTIZED = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
# cfg kwargs and engine kwargs ("draft": the 1-layer draft) by case
CASES = {
    "plain": ({}, {}),
    "int8_w": ({"weight_dtype": "int8"}, {}),
    "int8_w_kv": ({"weight_dtype": "int8", "kv_dtype": "int8"}, {}),
    "draft": ({}, {"spec": "draft", "spec_k": SPEC_K}),
}
# roles on the mesh, each against the JAX colocated case of its config
ROLES = ("plain", "int8_w_kv", "draft")


def _draft_tree(tree):
    return {**tree, "layers": {k: v[:1] for k, v in tree["layers"].items()}}


def _events(eng, rids):
    return [[(int(t), float(t.logprob), int(t.params_version))
             for t in eng.tokens_for(r)] for r in rids]


def _handoffs(pre):
    """Each prompt of the chunked/COW traffic through a prefill-role
    engine: its blob."""
    return [pre.handoff_for(pre.submit(p, max_new_tokens=NEW))
            for p, _ in _traffic("chunked_cow")]


def _decode(dec, blobs):
    rids = [dec.import_handoff(b) for b in blobs]
    dec.run_until_idle()
    out = _events(dec, rids)
    dec.check_invariants()
    return out


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _roles_jobs(rank, payload):
    import torch

    from ray_tpu_torch.exceptions import MeshDivergenceError
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.serve import InferenceEngine
    tree, swap_tree, jax_blobs, q_swap = payload
    meshes = {"dt": MeshSpec(**MESH).build(),
              "ft": MeshSpec(**FSDP_MESH).build()}
    out = {"coords": {k: (m.shape, m.coords) for k, m in meshes.items()}}

    def engine(case, mesh="dt", **kw):
        cfg_kw, eng_kw = CASES[case]
        cfg = gpt.small(dtype="float32", **cfg_kw)
        if eng_kw.get("spec") == "draft":
            dcfg = gpt.small(dtype="float32", n_layers=1)
            eng_kw = {**eng_kw, "draft_cfg": dcfg, "draft_params":
                      gpt.params_from_numpy(_draft_tree(tree), dcfg, "cpu")}
        return InferenceEngine(gpt.params_from_numpy(tree, cfg, "cpu"), cfg,
                               device="cpu", mesh=meshes.get(mesh),
                               **{**ENGINE, **eng_kw, **kw})

    for case in CASES:
        if case != "plain":
            eng = engine(case)
            outs, st = _drive(eng, "chunked_cow")
            out[("engine", case)] = (outs, {k: st[k] for k in (
                "decode_traces", "prefill_traces", "verify_traces",
                "draft_traces", "draft_prefill_traces", "quantize_traces",
                "captured")}, eng.model.layers["wq"].dtype == torch.int8)
    for case in ROLES:
        blobs = _handoffs(engine(case, role="prefill"))
        out[("roles", case)] = _decode(engine(case, role="decode"), blobs)
        if case == "plain":
            mesh_blobs = blobs

    # blobs across: one card -> mesh, mesh -> one card, JAX -> mesh
    single = _handoffs(engine("plain", mesh=None, role="prefill"))
    out["single_to_mesh"] = _decode(engine("plain", role="decode"), single)
    out["mesh_to_single"] = _decode(engine("plain", mesh=None,
                                           role="decode"), mesh_blobs)
    out["blob_gap"] = [
        (a["kv_host"].shape == b["kv_host"].shape,
         {n: (x.shape, x.dtype) for n, x in a["payload"][0].items()} ==
         {n: (x.shape, x.dtype) for n, x in b["payload"][0].items()},
         max(float(np.abs(x[n] - y[n]).max()) for x, y in zip(
             a["payload"], b["payload"]) for n in x))
        for a, b in zip(single, mesh_blobs)]
    out["jax_to_mesh"] = _decode(engine("plain", role="decode"), jax_blobs)

    # int8 weights on fsdp x tensor: the blocks at construction, after a
    # swap of f32 masters mid-stream, after a swap of an int8 tree
    eng = engine("int8_w", mesh="ft")

    def blocks():
        return {n: eng.model.layers[n].detach().numpy().copy()
                for n in eng.model.layers if n.startswith(QUANTIZED)}
    specs = {n: tuple(eng.model.specs["layers." + n])
             for n in eng.model.layers if n.startswith(QUANTIZED)}
    first = blocks()
    outs, st = _drive(eng, "swap", swap_tree)
    swapped = blocks()
    version = eng.update_params(q_swap)
    out["int8_fsdp"] = (specs, first, outs, swapped, blocks(), version,
                        st["quantize_traces"])

    # a rank given a different blob: every rank raises at the next tick
    dec = engine("plain", role="decode")
    blob = mesh_blobs[0]
    if rank == 1:
        host = blob["kv_host"].clone()
        host[0] += 1
        blob = {**blob, "kv_host": host}
    dec.import_handoff(blob)
    try:
        dec.run_until_idle()
        out["diverge"] = None
    except MeshDivergenceError as e:
        out["diverge"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The JAX prefill engine's blobs first (the ranks import them), then
    the ranks start and the JAX engines run meanwhile, each in a thread.
    Returns (the JAX side, the ranks' results)."""
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import MeshSpec, tree_shardings
    from ray_tpu.serve.engine import InferenceEngine as JaxEngine

    cfg0 = jgpt.small(dtype="float32")
    init = jax.jit(jgpt.init_params, static_argnums=1)
    tree, swap_tree = (_peaked(jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(seed), cfg0))) for seed in (0, 1))
    q_tree, q_swap = (jax.tree.map(np.asarray, jgpt.quantize_params(t))
                      for t in (tree, swap_tree))
    devs = jax.devices()[:4]
    meshes = {"dt": MeshSpec(**MESH).build(devs),
              "ft": MeshSpec(**FSDP_MESH).build(devs)}

    def placed(t, mesh="dt", cfg=cfg0):
        return jax.device_put(t, tree_shardings(
            meshes[mesh], jgpt.param_logical_axes(cfg)))

    def engine(case, mesh="dt", **kw):
        cfg_kw, eng_kw = CASES[case]
        params = placed(tree, mesh)
        if cfg_kw.get("weight_dtype") == "int8":
            # the function's int8 tree, which the port's quantize equals
            cfg_kw = {k: v for k, v in cfg_kw.items() if k != "weight_dtype"}
            params = q_tree
        cfg = jgpt.small(dtype="float32", **cfg_kw)
        if eng_kw.get("spec") == "draft":
            dcfg = jgpt.small(dtype="float32", n_layers=1)
            eng_kw = {**eng_kw, "draft_cfg": dcfg, "draft_params": placed(
                _draft_tree(tree), mesh, dcfg)}
        return JaxEngine(params, cfg, mesh=meshes[mesh],
                         **{**ENGINE, **eng_kw, **kw})

    jax_blobs = _handoffs(engine("plain", role="prefill"))
    world = World(__name__, "_roles_jobs", (tree, swap_tree, jax_blobs,
                                            q_swap))

    def serve(case):
        return _drive(engine(case), "chunked_cow")

    def swap():
        return _drive(engine("int8_w", "ft"), "swap", q_swap)

    jobs = {**{case: (lambda c=case: serve(c)) for case in CASES},
            "swap": swap}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        served = {k: f.result() for k, f in futs.items()}
    return dict(served=served, q_tree=q_tree, q_swap=q_swap), world.results()


@pytest.fixture(scope="module")
def jax_side(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world(runs):
    return runs[1]


def _same_stream(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [t for t, _, _ in g] == [t for t, _, _ in w]
        assert [v for _, _, v in g] == [v for _, _, v in w]
        np.testing.assert_allclose([lp for _, lp, _ in g],
                                   [lp for _, lp, _ in w], atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", [c for c in CASES if c != "plain"])
def test_engine_on_a_mesh_matches_jax(world, jax_side, case):
    want, jst = jax_side["served"][case]
    assert sum(len(o) for o in want) > 0
    for res in world:
        got, st, int8 = res[("engine", case)]
        _same_stream(got, want)
        for key, val in st.items():
            if key not in ("captured", "quantize_traces"):
                assert val == jst[key], (case, key)
        assert st["captured"] is False
        assert int8 == case.startswith("int8")
        assert st["quantize_traces"] == int(int8)
    if case == "draft":
        assert world[0][("engine", case)][1]["draft_traces"] == 1


@pytest.mark.parametrize("case", ROLES)
def test_prefill_decode_roles_on_a_mesh_match_jax(world, jax_side, case):
    """Each prompt prefilled on the mesh's prefill engine, its blob
    imported by the mesh's decode engine: the colocated JAX stream."""
    want = jax_side["served"][case][0]
    for res in world:
        _same_stream(res[("roles", case)], want)


@pytest.mark.parametrize("direction", ["single_to_mesh", "mesh_to_single",
                                       "jax_to_mesh"])
def test_blobs_cross_between_one_card_a_mesh_and_jax(world, jax_side,
                                                     direction):
    want = jax_side["served"]["plain"][0]
    for res in world:
        _same_stream(res[direction], want)


def test_mesh_blob_is_the_single_card_layout(world):
    """The mesh's export gathers every rank's heads: its ``kv_host`` has
    the single-card export's size, each block its entries' whole-head
    shapes, and the values agree within 1e-5 (the row-split products
    sum in another order)."""
    for res in world:
        for same_size, same_entries, gap in res["blob_gap"]:
            assert same_size and same_entries and gap <= 1e-5, gap


def test_int8_blocks_on_fsdp_and_tensor_are_the_reference_cut(world,
                                                              jax_side):
    """Each rank's int8 and scale blocks against its cut of the
    reference's `quantize_params` tree, bit for bit: at construction,
    after the f32 swap (the quantize on the mesh takes the absmax over
    the ranks that split each input axis) and after an int8 swap."""
    want_swap, _ = jax_side["served"]["swap"]
    q_tree, q_swap = jax_side["q_tree"], jax_side["q_swap"]
    for res in world:
        specs, first, outs, swapped, last, version, traces = \
            res["int8_fsdp"]
        shape, coords = res["coords"]["ft"]
        assert specs["wq"] == (None, "fsdp", "tensor")
        assert specs["wq_scale"] == (None, "tensor")
        assert specs["wo"] == (None, "tensor", "fsdp")
        assert specs["w_down_scale"] == (None, "fsdp")
        assert set(first) == set(specs) and len(first) == 14
        for got, tree in ((first, q_tree), (swapped, q_swap),
                          (last, q_swap)):
            for name, arr in got.items():
                want = block(tree["layers"][name], specs[name], shape,
                             coords)
                assert arr.dtype == want.dtype, name
                np.testing.assert_array_equal(arr, want, err_msg=name)
        _same_stream(outs, want_swap)
        assert version == 2 and traces == 1


def test_a_rank_given_another_blob_raises_on_every_rank(world):
    for res in world:
        msg = res["diverge"]
        assert msg is not None and "queue" in msg and "rank 1" in msg, msg
