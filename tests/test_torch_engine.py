"""The port's InferenceEngine (`ray_tpu_torch.serve.engine`, on the CPU)
against the JAX package's on the same traffic, with JAX-initialised
params carried across: more requests than slots, a shared prefix that
ends mid-block (radix hit + copy-on-write), prompts longer than the
prefill chunk, then cancellation and sampling on the port alone.

Params are peaked (embed x 8, `tests/test_paged_cache.py::_peaked`): the
tiny random model's logits are otherwise near-uniform, and greedy
token identity needs a decisive argmax. Greedy tokens must be identical;
logprobs agree to 1e-4 (f32, summation order only)."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.engine import InferenceEngine as JaxEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import InferenceEngine, TokenEvent

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64, dtype="float32")
ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=8,
              prefill_chunk=8)


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt.GPTConfig(**CFG)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    params = {**params, "embed": params["embed"] * 8}
    return jax.tree.map(np.asarray, params)


def _port(tree, **kw):
    cfg = tgpt.GPTConfig(**CFG)
    model = tgpt.params_from_numpy(tree, cfg, device="cpu")
    return InferenceEngine(model, cfg, device="cpu", **{**ENGINE, **kw})


def _traffic():
    """Five requests for two slots: B shares A's first 12 tokens (a match
    ending mid-block, so B's admission copies the shared block), B and C
    run past the 8-token prefill chunk."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 128, 12)
    return [np.concatenate([prefix, rng.integers(0, 128, 4)]),
            np.concatenate([prefix, rng.integers(0, 128, 6)]),
            rng.integers(0, 128, 20), rng.integers(0, 128, 5),
            rng.integers(0, 128, 9)]


def _run(eng, prompts, max_new=6):
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    outs = [list(eng.tokens_for(r)) for r in rids]
    eng.check_invariants()
    return outs


def test_greedy_tokens_identical_to_jax_engine(tree):
    jeng = JaxEngine(jax.tree.map(jax.numpy.asarray, tree),
                     jgpt.GPTConfig(**CFG), **ENGINE)
    teng = _port(tree)
    launches = teng.stats()["kernel_launches"]
    prompts = _traffic()
    jouts = _run(jeng, prompts)
    touts = _run(teng, prompts)
    for j, t in zip(jouts, touts):
        assert [int(x) for x in t] == [int(x) for x in j]
        assert all(isinstance(x, TokenEvent) for x in t)
        np.testing.assert_allclose([x.logprob for x in t],
                                   [x.logprob for x in j], atol=1e-4,
                                   rtol=0)
    js, ts = jeng.stats(), teng.stats()
    assert ts["prefix_hit_tokens"] > 0 and ts["cow_copies"] > 0
    for key in ("prefix_hit_tokens", "cow_copies", "prefill_tokens",
                "prefill_chunks", "decode_tokens", "decode_steps"):
        assert ts[key] == js[key], key
    assert ts["blocks_in_use"] == ts["cached_prefix_blocks"]
    # CPU tensors take the plain path: no kernel ran
    assert ts["kernel_launches"] == launches


@pytest.mark.parametrize("block_size", [24, 64])
def test_block_sizes_off_the_kernel_list_at_head_dim_96_match_jax(
        block_size):
    """Pool blocks of 24 and 64 (the multi-query kernel sees them as
    blocks of 8 and 32) under a model with head dim 96, prompts of up to
    90 tokens in 32-token chunks: greedy tokens identical to the JAX
    engine's, logprobs to 1e-4."""
    cfg_kw = dict(vocab_size=128, d_model=96, n_layers=2, n_heads=1,
                  d_ff=64, max_seq_len=160, dtype="float32")
    eng_kw = dict(slots=2, max_len=144, prefill_buckets=(16, 32),
                  block_size=block_size, prefill_chunk=32)
    jcfg = jgpt.GPTConfig(**cfg_kw)
    params = jgpt.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray,
                        {**params, "embed": params["embed"] * 8})
    tcfg = tgpt.GPTConfig(**cfg_kw)
    assert tcfg.head_dim == 96
    teng = InferenceEngine(tgpt.params_from_numpy(tree, tcfg, device="cpu"),
                           tcfg, device="cpu", **eng_kw)
    jeng = JaxEngine(jax.tree.map(jax.numpy.asarray, tree), jcfg, **eng_kw)
    rng = np.random.default_rng(block_size)
    prefix = rng.integers(0, 128, 50)
    prompts = [np.concatenate([prefix, rng.integers(0, 128, 40)]),
               np.concatenate([prefix, rng.integers(0, 128, 20)]),
               rng.integers(0, 128, 33), rng.integers(0, 128, 7)]
    jouts = _run(jeng, prompts)
    touts = _run(teng, prompts)
    for j, t in zip(jouts, touts):
        assert [int(x) for x in t] == [int(x) for x in j]
        np.testing.assert_allclose([x.logprob for x in t],
                                   [x.logprob for x in j], atol=1e-4,
                                   rtol=0)
    assert teng.stats()["prefill_chunks"] == jeng.stats()["prefill_chunks"]


def test_cancel_mid_decode_releases_blocks(tree):
    eng = _port(tree)
    keep, drop = [eng.submit(p, max_new_tokens=8) for p in _traffic()[2:4]]
    for _ in range(6):
        eng.step()
    assert all(s.phase == "decode" for s in eng._slots)
    dropped = list(eng._slots[1].blocks)
    assert eng.cancel(drop)
    eng.check_invariants()     # every refcount == its holders
    assert eng._slots[1].phase == "idle"
    # its private decode blocks are free again; its full prompt blocks
    # stay cached in the radix tree
    assert any(eng._alloc.refcount(b) == 0 for b in dropped)
    assert not eng.cancel(drop)
    assert len(list(eng.tokens_for(keep))) == 8
    eng.check_invariants()
    eng._tree.clear()
    assert eng.stats()["blocks_in_use"] == 0
    # an abandoned stream cancels itself
    gen = eng.tokens_for(eng.submit(_traffic()[4], max_new_tokens=8))
    next(gen)
    gen.close()
    eng.check_invariants()
    assert eng.stats()["active"] == 0 and eng.stats()["cancelled"] == 2


def test_sampling_is_seeded_and_scored(tree):
    """Temperature sampling draws from the engine's own generator: the
    same seed gives the same tokens, and each token carries its natural
    (temperature-1) logprob."""
    prompts = _traffic()[2:4]
    runs = []
    for _ in range(2):
        eng = _port(tree, seed=5)
        rids = [eng.submit(p, max_new_tokens=6, temperature=1.5)
                for p in prompts]
        eng.run_until_idle()
        runs.append([list(eng.tokens_for(r)) for r in rids])
        eng.check_invariants()
    assert runs[0] == runs[1]
    lps = [t.logprob for out in runs[0] for t in out]
    assert all(np.isfinite(lps)) and max(lps) <= 0.0


def test_unported_features_refuse(tree):
    # disaggregated serving is ported: the roles construct, an unknown
    # one raises as the reference does
    assert _port(tree, role="prefill").role == "prefill"
    with pytest.raises(ValueError, match="unknown engine role 'bogus'"):
        _port(tree, role="bogus")
    # the flight recorder is ported: telemetry_sample constructs; device
    # meshes are ported: a mesh of one rank serves as no mesh, bit for
    # bit (the multi-rank cases and the refusals that stay, ROADMAP
    # A6 (c), are tests/test_torch_serve_mesh.py's); a mesh must be one
    assert _port(tree, telemetry_sample=0.5)._recorder.sample == 0.5
    from ray_tpu_torch.parallel import single_device_mesh
    one = _port(tree, mesh=single_device_mesh())
    assert one.mesh is None and one.stats()["mesh"] is None
    prompts = _traffic()[:3]
    assert [[(int(t), t.logprob) for t in o] for o in _run(one, prompts)] \
        == [[(int(t), t.logprob) for t in o]
            for o in _run(_port(tree), prompts)]
    with pytest.raises(TypeError, match="parallel.Mesh"):
        _port(tree, mesh=object())
    with pytest.raises(TypeError, match="bogus"):
        _port(tree, bogus=1)
    eng = _port(tree)
    # priority classes are ported: a class in range is queued, one
    # outside [0, priority_classes) raises
    rid = eng.submit([1, 2, 3], priority=1)
    assert eng.stats()["per_class"]["1"]["pending"] == 1
    assert eng.cancel(rid)
    with pytest.raises(ValueError, match=r"priority 3 outside \[0, 3\)"):
        eng.submit([1, 2, 3], priority=3)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(30), max_new_tokens=8)
    assert torch.equal(eng.cache["k"], torch.zeros_like(eng.cache["k"]))
