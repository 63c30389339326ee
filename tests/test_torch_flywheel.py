"""The RL flywheel in the port (`ray_tpu_torch.rl`, `models.gpt.
completion_logprobs`, `train.spmd.Adam`, `rllib.rollout`) against the JAX
package, on the CPU, at the JAX flywheel tests' tiny float32 config
(vocab 128, d_model 32, 2 layers, 2 heads) with the JAX weights carried
across by `params_from_numpy`. The JAX references are computed once per
module.

- `completion_logprobs` within 1e-5 of the JAX function, its parameter
  gradients within 1e-4, and ``mesh=`` refused;
- the learner's step against the JAX flywheel's jitted ``step_fn`` with
  ``optax.adam`` on one fixed batch: loss, the three metrics and the
  updated params within 1e-5, with ``clip=0.2`` and ``clip=None``;
- the engine's emitted logprobs against `completion_logprobs` on the
  decode, verify and chunked-prefill paths (1e-4), as
  `tests/test_flywheel.py` pins them in the JAX package;
- `EngineSampler` on greedy peaked traffic (embed x 8) identical to the
  JAX sampler's, across a weight swap;
- `TokenEnvRunner`, `make_env_runner("engine")`, an unknown backend and
  ``backend=None`` (refused, ROADMAP A8);
- the engine's weights untouched by a learner step until the publish;
- `tests/test_flywheel.py::test_flywheel_e2e_smoke` on the port: the
  reward rises, 12 swaps, nothing rebuilt, the ``publish_to`` fan-out,
  post-swap greedy tokens identical to a fresh engine's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.rl import flywheel as jfly
from ray_tpu.rl import sampler as jsampler
from ray_tpu.serve.engine import InferenceEngine as JaxEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.rl.flywheel import (FlywheelLoop, make_learner_step,
                                       motif_reward)
from ray_tpu_torch.rl.sampler import (MASK, PARAMS_VERSION, START, TOKENS,
                                      EngineSampler, TokenEnvRunner)
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.rollout import make_env_runner
from ray_tpu_torch.serve import InferenceEngine
from ray_tpu_torch.train import spmd

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=64, dtype="float32")
ENGINE = dict(slots=2, max_len=32, prefill_buckets=(8, 16), block_size=8)
B, T, W = 4, 16, 6


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """JAX params (seed 0 and 1) as host trees, and their peaked
    (embed x 8) copies."""
    cfg = jgpt.GPTConfig(**CFG)
    out = {}
    for seed in (0, 1):
        t = _host(jgpt.init_params(jax.random.PRNGKey(seed), cfg))
        out[seed] = t
        out[f"peaked{seed}"] = {**t, "embed": t["embed"] * 8}
    return out


def _model(tree, trainable=False):
    return tgpt.params_from_numpy(tree, tgpt.GPTConfig(**CFG), device="cpu",
                                  dtype=torch.float32, trainable=trainable)


def _grad_tree(model) -> dict:
    return {"embed": model.embed.grad, "pos_embed": model.pos_embed.grad,
            "final_ln_scale": model.final_ln_scale.grad,
            "layers": {k: v.grad for k, v in model.layers.items()}}


def _close_trees(got, want, atol):
    for k, v in want.items():
        if isinstance(v, dict):
            _close_trees(got[k], v, atol)
        else:
            np.testing.assert_allclose(
                got[k].detach().numpy() if isinstance(got[k], torch.Tensor)
                else got[k], np.asarray(v), atol=atol, rtol=0, err_msg=k)


def _batch(tree, seed=0):
    """A fixed learner batch: random sequences, ragged starts (one window
    running past T), behaviour logprobs near the JAX recompute (some
    ratios beyond the clip range), a ragged mask and advantages."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    start = np.array([3, 5, 8, 12], np.int32)
    lp = np.asarray(jgpt.completion_logprobs(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens),
        jnp.asarray(start), W, jgpt.GPTConfig(**CFG)))
    mask = np.ones((B, W), np.float32)
    mask[1, 4:] = 0.0
    mask[3, 4:] = 0.0                         # start 12 + 4 = T
    return {"tokens": tokens, "start": start,
            "behavior_logp": (lp + rng.normal(0, 0.3, lp.shape)
                              ).astype(np.float32),
            "mask": mask,
            "advantage": rng.normal(0, 1, (B,)).astype(np.float32)}


# ---------------------------------------------------------------------------
# completion_logprobs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_logprobs(trees):
    """The JAX function's values and its parameter gradients of a fixed
    weighted sum of them."""
    cfg = jgpt.GPTConfig(**CFG)
    b = _batch(trees[0])
    wsum = np.random.default_rng(5).normal(0, 1, (B, W)).astype(np.float32)

    def f(p):
        lp = jgpt.completion_logprobs(p, jnp.asarray(b["tokens"]),
                                      jnp.asarray(b["start"]), W, cfg)
        return (lp * wsum).sum(), lp

    (_, lp), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, trees[0]))
    return b, wsum, np.asarray(lp), _host(grads)


def test_completion_logprobs_match_jax(trees, jax_logprobs):
    b, wsum, want, want_grads = jax_logprobs
    model = _model(trees[0], trainable=True)
    lp = tgpt.completion_logprobs(model, torch.from_numpy(b["tokens"]),
                                  torch.from_numpy(b["start"]), W)
    assert lp.shape == (B, W) and lp.dtype == torch.float32
    np.testing.assert_allclose(lp.detach().numpy(), want, atol=1e-5, rtol=0)
    (lp * torch.from_numpy(wsum)).sum().backward()
    _close_trees(_grad_tree(model), want_grads, atol=1e-4)


def test_completion_logprobs_refuses_a_mesh(trees):
    """``mesh=`` is ported: a mesh of one rank is the single-card
    function, bit for bit; a mesh the model was not built on raises (the
    multi-rank cases, the seq split among them, are
    tests/test_torch_rl_moe_mesh.py's and tests/test_torch_mesh_axes.py's)."""
    from ray_tpu_torch.parallel import single_device_mesh
    model = _model(trees[0])
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG["vocab_size"], (2, 8)).astype(np.int32))
    start = torch.tensor([1, 3], dtype=torch.int32)
    want = tgpt.completion_logprobs(model, toks, start, 4)
    got = tgpt.completion_logprobs(model, toks, start, 4,
                                   mesh=single_device_mesh())
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the learner's step against the JAX flywheel's step_fn with optax.adam
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(trees):
    """One JAX flywheel step per clip setting on the same batch: the
    loss, the metrics and the updated params (host)."""
    cfg = jgpt.GPTConfig(**CFG)
    batch = _batch(trees[0], seed=1)
    out = {}
    for clip in (0.2, None):
        fly = jfly.FlywheelLoop(
            cfg, lambda rng: [1, 2, 3], motif_reward(7),
            params=jax.tree.map(jnp.asarray, trees[0]), lr=1e-2, clip=clip,
            max_new_tokens=W, pad_to=T, engine_kwargs=ENGINE)
        state, metrics = fly._step(fly.state,
                                   jax.tree.map(jnp.asarray, batch))
        out[clip] = (_host(metrics), _host(state.params))
    return batch, out


@pytest.mark.parametrize("clip", [0.2, None])
def test_learner_step_matches_jax_adam_step(trees, jax_steps, clip):
    batch, out = jax_steps
    want_metrics, want_params = out[clip]
    model = _model(trees[0], trainable=True)
    opt = spmd.Adam(1e-2)
    state = spmd.TrainState(model, opt.init(model),
                            torch.zeros((), dtype=torch.int32))
    step = make_learner_step(tgpt.GPTConfig(**CFG), opt, W, clip)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(metrics) == set(want_metrics) == {
        "loss", "mean_logprob", "mean_ratio"}
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, atol=1e-5, rtol=0,
                                   err_msg=k)
    assert int(state.step) == 1
    _close_trees(tgpt.param_tree(state.params), want_params, atol=1e-5)


def test_adam_matches_optax_over_steps():
    """`spmd.Adam` against ``optax.adam`` over three updates of one leaf
    (bias corrections at counts 1, 2, 3)."""
    import optax
    rng = np.random.default_rng(0)
    p0 = rng.normal(0, 1, (5, 7)).astype(np.float32)
    grads = [rng.normal(0, 1, (5, 7)).astype(np.float32) for _ in range(3)]
    tx = optax.adam(3e-2)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = spmd.Adam(3e-2)
    st = opt.init(model)
    for g in grads:
        opt.update([torch.from_numpy(g)], st, model)
    assert int(st["count"]) == 3
    np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(jp),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# engine logprobs against the recompute (decode, verify, chunked prefill)
# ---------------------------------------------------------------------------

def _recompute(model, prompt, completion):
    full = np.concatenate([np.asarray(prompt, np.int32),
                           np.asarray(completion, np.int32)])[None]
    with torch.no_grad():
        lp = tgpt.completion_logprobs(model, torch.from_numpy(full),
                                      torch.tensor([len(prompt)]),
                                      len(completion))
    return lp[0].numpy()


@pytest.mark.parametrize("path", ["decode_greedy", "decode_sampled",
                                  "verify", "chunked_prefill"])
def test_engine_logprobs_match_completion_logprobs(trees, path):
    model = _model(trees[0])
    cfg = tgpt.GPTConfig(**CFG)
    kw, temp = dict(ENGINE), 0.0
    prompt = [3, 1, 4, 1, 5]
    if path == "decode_sampled":
        temp = 0.7
    elif path == "verify":
        kw.update(spec="ngram", spec_k=3)
        motif = np.random.default_rng(3).integers(1, CFG["vocab_size"], 3)
        prompt = np.tile(motif, 4).astype(np.int32).tolist()
    elif path == "chunked_prefill":
        kw.update(prefill_chunk=8)
        prompt = list(range(1, 20))
    eng = InferenceEngine(tgpt.params_from_numpy(trees[0], cfg, device="cpu"),
                          cfg, device="cpu", **kw)
    out = eng.generate(prompt, max_new_tokens=8 if path == "verify" else 6,
                       temperature=temp)
    if path == "verify":
        assert eng.stats()["spec_steps"] > 0
    np.testing.assert_allclose([t.logprob for t in out],
                               _recompute(model, prompt, [int(t) for t in out]),
                               atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# EngineSampler against the JAX sampler (greedy, peaked)
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [1, 2, 3, 10, 11, 12, 13, 14, 15]]


def _rollouts(which, trees):
    """Two greedy rollouts of PROMPTS through a fresh engine of
    ``which`` package on peaked seed-0 weights, a swap to peaked seed-1
    weights between them."""
    if which == "jax":
        eng = JaxEngine(jax.tree.map(jnp.asarray, trees["peaked0"]),
                        jgpt.GPTConfig(**CFG), **{**ENGINE, "slots": 4})
        samp = jsampler.EngineSampler(eng, max_new_tokens=5,
                                      temperature=0.0, pad_to=16)
        swap = jax.tree.map(jnp.asarray, trees["peaked1"])
    else:
        cfg = tgpt.GPTConfig(**CFG)
        eng = InferenceEngine(
            tgpt.params_from_numpy(trees["peaked0"], cfg, device="cpu"),
            cfg, device="cpu", **{**ENGINE, "slots": 4})
        samp = EngineSampler(eng, max_new_tokens=5, temperature=0.0,
                             pad_to=16)
        swap = trees["peaked1"]
    reward = motif_reward(7)
    first = samp.rollout(PROMPTS, reward)
    eng.update_params(swap)
    return first, samp.rollout(PROMPTS, reward)


@pytest.fixture(scope="module")
def jax_rollouts(trees):
    return _rollouts("jax", trees)


def test_engine_sampler_matches_jax_sampler(trees, jax_rollouts):
    for got, want, ver in zip(_rollouts("port", trees), jax_rollouts,
                              (0, 1)):
        assert set(got) == set(want)
        for k in (TOKENS, START, MASK, PARAMS_VERSION, sb.ACTIONS,
                  sb.REWARDS, sb.DONES, sb.EPS_ID):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[sb.ACTION_LOGP], want[sb.ACTION_LOGP],
                                   atol=1e-4, rtol=0)
        assert (got[PARAMS_VERSION][got[MASK] > 0] == ver).all()
        assert got[TOKENS].shape == (len(PROMPTS), 16)


# ---------------------------------------------------------------------------
# runners and the backend registry
# ---------------------------------------------------------------------------

class _TokenEnv:
    eos_id = None

    def __init__(self, motif=7):
        self._reward = motif_reward(motif)

    def make_prompt(self, rng):
        return [1, 2, int(rng.integers(3, 9))]

    def reward(self, prompt, completion):
        return self._reward(prompt, completion)


def _engine(trees, **kw):
    cfg = tgpt.GPTConfig(**CFG)
    return InferenceEngine(tgpt.params_from_numpy(trees[0], cfg, device="cpu"),
                           cfg, device="cpu", **{**ENGINE, **kw})


def test_engine_backend_runner(trees):
    runner = make_env_runner(
        _TokenEnv(), module=None, rollout_length=3, seed=0,
        backend="engine",
        backend_kwargs=dict(engine=_engine(trees), max_new_tokens=4,
                            pad_to=16, publish=False))
    assert isinstance(runner, TokenEnvRunner)
    batch, last_v = runner.sample(None)
    assert len(batch) == 3 and last_v.shape == (3,)
    assert batch[sb.ACTIONS].shape == (3, 4)
    stats = runner.pop_episode_stats()
    assert stats["episodes_this_iter"] == 3
    assert np.isfinite(stats["episode_reward_mean"])
    assert runner.pop_episode_stats()["episodes_this_iter"] == 0


def test_token_env_runner_publishes_new_weights(trees):
    """A new tree is swapped in once; a model, which the port's
    optimizers update in place, at every call."""
    eng = _engine(trees)
    runner = TokenEnvRunner(_TokenEnv(), None, 2, engine=eng,
                            max_new_tokens=3, pad_to=16)
    tree = trees[1]
    for _ in range(2):
        batch, _ = runner.sample(tree)
    assert eng.params_version == 1
    assert (batch[PARAMS_VERSION][batch[MASK] > 0] == 1).all()
    model = _model(trees[0], trainable=True)
    for want in (2, 3):
        runner.sample(model)
        assert eng.params_version == want
    with pytest.raises(ValueError, match="engine"):
        TokenEnvRunner(_TokenEnv(), None, 2)


def test_backend_registry_refusals():
    with pytest.raises(ValueError, match="unknown generation"):
        make_env_runner(object(), None, 1, backend="nope")
    with pytest.raises(NotImplementedError, match="A8"):
        make_env_runner(object(), None, 1)


# ---------------------------------------------------------------------------
# learner/engine separation and the end-to-end flywheel
# ---------------------------------------------------------------------------

def _tiny(**kw):
    return tgpt.GPTConfig(**{**CFG, **kw})


def test_engine_weights_change_only_at_the_publish(trees):
    # a reward that varies over the batch, so the first advantages and
    # the first update are not zero
    fly = FlywheelLoop(_tiny(), lambda rng: [1, 2, int(rng.integers(3, 9))],
                       lambda p, c: p[-1] / 8, params=trees[0],
                       prompts_per_iter=4,
                       max_new_tokens=5, pad_to=16, device="cpu",
                       engine_kwargs=ENGINE)
    learner, engine = fly.state.params, fly.engine.model
    ptrs = {p.data_ptr() for p in learner.parameters()}
    assert not ptrs & {p.data_ptr() for p in engine.parameters()}
    before = {k: v.clone() for k, v in engine.named_parameters()}
    fly._step(fly.state, fly._collect())
    moved = any(not torch.equal(v, dict(learner.named_parameters())[k])
                for k, v in before.items())
    assert moved
    for k, v in engine.named_parameters():
        assert torch.equal(v, before[k]), k
    assert fly.engine.params_version == 0
    fly._publish(fly.state, 1)
    assert fly.engine.params_version == fly.published_version == 1
    for (k, v), (_, w) in zip(engine.named_parameters(),
                              learner.named_parameters()):
        assert torch.equal(v, w.detach()), k
    # the caller's tree was copied, not trained in place
    np.testing.assert_array_equal(
        tgpt.params_to_numpy(_model(trees[0]))["embed"], trees[0]["embed"])
    # mesh= is ported: a mesh of one rank is the single-card loop (the
    # multi-rank loop is tests/test_torch_rl_moe_mesh.py's)
    from ray_tpu_torch.parallel import single_device_mesh
    one = FlywheelLoop(_tiny(), None, None, params=trees[0], device="cpu",
                       mesh=single_device_mesh(), engine_kwargs=ENGINE)
    assert one.mesh is None and one.engine.mesh is None
    assert one.state.params.mesh is None


class _RemoteTarget:
    """A deployment-handle-like target: ``update_params.remote`` gets
    host numpy params."""

    def __init__(self):
        self.got = []
        target = self

        class _Method:
            def remote(self, params):
                target.got.append(params)

        self.update_params = _Method()


def test_flywheel_e2e_smoke():
    """`tests/test_flywheel.py::test_flywheel_e2e_smoke` on the port."""
    cfg = _tiny(vocab_size=32)
    ekw = dict(slots=4, max_len=32, prefill_buckets=(8,), block_size=8)
    replica_like = InferenceEngine(
        tgpt.GPT(cfg, tgpt.init_params(0, cfg, "cpu"), device="cpu"), cfg,
        device="cpu", **ekw)
    remote = _RemoteTarget()
    fly = FlywheelLoop(cfg, lambda rng: [1, 2, int(rng.integers(3, 9))],
                       motif_reward(7), lr=5e-2, prompts_per_iter=8,
                       max_new_tokens=5, temperature=1.0, pad_to=16, seed=0,
                       engine_kwargs=ekw, publish_to=[replica_like, remote],
                       device="cpu")
    state, metrics = fly.run(12)
    st = fly.engine.stats()
    assert st["decode_traces"] == 1 and st["retraces_unexpected"] == 0
    assert st["swaps"] == 12 and fly.engine.params_version == 12
    assert replica_like.params_version == 12          # publish fan-out
    assert len(remote.got) == 12
    assert isinstance(remote.got[-1]["embed"], np.ndarray)
    rw = [h["reward_mean"] for h in fly.history]
    assert np.mean(rw[-4:]) > np.mean(rw[:4]) + 0.15, rw
    assert all(h["staleness"] >= 0 for h in fly.history)
    assert len(metrics) == 12 and np.isfinite(metrics[-1]["loss"])
    ls = fly.loop.stats()
    assert ls["steps"] == 12 and ls["retraces_unexpected"] == 0
    assert ls["mfu"] > 0.0
    assert fly.stats()["iterations"] == 12
    fresh = InferenceEngine(tgpt.GPT(cfg, tgpt.param_tree(state.params),
                                     device="cpu"), cfg, device="cpu", **ekw)
    for prompt in ([1, 2, 3], [1, 2, 8]):
        got = fly.engine.generate(prompt, max_new_tokens=5)
        want = fresh.generate(prompt, max_new_tokens=5)
        assert [int(t) for t in got] == [int(t) for t in want]
        np.testing.assert_allclose([t.logprob for t in got],
                                   [t.logprob for t in want], atol=1e-5)
    assert fly.engine.decode_traces == 1
