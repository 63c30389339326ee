"""Parity of the port's training half (`ray_tpu_torch.models.gpt` loss
and gradients, `ray_tpu_torch.train.spmd`) with the JAX package on the
CPU, on `gpt.small(dtype="float32", attn_impl="flash")` with the JAX
params carried across by `params_from_numpy` (the JAX flash kernels run
in interpret mode; the port runs their plain versions on the CPU).

Tolerances (f32): loss 1e-5; each gradient leaf within 1e-4 of its own
largest magnitude (another summation order through ~10 matmuls per
layer); optimizer updates on given gradients 1e-6 (the same elementwise
formulas); parameters after 3 full train steps 1e-4 (Adam divides each
gradient element by its own RMS, so an element whose gradient differs
by summation error moves by a correspondingly amplified amount)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel import MeshSpec
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import fused_xent as tfx
from ray_tpu_torch.train import spmd as tspmd

T = 32


@pytest.fixture(scope="module")
def cfgs():
    return (jgpt.small(dtype="float32", attn_impl="flash"),
            tgpt.small(dtype="float32", attn_impl="flash"))


@pytest.fixture(scope="module")
def tree(cfgs):
    return jax.tree.map(np.asarray,
                        jgpt.init_params(jax.random.PRNGKey(0), cfgs[0]))


def _batch(vocab, b=4, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, T + 1)).astype(np.int32)
    out = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        out["mask"] = (rng.random((b, T)) < 0.7).astype(np.float32)
    return out


def _jax_loss_and_grads(params, batch, cfg):
    """`jax.value_and_grad(jspmd.gpt_loss_fn)`, jitted: eagerly the
    Pallas kernels' interpret mode runs op by op."""
    return jax.jit(jax.value_and_grad(jspmd.gpt_loss_fn),
                   static_argnums=2)(params, batch, cfg)


def _model(tree, cfg):
    return tgpt.params_from_numpy(tree, cfg, device="cpu",
                                  dtype=torch.float32, trainable=True)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_leaves(model):
    g = {"embed": model.embed.grad, "pos_embed": model.pos_embed.grad,
         "final_ln_scale": model.final_ln_scale.grad,
         "layers": {n: p.grad for n, p in model.layers.items()}}
    return jax.tree.map(lambda x: x.numpy(), g)


def _assert_tree_close(got, want, rel):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, a), b in zip(flat_g, flat_w):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-12),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mask", [False, True])
def test_loss_and_grads_match_jax(cfgs, tree, mask):
    jcfg, tcfg = cfgs
    batch = _batch(jcfg.vocab_size, mask=mask)
    jloss, jgrads = _jax_loss_and_grads(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.asarray, batch), jcfg)
    model = _model(tree, tcfg)
    loss = tspmd.gpt_loss_fn(model, _tb(batch))
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    _assert_tree_close(_grad_leaves(model), jgrads, 1e-4)


@pytest.mark.parametrize("d_model,n_heads,loss_impl", [
    (96, 1, "dense"), (192, 2, "dense"), (384, 4, "fused"), (200, 5, "fused")])
def test_once_refused_shapes_loss_and_grads_match_jax(d_model, n_heads,
                                                     loss_impl):
    """Shapes the card's kernels used to refuse, through the whole
    training loss against JAX's: head dim 96 (d_model 96 over one head,
    192 over two), the fused loss at width 384 (four heads of 96) and at
    width 200 (five heads of 40: a width and a head dim the kernels run
    zero-padded)."""
    kw = dict(d_model=d_model, n_heads=n_heads, d_ff=2 * d_model,
              dtype="float32", attn_impl="flash", loss_impl=loss_impl)
    jcfg, tcfg = jgpt.small(**kw), tgpt.small(**kw)
    assert tcfg.head_dim in (96, 40)
    tree = jax.tree.map(np.asarray,
                        jgpt.init_params(jax.random.PRNGKey(1), jcfg))
    batch = _batch(jcfg.vocab_size, b=2, seed=9)
    jloss, jgrads = _jax_loss_and_grads(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.asarray, batch), jcfg)
    model = _model(tree, tcfg)
    loss = tspmd.gpt_loss_fn(model, _tb(batch), tcfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    _assert_tree_close(_grad_leaves(model), jgrads, 1e-4)


@pytest.mark.parametrize("mask", [False, True])
def test_fused_loss_and_grads_match_jax(cfgs, tree, mask):
    """loss_impl="fused" (the port's fused cross-entropy, its plain
    version on the CPU) against JAX's fused loss on the same config,
    through `gpt_loss_fn` with and without a padding mask."""
    jcfg, tcfg = (dataclasses.replace(c, loss_impl="fused") for c in cfgs)
    batch = _batch(jcfg.vocab_size, seed=6, mask=mask)
    jloss, jgrads = _jax_loss_and_grads(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.asarray, batch), jcfg)
    model = _model(tree, tcfg)
    loss = tspmd.gpt_loss_fn(model, _tb(batch), tcfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    _assert_tree_close(_grad_leaves(model), jgrads, 1e-4)


def test_fused_loss_fn_tokens_form_matches_jax_and_dense(cfgs, tree):
    """models.gpt.loss_fn under loss_impl="fused" against JAX's, and
    against the port's own dense loss."""
    jcfg, tcfg = (dataclasses.replace(c, loss_impl="fused") for c in cfgs)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                             (2, T + 1)).astype(np.int32)
    jloss = jgpt.loss_fn(jax.tree.map(jnp.asarray, tree),
                         {"tokens": jnp.asarray(toks)}, jcfg)
    model = _model(tree, tcfg)
    fused = tgpt.loss_fn(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    dense = tgpt.loss_fn(model, {"tokens": torch.from_numpy(toks)},
                         cfgs[1])
    assert abs(fused.item() - float(jloss)) < 1e-5
    assert abs(fused.item() - dense.item()) < 1e-4


def test_fused_loss_never_materializes_logits(tree):
    """Every op output of the fused forward + backward is recorded (a
    TorchDispatchMode): none has B*T*V elements, the size of the logits.
    The dense graph is the positive control."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numels = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.numels.add(o.numel())
            return out

    # vocab 768, so B*T*V collides with no other activation, and a chunk
    # below it, or the single chunk would be the logits
    tcfg = tgpt.small(dtype="float32", attn_impl="flash", vocab_size=768,
                      loss_chunk=128)
    params = tgpt.init_params(0, tcfg, device="cpu")
    b, v = 2, tcfg.vocab_size
    batch = _tb(_batch(v, b=b, seed=8))
    seen = {}
    for impl in ("dense", "fused"):
        cfg = dataclasses.replace(tcfg, loss_impl=impl)
        model = tgpt.GPT(cfg, params, device="cpu", dtype=torch.float32,
                         trainable=True)
        with Sizes() as mode:
            tspmd.gpt_loss_fn(model, batch, cfg).backward()
        seen[impl] = mode.numels
    assert b * T * v in seen["dense"]          # the probe sees logits
    assert b * T * v not in seen["fused"]


def test_gpt_loss_fn_tokens_form_matches_jax(cfgs, tree):
    """models.gpt.loss_fn (unshifted {"tokens"}) agrees too."""
    jcfg, tcfg = cfgs
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             (2, T + 1)).astype(np.int32)
    jloss = jgpt.loss_fn(jax.tree.map(jnp.asarray, tree),
                         {"tokens": jnp.asarray(toks)}, jcfg)
    loss = tgpt.loss_fn(_model(tree, tcfg), {"tokens": torch.from_numpy(toks)})
    assert abs(loss.item() - float(jloss)) < 1e-5


def test_softmax_xent_bf16_logits_matches_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 5, 64)) * 4).astype(np.float32)
    targets = rng.integers(0, 64, (3, 5)).astype(np.int32)
    want = jspmd.softmax_xent(jnp.asarray(logits, jnp.bfloat16),
                              jnp.asarray(targets))
    got = tspmd.softmax_xent(torch.from_numpy(logits).bfloat16(),
                             torch.from_numpy(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_default_optimizer_matches_optax():
    """3 updates with warmup_steps=2: update 0 runs at lr 0 (params
    unchanged), update 1 is clipped (global norm > 1), update 2 not."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [jax.tree.map(lambda p, s=s: (rng.standard_normal(p.shape)
                                          * s).astype(np.float32), params)
             for s in (0.05, 3.0, 0.2)]
    jopt = jspmd.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                   total_steps=10)
    topt = tspmd.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                   total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(params[k].copy()))
         for k in sorted(params)})
    tstate = topt.init(tp)
    norms = []
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update([torch.from_numpy(g[k]) for k in sorted(g)],
                           tstate, tp)
        norms.append(norm.item())
        np.testing.assert_allclose(norm.item(),
                                   float(optax.global_norm(g)), rtol=1e-6)
        for k in sorted(params):
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6,
                                       rtol=0)
            if i == 0:
                np.testing.assert_array_equal(tp[k].detach().numpy(),
                                              params[k])
    assert norms[1] > 1.0 > norms[0]
    assert int(tstate["count"]) == 3


def test_schedule_matches_optax():
    topt = tspmd.default_optimizer(learning_rate=3e-4, warmup_steps=4,
                                   total_steps=20)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 20)
    counts = torch.arange(0, 25, dtype=torch.int32)
    np.testing.assert_allclose(topt.schedule(counts).numpy(),
                               [float(sched(c)) for c in range(25)],
                               rtol=1e-6, atol=1e-12)


def test_train_step_three_steps_match_jax(cfgs, tree):
    jcfg, tcfg = cfgs
    mesh = MeshSpec(data=1).build(jax.devices()[:1])
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jopt = jspmd.default_optimizer(**kw)
    jstep = jspmd.make_train_step(partial(jspmd.gpt_loss_fn, cfg=jcfg),
                                  jopt, mesh, donate=False)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jspmd.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    topt = tspmd.default_optimizer(**kw)
    model = _model(tree, tcfg)
    tstate = tspmd.TrainState(model, topt.init(model),
                              torch.zeros((), dtype=torch.int32))
    tstep = tspmd.make_train_step(tspmd.gpt_loss_fn, topt)
    for s in range(3):
        batch = _batch(jcfg.vocab_size, seed=10 + s)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, _tb(batch))
        assert abs(tm["loss"].item() - float(jm["loss"])) < 1e-5
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert int(tm["step"]) == int(jm["step"]) == s + 1
    got = tgpt.params_to_numpy(tstate.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


def test_accum_matches_single_step(cfgs, tree):
    """accum=2 (running f32 mean over two microbatches) == accum=1 on
    the same batch, up to summation order."""
    _, tcfg = cfgs
    batch = _tb(_batch(tcfg.vocab_size, seed=1))
    out = []
    for accum in (1, 2):
        opt = tspmd.default_optimizer(learning_rate=1e-3, warmup_steps=0)
        model = _model(tree, tcfg)
        state = tspmd.TrainState(model, opt.init(model),
                                 torch.zeros((), dtype=torch.int32))
        step = tspmd.make_train_step(tspmd.gpt_loss_fn, opt, accum=accum)
        state, m = step(state, batch)
        out.append((m, tgpt.params_to_numpy(state.params)))
    (m1, p1), (m2, p2) = out
    assert abs(m1["loss"].item() - m2["loss"].item()) < 1e-5
    np.testing.assert_allclose(m1["grad_norm"].item(),
                               m2["grad_norm"].item(), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="accum"):
        tspmd.make_train_step(tspmd.gpt_loss_fn, None, accum=3)(
            state, batch)


@pytest.mark.parametrize("policy", ["nothing", "dots", "attn_out"])
def test_remat_does_not_change_the_numbers(cfgs, tree, policy):
    _, tcfg = cfgs
    batch = _tb(_batch(tcfg.vocab_size, seed=2))
    grads = []
    for cfg in (dataclasses.replace(tcfg, remat=False),
                dataclasses.replace(tcfg, remat=True, remat_policy=policy)):
        model = _model(tree, cfg)
        tspmd.gpt_loss_fn(model, batch).backward()
        grads.append(_grad_leaves(model))
    for a, b in zip(jax.tree.leaves(grads[0]), jax.tree.leaves(grads[1])):
        np.testing.assert_array_equal(a, b)


def test_unported_and_unknown_knobs_raise(cfgs, tree):
    _, tcfg = cfgs
    batch = _tb(_batch(tcfg.vocab_size))
    model = _model(tree, tcfg)
    # a mesh of one rank is the single-card loss, bit for bit
    from ray_tpu_torch.parallel import single_device_mesh
    with torch.no_grad():
        x = tgpt.forward_features(model, batch["inputs"])
        torch.testing.assert_close(
            tfx.fused_softmax_xent(x, model.embed, batch["targets"],
                                   mesh=single_device_mesh()),
            tfx.fused_softmax_xent(x, model.embed, batch["targets"]),
            rtol=0, atol=0)
    # the ring runs over a mesh's seq axis: without one it names the mesh
    with pytest.raises(ValueError, match="needs a mesh"):
        tspmd.gpt_loss_fn(_model(tree, tcfg), batch,
                          dataclasses.replace(tcfg, attn_impl="ring"))
    with pytest.raises(ValueError, match="remat_policy"):
        tspmd.gpt_loss_fn(_model(tree, tcfg), batch,
                          dataclasses.replace(tcfg, remat_policy="all"))
    with pytest.raises(ValueError, match="loss_impl"):
        tgpt.check_loss_impl(dataclasses.replace(tcfg, loss_impl="x"))


def test_make_gpt_trainer_trains_and_flops_match_jax(cfgs):
    jcfg, tcfg = cfgs
    assert tspmd.train_flops_per_token(tcfg, T) == \
        jspmd.train_flops_per_token(jcfg, T)
    state, step, place = tspmd.make_gpt_trainer(
        tcfg, seed=0, device="cpu",
        optimizer=tspmd.default_optimizer(learning_rate=3e-3,
                                          warmup_steps=0))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in state.params.parameters())
    batch = place(_batch(tcfg.vocab_size, seed=5))
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.5
    assert int(state.step) == 6
