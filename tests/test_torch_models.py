"""The port's other model families (`ray_tpu_torch.models.moe`, `vit`,
`resnet`) and its predictor against the JAX package's on the CPU, in
f32 (in bf16 the router's near-ties would flip experts between the two).

Tolerances (f32): MoE routing's dispatch exactly (every pick, slot and
capacity drop); its combine weights and aux loss within a few f32 ulps
(``ROUTE_RTOL``: the same operations in the same order, but XLA's and
ATen's ``exp`` in the router softmax differ in the last bit); losses and logits
1e-4 of their scale; each gradient leaf within 1e-3 of its own largest
magnitude (another summation order through the dispatch/combine
contractions); three trainer steps' losses 1e-4. ViT and ResNet as
MoE; ResNet's updated batch statistics 1e-5."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.models import resnet as jresnet
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import MeshSpec
from ray_tpu.train import checkpoint as jcheckpoint
from ray_tpu.train import predictor as jpredictor
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import _stacked
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import resnet as tresnet
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.train import checkpoint as tcheckpoint
from ray_tpu_torch.train import predictor as tpredictor
from ray_tpu_torch.train import spmd as tspmd


ROUTE_RTOL = 2 ** -20     # 8 ulps of f32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grads(model) -> dict:
    return jax.tree.map(lambda p: p.grad.numpy(), _stacked.param_tree(model))


def _assert_tree_close(got, want, rel):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, a), b in zip(flat_g, flat_w):
        b = np.asarray(b)
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=0,
            atol=rel * max(np.abs(b).max(), 1e-12),
            err_msg=jax.tree_util.keystr(path))


# -- MoE ----------------------------------------------------------------------

@pytest.mark.parametrize("kw,n", [
    (dict(), 64),                                          # the defaults
    (dict(n_experts=4, top_k=2, capacity_factor=4.0), 32),  # no drops
    (dict(n_experts=4, top_k=1, capacity_factor=0.25), 64),  # drops
    (dict(n_experts=8, top_k=2, capacity_factor=0.5), 48),  # top-2 drops
])
def test_route_matches_jax_exactly(kw, n):
    jcfg, tcfg = jmoe.small(**kw), tmoe.small(**kw)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(n, jcfg.d_model)).astype(np.float32)
    router = (rng.normal(size=(jcfg.d_model, jcfg.n_experts)) * 0.1
              ).astype(np.float32)
    jd, jc, ja = _np_tree(jmoe._route(jnp.asarray(h), jnp.asarray(router),
                                      jcfg))
    td, tc, ta = tmoe._route(torch.from_numpy(h), torch.from_numpy(router),
                             tcfg)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=ROUTE_RTOL, atol=0)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=ROUTE_RTOL, atol=0)
    if kw.get("capacity_factor", 1.25) < 1:
        assert jd.sum() < n * jcfg.top_k       # some picks were dropped


def test_route_ties_pick_the_first_expert():
    """A zero router gives every token equal probabilities: argmax takes
    the first index, so every token goes to expert 0 then 1, as in JAX,
    and the capacity drops the overflow in token order."""
    jcfg, tcfg = jmoe.small(), tmoe.small()
    h = np.random.default_rng(0).normal(size=(32, 128)).astype(np.float32)
    router = np.zeros((128, jcfg.n_experts), np.float32)
    jd, jc, _ = _np_tree(jmoe._route(jnp.asarray(h), jnp.asarray(router),
                                     jcfg))
    td, tc, _ = tmoe._route(torch.from_numpy(h), torch.from_numpy(router),
                            tcfg)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=ROUTE_RTOL, atol=0)
    assert td.sum(dim=(0, 2))[2:].sum() == 0


@pytest.fixture(scope="module")
def moe_setup():
    # the port's "flash" takes its flash wrapper, whose CPU path is the
    # plain version; JAX's plain attention keeps its side fast
    jcfg = jmoe.small(dtype="float32", attn_impl="xla")
    tcfg = tmoe.small(dtype="float32", attn_impl="flash")
    tree = _np_tree(jmoe.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    return jcfg, tcfg, tree, toks


def test_moe_forward_loss_and_grads_match_jax(moe_setup):
    jcfg, tcfg, tree, toks = moe_setup
    jp = jax.tree.map(jnp.asarray, tree)
    jlogits, jaux = jax.jit(partial(jmoe.forward, cfg=jcfg))(
        jp, jnp.asarray(toks))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg)))(jp)
    model = tmoe.params_from_numpy(tree, tcfg, device="cpu",
                                   dtype=torch.float32, trainable=True)
    with torch.no_grad():
        tlogits, taux = tmoe.forward(model, torch.from_numpy(toks))
    scale = np.abs(np.asarray(jlogits)).max()
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    loss = tmoe.loss_fn(model, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-4
    _assert_tree_close(_grads(model), jgrads, 1e-3)
    assert tmoe.num_params(model) == jmoe.num_params(tree)


def test_moe_trainer_three_steps_match_jax(moe_setup):
    _, _, tree, _ = moe_setup
    jcfg = jmoe.small(dtype="float32", attn_impl="xla")
    tcfg = tmoe.small(dtype="float32", attn_impl="xla")
    mesh = MeshSpec(data=1).build(jax.devices()[:1])
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    jopt = jspmd.default_optimizer(**kw)
    _, jstep, _ = jspmd.make_moe_trainer(jcfg, mesh, optimizer=jopt,
                                         init_state=False)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jspmd.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    tstate, tstep, place = tspmd.make_moe_trainer(
        tcfg, optimizer=tspmd.default_optimizer(**kw), device="cpu")
    tstate.params = tmoe.params_from_numpy(tree, tcfg, device="cpu",
                                           dtype=torch.float32,
                                           trainable=True)
    tstate.opt_state = tspmd.default_optimizer(**kw).init(tstate.params)
    for s in range(3):
        toks = np.random.default_rng(10 + s).integers(
            0, jcfg.vocab_size, (4, 33)).astype(np.int32)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, place(batch))
        assert abs(tm["loss"].item() - float(jm["loss"])) < 1e-4, s
        assert int(tm["step"]) == int(jm["step"]) == s + 1
    got = _stacked.params_to_numpy(tstate.params)
    _assert_tree_close(got, jstate.params, 1e-3)


def test_moe_trainer_skips_state_on_resume():
    state, step, place = tspmd.make_moe_trainer(tmoe.small(), device="cpu",
                                                init_state=False)
    assert state is None and callable(step) and place.device.type == "cpu"


# -- ViT ----------------------------------------------------------------------

def test_vit_forward_loss_and_grads_match_jax():
    jcfg, tcfg = jvit.small(dtype="float32"), tvit.small(dtype="float32")
    tree = _np_tree(jvit.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, 4).astype(np.int32)
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    jp = jax.tree.map(jnp.asarray, tree)
    jlogits = jax.jit(partial(jvit.forward, cfg=jcfg))(jp, jb["images"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jvit.loss_fn(p, jb, jcfg)))(jp)
    model = tvit.params_from_numpy(tree, tcfg, device="cpu",
                                   dtype=torch.float32, trainable=True)
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        tlogits = tvit.forward(model, tb["images"])
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jlogits)).max())
    loss = tvit.loss_fn(model, tb)
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-4
    _assert_tree_close(_grads(model), jgrads, 1e-3)
    assert tvit.num_params(model) == jvit.num_params(tree)


def test_vit_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x),
                                 approximate="tanh").numpy(),
        jax.nn.gelu(jnp.asarray(x)), rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() \
        > 1e-4


# -- ResNet -------------------------------------------------------------------

def _flax_pair(tmodel, seed=0):
    """The port model's variables as flax's tree (which flax's apply
    takes only if every name and shape matches), with non-trivial batch
    statistics and final-norm scales so that eval mode and the
    zero-initialised scales are exercised, loaded back into the port."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith(("['mean']", "['scale']")):
            return x + rng.normal(size=x.shape).astype(np.float32) * 0.1
        if key.endswith("['var']"):
            return x * rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        return x
    variables = jax.tree_util.tree_map_with_path(
        perturb, tresnet.params_to_numpy(tmodel))
    return variables, tresnet.params_from_numpy(variables, tmodel)


def test_resnet18_train_eval_grads_and_batch_stats_match_flax():
    jmodel = jresnet.resnet18(num_classes=10, dtype="float32",
                              num_filters=8)
    tmodel = tresnet.resnet18(num_classes=10, dtype="float32",
                              num_filters=8, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4)
    variables, tmodel = _flax_pair(tmodel)
    jv = jax.tree.map(jnp.asarray, variables)

    jeval = jax.jit(partial(jmodel.apply, train=False))(
        jv, jnp.asarray(images))
    with torch.no_grad():
        teval = tmodel(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(teval.numpy(), jeval, rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jeval)).max())

    def jloss(params):
        logits, upd = jmodel.apply(
            {"params": params, "batch_stats": jv["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(4), labels]), (logits, upd)

    (jl, (jlogits, jupd)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jv["params"])
    tlogits = tmodel(torch.from_numpy(images), train=True)
    tl = -torch.log_softmax(tlogits, -1)[torch.arange(4),
                                         torch.from_numpy(labels)].mean()
    tl.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jlogits)).max())
    assert abs(tl.item() - float(jl)) < 1e-4
    got = tresnet.params_to_numpy(tmodel)
    _assert_tree_close(got["batch_stats"], jupd["batch_stats"], 1e-5)
    grads = _stacked.nest((n, tresnet.to_flax_layout(p.grad))
                          for n, p in tmodel.named_parameters())
    _assert_tree_close(grads, jgrads, 1e-3)


def test_resnet50_same_padding_is_asymmetric_as_in_flax():
    """At 64^2 the 7x7 stride-2 stem pads (2, 3), the 3x3 stride-2 pool
    and the strided 3x3 convs (0, 1): the port's forward equals flax's,
    where torch's symmetric padding would not."""
    assert tresnet.same_pads(64, 7, 2) == (2, 3)
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(32, 3, 2) == (0, 1)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)
    jmodel = jresnet.resnet50(num_classes=10, dtype="float32",
                              num_filters=8)
    tmodel = tresnet.resnet50(num_classes=10, dtype="float32",
                              num_filters=8, device="cpu")
    images = np.random.default_rng(1).normal(
        size=(2, 64, 64, 3)).astype(np.float32)
    variables, tmodel = _flax_pair(tmodel, seed=1)
    jout = jax.jit(partial(jmodel.apply, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images), train=False)
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        stem = tmodel.Conv_0(x)
        sym = torch.nn.functional.conv2d(x, tmodel.Conv_0.kernel, stride=2,
                                         padding=3)
        pooled = torch.nn.functional.max_pool2d(
            tresnet._pad_same(stem, 3, 2, value=-float("inf")), 3, 2)
    assert tuple(stem.shape[2:]) == (32, 32) and \
        tuple(pooled.shape[2:]) == (16, 16)
    assert not torch.allclose(stem, sym[:, :, :32, :32])
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jout)).max())


def test_resnet_carry_across_round_trips():
    tmodel = tresnet.resnet18(num_classes=10, dtype="float32", device="cpu")
    tree = tresnet.params_to_numpy(tmodel)
    other = tresnet.params_from_numpy(
        tree, tresnet.resnet18(num_classes=10, dtype="float32",
                               device="cpu", seed=5))
    for (n, a), (_, b) in zip(tmodel.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), n
    tree["params"]["Conv_0"]["kernel"] = tree["params"]["Conv_0"][
        "kernel"][:2]
    with pytest.raises(ValueError, match="Conv_0"):
        tresnet.params_from_numpy(tree, other)


# -- predictor ------------------------------------------------------------------

def test_predictor_matches_jax_predictor(tmp_path):
    """The same checkpoint dict through `JaxPredictor` and through the
    port's `TorchPredictor` (after a directory round trip)."""
    jcfg, tcfg = jvit.small(dtype="float32"), tvit.small(dtype="float32")
    params = _np_tree(jvit.init_params(jax.random.PRNGKey(2), jcfg))
    images = np.random.default_rng(0).normal(
        size=(3, 32, 32, 3)).astype(np.float32)
    jpred = jpredictor.JaxPredictor.from_checkpoint(
        jcheckpoint.Checkpoint.from_dict({"params": params, "epoch": 1}),
        apply_fn=lambda p, x: jvit.forward(p, x, jcfg))
    ck = tcheckpoint.Checkpoint.from_dict({"params": params, "epoch": 1})
    ck = tcheckpoint.Checkpoint.from_directory(
        ck.to_directory(str(tmp_path / "ck")))
    tpred = tpredictor.TorchPredictor.from_checkpoint(
        ck, apply_fn=lambda p, x: tvit.forward(
            tvit.ViT(tcfg, p, device="cpu", dtype=torch.float32), x),
        device="cpu")
    jout = jpred.predict(images)
    tout = tpred.predict(images)
    assert set(tout) == set(jout) == {"__value__", "predictions"}
    np.testing.assert_allclose(tout["predictions"], jout["predictions"],
                               rtol=0, atol=1e-4)
    out = tpred.predict({"x": images, "id": np.arange(3)})
    assert out["predictions"].shape == (3, tcfg.num_classes)
    np.testing.assert_array_equal(out["id"], np.arange(3))
