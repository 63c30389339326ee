"""The port's fault-tolerant training (`ray_tpu_torch.train.ft`,
`train.checkpoint`, `util.storage`) against the JAX package's, on the
CPU.

The units mirror `tests/test_ft.py` on a tree of CPU tensors. Across the
packages: a train state the JAX `AsyncCheckpointer` wrote from an
8-device mesh (fsdp-sharded leaves) restores into the port bit for bit
and trains on with JAX's losses (f32, 1e-5: another summation order);
the port's checkpoints read back in the JAX package; a JAX bf16 leaf
reads back bit-exact; a skeleton naming any other class is refused.
The kill/resume proof (`tests/test_chaos.py`'s, on the port): this
file's ``__main__`` block is the trainer child, a tiny CPU GPT on one
thread; a SIGKILLed run resumes from its last committed step with
losses bitwise equal to an unkilled run's.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import ft, loop, spmd
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointError
from ray_tpu_torch.util import storage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- the trainer child (run as __main__) ---------------------------------------

BATCH, SEQ, VOCAB = 8, 16, 128


def child_cfg():
    return tgpt.small(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=2,
                      d_ff=64, max_seq_len=SEQ, dtype="float32",
                      attn_impl="xla")


def host_batches(start: int = 0):
    """Deterministic stream: the batch of global step i is a function of
    i alone, so a resumed run replays the killed run's batches."""
    idx = start
    while True:
        rng = np.random.default_rng(1234 + idx)
        toks = rng.integers(0, VOCAB, (BATCH, SEQ + 1), np.int32)
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        idx += 1


def _killing_feed(inner, ckpt, crash_at: int):
    for idx, batch in enumerate(inner):
        if idx >= crash_at:
            deadline = time.time() + 120
            while ckpt.commits < 1 and time.time() < deadline:
                time.sleep(0.01)
            os.kill(os.getpid(), signal.SIGKILL)
        yield batch


def child_main() -> None:
    """FT_ROOT, FT_OUT, FT_MODE (train | resume), FT_STEPS, FT_EVERY (0:
    no checkpointer), FT_CRASH_AT (SIGKILL once the feed reaches this
    batch and a checkpoint is committed), as `tests/ft_train_child.py`."""
    torch.set_num_threads(1)
    root = os.environ["FT_ROOT"]
    out = os.environ.get("FT_OUT")
    steps = int(os.environ.get("FT_STEPS", "12"))
    every = int(os.environ.get("FT_EVERY", "0"))
    crash_at = int(os.environ.get("FT_CRASH_AT", "-1"))
    unroll = 2
    cfg = child_cfg()
    opt = spmd.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                 total_steps=20)
    if os.environ.get("FT_MODE", "train") == "resume":
        _, step_fn, place = spmd.make_gpt_trainer(
            cfg, optimizer=opt, device="cpu", init_state=False)
        tree, start = ft.restore_resharded(root, "cpu")
        state = ft.state_from_tree(tree, cfg, "cpu")
        host = ft.fast_forward(host_batches(), start)
    else:
        state, step_fn, place = spmd.make_gpt_trainer(
            cfg, optimizer=opt, device="cpu")
        start, host = 0, host_batches()
    ckpt = None
    if every > 0:
        ckpt = ft.AsyncCheckpointer(root, every=every, max_in_flight=2,
                                    keep=2)
    if crash_at >= 0:
        host = _killing_feed(host, ckpt, crash_at)
    batches = loop.DevicePrefetcher(host, place, depth=2, group=unroll)
    train = loop.TrainLoop(step_fn, unroll=unroll, metrics_interval=4,
                           checkpointer=ckpt)
    state, metrics = train.run(state, batches, num_steps=steps,
                               start_step=start)
    if ckpt is not None:
        ckpt.check_invariants()
        ckpt.close()
    if out:
        with open(out, "w") as f:
            json.dump({"start": int(start),
                       "steps": [int(m["step"]) for m in metrics],
                       "losses": [float(m["loss"]) for m in metrics]}, f)


if __name__ == "__main__":
    child_main()
    sys.exit(0)

# -- tests (JAX on the CPU) -------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ray_tpu.models import gpt as jgpt  # noqa: E402
from ray_tpu.parallel import MeshSpec  # noqa: E402
from ray_tpu.train import ft as jft  # noqa: E402
from ray_tpu.train import spmd as jspmd  # noqa: E402


def tree():
    """A small mixed tree: a matrix, a vector, a scalar step."""
    return {"params": {"w": torch.arange(64, dtype=torch.float32)
                       .reshape(8, 8),
                       "b": torch.ones(8)},
            "step": torch.tensor(7, dtype=torch.int32)}


def snapshot_to(root, t, step, **kw):
    ckpt = ft.AsyncCheckpointer(str(root), every=1, **kw)
    ckpt.maybe_snapshot(t, step, force=True)
    ckpt.flush()
    return ckpt


def assert_trees_equal(a, b):
    la, lb = ft.tree_leaves(a), ft.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_snapshot_restore_roundtrip(tmp_path):
    t = tree()
    ckpt = snapshot_to(tmp_path, t, 5)
    ckpt.check_invariants()
    ckpt.close()
    restored, step = ft.restore_resharded(str(tmp_path), "cpu")
    assert step == 5
    assert_trees_equal(restored, t)
    manifest = ft.load_manifest(ft.latest_checkpoint(str(tmp_path)))
    assert [s["spec"] for s in manifest["shards"]] == [[None], [None] * 2,
                                                       []]


def test_snapshot_is_a_copy_of_the_live_state(tmp_path):
    """The step updates its state in place: a snapshot holds the values
    at the call, whatever happens to the live tensors after it."""
    t = tree()
    ckpt = ft.AsyncCheckpointer(str(tmp_path), every=1)
    ckpt.maybe_snapshot(t, 1, force=True)
    t["params"]["w"].add_(1000.0)
    ckpt.flush()
    ckpt.close()
    restored, _ = ft.restore_resharded(str(tmp_path), "cpu")
    assert torch.equal(restored["params"]["w"], tree()["params"]["w"])


def test_bfloat16_leaves_roundtrip(tmp_path):
    t = {"p": torch.linspace(-2, 2, 16, dtype=torch.bfloat16)}
    snapshot_to(tmp_path, t, 1).close()
    restored, _ = ft.restore_resharded(str(tmp_path), "cpu")
    assert restored["p"].dtype == torch.bfloat16
    assert_trees_equal(restored, t)


def test_writer_crash_leaves_no_partial_checkpoint(tmp_path, monkeypatch):
    t = tree()
    snapshot_to(tmp_path, t, 2).close()     # a good previous commit
    before = ft.committed_steps(str(tmp_path))
    real = ft._write_file
    calls = {"n": 0}

    def dying(path, data):
        calls["n"] += 1
        if calls["n"] >= 2:                  # die mid-checkpoint
            raise OSError("disk full")
        real(path, data)

    monkeypatch.setattr(ft, "_write_file", dying)
    ckpt = ft.AsyncCheckpointer(str(tmp_path), every=1)
    ckpt.maybe_snapshot(t, 4, force=True)
    with pytest.raises(CheckpointError, match="disk full"):
        ckpt.flush()
    monkeypatch.setattr(ft, "_write_file", real)
    assert ft.committed_steps(str(tmp_path)) == before
    assert not any(d.startswith(".step_") for d in os.listdir(tmp_path)), \
        "crashed writer leaked a temp dir"
    ft.validate_checkpoint(before[-1][1])
    ckpt.close()


def test_partial_dir_ignored_and_empty_root_raises(tmp_path):
    os.makedirs(tmp_path / "step_00000042")    # no manifest: uncommitted
    assert ft.committed_steps(str(tmp_path)) == []
    assert ft.latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(CheckpointError, match="no committed checkpoint"):
        ft.restore_resharded(str(tmp_path), "cpu")


def test_corrupted_shard_detected(tmp_path):
    snapshot_to(tmp_path, tree(), 1).close()
    path = ft.latest_checkpoint(str(tmp_path))
    shard = os.path.join(path, "shard_00000.bin")
    blob = bytearray(open(shard, "rb").read())
    blob[0] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(blob)
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        ft.validate_checkpoint(path)
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        ft.restore_resharded(str(tmp_path), "cpu")


def test_in_flight_bound_backpressures(tmp_path, monkeypatch):
    """A slow filesystem stalls maybe_snapshot, never memory: at most
    max_in_flight snapshots sit between device and disk."""
    release = threading.Event()
    real_get = ft._device_get
    max_seen = {"q": 0}

    def slow_get(snap):
        release.wait(30)
        return real_get(snap)

    monkeypatch.setattr(ft, "_device_get", slow_get)
    ckpt = ft.AsyncCheckpointer(str(tmp_path), every=1, max_in_flight=1,
                                keep=5)
    t = tree()
    ckpt.maybe_snapshot(t, 1, force=True)   # writer dequeues, blocks
    time.sleep(0.2)
    ckpt.maybe_snapshot(t, 2, force=True)   # fills the bounded queue

    def late_release():
        time.sleep(0.3)
        max_seen["q"] = ckpt._queue.qsize()
        release.set()

    th = threading.Thread(target=late_release)
    th.start()
    ckpt.maybe_snapshot(t, 3, force=True)   # must block until release
    th.join(30)
    assert not th.is_alive()
    assert max_seen["q"] <= 1
    assert ckpt.stalls >= 1
    ckpt.flush()
    ckpt.check_invariants()
    assert ckpt.commits == 3
    assert [r["step"] for r in ckpt.timings] == [1, 2, 3]
    ckpt.close()


def test_keep_prunes_oldest(tmp_path):
    ckpt = ft.AsyncCheckpointer(str(tmp_path), every=1, keep=2)
    t = tree()
    for step in range(1, 6):
        ckpt.maybe_snapshot(t, step, force=True)
        ckpt.flush()
    assert [s for s, _ in ft.committed_steps(str(tmp_path))] == [4, 5]
    ckpt.check_invariants()
    ckpt.close()


def test_snapshot_cadence(tmp_path):
    ckpt = ft.AsyncCheckpointer(str(tmp_path), every=4, keep=10)
    t = tree()
    for step in range(1, 13):
        ckpt.maybe_snapshot(t, step)
    ckpt.flush()
    assert ckpt.snapshots == 3
    assert [s for s, _ in ft.committed_steps(str(tmp_path))] == [4, 8, 12]
    ckpt.close()


def test_fast_forward():
    it = ft.fast_forward(iter(range(10)), 4)
    assert list(it) == [4, 5, 6, 7, 8, 9]


def test_uri_root_mirrors_and_restores():
    """root='mem://...' stages locally and mirrors every commit through
    the commit-marker upload; restore works straight from the URI."""
    uri = f"mem://ftckpt/torch_{uuid.uuid4().hex}"
    t = tree()
    ckpt = ft.AsyncCheckpointer(uri, every=1, keep=1)
    ckpt.maybe_snapshot(t, 9, force=True)
    ckpt.flush()
    assert storage.is_committed(storage.uri_join(uri, "step_00000009"))
    restored, step = ft.restore_resharded(uri, "cpu")
    assert step == 9
    assert_trees_equal(restored, t)
    ckpt.close()
    storage.delete(uri)


def test_training_thread_never_fetches(tmp_path, monkeypatch):
    """With checkpointing on, every fetch ft makes happens off the
    training thread, one a snapshot, and the loop's own fetch count stays
    at its ring cadence."""
    cfg = tgpt.small(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                     d_ff=32, max_seq_len=8, dtype="float32",
                     attn_impl="xla")
    state, step_fn, place = spmd.make_gpt_trainer(cfg, device="cpu")
    main_thread = threading.get_ident()
    ft_threads, loop_fetches = [], {"n": 0}
    real_ft_get, real_loop_get = ft._device_get, loop._to_host

    def spy_ft(snap):
        ft_threads.append(threading.get_ident())
        return real_ft_get(snap)

    def spy_loop(t):
        loop_fetches["n"] += 1
        return real_loop_get(t)

    monkeypatch.setattr(ft, "_device_get", spy_ft)
    monkeypatch.setattr(loop, "_to_host", spy_loop)

    def host():
        rng = np.random.default_rng(0)
        while True:
            toks = rng.integers(0, cfg.vocab_size, (8, cfg.max_seq_len + 1),
                                np.int32)
            yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    steps, every = 20, 5
    ckpt = ft.AsyncCheckpointer(str(tmp_path), every=every, keep=2)
    train = loop.TrainLoop(step_fn, metrics_interval=10, checkpointer=ckpt)
    state, metrics = train.run(state, loop.DevicePrefetcher(host(), place),
                               num_steps=steps)
    ckpt.check_invariants()
    ckpt.close()
    assert len(metrics) == steps
    assert len(ft_threads) == ckpt.snapshots == steps // every
    assert all(t != main_thread for t in ft_threads)
    assert loop_fetches["n"] <= steps // 10 + 1
    # the last commit is the state the loop ended with
    restored, step = ft.restore_resharded(str(tmp_path), "cpu")
    assert step == steps
    back = ft.state_from_tree(restored, cfg, "cpu")
    for a, b in zip(back.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(back.opt_state[k], state.opt_state[k]):
            assert torch.equal(a, b)
    assert int(back.opt_state["count"]) == int(back.step) == steps


def test_checkpoint_dict_directory_uri_roundtrip(tmp_path):
    """`Checkpoint`: dict -> directory (arrays in the shard + manifest
    layout, the rest pickled) -> dict, bf16 included, and through a
    committed mem:// upload; an interrupted upload is refused."""
    data = {"params": {"w": torch.randn(4, 3),
                       "h": np.arange(6, dtype=np.int32).reshape(2, 3),
                       "b": torch.randn(5).to(torch.bfloat16)},
            "epoch": 3, "note": "x"}
    w0 = data["params"]["w"].clone()
    ck = Checkpoint.from_dict(data)
    data["params"]["w"].add_(1.0)            # the snapshot is a copy
    path = ck.to_directory(str(tmp_path / "ck"))
    assert sorted(os.listdir(path)) == ["arrays", "data.pkl"]
    back = Checkpoint.from_directory(path).to_dict()
    assert back["epoch"] == 3 and back["note"] == "x"
    assert torch.equal(back["params"]["w"], w0)
    assert torch.equal(back["params"]["h"],
                       torch.from_numpy(data["params"]["h"]))
    assert torch.equal(back["params"]["b"], data["params"]["b"])
    uri = f"mem://ckpt/torch_{uuid.uuid4().hex}"
    ck.to_uri(uri)
    got = Checkpoint.from_uri(uri).to_dict()
    assert torch.equal(got["params"]["b"], data["params"]["b"])
    storage.delete(storage.uri_join(uri, storage.COMMIT_FILE))
    with pytest.raises(CheckpointError, match="no commit marker"):
        Checkpoint.from_uri(uri)
    storage.delete(uri)


def test_orbax_directory_is_refused_not_read_as_empty(tmp_path):
    """A reference directory whose arrays orbax wrote (``pytree/``) raises
    naming orbax."""
    os.makedirs(tmp_path / "ck" / "pytree")
    with open(tmp_path / "ck" / "data.pkl", "wb") as f:
        pickle.dump({"epoch": 1}, f)
    with pytest.raises(CheckpointError, match="orbax"):
        Checkpoint.from_directory(str(tmp_path / "ck")).to_dict()


# -- across the packages ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX `TrainState` of `gpt.small(dtype="float32")` trained 2 steps
    on an 8-device mesh (data 2 x fsdp 4, so parameters and moments are
    sharded), checkpointed by the JAX `AsyncCheckpointer`, then 3 more
    steps: (root, cfgs, optimizer kwargs, the state at step 2 on the
    host, the losses of steps 3-5)."""
    mesh = MeshSpec(data=2, fsdp=4).build(jax.devices())
    jcfg = jgpt.small(dtype="float32", attn_impl="xla")
    tcfg = tgpt.small(dtype="float32", attn_impl="xla")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state, step_fn, shard = jspmd.make_gpt_trainer(
        jcfg, mesh, optimizer=jspmd.default_optimizer(**kw))
    root = str(tmp_path_factory.mktemp("jax_ft"))
    for s in range(2):
        state, _ = step_fn(state, shard(_batch(jcfg.vocab_size, s)))
    ckpt = jft.AsyncCheckpointer(root, every=1)
    ckpt.maybe_snapshot(state, 2, force=True)
    ckpt.flush()
    ckpt.close()
    at2 = jax.tree.map(np.asarray, state)
    losses = []
    for s in range(2, 5):
        state, m = step_fn(state, shard(_batch(jcfg.vocab_size, s)))
        losses.append(float(m["loss"]))
    return root, (jcfg, tcfg), kw, at2, losses


def _batch(vocab, seed, b=8, t=32):
    toks = np.random.default_rng(100 + seed).integers(
        0, vocab, (b, t + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def test_jax_checkpoint_restores_into_the_port_and_trains_on(jax_run):
    root, (jcfg, tcfg), kw, at2, losses = jax_run
    manifest = ft.load_manifest(ft.latest_checkpoint(root))
    assert any(any(s["spec"]) for s in manifest["shards"]), \
        "no sharded leaf in the JAX checkpoint"
    tree_, step = ft.restore_resharded(root, "cpu")
    assert step == 2
    state = ft.state_from_tree(tree_, tcfg, "cpu")
    # parameters and both moments bit for bit
    names = [n for n, _ in state.params.named_parameters()]
    adam = at2.opt_state[1][0]
    for i, (n, p) in enumerate(state.params.named_parameters()):
        want = at2.params
        for k in n.split("."):
            want = want[k]
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=n)
        for got, tree_m in ((state.opt_state["mu"][i], adam.mu),
                            (state.opt_state["nu"][i], adam.nu)):
            for k in names[i].split("."):
                tree_m = tree_m[k]
            np.testing.assert_array_equal(got.numpy(), tree_m, err_msg=n)
    assert int(state.opt_state["count"]) == int(adam.count) == 2
    assert int(state.step) == 2
    _, step_fn, place = spmd.make_gpt_trainer(
        tcfg, optimizer=spmd.default_optimizer(**kw), device="cpu",
        init_state=False)
    got = []
    for s in range(2, 5):
        state, m = step_fn(state, place(_batch(tcfg.vocab_size, s)))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, losses, rtol=0, atol=1e-5)
    assert int(state.step) == 5


def test_port_checkpoint_reads_back_in_jax(jax_run, tmp_path):
    """The port writes the reference's layout: the JAX package restores a
    port-written train state (the skeleton names the reference's
    classes) onto its mesh, equal leaf for leaf."""
    root, (jcfg, tcfg), _, at2, _ = jax_run
    tree_, _ = ft.restore_resharded(root, "cpu")
    state = ft.state_from_tree(tree_, tcfg, "cpu")
    snapshot_to(tmp_path, state, 2).close()
    mesh = MeshSpec(data=2, fsdp=4).build(jax.devices())
    back, step = jft.restore_resharded(str(tmp_path), mesh)
    assert step == 2
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(at2)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(at2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_mem_uri_upload_reads_back_in_the_port():
    """Both packages root ``mem://`` at the same place: a JAX mirror
    restores through the port's storage."""
    mesh = MeshSpec(data=-1).build(jax.devices())
    uri = f"mem://ftckpt/jax_{uuid.uuid4().hex}"
    t = {"w": jax.device_put(jnp.arange(16.0).reshape(8, 2),
                             NamedSharding(mesh, P("data", None)))}
    ckpt = jft.AsyncCheckpointer(uri, every=1, keep=1)
    ckpt.maybe_snapshot(t, 3, force=True)
    ckpt.flush()
    ckpt.close()
    restored, step = ft.restore_resharded(uri, "cpu")
    assert step == 3
    np.testing.assert_array_equal(restored["w"].numpy(), np.asarray(t["w"]))
    storage.delete(uri)


def test_jax_bf16_leaf_reads_back_bit_exact(tmp_path):
    mesh = MeshSpec(data=-1).build(jax.devices())
    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 5)) * 100,
                    jnp.bfloat16)
    t = {"p": jax.device_put(x, NamedSharding(mesh, P("data", None)))}
    ckpt = jft.AsyncCheckpointer(str(tmp_path), every=1)
    ckpt.maybe_snapshot(t, 1, force=True)
    ckpt.flush()
    ckpt.close()
    restored, _ = ft.restore_resharded(str(tmp_path), "cpu")
    assert restored["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["p"].view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))


@pytest.mark.parametrize("name", ["collections.OrderedDict", "os.system",
                                  "optax._src.base.GradientTransformation"])
def test_unknown_class_in_skeleton_is_refused(tmp_path, name):
    snapshot_to(tmp_path, tree(), 1).close()
    path = ft.latest_checkpoint(str(tmp_path))
    module, _, cls = name.rpartition(".")
    # protocol 2: GLOBAL module\nname\n, NEWOBJ with no arguments
    skel = b"\x80\x02c%s\n%s\n)\x81." % (module.encode(), cls.encode())
    with open(os.path.join(path, "skeleton.pkl"), "wb") as f:
        f.write(skel)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["skeleton"]["sha256"] = ft._sha256(skel)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointError, match="not one of"):
        ft.restore_resharded(str(tmp_path), "cpu")


# -- kill/resume --------------------------------------------------------------------

def _run_child(env_over: dict, timeout: float = 240):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in env_over.items()})
    return subprocess.run([sys.executable, os.path.abspath(__file__)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_trainer_kill_resume_bitwise(tmp_path):
    """A control run with no checkpointer; a victim checkpointing every 3
    steps SIGKILLs itself at batch 8 once a commit exists; a resume from
    its last committed step reproduces the control's losses bit for bit
    (JSON float round trips are exact)."""
    ctl_out = str(tmp_path / "control.json")
    r = _run_child({"FT_ROOT": str(tmp_path / "unused"), "FT_OUT": ctl_out,
                    "FT_STEPS": 12, "FT_EVERY": 0})
    assert r.returncode == 0, r.stderr[-2000:]
    with open(ctl_out) as f:
        control = json.load(f)
    assert control["steps"] == list(range(1, 13))

    root = str(tmp_path / "ckpts")
    r = _run_child({"FT_ROOT": root, "FT_STEPS": 12, "FT_EVERY": 3,
                    "FT_CRASH_AT": 8})
    assert r.returncode == -signal.SIGKILL, \
        f"rc={r.returncode}\n{r.stderr[-2000:]}"
    os.makedirs(os.path.join(root, "step_00000099"))      # no manifest
    os.makedirs(os.path.join(root, ".step_00000098.tmp-1-abcdef"))
    latest = ft.latest_checkpoint(root)
    assert latest is not None, "kill left no committed checkpoint"
    step = ft.validate_checkpoint(latest)["step"]
    assert 0 < step < 12, step

    out = str(tmp_path / "resume.json")
    r = _run_child({"FT_ROOT": root, "FT_OUT": out, "FT_MODE": "resume",
                    "FT_STEPS": 12, "FT_EVERY": 3})
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as f:
        res = json.load(f)
    assert res["start"] == step
    assert res["steps"] == list(range(step + 1, 13))
    assert res["losses"] == control["losses"][step:]
