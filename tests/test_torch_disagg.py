"""Disaggregated prefill/decode serving in the port
(`ray_tpu_torch.serve.engine` roles, `models.gpt` block gather/scatter,
`ray_tpu_torch.serve.disagg`) against the JAX package, on the CPU.

It follows `tests/test_serve_disagg.py`'s engine cases with the port
beside the reference, on the same tiny config in float32 (vocab 128,
d_model 32, 2 layers, 2 heads) with the JAX weights carried across by
`params_from_numpy`: the block gather and scatter exactly, the exported
blobs (payload within 1e-5; int8 rows within one step and scales within
1e-5), a JAX blob imported by the port, the port's disaggregated greedy
streams against the JAX colocated ones for plain, n-gram, draft and int8
serving with the reference's stats checks, shared prefixes, cancels and
rejected blobs, and imports under block pressure and across a weight
swap against the JAX engine. The transport runs the port's replica pair
over localhost (netaddr): the pull, the fallback to a local prefill, a
failing send, the wire frames of bf16 blobs, and the replicas' `close`.
The JAX engines' streams and blobs are computed once per module.

Every socket wait is bounded (netaddr's channels time out every read
and write; the block server polls) and every replica is closed by its
fixture."""

import gc
import os
import socket
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import engine as jengine
from ray_tpu_torch._private import config, netaddr
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import (DecodeReplica, InferenceEngine,
                                 InferenceReplica, PrefillReplica, disagg,
                                 disagg_resume)
from ray_tpu_torch.util import faults as tfaults

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq_len=128, dtype="float32")
ENGINE = dict(slots=2, max_len=128, block_size=8)
PROMPTS = [[5, 9, 3, 17, 2, 88, 41, 7, 19, 23, 55, 1, 4, 9],
           [5, 9, 3, 17, 2, 88, 41, 7, 100, 101],
           [7] * 37,
           [1, 2, 3]]
NEW = 12
INT8 = {"kv_dtype": "int8", "weight_dtype": "int8"}
MATRIX = {"plain": ({}, {}), "ngram": ({"spec": "ngram"}, {}),
          "draft": ("draft", {}), "int8": ({}, INT8)}


def _jcfg(**kw):
    return jgpt.GPTConfig(**{**CFG, **kw})


def _tcfg(**kw):
    return tgpt.GPTConfig(**{**CFG, **kw})


@pytest.fixture(scope="module")
def params():
    """The JAX weights (seed 0) and a 1-layer draft (seed 1)."""
    return {"target": jgpt.init_params(jax.random.PRNGKey(0), _jcfg()),
            "draft": jgpt.init_params(jax.random.PRNGKey(1),
                                      _jcfg(n_layers=1))}


def _engine_kw(which, ek, params):
    """Engine kwargs of one matrix row for ``which`` ("jax" or "port"):
    ``ek == "draft"`` is a 1-layer draft model of seed 1."""
    if ek != "draft":
        return dict(ek)
    if which == "jax":
        return {"spec": "draft", "draft_cfg": _jcfg(n_layers=1),
                "draft_params": params["draft"]}
    dcfg = _tcfg(n_layers=1)
    return {"spec": "draft", "draft_cfg": dcfg,
            "draft_params": _port_model(params["draft"], dcfg)}


def _port_model(tree, cfg):
    return tgpt.params_from_numpy(jax.tree.map(np.asarray, tree), cfg,
                                  device="cpu")


def _jax(params, cfg_kw=None, role=None, ek=None, tree=None, **kw):
    cfg = _jcfg(**(cfg_kw or {}))
    if role:
        kw["role"] = role
    return jengine.InferenceEngine(
        params["target"] if tree is None else tree, cfg,
        **{**ENGINE, **kw}, **_engine_kw("jax", ek or {}, params))


def _port(params, cfg_kw=None, role=None, ek=None, tree=None, **kw):
    cfg = _tcfg(**(cfg_kw or {}))
    if role:
        kw["role"] = role
    model = _port_model(params["target"] if tree is None else tree, cfg)
    return InferenceEngine(model, cfg, device="cpu", **{**ENGINE, **kw},
                           **_engine_kw("port", ek or {}, params))


def _tokens(it):
    return [int(t) for t in it]


def _disagg(pre, dec, prompt, n):
    blob = pre.handoff_for(pre.submit(list(prompt), max_new_tokens=n))
    return _tokens(dec.tokens_for(dec.import_handoff(blob)))


@pytest.fixture(scope="module")
def jax_runs(params):
    """Per matrix row, the JAX colocated streams of PROMPTS; for the plain
    and int8 rows also the JAX prefill engine's blobs of PROMPTS and its
    pool after them."""
    out = {}
    for label, (ek, cfg_kw) in MATRIX.items():
        col = _jax(params, cfg_kw, ek=ek)
        row = {"streams": [_tokens(col.generate(list(p), max_new_tokens=NEW))
                           for p in PROMPTS]}
        if label in ("plain", "int8"):
            pre = _jax(params, cfg_kw, role="prefill")
            row["blobs"] = [pre.handoff_for(pre.submit(p,
                                                       max_new_tokens=NEW))
                            for p in PROMPTS]
            row["pool"] = {k: np.asarray(v) for k, v in pre.cache.items()}
        out[label] = row
    return out


# ---------------------------------------------------------------------------
# gather_block / scatter_block against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["plain", "int8"])
def test_gather_and_scatter_block_match_jax(params, jax_runs, label):
    """The JAX prefill engine's pool after PROMPTS, carried into a port
    pool: every block gathers to the same rows (entries and shapes the
    reference's, no ``_rows`` alias), the batched gather stacks them, and
    scattering a block, singly or batched, leaves both pools equal."""
    jpool = jax_runs[label]["pool"]
    cfg = _tcfg(**MATRIX[label][1])
    n_blocks = jpool["k"].shape[1]
    pool = tgpt.init_kv_pool(cfg, n_blocks, ENGINE["block_size"], "cpu")
    for name, arr in jpool.items():
        pool[name].copy_(torch.from_numpy(np.array(arr)))
    want = {"k", "v"} | ({"k_scale", "v_scale"} if label == "int8"
                         else set())
    assert set(jpool) == set(tgpt.pool_entries(pool)) == want
    used = list(range(1, 11))
    for b in used:
        jb = jgpt.gather_block(jpool, b)
        tb = tgpt.gather_block(pool, b)
        assert set(tb) == set(jb)
        for name in jb:
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]))
    batched = tgpt.gather_blocks(pool, used)
    for j, b in enumerate(used):
        for name in batched:
            assert torch.equal(batched[name][j], pool[name][:, b])
    jpool = jgpt.scatter_block(jpool, jgpt.gather_block(jpool, 3), 20)
    tgpt.scatter_block(pool, tgpt.gather_block(pool, 3), 20)
    jpool = jgpt.scatter_block(jpool, jgpt.gather_block(jpool, 5), 21)
    ptrs = {name: t.data_ptr() for name, t in pool.items()}
    tgpt.scatter_blocks(pool, tgpt.gather_blocks(pool, [5]), [21])
    assert ptrs == {name: t.data_ptr() for name, t in pool.items()}
    for name in jpool:
        np.testing.assert_array_equal(pool[name].numpy(),
                                      np.asarray(jpool[name]))


# ---------------------------------------------------------------------------
# the blob against the reference's, and a reference blob in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["plain", "int8"])
def test_export_blob_matches_jax(params, jax_runs, label):
    """The port's export of PROMPTS against the JAX export: the same keys
    (the port adds ``dtypes`` and ``kv_host``), block counts, first token
    and its version; the logprob and f32 payload within 1e-5, int8 rows
    within one quantization step and scales within 1e-5."""
    pre = _port(params, MATRIX[label][1], role="prefill")
    for jb, p in zip(jax_runs[label]["blobs"], PROMPTS):
        tb = pre.handoff_for(pre.submit(p, max_new_tokens=NEW))
        assert set(tb) == set(jb) | {"dtypes", "kv_host"}
        for k in ("n_blocks", "token", "token_ver", "max_new_tokens",
                  "block_size", "params_version", "priority", "kv_bytes",
                  "temperature", "eos_id"):
            assert tb[k] == jb[k], k
        np.testing.assert_array_equal(tb["prompt"], jb["prompt"])
        assert abs(tb["token_logp"] - jb["token_logp"]) <= 1e-5
        assert tb["draft_payload"] is None and jb["draft_payload"] is None
        assert len(tb["payload"]) == len(jb["payload"]) == tb["n_blocks"]
        for tblk, jblk in zip(tb["payload"], jb["payload"]):
            assert set(tblk) == set(jblk)
            for name, arr in jblk.items():
                arr = np.asarray(arr)
                assert tblk[name].shape == arr.shape
                assert tblk[name].dtype == arr.dtype
                if arr.dtype == np.int8:
                    diff = np.abs(tblk[name].astype(np.int32)
                                  - arr.astype(np.int32))
                    assert diff.max() <= 1, name
                else:
                    np.testing.assert_allclose(tblk[name], arr, atol=1e-5,
                                               rtol=0)
        assert tb["dtypes"]["payload"] == {
            name: str(np.asarray(a).dtype)
            for name, a in jb["payload"][0].items()}
    pre.check_invariants()


def test_jax_blob_imports_into_the_port(params, jax_runs):
    """A JAX f32 prefill engine's blobs continue in the port's decode
    engine with the JAX colocated streams."""
    dec = _port(params, role="decode")
    got = [_tokens(dec.tokens_for(dec.import_handoff(b)))
           for b in jax_runs["plain"]["blobs"]]
    assert got == jax_runs["plain"]["streams"]
    dec.check_invariants()
    assert dec.stats()["imports"] == len(PROMPTS)


# ---------------------------------------------------------------------------
# the tentpole: token identity across the decode backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(MATRIX))
def test_disagg_token_identity_matrix(params, jax_runs, label):
    """Port prefill-role export -> port decode-role import reproduces the
    JAX colocated greedy streams for every decode backend; the
    reference's stats checks hold, and a prefill-role engine builds and
    runs no decode step."""
    ek, cfg_kw = MATRIX[label]
    pre = _port(params, cfg_kw, role="prefill", ek=ek)
    dec = _port(params, cfg_kw, role="decode", ek=ek)
    got = [_disagg(pre, dec, p, NEW) for p in PROMPTS]
    assert got == jax_runs[label]["streams"]
    pre.check_invariants()
    dec.check_invariants()
    ps, ds = pre.stats(), dec.stats()
    assert ps["role"] == "prefill" and ds["role"] == "decode"
    assert ps["handoffs"] == len(PROMPTS)
    assert ds["imports"] == len(PROMPTS)
    assert ps["decode_steps"] == 0, "a prefill-role engine decoded"
    assert ps["decode_traces"] == ps["verify_traces"] == 0
    assert ("decode", None) not in pre._steps
    assert ps["kv_blocks_exported"] > 0
    assert ps["kv_export_bytes"] > 0 and ds["kv_import_bytes"] > 0
    drafted = ek == "draft"
    assert ps["kv_gather_traces"] == ds["kv_scatter_traces"] == 1 + drafted
    assert ps["kv_blocks_exported"] == (1 + drafted) * sum(
        (len(p) - 1) // ENGINE["block_size"] + 1 for p in PROMPTS)
    assert ps["retraces_unexpected"] == ds["retraces_unexpected"] == 0
    assert ps["queue_depth"] == ds["queue_depth"] == 0


def test_disagg_shared_prefix_matches_jax(params, jax_runs):
    """Prompts sharing two full blocks: the decode pool shares the
    radix-cached blocks at import instead of scattering them again, with
    the JAX engines' exported and imported block counts and the JAX
    colocated tokens."""
    shared = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
    prompts = [shared + [40 + i, 41 + i] for i in range(3)]
    counts = {}
    for which, make in (("jax", _jax), ("port", _port)):
        pre, dec = make(params, role="prefill"), make(params, role="decode")
        counts[which] = ([_disagg(pre, dec, p, 10) for p in prompts],
                         pre.stats()["kv_blocks_exported"],
                         dec.stats()["kv_blocks_imported"],
                         dec.stats()["prefix_hit_tokens"])
        pre.check_invariants()
        dec.check_invariants()
    col = _jax(params)
    want = [_tokens(col.generate(p, max_new_tokens=10)) for p in prompts]
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] == want
    assert counts["port"][2] < counts["port"][1]


# ---------------------------------------------------------------------------
# cancellation and rejected blobs
# ---------------------------------------------------------------------------

def test_disagg_cancel_frees_blocks_both_sides(params):
    """(a) cancelled while queued, (b) exported but never collected
    (``handoffs_abandoned``), (c) imported and cancelled mid-stream: both
    pools return to their free count once the radix cache is evicted,
    and a queued import cancels too."""
    pre, dec = _port(params, role="prefill"), _port(params, role="decode")
    free_pre, free_dec = pre._alloc.free, dec._alloc.free

    def drained(eng, baseline):
        if eng._tree is not None:
            eng._tree.evict(10 ** 6)
        return eng._alloc.free == baseline

    rid = pre.submit([9] * 30, max_new_tokens=8)
    assert pre.cancel(rid)
    assert drained(pre, free_pre)
    with pytest.raises(KeyError):
        pre.handoff_for(rid)

    blob = pre.handoff_for(pre.submit([8] * 20, max_new_tokens=8))
    rid3 = pre.submit([4] * 20, max_new_tokens=8)
    while rid3 not in pre._handoffs:
        pre.step()
    pre.check_invariants()
    assert pre.cancel(rid3)
    assert pre.take_handoff(rid3) is None
    assert pre.stats()["handoffs_abandoned"] == 1
    assert drained(pre, free_pre)

    drid = dec.import_handoff(blob)
    assert dec.stats()["imports_queued"] == dec.stats()["queue_depth"] == 1
    dec.check_invariants()
    it = dec.tokens_for(drid)
    assert next(it) is not None
    assert dec.cancel(drid)
    it.close()
    assert drained(dec, free_dec)
    queued = dec.import_handoff(blob)
    assert dec.cancel(queued) and not dec._imports and not dec._import_rids
    assert dec.stats()["cancelled"] == 2
    pre.check_invariants()
    dec.check_invariants()


def test_import_rejects_mismatched_blob(params):
    """The reference's rejections, with its messages, and the port's
    checks of the payload's entries, shapes and dtypes; the untouched
    blob still imports after them."""
    pre, dec = _port(params, role="prefill"), _port(params, role="decode")
    blob = pre.handoff_for(pre.submit([1, 2, 3, 4], max_new_tokens=4))
    with pytest.raises(ValueError, match="block_size"):
        dec.import_handoff(dict(blob, block_size=blob["block_size"] * 2))
    with pytest.raises(ValueError, match="max_len"):
        dec.import_handoff(dict(blob, max_new_tokens=10_000))
    with pytest.raises(ValueError, match="priority"):
        dec.import_handoff(dict(blob, priority=99))
    with pytest.raises(ValueError, match="payload has 2 blocks"):
        dec.import_handoff(dict(blob, payload=blob["payload"] * 2))
    with pytest.raises(ValueError, match="entries"):
        dec.import_handoff(dict(blob,
                                payload=[{"k": blob["payload"][0]["k"]}]))
    bad = {n: a.astype(np.float64) for n, a in blob["payload"][0].items()}
    with pytest.raises(ValueError, match="pool's rows"):
        dec.import_handoff(dict(blob, payload=[bad]))
    with pytest.raises(RuntimeError):
        pre.import_handoff(blob)
    with pytest.raises(RuntimeError):
        dec.handoff_for(0)
    with pytest.raises(ValueError, match="unknown engine role 'bogus'"):
        _port(params, role="bogus")
    draft = _port(params, role="decode", ek="draft")
    with pytest.raises(ValueError, match="draft-pool blocks"):
        draft.import_handoff(blob)
    assert len(list(dec.tokens_for(dec.import_handoff(blob)))) == 4
    dec.check_invariants()


# ---------------------------------------------------------------------------
# imports under block pressure and across a weight swap, against JAX
# ---------------------------------------------------------------------------

LONG = list(range(1, 17))           # 2 blocks of 8


def _peaked(params):
    return {**params["target"], "embed": params["target"]["embed"] * 8}


def _imported_preempted(make, pre, tree):
    """An imported class-0 stream is preempted by a class-1 arrival under
    block pressure (6 usable blocks, 4 a request) and resumes."""
    eng = make(role="decode", cache_blocks=7, priority_classes=2)
    ra = eng.import_handoff(pre.handoff_for(pre.submit(LONG,
                                                       max_new_tokens=12)))
    for _ in range(3):
        eng.step()
    rb = eng.submit([9] * 16, max_new_tokens=12, priority=1)
    return eng, [ra, rb]


def _import_preempts(make, pre, tree):
    """A class-1 import preempts the decoding class-0 stream."""
    eng = make(role="decode", cache_blocks=7, priority_classes=2)
    ra = eng.submit([9] * 16, max_new_tokens=12, priority=0)
    for _ in range(3):
        eng.step()
    blob = pre.handoff_for(pre.submit(LONG, max_new_tokens=12, priority=1))
    rb = eng.import_handoff(blob)
    return eng, [ra, rb]


def _cross_version(make, pre, tree):
    """The decode engine swapped (to the same weights, ``tree``) to
    version 1 imports a version-0 blob: the stream continues, its blocks
    never enter the radix tree (a later submit of the same prompt hits
    nothing), its tokens carry version 0 for the parked one and 1 after."""
    eng = make(role="decode")
    eng.update_params(tree)
    ra = eng.import_handoff(pre.handoff_for(pre.submit(LONG,
                                                       max_new_tokens=6)))
    first = [(int(t), t.params_version) for t in eng.tokens_for(ra)]
    rb = eng.submit(LONG, max_new_tokens=6)
    return eng, first, rb


@pytest.mark.parametrize("scenario", [_imported_preempted, _import_preempts,
                                      _cross_version])
def test_imports_under_pressure_and_swaps_match_jax(params, scenario):
    """On peaked weights (embed x 8) and no aging: the streams (tokens and
    versions; logprobs within 1e-4), preemptions and prefix hits of the
    port equal the JAX engine's, invariants hold every tick, and a
    preempted import resumes with the tokens of an unpressured run."""
    tree = _peaked(params)
    got = {}
    for which, make in (("jax", _jax), ("port", _port)):
        pre = make(params, role="prefill", tree=tree, priority_classes=2)
        res = scenario(
            lambda **kw: make(params, tree=tree, priority_aging_s=1e6, **kw),
            pre, tree if which == "jax" else jax.tree.map(np.asarray, tree))
        eng, rids = res[0], res[-1]
        first = res[1] if len(res) == 3 else None
        rids = rids if isinstance(rids, list) else [rids]
        while eng.step():
            eng.check_invariants()
        outs = [[(int(t), t.logprob, t.params_version)
                 for t in eng.tokens_for(r)] for r in rids]
        eng.check_invariants()
        st = eng.stats()
        got[which] = {"outs": outs, "first": first,
                      "stats": {k: st[k] for k in (
                          "preemptions", "prefix_hit_tokens", "imports",
                          "kv_blocks_imported", "reprefill_blocks")}}
    j, t = got["jax"], got["port"]
    assert t["stats"] == j["stats"]
    assert t["first"] == j["first"]
    for go, wo in zip(t["outs"], j["outs"]):
        assert [(a, v) for a, _, v in go] == [(a, v) for a, _, v in wo]
        np.testing.assert_allclose([lp for _, lp, _ in go],
                                   [lp for _, lp, _ in wo], atol=1e-4, rtol=0)
    if scenario is not _cross_version:
        assert t["stats"]["preemptions"] >= 1
        calm = _port(params, tree=tree)
        want = [_tokens(calm.generate(p, max_new_tokens=12))
                for p in (LONG, [9] * 16)]
        order = [0, 1] if scenario is _imported_preempted else [1, 0]
        assert [[a for a, _, _ in o] for o in t["outs"]] == \
            [want[i] for i in order]
    else:
        assert t["stats"]["prefix_hit_tokens"] == 0
        assert [v for _, v in t["first"]] == [0] + [1] * 5


# ---------------------------------------------------------------------------
# the transport: the replica pair over localhost netaddr
# ---------------------------------------------------------------------------

REPLICA = dict(cfg_kwargs=CFG, slots=2, max_len=64, seed=0, device="cpu")


@pytest.fixture
def replicas(monkeypatch):
    """A PrefillReplica and a DecodeReplica on the tiny config (the same
    seed), advertising 127.0.0.1, closed at teardown."""
    monkeypatch.setenv("RAY_TPU_NODE_IP", "127.0.0.1")
    config.reset_caches()
    tfaults.clear()
    made = []

    def make(cls, **kw):
        r = cls(**{**REPLICA, **kw})
        made.append(r)
        return r

    yield make
    tfaults.clear()
    for r in made:
        r.close()
    for r in made:
        if isinstance(r, PrefillReplica):
            assert not r._accept_thread.is_alive()
            assert not any(t.is_alive() for t in r._served)
    config.reset_caches()


def test_replica_pair_over_localhost_matches_local(replicas):
    """Descriptors pulled over netaddr continue token-identically to a
    local replica of the same seed; the pulls are counted, a pulled
    handoff is gone from the server, and `close` stops every thread."""
    pre = replicas(PrefillReplica)
    dec = replicas(DecodeReplica)
    local = InferenceReplica(**REPLICA)
    for p, n in (([5, 9, 3], 8), (list(range(1, 30)), 6)):
        desc = pre(p, max_new_tokens=n)
        assert desc["handoff_addr"].startswith("127.0.0.1:")
        assert _tokens(dec(desc)) == _tokens(local(p, max_new_tokens=n))
    st = dec.stats()
    assert st["imports"] == 2 and st["handoff_fallbacks"] == 0
    assert st["kv_pulled_bytes"] == st["kv_import_bytes"] > 0
    assert st["kv_transfer_gbps"] > 0 and st["handoff_pull_ms_p99"] > 0
    assert pre.stats()["handoffs_parked"] == 0
    assert pre.stats()["decode_steps"] == 0
    # a pulled handoff streams out once: a second pull falls back
    assert _tokens(dec(desc)) == _tokens(local(list(range(1, 30)),
                                               max_new_tokens=6))
    assert dec.stats()["handoff_fallbacks"] == 1
    dec.engine.check_invariants()
    threads = list(pre._served)
    pre.close()
    dec.close()
    assert not pre._accept_thread.is_alive()
    assert threads and not any(t.is_alive() for t in threads)


def test_pulled_frames_land_in_one_host_buffer(replicas):
    """A pull receives every frame into one `handoff_buffer` that the blob
    carries as ``kv_host`` (the payload arrays are views of it), and the
    import from it continues like a local replica."""
    pre = replicas(PrefillReplica)
    dec = replicas(DecodeReplica)
    local = InferenceReplica(**REPLICA)
    prompt = list(range(2, 22))
    blob = dec._pull_blob(pre(prompt, max_new_tokens=5))
    host = blob["kv_host"].numpy()
    assert len(blob["payload"]) == blob["n_blocks"] == 2
    for blk in blob["payload"]:
        assert all(np.shares_memory(a, host) for a in blk.values())
    rid = dec.engine.import_handoff(blob)
    assert _tokens(dec.engine.tokens_for(rid)) == _tokens(
        local(prompt, max_new_tokens=5))


def test_concurrent_pulls_share_one_connection(replicas):
    """Pulls racing to one block server dial it once: one connection on
    each side, every stream token-identical."""
    pre = replicas(PrefillReplica)
    dec = replicas(DecodeReplica, slots=4)
    local = InferenceReplica(**REPLICA)
    prompts = [[3 + i, 9, 4, 1 + i] for i in range(4)]
    descs = [pre(p, max_new_tokens=4) for p in prompts]
    outs = [None] * len(descs)

    def pull(i):
        outs[i] = _tokens(dec(descs[i]))

    threads = [threading.Thread(target=pull, args=(i,))
               for i in range(len(descs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert outs == [_tokens(local(p, max_new_tokens=4)) for p in prompts]
    assert len(dec._conns) == 1 and len(pre._served) == 1
    assert dec.stats()["handoff_fallbacks"] == 0


def test_channels_turn_nagle_off():
    """Both ends of a netaddr channel send each frame at once (no wait
    for the peer's delayed ACK)."""
    key = os.urandom(16)
    lst = netaddr.listener(("127.0.0.1", 0))
    lst.settimeout(5.0)
    ends = {}

    def dial():
        ends["client"] = netaddr.client(netaddr.bound_address(lst), key, 5.0)

    t = threading.Thread(target=dial)
    t.start()
    try:
        ends["server"] = netaddr.serve(lst.accept()[0], key, 5.0)
        t.join(timeout=10)
        assert set(ends) == {"client", "server"}
        for c in ends.values():
            s = socket.socket(fileno=os.dup(c.fileno()))
            try:
                assert s.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
            finally:
                s.close()
    finally:
        for c in ends.values():
            c.close()
        lst.close()


def test_decode_fallback_when_prefill_unreachable(replicas):
    """A descriptor whose block server is gone: a full local prefill,
    token-identical and counted."""
    dec = replicas(DecodeReplica)
    local = InferenceReplica(**REPLICA)
    desc = {"handoff_addr": "127.0.0.1:9", "handoff_key": "00" * 16,
            "handoff_id": 1, "prompt": [5, 9, 3], "max_new_tokens": 8,
            "temperature": 0.0, "priority": 0, "kv_bytes": 0}
    assert _tokens(dec(desc)) == _tokens(local([5, 9, 3], max_new_tokens=8))
    assert dec.stats()["handoff_fallbacks"] == 1
    dec.engine.check_invariants()


def test_failed_send_raises_and_leaves_the_pool(replicas):
    """``netaddr.send`` failing on the decode side: `resume_from` raises
    FaultInjected (not a fallback, as in the reference), the decode
    pool is untouched, and the parked handoff is still there."""
    pre = replicas(PrefillReplica)
    dec = replicas(DecodeReplica)
    desc = pre([5, 9, 3, 17, 2, 88, 41, 7, 19], max_new_tokens=4)
    before = {n: t.clone() for n, t in dec.engine.cache.items()}
    free = dec.engine._alloc.free
    tfaults.install(tfaults.FaultPlan().fail("netaddr.send"))
    with pytest.raises(tfaults.FaultInjected):
        dec.resume_from(desc)
    assert tfaults.fired() == [("netaddr.send", 0, "fail")]
    for n, t in dec.engine.cache.items():
        assert torch.equal(t, before[n])
    assert dec.engine._alloc.free == free
    st = dec.stats()
    assert st["imports"] == st["handoff_fallbacks"] == 0
    assert pre.stats()["handoffs_parked"] == 1
    tfaults.clear()


def test_silent_peer_times_out_into_the_fallback(replicas, monkeypatch):
    """A listener that accepts and never answers the handshake (a frozen
    process, or a foreign server on the port): the dial's bounded wait
    ends it, and the decode side prefills locally."""
    monkeypatch.setattr(DecodeReplica, "_PULL_TIMEOUT_S", 0.3)
    dec = replicas(DecodeReplica)
    local = InferenceReplica(**REPLICA)
    lst = socket.create_server(("127.0.0.1", 0))
    try:
        desc = {"handoff_addr": "127.0.0.1:%d" % lst.getsockname()[1],
                "handoff_key": "00" * 16, "handoff_id": 1,
                "prompt": [5, 9, 3], "max_new_tokens": 6,
                "temperature": 0.0, "priority": 0, "kv_bytes": 0}
        t0 = time.monotonic()
        stream = dec(desc)
        assert time.monotonic() - t0 < 5.0
        assert _tokens(stream) == _tokens(local([5, 9, 3], max_new_tokens=6))
    finally:
        lst.close()
    assert dec.stats()["handoff_fallbacks"] == 1 and not dec._conns


def test_dropped_send_times_out_into_the_fallback(replicas, monkeypatch):
    """A dropped request never reaches the server: the pull's bounded
    wait ends it, and the decode side prefills locally."""
    monkeypatch.setattr(DecodeReplica, "_PULL_TIMEOUT_S", 0.3)
    pre = replicas(PrefillReplica)
    dec = replicas(DecodeReplica)
    local = InferenceReplica(**REPLICA)
    desc = pre([4, 4, 8], max_new_tokens=5)
    tfaults.install(tfaults.FaultPlan().drop("netaddr.send"))
    assert _tokens(dec(desc)) == _tokens(local([4, 4, 8], max_new_tokens=5))
    assert dec.stats()["handoff_fallbacks"] == 1 and not dec._conns
    assert tfaults.fired() == [("netaddr.send", 0, "drop")]


def _bf16_blob():
    """A bf16 port prefill engine's blob (bf16 rows as uint16)."""
    cfg = _tcfg(dtype="bfloat16")
    model = tgpt.GPT(cfg, tgpt.init_params(0, cfg, "cpu"), device="cpu")
    pre = InferenceEngine(model, cfg, device="cpu", role="prefill", **ENGINE)
    return model, cfg, pre.handoff_for(pre.submit(list(range(3, 23)),
                                                  max_new_tokens=5))


def test_wire_frames_round_trip_with_bf16_tags():
    """`_np_frames` -> bytes -> `_blob_from_frames` keeps every array's
    bits, names bf16 rows "bfloat16" in the manifest (the name the
    reference's ml_dtypes arrays carry, with the same bytes), and the
    rebuilt blob continues like the original in a bf16 decode engine."""
    model, cfg, blob = _bf16_blob()
    assert blob["dtypes"]["payload"] == {"k": "bfloat16", "v": "bfloat16"}
    assert blob["payload"][0]["k"].dtype == np.uint16
    meta, manifest, arrays = disagg._np_frames(blob)
    assert {m[4] for m in manifest} == {"bfloat16"}
    back = disagg._blob_from_frames(meta, [a.tobytes() for a in arrays])
    assert back["dtypes"] == blob["dtypes"]
    for a, b in zip(blob["payload"], back["payload"]):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    streams = []
    for b in (blob, back):
        dec = InferenceEngine(model, cfg, device="cpu", role="decode",
                              **ENGINE)
        streams.append(_tokens(dec.tokens_for(dec.import_handoff(b))))
    assert streams[0] == streams[1] and len(streams[0]) == 5
    # the reference's bf16 arrays (ml_dtypes): the same manifest name and
    # bytes, and the port imports them as they are
    ref = dict(blob, dtypes=None, payload=[
        {n: np.frombuffer(a.tobytes(), jnp.bfloat16).reshape(a.shape)
         for n, a in blk.items()} for blk in blob["payload"]])
    rmeta, rman, rarrays = disagg._np_frames(ref)
    assert rman == manifest
    assert [a.tobytes() for a in rarrays] == [a.tobytes() for a in arrays]
    dec = InferenceEngine(model, cfg, device="cpu", role="decode", **ENGINE)
    assert _tokens(dec.tokens_for(dec.import_handoff(ref))) == streams[0]


def test_disagg_resume_rebuilds_prompt_plus_emitted():
    desc = {"prompt": [1, 2], "max_new_tokens": 5, "temperature": 0.5,
            "priority": 1}
    assert disagg_resume((desc,), {}, [7, 8]) == (
        ([1, 2, 7, 8],), {"max_new_tokens": 3, "temperature": 0.5,
                          "priority": 1})
    assert disagg_resume((desc,), {}, [0] * 5) is None
    with pytest.raises(TypeError):
        disagg_resume(([1, 2],), {}, [])


def test_prefill_replica_close_is_bounded_with_a_live_puller(replicas):
    """`close` with a puller connected and idle: its thread sees the
    close within one poll and every thread ends; a second close is a
    no-op."""
    pre = replicas(PrefillReplica)
    conn = netaddr.client(pre._addr, pre._authkey, 5.0)
    try:
        conn.send({"handoff_id": 12345})
        assert conn.poll(5.0) and "error" in conn.recv()
        pre.close()
        pre.close()
        assert not pre._accept_thread.is_alive()
        assert all(not t.is_alive() for t in threading.enumerate()
                   if t.name == "disagg-kv-conn")
    finally:
        conn.close()


def test_unclosed_prefill_replica_is_freed(monkeypatch):
    """A PrefillReplica dropped without `close`: its engine is freed and
    its block server's threads end (they hold it only weakly), a puller's
    connection thread included."""
    monkeypatch.setenv("RAY_TPU_NODE_IP", "127.0.0.1")
    config.reset_caches()
    pre = PrefillReplica(**REPLICA)
    conn = netaddr.client(pre._addr, pre._authkey, 5.0)
    try:
        conn.send({"handoff_id": 7})
        assert conn.poll(5.0) and "error" in conn.recv()
        threads = [pre._accept_thread] + list(pre._served)
        engine = weakref.ref(pre.engine)
        del pre
        gc.collect()
        assert engine() is None
        for t in threads:
            t.join(timeout=5.0)
            assert not t.is_alive()
    finally:
        conn.close()
        config.reset_caches()

