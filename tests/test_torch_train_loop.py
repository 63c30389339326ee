"""The port's training loop (`ray_tpu_torch.train.loop`) on the CPU:
multi-step dispatch gives the parameters that plain step calls give,
metrics reach the host only through the lagged ring (counted by patching
the fetch seam, the idiom of `tests/test_train_loop.py`), and the
prefetcher delivers host batches in order, grouped, with ragged tails
and feed errors surfaced."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.train import loop, spmd


def _tiny():
    return gpt.small(vocab_size=128, d_model=32, n_layers=1, n_heads=2,
                     d_ff=64, max_seq_len=16, dtype="float32")


def _host(cfg, n, b=4):
    for s in range(n):
        rng = np.random.default_rng(s)
        toks = rng.integers(0, cfg.vocab_size, (b, cfg.max_seq_len + 1))
        yield {"inputs": toks[:, :-1].astype(np.int32),
               "targets": toks[:, 1:].astype(np.int32)}


def _trainer(cfg):
    return spmd.make_gpt_trainer(
        cfg, seed=0, device="cpu",
        optimizer=spmd.default_optimizer(learning_rate=1e-3,
                                         warmup_steps=1))


@pytest.mark.parametrize("unroll", [1, 2])
def test_train_loop_matches_plain_step_calls(unroll):
    cfg = _tiny()
    state_a, step_a, place = _trainer(cfg)
    losses = []
    for hb in _host(cfg, 4):
        state_a, m = step_a(state_a, place(hb))
        losses.append(m["loss"].item())

    state_b, step_b, place = _trainer(cfg)
    tl = loop.TrainLoop(step_b, unroll=unroll, metrics_interval=2,
                        device="cpu", flops_per_step=1e9)
    pf = loop.DevicePrefetcher(_host(cfg, 4), place, depth=2, group=unroll)
    state_b, hist = tl.run(state_b, pf, num_steps=4)
    assert [int(m["step"]) for m in hist] == [1, 2, 3, 4]
    np.testing.assert_array_equal([float(m["loss"]) for m in hist], losses)
    for a, b in zip(state_a.params.parameters(),
                    state_b.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    st = tl.stats()
    assert st["steps"] == 4 and st["unroll"] == unroll
    # MFU through telemetry.mfu, a number as the reference reports it
    # (the CPU reads against the H100's peak, as the reference reads an
    # unknown device against its default chip's)
    assert st["mfu"] == tl.last_mfu > 0.0
    assert st["dispatch_traces"] == int(unroll > 1)
    assert st["retraces_unexpected"] == 0
    assert 0.0 < st["dispatch_share"] <= 1.0


def test_metrics_reach_the_host_only_through_the_lagged_ring(monkeypatch):
    calls = []
    real = loop._to_host

    def counting(tree):
        calls.append(len(tree))
        return real(tree)

    monkeypatch.setattr(loop, "_to_host", counting)

    def step(s, b):
        return s + 1, {"loss": b["x"].mean(), "i": s}

    host = ({"x": np.full((8,), float(i), np.float32)} for i in range(20))
    tl = loop.TrainLoop(step, unroll=1, metrics_interval=5, metrics_lag=2)
    state, hist = tl.run(torch.zeros((), dtype=torch.int32),
                         loop.DevicePrefetcher(host,
                                               loop.make_placer("cpu")),
                         num_steps=20)
    assert [float(m["loss"]) for m in hist] == [float(i) for i in range(20)]
    assert [int(m["i"]) for m in hist] == list(range(20))
    assert tl.last_ring.fetches == len(calls) <= 20 // 5 + 1
    # every fetch but the final drain leaves the newest `lag` dispatches
    # on the device: the first fires at push 5 with 5 - 2 entries
    assert calls[0] == 3


def test_metrics_ring_unstacks_multi_step_dispatch():
    ring = loop.MetricsRing(interval=100, lag=0)
    ring.push({"loss": torch.tensor([0.0, 1.0, 2.0]),
               "step": torch.tensor([1, 2, 3], dtype=torch.int32)}, count=3)
    hist = ring.drain()
    assert [float(h["loss"]) for h in hist] == [0.0, 1.0, 2.0]
    assert [int(h["step"]) for h in hist] == [1, 2, 3]
    assert hist[0]["step"].dtype == np.int32
    assert ring.fetches == 1


def test_prefetcher_groups_in_order_and_counts_ragged_tail():
    def host(n):
        for i in range(n):
            yield {"x": np.full((2, 3), i, np.int32)}

    pf = loop.DevicePrefetcher(host(7), loop.make_placer("cpu"), depth=3,
                               group=3)
    got = list(pf)
    assert len(got) == 2 and pf.skipped_ragged == 1
    assert [g["x"].shape for g in got] == [(3, 2, 3)] * 2
    assert [g["x"][:, 0, 0].tolist() for g in got] == [[0, 1, 2], [3, 4, 5]]
    pf = loop.DevicePrefetcher(host(5), loop.make_placer("cpu"), depth=2)
    assert [int(b["x"][0, 0]) for b in pf] == [0, 1, 2, 3, 4]
    assert pf.issued == 5


def test_prefetcher_surfaces_host_iterator_error():
    def host():
        for i in range(3):
            yield {"x": np.full((4,), float(i), np.float32)}
        raise OSError("data shard unreachable")

    pf = loop.DevicePrefetcher(host(), loop.make_placer("cpu"), depth=2)
    seen = []
    with pytest.raises(OSError, match="unreachable"):
        for b in pf:
            seen.append(float(b["x"][0]))
    assert seen == [0.0, 1.0, 2.0]
    with pytest.raises(OSError, match="unreachable"):
        next(pf)


def test_run_steps_and_placer_device():
    cfg = _tiny()
    state, step, place = _trainer(cfg)
    assert place.device == torch.device("cpu")
    state, hist = loop.run_steps(
        step, state, loop.DevicePrefetcher(_host(cfg, 6), place, group=2),
        num_steps=6, unroll=2, metrics_interval=4)
    assert len(hist) == 6 and int(state.step) == 6
    with pytest.raises(ValueError, match="unroll"):
        loop.fuse_steps(step, 0)
