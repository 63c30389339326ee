"""The port's task and actor runtime (`ray_tpu_torch.init`, tasks,
actors, objects, reference counts) held against the JAX package's
runtime (`ray_tpu`) on one table of scenarios
(`tests/torch_runtime_scenarios.py`, mirroring `tests/test_core.py`,
`tests/test_actor.py` and `tests/test_refcounting.py`).

The JAX side runs once per module in a child process of its own session
(``start_new_session=True``; the whole process group is killed past a
90 s deadline), which pickles each scenario's result to a file before it
shuts its runtime down: neither its shutdown (seconds, and C7's hang in
ROADMAP) nor any other hang in it can hold this process. Once the
results are read the child gets a second to finish; then its group is
killed and its session directory removed (its forked workers exit when
their channel closes). The port side runs the same table in one module-scoped
session. Both have 2 CPUs and 2 fake accelerators. Each scenario is one
case: the values are equal, the raised classes' names are equal (each
an instance of the port's class of that name), and the resource dicts
are equal once the reference's ``TPU`` reads ``GPU``.
"""

import os
import pickle
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import torch_runtime_scenarios as sc

JAX_DEADLINE_S = 90.0
JAX_SHUTDOWN_GRACE_S = 1.0
HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """Start the JAX side at once; the first case to need it waits for its
    results file, bounded by the one deadline."""
    out = tmp_path_factory.mktemp("jax_runtime") / "results.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    env.pop("XLA_FLAGS", None)
    log = open(out.with_suffix(".log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_runtime_scenarios.py"), str(out)],
        cwd=HERE.parent, env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    deadline = time.monotonic() + JAX_DEADLINE_S
    box = {}

    def results():
        if "r" not in box:
            while not out.exists():
                if proc.poll() is not None or time.monotonic() > deadline:
                    pytest.fail("the JAX runtime's table did not finish "
                                f"(rc {proc.poll()}):\n"
                                + out.with_suffix(".log").read_text()[-4000:])
                time.sleep(0.05)
            box["r"] = pickle.loads(out.read_bytes())
        return box["r"]
    yield results
    try:
        proc.wait(timeout=JAX_SHUTDOWN_GRACE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
    log.close()
    session = box.get("r", {}).get("__session_dir__")
    if session:
        shutil.rmtree(session, ignore_errors=True)
        # the killed group's forkserver could not remove its socket
        fs_sock = os.path.join(os.path.dirname(session),
                               f"ray_tpu_fs_{proc.pid}.sock")
        if os.path.exists(fs_sock):
            os.unlink(fs_sock)


@pytest.fixture(scope="module")
def rt(jax_results):
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=sc.NUM_CPUS, num_gpus=sc.NUM_ACCELERATORS)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _as_gpu(value):
    """The reference's result with its accelerator named as the port's."""
    if isinstance(value, dict):
        return {("GPU" if k == "TPU" else k): _as_gpu(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_as_gpu(v) for v in value)
    return value


@pytest.mark.parametrize("name", list(sc.SCENARIOS))
def test_scenario_matches_the_jax_runtime(rt, jax_results, name):
    got = sc.run_one(rt, sc.GPU, name)
    want = _as_gpu(jax_results()[name])
    assert "raised" not in want, want      # the table runs in the reference
    assert got == want


def test_resources_map_tpu_to_gpu(rt, jax_results):
    """The fake accelerators are the GPU resource in the port, the TPU
    resource in the reference, at the same count."""
    assert rt.cluster_resources() == {"CPU": 2.0, "GPU": 2.0}
    assert jax_results()["cluster_resources"]["value"] == {"CPU": 2.0,
                                                           "TPU": 2.0}


def test_num_tpus_is_an_alias_of_num_gpus(rt):
    from ray_tpu_torch.remote_function import _resources_from_options
    assert (_resources_from_options({"num_tpus": 1}, 1.0)
            == _resources_from_options({"num_gpus": 1}, 1.0)
            == {"CPU": 1.0, "GPU": 1.0})
    assert (_resources_from_options({"num_tpus": 0.5}, 1.0)
            == _resources_from_options({"num_gpus": 0.5}, 1.0)
            == {"CPU": 1.0, "GPU": 0.5})


def test_what_waits_for_a5a2_is_refused(rt):
    @rt.remote
    def f():
        return 1
    for opts in ({"scheduling_strategy": "SPREAD"},
                 {"runtime_env": {"pip": ["x"]}}):
        with pytest.raises(NotImplementedError, match=r"A5 \(a2\)"):
            f.options(**opts).remote()
    with pytest.raises(NotImplementedError, match=r"A5 \(a2\)"):
        rt.init(address="auto")


def test_env_vars_reach_a_dedicated_worker(rt):
    @rt.remote(runtime_env={"env_vars": {"RTT_PROBE": "yes"}})
    def probe():
        return os.environ.get("RTT_PROBE")
    assert rt.get(probe.remote(), timeout=60) == "yes"


def test_gpu_fractions_pack_on_one_card_and_free_it_whole(rt):
    """Fractions of a GPU pack on the fullest card they fit on (three
    0.1 share card 0), and once they end the card is whole again: a
    2-card task gets both. The booking itself, taken and freed in one
    order: 0.1 + 0.1 + 0.1 - 0.1 - 0.1 - 0.1 is not 0 in floating point,
    and that residue must not keep card 0 booked."""
    from ray_tpu_torch._private.node import NodeServer

    @rt.remote(num_gpus=0.1)
    def frac():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @rt.remote(num_gpus=2)
    def both():
        return os.environ.get("CUDA_VISIBLE_DEVICES")
    assert rt.get([frac.remote() for _ in range(3)], timeout=120) == \
        ["0"] * 3
    assert rt.get(both.remote(), timeout=120) == "0,1"

    book = object.__new__(NodeServer)
    book.gpu_load = [0.0, 0.0]
    req = {"GPU": 0.1}
    taken = [book._take_gpus(req, book._gpu_pick(req)) for _ in range(3)]
    assert taken == [[0]] * 3 and book._gpu_pick({"GPU": 2}) is None
    for ids_ in taken:
        book._free_gpus(req, ids_)
    assert book.gpu_load == [0.0, 0.0]
    assert book._gpu_pick({"GPU": 2}) == [0, 1]
