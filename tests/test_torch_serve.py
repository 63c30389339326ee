"""The port's serve control plane (`ray_tpu_torch.serve`: deployments,
handles, the controller, replicas and the stdlib HTTP proxy) held against
the JAX package's (`ray_tpu.serve`) on one table of plain-callable
scenarios (`tests/torch_serve_scenarios.py`'s ``PLAIN``, mirroring
`tests/test_serve.py`, `tests/test_serve_platform.py` and the control
plane of `tests/test_serve_chaos.py`).

The JAX side runs the table once per module in a child process of its
own session, under one deadline, and pickles its results before its own
slow shutdown; the port runs it in one module session meanwhile. Both
have 4 CPUs and the same serve knobs (`KNOBS`). Each scenario is one
case: values, raised class names and HTTP statuses, headers and bodies
are equal. The port's own cases follow: what it refuses (the proxy on
every node needs remote nodes, ROADMAP A5 (a2)) and that its controller
and proxy processes never load ``torch``.
"""

import os

import pytest

import torch_serve_scenarios as sc

JAX_DEADLINE_S = 120.0


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    side = sc.JaxSide("plain", tmp_path_factory.mktemp("jax_serve")
                      / "results.pkl", JAX_DEADLINE_S)
    yield side.results
    side.close()


@pytest.fixture(scope="module")
def rt(jax_results):
    saved = {k: os.environ.get(k) for k in sc.KNOBS}
    os.environ.update(sc.KNOBS)
    import ray_tpu_torch
    from ray_tpu_torch import serve
    ray_tpu_torch.init(num_cpus=sc.NUM_CPUS, num_gpus=0)
    sc.set_driver_knobs(ray_tpu_torch)
    try:
        yield ray_tpu_torch
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def port_results(rt):
    """The whole table on the port, while the JAX side runs."""
    return {name: sc.run_one(rt, sc.PORT, "plain", name)
            for name in sc.PLAIN}


@pytest.mark.parametrize("name", list(sc.PLAIN))
def test_scenario_matches_the_jax_serve(port_results, jax_results, name):
    got = port_results[name]
    want = jax_results()[name]
    assert "raised" not in want, want      # the table runs in the reference
    assert got == want


def _maps_torch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def test_control_plane_processes_never_load_torch(rt):
    """The controller and the proxy run in forked CPU workers; neither
    unpickling them nor serving loads ``torch``."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    @serve.deployment
    def ping(x):
        return x

    assert serve.run(ping.bind(), name="t_torchless").call(3) == 3
    serve.start(http_options={"port": 0})
    node = rt._worker.get_client().node
    for actor in (rt.get_actor(CONTROLLER_NAME), api._http_proxy):
        pid = node.actors[actor._actor_id].worker.proc.pid
        assert not _maps_torch(pid), pid
    serve.delete("t_torchless")


def test_proxy_on_every_node_needs_remote_nodes(rt):
    from ray_tpu_torch import serve
    with pytest.raises(NotImplementedError, match=r"A5 \(a2\)"):
        serve.start(http_options={"location": "EveryNode", "port": 0})
