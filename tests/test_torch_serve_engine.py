"""Engine-backed deployments of the port's serve control plane held
against the JAX package's on one table of scenarios
(`tests/torch_serve_scenarios.py`'s ``ENGINE``, mirroring the engine
cases of `tests/test_serve_chaos.py` and `tests/test_serve_disagg.py`).

Both packages serve the same tiny f32 weights, made from a seed with
numpy and peaked (embedding x 8), swapped into each replica's engine
after construction (the port takes the numpy tree as it is, as
`gpt.params_from_numpy` does). The greedy streams are token-identical
across packages: through the handle, through HTTP, across a mid-stream
kill and a double failover, and through a peaked prefill/decode pair.
`run_disagg` at the seed's weights is held to each package's own
colocated replica (the two packages' seeds make different weights), with
its transfer stats; a prefill replica killed mid-handoff fails over; the
decode pool's autoscaling on ``streams`` is read from the controller's
decision; ``update_params`` through a handle bumps ``params_version``
alike. The JAX side runs in a child process of its own session under
one deadline (`torch_serve_scenarios.JaxSide`); the port runs the table
in one module session meanwhile, its engines on the CPU.
"""

import os

import pytest

import torch_serve_scenarios as sc

JAX_DEADLINE_S = 150.0


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    side = sc.JaxSide("engine", tmp_path_factory.mktemp("jax_serve_engine")
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
        sc._APPS.clear()
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
    return {name: sc.run_one(rt, sc.PORT, "engine", name)
            for name in sc.ENGINE}


@pytest.mark.parametrize("name", list(sc.ENGINE))
def test_engine_scenario_matches_the_jax_serve(port_results, jax_results,
                                               name):
    got = port_results[name]
    want = jax_results()[name]
    assert "raised" not in want, want      # the table runs in the reference
    assert got == want

