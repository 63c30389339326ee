"""The port (`ray_tpu_torch`) stands alone: importing any of its modules
loads neither JAX nor anything of the JAX package `ray_tpu` (whose name
is a prefix of the port's, hence the exact-name checks), nor optax or
ml_dtypes (whose classes and bf16 the port's checkpoints read without
them); no source file under it imports them, and its entry points
refuse to run silently on the CPU when no CUDA device is there."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ray_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ray_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ray_tpu_torch.__path__, prefix="ray_tpu_torch."))


def test_every_module_imports_without_jax_or_ray_tpu():
    mods = _modules()
    assert {"ray_tpu_torch.serve.engine", "ray_tpu_torch.ops.flash_attention",
            "ray_tpu_torch.ops.fused_xent", "ray_tpu_torch.train.spmd",
            "ray_tpu_torch.train.loop",
            "ray_tpu_torch.util.telemetry", "ray_tpu_torch.util.faults",
            "ray_tpu_torch.serve.priority",
            "ray_tpu_torch._private.constants",
            "ray_tpu_torch._private.config", "ray_tpu_torch._private.netaddr",
            "ray_tpu_torch.serve.disagg", "ray_tpu_torch.util.metrics",
            "ray_tpu_torch.util.tracing", "ray_tpu_torch.rllib",
            "ray_tpu_torch.rllib.sample_batch", "ray_tpu_torch.rllib.rollout",
            "ray_tpu_torch.rl", "ray_tpu_torch.rl.sampler",
            "ray_tpu_torch.rl.flywheel", "ray_tpu_torch.util.storage",
            "ray_tpu_torch.train.checkpoint", "ray_tpu_torch.train.ft",
            "ray_tpu_torch.train.predictor", "ray_tpu_torch.models.moe",
            "ray_tpu_torch.models.vit",
            "ray_tpu_torch.models.resnet", "ray_tpu_torch.parallel",
            "ray_tpu_torch.parallel.mesh",
            "ray_tpu_torch.parallel.collectives",
            "ray_tpu_torch.parallel.sharding",
            "ray_tpu_torch.parallel.ring_attention",
            "ray_tpu_torch.parallel.pipeline",
            "ray_tpu_torch.actor", "ray_tpu_torch.remote_function",
            "ray_tpu_torch.runtime_context", "ray_tpu_torch._private.ids",
            "ray_tpu_torch._private.serialization",
            "ray_tpu_torch._private.native",
            "ray_tpu_torch._private.native.arena",
            "ray_tpu_torch._private.object_store",
            "ray_tpu_torch._private.protocol", "ray_tpu_torch._private.spawn",
            "ray_tpu_torch._private.forkserver",
            "ray_tpu_torch._private.worker_main",
            "ray_tpu_torch._private.worker",
            "ray_tpu_torch._private.node",
            "ray_tpu_torch.serve.api", "ray_tpu_torch.serve.batching",
            "ray_tpu_torch.serve.controller", "ray_tpu_torch.serve.events",
            "ray_tpu_torch.serve.handle", "ray_tpu_torch.serve.http_proxy",
            "ray_tpu_torch.serve.multiplex", "ray_tpu_torch.serve.replica",
            "ray_tpu_torch.serve.schema"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'ray_tpu', 'optax', 'ml_dtypes'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_REFUSED = r"(jax|ray_tpu|optax|ml_dtypes)\b(?!_)"


def test_no_source_imports_jax_or_ray_tpu():
    pat = re.compile(rf"^\s*(import\s+{_REFUSED}|from\s+{_REFUSED})", re.M)
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in PKG.rglob("*.py")
            for m in pat.finditer(p.read_text())]
    assert hits == []
    # the scan itself must tell the two packages apart
    assert pat.search("from ray_tpu.models import gpt")
    assert pat.search("import jax.numpy as jnp")
    assert pat.search("import optax")
    assert pat.search("from ml_dtypes import bfloat16")
    assert not pat.search("from ray_tpu_torch.models import gpt")
    # the JAX package's parallelism layer shares the port's prefix
    assert pat.search("from ray_tpu.parallel import MeshSpec")
    assert pat.search("import ray_tpu.parallel.sharding")
    assert not pat.search("from ray_tpu_torch.parallel import MeshSpec")


def test_chip_smoke_imports_no_jax_or_ray_tpu():
    """chip_smoke.py drives the port on the card, where JAX is not
    installed: it imports neither it nor the JAX package."""
    pat = re.compile(rf"^\s*(import\s+{_REFUSED}|from\s+{_REFUSED})", re.M)
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_chip_smoke_mesh_child_imports_no_jax_or_ray_tpu():
    """``chip_smoke.py --mesh-child`` (one rank of phase 18 (b)) imports
    its modules (the port's parallel layer and trainer) and neither JAX
    nor the JAX package; here it stops where it loads the kernels, which
    are built on the card."""
    code = (
        "import atexit, runpy, sys\n"
        "def report():\n"
        "    bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "                 ('jax', 'ray_tpu', 'optax', 'ml_dtypes'))\n"
        "    print(repr(bad), 'ray_tpu_torch.parallel.collectives' in "
        "sys.modules, 'ray_tpu_torch.train.spmd' in sys.modules)\n"
        "atexit.register(report)\n"
        "import torch\n"
        "from ray_tpu_torch.ops import _build\n"
        "def no_build():\n"
        "    raise RuntimeError('the kernels are built on the card')\n"
        "_build.load = no_build\n"
        "torch.cuda.is_available = lambda: True\n"
        "sys.argv = ['chip_smoke.py', '--mesh-child']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except BaseException:\n"
        "    pass\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[] True True", \
        out.stdout + out.stderr


def test_runtime_processes_import_no_jax_ray_tpu_or_torch():
    """The runtime's spawned processes stand alone too: a CPU worker
    forked from the forkserver (so the forkserver's own imports are in its
    modules) and a GPU worker exec'd as ``python -m
    ray_tpu_torch._private.worker_main`` load neither JAX nor the JAX
    package, and not ``torch`` either; nor does the driver's ``import
    ray_tpu_torch``."""
    code = (
        "import sys\n"
        "import ray_tpu_torch as rt\n"
        "def bad():\n"
        "    import os, sys\n"
        "    return os.environ.get('CUDA_VISIBLE_DEVICES'), sorted(\n"
        "        n for n in sys.modules if n.split('.')[0] in\n"
        "        ('jax', 'ray_tpu', 'optax', 'ml_dtypes', 'torch'))\n"
        "driver = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "                ('jax', 'ray_tpu', 'torch'))\n"
        "rt.init(num_cpus=1, num_gpus=1)\n"
        "try:\n"
        "    cpu = rt.get(rt.remote(bad).remote(), timeout=60)\n"
        "    gpu = rt.get(rt.remote(num_gpus=1)(bad).remote(), timeout=60)\n"
        "finally:\n"
        "    rt.shutdown()\n"
        "print(repr([driver, cpu, gpu]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        repr([[], ("", []), ("0", [])]), out.stdout


def test_serve_control_plane_imports_no_torch_or_aiohttp():
    """The serve control plane's modules load neither ``torch`` (the
    controller and the HTTP proxy run in CPU workers that never load it,
    and unpickle their classes from these modules) nor ``aiohttp`` (the
    proxy serves on the standard library); the engine's names in
    `ray_tpu_torch.serve` load only when asked for."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.api\n"
        "import ray_tpu_torch.serve.controller, ray_tpu_torch.serve.handle\n"
        "import ray_tpu_torch.serve.replica, ray_tpu_torch.serve.http_proxy\n"
        "import ray_tpu_torch.serve.schema, ray_tpu_torch.serve.events\n"
        "from ray_tpu_torch.serve.controller import ServeController\n"
        "from ray_tpu_torch.serve.http_proxy import HTTPProxy\n"
        "before = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "                ('torch', 'aiohttp', 'jax', 'ray_tpu'))\n"
        "ray_tpu_torch.serve.InferenceReplica\n"
        "print(repr([before, 'torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == repr([[], True]), \
        out.stdout


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine, InferenceReplica
    cfg = gpt.GPTConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                        d_ff=32, max_seq_len=16, dtype="float32")
    model = gpt.GPT(cfg, gpt.init_params(0, cfg, device="cpu"),
                    device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, cfg, slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceReplica({"vocab_size": 64}, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt.init_kv_pool(cfg, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt.init_kv_cache(cfg, 1, 8)


def test_training_entry_points_and_numpy_model_need_a_card():
    """Training entry points (the RL flywheel's, the MoE trainer, the other
    model families, the predictor and the checkpoint reader among them)
    and `GPT(cfg, numpy_tree)` run on the card
    unless given device="cpu"; without one they raise (a numpy tree once
    stayed on the CPU silently)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    import numpy as np

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.rl import FlywheelLoop
    from ray_tpu_torch.train import loop, spmd
    cfg = gpt.GPTConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                        d_ff=32, max_seq_len=16, dtype="float32")
    tree = {k: (v.numpy() if not isinstance(v, dict) else
                {n: x.numpy() for n, x in v.items()})
            for k, v in gpt.init_params(0, cfg, device="cpu").items()}
    assert isinstance(tree["embed"], np.ndarray)
    from ray_tpu_torch.models import moe, resnet, vit
    from ray_tpu_torch.train import ft, predictor
    for call in (lambda: gpt.GPT(cfg, tree),
                 lambda: gpt.params_from_numpy(tree, cfg),
                 lambda: gpt.init_params(0, cfg),
                 lambda: spmd.make_gpt_trainer(cfg),
                 lambda: spmd.make_gpt_trainer(cfg, init_state=False),
                 lambda: spmd.make_moe_trainer(moe.small()),
                 lambda: moe.init_params(0, moe.small()),
                 lambda: vit.init_params(0, vit.small()),
                 lambda: resnet.resnet18(),
                 lambda: predictor.TorchPredictor(lambda p, x: x, {}),
                 lambda: ft.read_tree("unused"),
                 lambda: loop.make_placer(),
                 lambda: FlywheelLoop(cfg, None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert gpt.GPT(cfg, tree, device="cpu").device == torch.device("cpu")
    state, _, place = spmd.make_gpt_trainer(cfg, device="cpu")
    assert state.params.device == place.device == torch.device("cpu")


def test_build_compiles_every_source_into_its_own_library():
    """Each `csrc/*.cu` is its own library, named by the hash of its own
    source (and of the `csrc/*.cuh` headers the sources share), and every
    entry point the wrappers call is declared."""
    from ray_tpu_torch.ops import _build
    names = [p.name for p in _build.sources()]
    assert names == sorted(["flash_attention.cu", "fused_xent.cu",
                            "paged_attention.cu"])
    libs = [_build._lib_path(p) for p in _build.sources()]
    assert len(set(libs)) == len(libs)
    assert all(p.name.startswith(s.stem + "-")
               for p, s in zip(libs, _build.sources()))
    assert {"rtt_flash_fwd", "rtt_flash_fwd_tc", "rtt_flash_dq",
            "rtt_flash_dkv", "rtt_paged_decode", "rtt_paged_mq", "rtt_decode",
            "rtt_xent_fwd", "rtt_xent_fwd_tc", "rtt_xent_fwd_merge",
            "rtt_xent_dx", "rtt_xent_de", "rtt_xent_dlog", "rtt_xent_dx_tc",
            "rtt_xent_de_tc"} <= set(_build.SIGNATURES)
    assert [p.name for p in _build.CSRC.glob("*.cuh")] == ["hopper.cuh"]
    for src, names in (
            ("flash_attention.cu", ("rtt_flash_fwd", "rtt_flash_fwd_tc",
                                    "rtt_flash_dq", "rtt_flash_dkv")),
            ("paged_attention.cu", ("rtt_paged_decode", "rtt_paged_mq",
                                    "rtt_decode")),
            ("fused_xent.cu", ("rtt_xent_fwd", "rtt_xent_fwd_tc",
                               "rtt_xent_fwd_merge", "rtt_xent_dx",
                               "rtt_xent_de", "rtt_xent_dlog",
                               "rtt_xent_dx_tc", "rtt_xent_de_tc"))):
        text = (_build.CSRC / src).read_text()
        for name in names:
            assert f'extern "C" int {name}(' in text
