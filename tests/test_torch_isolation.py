"""The port (`ray_tpu_torch`) stands alone: importing any of its modules
loads neither JAX nor anything of the JAX package `ray_tpu` (whose name
is a prefix of the port's, hence the exact-name checks), no source file
under it imports them, and its entry points refuse to run silently on
the CPU when no CUDA device is there."""

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
            "ray_tpu_torch.rl.flywheel"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith('jax.') or n == 'ray_tpu'\n"
        "             or n.startswith('ray_tpu.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_imports_jax_or_ray_tpu():
    pat = re.compile(r"^\s*(import\s+(jax|ray_tpu)\b(?!_)"
                     r"|from\s+(jax|ray_tpu)\b(?!_))", re.M)
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in PKG.rglob("*.py")
            for m in pat.finditer(p.read_text())]
    assert hits == []
    # the scan itself must tell the two packages apart
    assert pat.search("from ray_tpu.models import gpt")
    assert pat.search("import jax.numpy as jnp")
    assert not pat.search("from ray_tpu_torch.models import gpt")


def test_chip_smoke_imports_no_jax_or_ray_tpu():
    """chip_smoke.py drives the port on the card, where JAX is not
    installed: it imports neither it nor the JAX package."""
    pat = re.compile(r"^\s*(import\s+(jax|ray_tpu)\b(?!_)"
                     r"|from\s+(jax|ray_tpu)\b(?!_))", re.M)
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


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
    """Training entry points (the RL flywheel's among them) and `GPT(cfg,
    numpy_tree)` run on the card
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
    for call in (lambda: gpt.GPT(cfg, tree),
                 lambda: gpt.params_from_numpy(tree, cfg),
                 lambda: gpt.init_params(0, cfg),
                 lambda: spmd.make_gpt_trainer(cfg),
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
