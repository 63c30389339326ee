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
    assert "ray_tpu_torch.serve.engine" in mods
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


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import InferenceEngine, InferenceReplica
    cfg = gpt.GPTConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                        d_ff=32, max_seq_len=16, dtype="float32")
    model = gpt.GPT(cfg, gpt.init_params(0, cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, cfg, slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceReplica({"vocab_size": 64}, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt.init_kv_pool(cfg, 4, 8)
