"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; on a
machine with a card (and no JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances, per element |kernel - plain| <= atol + rtol * |plain|: f32
atol 2e-5 (summation order and expf only); bf16 atol 1e-5, rtol 2**-7
(the kernel and the plain version both accumulate in f32 from the same
bf16 inputs, so they differ by at most the final rounding to bf16, one
ulp, which is at most 2**-7 of the value)."""

import pytest
import torch

from ray_tpu_torch.ops import decode_attention as da

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=2e-5, rtol=0),
       torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, b, h, d, bs, mb, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = b * mb + 1
    kp = torch.randn((nb, bs, h, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((nb, bs, h, d), generator=g, device=dev).to(dtype)
    tables = (torch.randperm(nb - 1, generator=g, device=dev)[:b * mb] + 1) \
        .view(b, mb).to(torch.int32).contiguous()
    return g, kp, vp, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_decode_kernel_matches_plain(dev, dtype, d, bs):
    b, h, mb = 4, 3, 5
    g, kp, vp, tables = _inputs(dev, dtype, b, h, d, bs, mb)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    pos = torch.tensor([0, bs - 1, bs, mb * bs - 1], dtype=torch.int32,
                       device=dev)
    n = da.paged_decode_attention.launches
    got = da.paged_decode_attention(q, kp, vp, tables, pos)
    assert da.paged_decode_attention.launches == n + 1
    ref = da.reference_paged_decode_attention(q, kp, vp, tables, pos)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_prefill_and_verify_kernel_match_plain(dev, dtype, d, bs):
    b, h, mb = 3, 2, 6
    g, kp, vp, tables = _inputs(dev, dtype, b, h, d, bs, mb, seed=1)
    for c, start in ((5, 0), (bs, bs), (40, 3)):
        q = torch.randn((c, h, d), generator=g, device=dev).to(dtype)
        got = da.paged_prefill_attention(q, kp, vp, tables[0], start)
        ref = da.reference_paged_prefill_attention(q, kp, vp, tables[0],
                                                   start)
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    # verify: the last row's window runs past the table's reach
    q = torch.randn((b, 5, h, d), generator=g, device=dev).to(dtype)
    pos = torch.tensor([0, 7, mb * bs - 3], dtype=torch.int32, device=dev)
    got = da.paged_verify_attention(q, kp, vp, tables, pos)
    ref = da.reference_paged_verify_attention(q, kp, vp, tables, pos)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


def test_unsupported_inputs_raise_instead_of_falling_back(dev):
    _, kp, vp, tables = _inputs(dev, torch.float32, 1, 2, 48, 16, 2)
    q = torch.zeros((1, 2, 48), device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        da.paged_decode_attention(q, kp, vp, tables, pos)
    with pytest.raises(TypeError, match="int32"):
        da.paged_decode_attention(q, kp, vp, tables.long(), pos)
