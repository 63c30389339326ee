"""Int8 quantization for the paged KV pool and the weight-only layer
matmuls: the counterpart of `ray_tpu/ops/quant.py`, with the same math.

Symmetric absmax int8 with f32 scales:

- **KV rows** (`quantize_rows`): one scale per (position, head) row of
  the last axis, ``x [..., D] -> (q int8 [..., D], scale f32 [...])``.
  A write lands its payload row and its scale cell through the same
  index, so copy-on-write block copies and prefix sharing need nothing
  special.
- **Weights** (`quantize_channels`): one scale per output channel over
  the contraction axis, ``w [..., In, Out] -> (q int8 [..., In, Out],
  scale f32 [..., Out])``.

Determinism: quantizing is a pure function of the f32 input (``x /
scale`` is a true f32 division, then round half to even, as
``jnp.round``), so every path that writes the same K/V values lands
byte-identical payloads and scales, on the CPU and on the card alike.
A zero row gets scale 0 and quantizes to zeros (dividing by 1 instead),
so the pool's zero fill dequantizes to exact zeros.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def _quantize(x, dim: int):
    xf = x.float()
    # The divisor is a tensor on x's device: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal, which can differ by an
    # ulp from the division the CPU (and JAX) does.
    scale = xf.abs().amax(dim=dim) / torch.full((), INT8_MAX,
                                                device=xf.device)
    safe = torch.where(scale > 0.0, scale, 1.0)
    q = torch.round(xf / safe.unsqueeze(dim)).clamp_(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def quantize_rows(x):
    """Symmetric per-row int8 over the last axis: ``x [..., D]`` (any
    float dtype) -> ``(q int8 [..., D], scale f32 [...])`` with ``scale
    = max|x| / 127`` and ``q = round(x / scale)`` clipped to [-127,
    127]."""
    return _quantize(x, -1)


def dequantize_rows(q, scale):
    """Inverse of `quantize_rows`: f32 ``[..., D]``."""
    return q.float() * scale.float()[..., None]


def quantize_channels(w):
    """Symmetric per-output-channel int8 over axis -2 (the contraction
    axis of a ``[..., In, Out]`` weight): ``(q int8 [..., In, Out],
    scale f32 [..., Out])``."""
    return _quantize(w, -2)


def dequantize_channels(q, scale):
    """Inverse of `quantize_channels`: f32 ``[..., In, Out]``."""
    return q.float() * scale.float()[..., None, :]
