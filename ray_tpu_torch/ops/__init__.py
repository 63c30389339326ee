"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each
beside a plain PyTorch version with the same math.

`kernel_launches` / `reset_kernel_launches` read and zero the launch
counter of every kernel wrapper in the package, so a run can show which
kernels its main path went through; `add_kernel_launches` adds the
launches of a CUDA graph's replays, which never pass through the
wrappers."""

import torch


def _modules():
    from ray_tpu_torch.ops import decode_attention, flash_attention, fused_xent
    return decode_attention, flash_attention, fused_xent


def kernel_launches() -> dict:
    """``{wrapper name: launches}`` over every kernel of the port."""
    out = {}
    for m in _modules():
        out.update(m.kernel_launches())
    return out


def reset_kernel_launches() -> None:
    for m in _modules():
        m.reset_kernel_launches()


def add_kernel_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (``{name: launches}``, names as
    `kernel_launches` gives them) to the counters: the launches a CUDA
    graph's replays make, which never pass through the wrappers."""
    for m in _modules():
        for f in getattr(m, "WRAPPERS", ()):
            f.launches += times * counts.get(f.__name__, 0)
        for name in m.LAUNCHES:
            m.LAUNCHES[name] += times * counts.get(name, 0)


def pad_last_dim(x, n: int):
    """``x`` with zero columns appended to its last dim up to ``n`` (x
    itself if it is ``n`` wide): how the wrappers present a head dim or
    loss width to a kernel built for a wider one."""
    d = x.shape[-1]
    return x if d == n else torch.nn.functional.pad(x, (0, n - d))


def trim_last_dim(x, n: int):
    """The first ``n`` columns of ``x``'s last dim, contiguous (x itself
    if it is ``n`` wide): a padded kernel output sliced back."""
    return x if x.shape[-1] == n else x[..., :n].contiguous()
