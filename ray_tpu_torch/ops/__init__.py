"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each
beside a plain PyTorch version with the same math.

`kernel_launches` / `reset_kernel_launches` read and zero the launch
counter of every kernel wrapper in the package, so a run can show which
kernels its main path went through."""


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
