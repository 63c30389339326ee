"""The weights of a stacked-layer model (MoE, ViT): the reference's
parameter tree as `nn.Parameter`s of one dtype on one device, top-level
leaves as attributes and the ``[L, ...]`` layer leaves in one
``layers`` `nn.ParameterDict`, shapes checked against the config, as
`models.gpt.GPT` holds GPT's."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class StackedModel(nn.Module):
    """``params`` is a tree shaped like the family's ``init_params``
    (tensors or numpy arrays); ``top`` and ``layer`` give each leaf's
    shape in the order the parameters are registered (the order of the
    optimizer's moments). Each leaf is copied in as a parameter of
    ``dtype`` (default: the config's activation dtype) on ``device``
    (`models.gpt.resolve_device`), frozen unless ``trainable``."""

    def __init__(self, cfg, params: dict, top: dict, layer: dict, *,
                 device=None, dtype: torch.dtype | None = None,
                 trainable: bool = False):
        super().__init__()
        from ray_tpu_torch.models.gpt import resolve_device
        self.cfg = cfg
        dtype = cfg.activation_dtype() if dtype is None else dtype
        device = resolve_device(device)

        def leaf(x, name, shape):
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"param {name} has shape {tuple(x.shape)}, "
                                 f"config wants {tuple(shape)}")
            t = (x if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x)))   # writable copy
            t = t.to(device=device, dtype=dtype)
            return nn.Parameter(t.contiguous(), requires_grad=trainable)

        for name, shape in top.items():
            setattr(self, name, leaf(params[name], name, shape))
        self.layers = nn.ParameterDict({
            name: leaf(params["layers"][name], "layers." + name, shape)
            for name, shape in layer.items()})

    @property
    def device(self) -> torch.device:
        return self.layers[next(iter(self.layers.keys()))].device

    def layer_params(self) -> list[dict]:
        """Per-layer views ``[{name: leaf[i]}]`` through one `unbind` per
        stacked leaf (as `models.gpt.GPT.layer_params`)."""
        names = list(self.layers.keys())
        return [dict(zip(names, per)) for per in
                zip(*(self.layers[n].unbind(0) for n in names))]


def nest(pairs) -> dict:
    """``[("layers.wq", x), ...]`` -> ``{"layers": {"wq": x}, ...}``."""
    out: dict = {}
    for name, x in pairs:
        *path, last = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[last] = x
    return out


def param_tree(model: nn.Module) -> dict:
    """The model's parameters as the reference's nested dict (the tensors
    themselves, no copy)."""
    return nest(model.named_parameters())


def params_to_numpy(model: nn.Module) -> dict:
    """The model's parameters as the JAX package's nested dict of float32
    numpy arrays."""
    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.detach().float().cpu().numpy()
    return host(param_tree(model))
