"""The weights of a stacked-layer model (MoE, ViT): the reference's
parameter tree as `nn.Parameter`s of one dtype on one device, top-level
leaves as attributes and the ``[L, ...]`` layer leaves in one
``layers`` `nn.ParameterDict`, shapes checked against the config, as
`models.gpt.GPT` holds GPT's. On a mesh each rank holds its block of
every leaf, as `models.gpt.GPT` does."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import active_mesh


def leaf_specs(logical_tree: dict, mesh, rules, model_axes: dict) -> dict:
    """``{leaf name: PartitionSpec}`` ("layers.wq", ...) of a parameter
    tree's logical axes on ``mesh``. ``model_axes`` maps each mesh axis
    the model computes on split to the logical axes it may split; a
    split over `parallel.sharding.ZERO_AXES` is gathered before use, any
    other split raises."""
    flat = {k: v for k, v in logical_tree.items() if k != "layers"}
    flat.update({f"layers.{k}": v
                 for k, v in logical_tree["layers"].items()})
    out = {}
    for name, axes in flat.items():
        spec = sharding.logical_to_spec(axes, rules, mesh)
        for logical, entry in zip(axes, spec):
            for a in mesh.live_axes(sharding.spec_axes((entry,))):
                if a not in sharding.ZERO_AXES and \
                        logical not in model_axes.get(a, ()):
                    raise ValueError(
                        f"param {name}: mesh axis {a!r} on its logical "
                        f"axis {logical!r}; the model computes on "
                        f"{a!r} splits of {model_axes.get(a, ())} only")
        out[name] = spec
    return out


class StackedModel(nn.Module):
    """``params`` is a tree shaped like the family's ``init_params``
    (tensors or numpy arrays); ``top`` and ``layer`` give each leaf's
    shape in the order the parameters are registered (the order of the
    optimizer's moments). Each leaf is copied in as a parameter of
    ``dtype`` (default: the config's activation dtype) on ``device``
    (`models.gpt.resolve_device`), frozen unless ``trainable``.

    With ``mesh`` (of more than one rank) each rank keeps its block of
    every leaf under ``logical_axes`` and the rule table ``rules``
    (``specs``: each leaf's spec; ``layer_specs``: a layer leaf's without
    the layer axis); a leaf may come whole or as the rank's block."""

    def __init__(self, cfg, params: dict, top: dict, layer: dict, *,
                 device=None, dtype: torch.dtype | None = None,
                 trainable: bool = False, mesh=None, rules=None,
                 logical_axes: dict | None = None, model_axes=None):
        super().__init__()
        from ray_tpu_torch.models.gpt import resolve_device
        self.cfg = cfg
        self.mesh = active_mesh(mesh)
        self.rules = rules
        self.specs = ({} if self.mesh is None else
                      leaf_specs(logical_axes, self.mesh, rules,
                                 model_axes or {}))
        self.layer_specs = {
            k[len("layers."):]: sharding.PartitionSpec(*spec[1:])
            for k, spec in self.specs.items() if k.startswith("layers.")}
        dtype = cfg.activation_dtype() if dtype is None else dtype
        device = resolve_device(device)
        self.whole_shapes = {**top, **{f"layers.{k}": v
                                       for k, v in layer.items()}}

        def leaf(x, name, shape):
            shape = tuple(shape)
            if self.mesh is not None and tuple(x.shape) == shape:
                x = sharding.local_shard(x, self.specs[name], self.mesh)
            elif self.mesh is not None:
                local = sharding.local_shape(shape, self.specs[name],
                                             self.mesh)
                if tuple(x.shape) != local:
                    raise ValueError(
                        f"param {name} has shape {tuple(x.shape)}; on "
                        f"{self.mesh} the config wants {shape} whole or "
                        f"{local} for this rank")
            elif tuple(x.shape) != shape:
                raise ValueError(f"param {name} has shape {tuple(x.shape)}, "
                                 f"config wants {shape}")
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

    def whole(self, name: str, x=None):
        """Leaf ``name`` (or ``x``, a block of it) gathered over the
        `parallel.sharding.ZERO_AXES` that split it (differentiable); the
        model-axis splits stay. Layer leaves take their per-layer spec."""
        from ray_tpu_torch.models.gpt import _whole
        if self.mesh is None:
            return getattr(self, name) if x is None else x
        if x is None:
            return _whole(getattr(self, name), self.specs[name], self.mesh)
        spec = self.layer_specs[name] if name in self.layer_specs \
            else self.specs[name]
        return _whole(x, spec, self.mesh)


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
    numpy arrays, copies that later updates of the model leave as they
    are; on a mesh every leaf gathered whole (all ranks call it)."""
    mesh = getattr(model, "mesh", None)

    def host(name, p):
        p = p.detach()
        if mesh is not None:
            p = sharding.gather_full(p, model.specs[name], mesh)
        return np.array(p.float().cpu())
    return nest((n, host(n, p)) for n, p in model.named_parameters())
