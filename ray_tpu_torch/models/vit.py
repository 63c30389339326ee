"""Vision Transformer classifier: the counterpart of
`ray_tpu/models/vit.py`, with its configuration, parameter tree and
math: patchify -> linear embed + learned positions -> pre-norm encoder
blocks (bidirectional attention, tanh-approximated GELU MLP) -> final
RMSNorm -> mean pool -> linear head.

The attention is plain softmax math, as in the reference (whose own
comment: "no flash kernel needed" at ViT's sequence lengths): the
scores and the probability-weighted values are accumulated in f32 from
the activation-dtype operands. ``jax.nn.gelu`` defaults to the tanh
approximation, so the MLP uses ``gelu(approximate="tanh")``.

On a mesh (``mesh=``, one process per rank; `param_logical_axes` under
the rule table) each rank holds its block of every leaf and its rows of
a batch: heads and the MLP's columns over ``tensor`` (Megatron, as
`models.gpt`), ``embed`` over ``fsdp`` (gathered at use); the loss is a
rank's rows' share of the global mean. A batch of images has no length
axis and the block ignores the mesh, as the reference's does: the
``seq``, ``expert`` and ``pipe`` ranks repeat the step on their rows
(`ViT.batch_axes`, the axes whose ranks hold other rows, are the only
ones a loss or gradient is summed over; place a batch with
`parallel.sharding.shard_batch(..., logical=("batch",))`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ray_tpu_torch.models import gpt
from ray_tpu_torch.models._stacked import StackedModel
from ray_tpu_torch.parallel import sharding


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    channels: int = 3
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size ** 2

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def small(**kw) -> ViTConfig:
    return ViTConfig(**{**dict(image_size=32, patch_size=4, num_classes=10,
                               d_model=128, n_layers=2, n_heads=4,
                               d_ff=256), **kw})


def param_logical_axes(cfg: ViTConfig) -> dict:
    """Pytree of logical-axis tuples, mirroring `init_params`' structure
    (`ray_tpu.models.vit.param_logical_axes`)."""
    layer = {
        "ln1_scale": (None, "embed"),
        "ln2_scale": (None, "embed"),
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "heads"),
        "wv": (None, "embed", "heads"),
        "wo": (None, "heads", "embed"),
        "w_up": (None, "embed", "mlp"),
        "w_down": (None, "mlp", "embed"),
    }
    return {
        "patch_embed": (None, "embed"),
        "pos_embed": (None, "embed"),
        "final_ln_scale": ("embed",),
        "head": ("embed", None),
        "head_bias": (None,),
        "layers": layer,
    }


# The mesh axis the model computes on split, by the logical axes it may
# split.
_MODEL_AXES = {"tensor": ("heads", "mlp")}


def _shapes(cfg: ViTConfig) -> tuple[dict, dict]:
    d, h = cfg.d_model, cfg.n_heads * cfg.head_dim
    f, L = cfg.d_ff, cfg.n_layers
    top = {"patch_embed": (cfg.patch_dim, d),
           "pos_embed": (cfg.num_patches, d), "final_ln_scale": (d,),
           "head": (d, cfg.num_classes), "head_bias": (cfg.num_classes,)}
    layer = {"ln1_scale": (L, d), "ln2_scale": (L, d), "wq": (L, d, h),
             "wk": (L, d, h), "wv": (L, d, h), "wo": (L, h, d),
             "w_up": (L, d, f), "w_down": (L, f, d)}
    return top, layer


def init_params(seed: int, cfg: ViTConfig, device=None) -> dict:
    """float32 master params with `ray_tpu.models.vit.init_params`'s tree,
    shapes and scales, drawn from a `torch.Generator` seeded with
    ``seed`` on ``device``."""
    device = gpt.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, h = cfg.d_model, cfg.n_heads * cfg.head_dim
    f, L = cfg.d_ff, cfg.n_layers

    def norm(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) \
            * (1.0 / np.sqrt(fan_in))

    layers = {
        "ln1_scale": torch.ones((L, d), device=device),
        "ln2_scale": torch.ones((L, d), device=device),
        "wq": norm((L, d, h), d),
        "wk": norm((L, d, h), d),
        "wv": norm((L, d, h), d),
        "wo": norm((L, h, d), h) / np.sqrt(2 * L),
        "w_up": norm((L, d, f), d),
        "w_down": norm((L, f, d), f) / np.sqrt(2 * L),
    }
    return {
        "patch_embed": norm((cfg.patch_dim, d), cfg.patch_dim),
        "pos_embed": norm((cfg.num_patches, d), 1.0) * 0.02,
        "final_ln_scale": torch.ones((d,), device=device),
        "head": norm((d, cfg.num_classes), d),
        "head_bias": torch.zeros((cfg.num_classes,), device=device),
        "layers": layers,
    }


class ViT(StackedModel):
    """The ViT's weights in one dtype on one device (the card unless
    ``device`` says otherwise), as `models.gpt.GPT`; with ``mesh`` each
    rank keeps its block of every leaf (`param_logical_axes` under
    ``rules``)."""

    def __init__(self, cfg: ViTConfig, params: dict, *, device=None,
                 dtype: torch.dtype | None = None, trainable: bool = False,
                 mesh=None, rules: dict | None = None):
        super().__init__(cfg, params, *_shapes(cfg), device=device,
                         dtype=dtype, trainable=trainable, mesh=mesh,
                         rules=rules, logical_axes=param_logical_axes(cfg),
                         model_axes=_MODEL_AXES)
        # the axes that split a batch: its rows' (no length axis)
        self.batch_axes = (() if self.mesh is None else
                           sharding.row_axes(self.mesh, rules))


def params_from_numpy(tree: dict, cfg: ViTConfig, device=None,
                      dtype: torch.dtype | None = None,
                      trainable: bool = False, mesh=None,
                      rules: dict | None = None) -> ViT:
    """Carry a JAX param pytree across (numpy arrays or tensors; copied,
    never transposed). For training pass ``dtype=torch.float32,
    trainable=True``; with ``mesh`` each rank keeps its blocks."""
    return ViT(cfg, tree, device=device, dtype=dtype, trainable=trainable,
               mesh=mesh, rules=rules)


def _patchify(images, cfg: ViTConfig):
    """[B, H, W, C] -> [B, N, patch_dim]."""
    b, hgt, wid, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, hgt // p, p, wid // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hgt // p) * (wid // p), p * p * c)


def _block(lp: dict, x, cfg: ViTConfig, model: ViT | None = None):
    """One encoder block; with ``model`` (on a mesh) ``lp`` holds this
    rank's blocks, gathered here over the axes that only store them
    split, the heads and MLP columns the rank's."""
    adt = x.dtype
    b, t, d = x.shape
    hd = cfg.head_dim
    enter = leave = (lambda y: y)
    if model is not None:
        mesh = model.mesh
        lp = {k: model.whole(k, w) for k, w in lp.items()}
        enter, leave = gpt.tensor_conjugates(mesh)

    h = enter(gpt._rms_norm(x, lp["ln1_scale"].to(adt)))
    q = (h @ lp["wq"].to(adt)).view(b, t, -1, hd)
    k = (h @ lp["wk"].to(adt)).view(b, t, -1, hd)
    v = (h @ lp["wv"].to(adt)).view(b, t, -1, hd)
    # bidirectional attention, f32 accumulation from the activation-dtype
    # operands (exact in f32), probabilities rounded to the activation
    # dtype as in the reference
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores / np.sqrt(hd), dim=-1).to(adt)
    att = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(adt)
    x = x + leave(att.reshape(b, t, -1) @ lp["wo"].to(adt))

    h = enter(gpt._rms_norm(x, lp["ln2_scale"].to(adt)))
    ff = nn.functional.gelu(h @ lp["w_up"].to(adt), approximate="tanh")
    return x + leave(ff @ lp["w_down"].to(adt))


def forward(model: ViT, images, cfg: ViTConfig | None = None):
    """images [B, H, W, C] float -> logits [B, num_classes] f32 (on a
    mesh: this rank's rows)."""
    cfg = model.cfg if cfg is None else cfg
    adt = cfg.activation_dtype()
    patches = _patchify(images.to(adt), cfg)
    x = patches @ model.whole("patch_embed").to(adt)
    x = x + model.whole("pos_embed").to(adt)[None]
    args = () if model.mesh is None else (model,)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in model.layer_params():
        if remat:
            x = ckpt.checkpoint(_block, lp, x, cfg, *args,
                                use_reentrant=False)
        else:
            x = _block(lp, x, cfg, *args)
    x = gpt._rms_norm(x, model.whole("final_ln_scale").to(adt))
    pooled = torch.mean(x.float(), dim=1)
    return pooled @ model.whole("head").float() + model.head_bias.float()


def loss_fn(model: ViT, batch: dict, cfg: ViTConfig | None = None):
    """Softmax cross entropy. batch: {"images": [B, H, W, C],
    "labels": [B]}. On a mesh: this rank's rows, and its share of the
    global mean over the ranks that hold other rows (`models.gpt.
    token_mean` over `ViT.batch_axes`)."""
    logits = forward(model, batch["images"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
    return gpt.token_mean(nll, model.mesh, rules=model.rules,
                          axes=model.batch_axes)


def num_params(model: ViT) -> int:
    return sum(p.numel() for p in model.parameters())
