"""GPT-style decoder-only transformer in PyTorch: the counterpart of
`ray_tpu/models/gpt.py` for paged serving, for the unpaged KV-cache path
(`init_kv_cache`, `prefill`, `decode_step`) and for training.

Same configuration fields, same parameter tree (stacked ``[L, ...]``
layer leaves in JAX's ``[in, out]`` orientation, so weights carried over
from the JAX package are copied, never transposed) and the same math:
token + learned position embeddings, then L blocks of RMSNorm -> QKV ->
attention -> ``wo`` -> RMSNorm -> SwiGLU, a final RMSNorm and the
unembed against the tied ``embed``.

Differences from the JAX module, all deliberate:

- `GPT` holds the weights in ONE dtype: the activation dtype for
  serving (cast once at load, so a decode tick never re-reads f32
  masters), float32 trainable masters for training. Every block casts
  its weights to the activation dtype at use, as JAX does
  (``lp["wq"].astype(adt)``), so gradients land on the f32 masters; on
  the serving model the cast is a no-op.
- Per-block remat is `torch.utils.checkpoint` (non-reentrant):
  ``remat_policy="nothing"`` recomputes the whole block, ``"dots"`` and
  ``"attn_out"`` are selective checkpointing that save the block's
  matmul outputs or the flash kernel's output (the plain ``"xla"``
  attention is recomputed under ``"attn_out"``). Remat never changes
  the numbers.
- The KV caches are updated in place (JAX donates them to the jit). Each
  layer's paged pool storage carries one extra row past its last block, the
  *sink*: writes JAX drops (``.at[].set(mode="drop")`` for padded chunk
  rows and positions past the table) go there, so no write needs a host
  sync or a boolean mask, and no block table can ever name the sink.
- Reads JAX clamps (``table[positions // bs]``, ``pos_embed[positions]``
  for padded rows) are clamped explicitly.
- Large products (QKV, ``wo``, the MLP, the dense unembed) are
  `torch.matmul`, as the JAX package leaves them to XLA; attention and
  the fused loss (``loss_impl="fused"``: `ops.fused_xent`, whose
  kernels do the unembed products themselves, so the ``[B, T, V]``
  logits never exist) are kernels of this repository.

Int8 serving, as in the reference: ``kv_dtype="int8"`` makes the paged
pool int8 with one f32 scale per (position, head) row, quantized at
write (`ops.quant.quantize_rows`) and dequantized inside the paged
attention kernels; ``weight_dtype="int8"`` serves a model from
`quantize_params` (per-output-channel int8 layer weights, each
dequantized to the activation dtype at use before its `torch.matmul`,
as the reference's ``_w`` leaves it to XLA). Training and the unpaged
``prefill``/``decode_step`` run full-precision weights only and refuse a
quantized model.

Training on a device mesh (`ray_tpu_torch.parallel`, one process per
rank): a `GPT` built with ``mesh=`` keeps this rank's block of every leaf
(`param_logical_axes` under the rule table), and the training forwards
run on it with the collectives written where XLA puts them in the
reference. ``fsdp`` (and any other data-like axis a rule puts on a leaf)
splits storage: each leaf is gathered before use, inside the remat
region, and its gradient reduce-scattered. ``tensor`` splits the Q/K/V
and MLP-up columns and the ``wo``/``w_down`` rows (Megatron: the block's
input enters through `collectives.copy_to`, the row products leave
through `collectives.reduce_from`), and the vocabulary of the tied
embedding (a masked lookup summed over the axis; the vocab-sharded
loss). ``seq`` splits the tokens: positions are offset by the rank's
block and ``attn_impl="auto"`` becomes the ring (`parallel.
ring_attention`). Every per-token quantity stays on the rank of its
tokens; `token_mean` divides a rank's sum by the global count. A mesh of
one rank is the single-card model.

Serving on a mesh: the same model serves the unpaged (`init_kv_cache`,
`prefill`, `decode_step`) and paged (`init_kv_pool`, `prefill_paged`,
`decode_step_paged`, `verify_step_paged`) forwards on any axes. Each
rank allocates its heads' slice of a cache or pool
(`kv_cache_logical_axes`, `kv_pool_logical_axes`: heads over
``tensor``; an unpaged cache's slots over the data axes, a pool's blocks
whole), the attention kernels run on the rank's ``H / tensor`` heads,
and the vocabulary-split logits are gathered over ``tensor``, so every
rank holds the same f32 ``[B, V]``. No GPT leaf, cache or pool axis
sits on ``seq``, ``expert`` or ``pipe``: their ranks repeat the step
(a serving prefill takes whole rows there, with no ring). Int8 weights
serve on a mesh too: each rank holds its int8 and scale blocks
(`quantize_params` takes each channel's absmax over the ranks that
split its input axis). `completion_logprobs` on a mesh takes a
distributed log-sum-exp over the vocabulary split, with no ``[B, T,
V]`` gather, and over a ``seq`` split gathers the ``[B, T]`` rows of
target log-probabilities.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ray_tpu_torch.models._stacked import leaf_specs
from ray_tpu_torch.ops import decode_attention as da
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import fused_xent as fx
from ray_tpu_torch.ops import quant
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import active_mesh
from ray_tpu_torch.parallel.ring_attention import ring_attention

@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 1024
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "auto"          # auto | ring | flash | xla
    matmul_out: str = "activation"   # activation | float32
    logits_dtype: str = "float32"    # float32 | bfloat16
    loss_impl: str = "dense"         # dense | fused
    loss_chunk: int = 512
    # "auto"/"pallas" select the hand-written CUDA kernel for CUDA
    # tensors (the plain version on the CPU); "jax" selects the plain
    # version everywhere, as it selects the pure-JAX path in ray_tpu.
    decode_attn_impl: str = "auto"   # auto | pallas | jax
    # Paged pool payload: "f32" keeps the activation dtype; "int8" stores
    # int8 rows plus one f32 scale per (position, head) row.
    kv_dtype: str = "f32"            # f32 | int8
    # Layer weights of the paged forwards: "int8" serves a model from
    # `quantize_params` (the engine quantizes the model it is given).
    weight_dtype: str = "f32"        # f32 | int8
    prefill_attn_impl: str = "auto"  # auto | pallas | jax

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def small(**kw) -> GPTConfig:
    return GPTConfig(**{**dict(vocab_size=512, d_model=128, n_layers=2,
                               n_heads=4, d_ff=512, max_seq_len=128), **kw})


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    another device; with no card and no explicit device they raise. A
    CUDA device comes back with its index, so devices compare equal to
    the ones tensors report."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_quant_cfg(cfg: GPTConfig) -> bool:
    """Validate the inference knobs; returns True when the KV pool is
    int8."""
    if cfg.kv_dtype not in ("f32", "int8"):
        raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r} (expected "
                         "'f32' | 'int8')")
    if cfg.weight_dtype not in ("f32", "int8"):
        raise ValueError(f"unknown weight_dtype {cfg.weight_dtype!r} "
                         "(expected 'f32' | 'int8')")
    for knob in ("prefill_attn_impl", "decode_attn_impl"):
        if getattr(cfg, knob) not in ("auto", "pallas", "jax"):
            raise ValueError(f"unknown {knob} {getattr(cfg, knob)!r} "
                             "(expected 'auto' | 'pallas' | 'jax')")
    return cfg.kv_dtype == "int8"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_logical_axes(cfg: GPTConfig, quantized: bool = False):
    """Pytree of logical-axis tuples, mirroring init_params' structure.
    Leading layer-stack axis is unsharded (None). With ``quantized`` (a
    tree from `quantize_params`) each ``"<name>_scale"`` ``[L, Out]``
    follows its weight's output axis (the reference names no axes for
    them)."""
    layer = {
        "ln1_scale": (None, "embed"),
        "ln2_scale": (None, "embed"),
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "heads"),
        "wv": (None, "embed", "heads"),
        "wo": (None, "heads", "embed"),
        "w_up": (None, "embed", "mlp"),
        "w_gate": (None, "embed", "mlp"),
        "w_down": (None, "mlp", "embed"),
    }
    if quantized:
        layer.update({w + "_scale": (None, layer[w][-1])
                      for w in QUANTIZED_WEIGHTS})
    return {
        "embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        "final_ln_scale": ("embed",),
        "layers": layer,
    }


# The mesh axes the model computes on split, by the logical axes they may
# split; a leaf split over `parallel.sharding.ZERO_AXES` is gathered
# before use.
_MODEL_AXES = {"tensor": ("heads", "mlp", "vocab"), "pipe": ("stage",)}


def _leaf_specs(cfg: GPTConfig, mesh, rules, logical_axes,
                quantized: bool = False) -> dict:
    """``{leaf name: PartitionSpec}`` ("layers.wq", ...) on ``mesh``;
    a split the model cannot compute on raises."""
    tree = (param_logical_axes(cfg, quantized) if logical_axes is None
            else logical_axes)
    return leaf_specs(tree, mesh, rules, _MODEL_AXES)


def init_params(seed: int, cfg: GPTConfig, device=None) -> dict:
    """float32 master params with `ray_tpu.models.gpt.init_params`'s tree,
    shapes and scales, drawn from a `torch.Generator` seeded with
    ``seed`` on ``device`` (the bits differ from ``jax.random``'s; carry
    JAX params across with `params_from_numpy` when they must match)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, h, f, n = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                  cfg.n_layers)

    def norm(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) \
            * (1.0 / np.sqrt(fan_in))

    layers = {
        "ln1_scale": torch.ones((n, d), device=device),
        "ln2_scale": torch.ones((n, d), device=device),
        "wq": norm((n, d, h), d),
        "wk": norm((n, d, h), d),
        "wv": norm((n, d, h), d),
        "wo": norm((n, h, d), h) / np.sqrt(2 * n),
        "w_up": norm((n, d, f), d),
        "w_gate": norm((n, d, f), d),
        "w_down": norm((n, f, d), f) / np.sqrt(2 * n),
    }
    return {
        "embed": norm((cfg.vocab_size, d), 1.0) * 0.02,
        "pos_embed": norm((cfg.max_seq_len, d), 1.0) * 0.01,
        "final_ln_scale": torch.ones((d,), device=device),
        "layers": layers,
    }


# The per-layer matmul weights the int8 weight-only path quantizes; norm
# scales, embed and pos_embed keep their dtype.
QUANTIZED_WEIGHTS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")


class GPT(nn.Module):
    """The model's weights, in one dtype on one device (`resolve_device`:
    the card unless ``device`` says otherwise). ``params`` is a tree
    shaped like `init_params`'s (tensors or numpy arrays); each leaf is
    copied in as a parameter of ``dtype`` (default: the config's
    activation dtype), frozen unless ``trainable`` (training holds f32
    masters: ``dtype=torch.float32, trainable=True``).

    A tree from `quantize_params` (the port's or the reference's, carried
    across) holds int8 `QUANTIZED_WEIGHTS` leaves, each beside an f32
    ``"<name>_scale"`` ``[L, Out]`` leaf: both keep their dtypes, and the
    model is ``quantized`` (frozen, for the paged forwards). On a mesh a
    scale splits with its weight's output axis
    (`param_logical_axes` with ``quantized``)."""

    def __init__(self, cfg: GPTConfig, params: dict, *, device=None,
                 dtype: torch.dtype | None = None, trainable: bool = False,
                 mesh=None, rules: dict | None = None, logical_axes=None):
        super().__init__()
        n, d, h, f = (cfg.n_layers, cfg.d_model,
                      cfg.n_heads * cfg.head_dim, cfg.d_ff)
        want = {"embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_seq_len, d),
                "final_ln_scale": (d,)}
        want_layers = {"ln1_scale": (n, d), "ln2_scale": (n, d),
                       "wq": (n, d, h), "wk": (n, d, h), "wv": (n, d, h),
                       "wo": (n, h, d), "w_up": (n, d, f),
                       "w_gate": (n, d, f), "w_down": (n, f, d)}
        layers = params["layers"]
        scales = {w + "_scale": (n, want_layers[w][-1])
                  for w in QUANTIZED_WEIGHTS if w + "_scale" in layers}
        self.quantized = bool(scales)
        if self.quantized and trainable:
            raise ValueError("a quantized model (int8 weights) cannot be "
                             "trained; train the f32 masters")
        self.cfg = cfg
        self.mesh = active_mesh(mesh)
        self.rules = rules
        self.specs = ({} if self.mesh is None else
                      _leaf_specs(cfg, self.mesh, rules, logical_axes,
                                  self.quantized))
        # each layer leaf's spec without the layer axis (what `_block`
        # gathers by)
        self.layer_specs = {
            k[len("layers."):]: sharding.PartitionSpec(*spec[1:])
            for k, spec in self.specs.items() if k.startswith("layers.")}
        # each leaf's whole shape (on a mesh the model holds a block)
        self.whole_shapes = {**want, **{f"layers.{k}": v for k, v in
                                        {**want_layers, **scales}.items()}}
        dtype = cfg.activation_dtype() if dtype is None else dtype
        device = resolve_device(device)

        def leaf(x, dt=dtype):
            t = (x if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x)))   # writable copy
            t = t.to(device=device, dtype=dt)
            return nn.Parameter(t.contiguous(), requires_grad=trainable)

        def block(name, x, shape):
            # the whole leaf (this rank keeps its block) or the block
            if self.mesh is None:
                return x
            spec = self.specs[name]
            if tuple(x.shape) == shape:
                return sharding.local_shard(x, spec, self.mesh)
            local = sharding.local_shape(shape, spec, self.mesh)
            if tuple(x.shape) != local:
                raise ValueError(f"param {name} has shape "
                                 f"{tuple(x.shape)}; on {self.mesh} the "
                                 f"config wants {shape} whole or {local} "
                                 "for this rank")
            return x

        for name, shape in want.items():
            x = params[name]
            if self.mesh is None and tuple(x.shape) != shape:
                raise ValueError(f"param {name} has shape "
                                 f"{tuple(x.shape)}, config wants "
                                 f"{shape}")
            setattr(self, name, leaf(block(name, x, shape)))
        self.layers = nn.ParameterDict()
        for name, shape in {**want_layers, **scales}.items():
            x = layers[name]
            if self.mesh is None and tuple(x.shape) != shape:
                raise ValueError(f"param layers.{name} has shape "
                                 f"{tuple(x.shape)}, config wants {shape}")
            x = block(f"layers.{name}", x, shape)
            dt = dtype
            if name in scales:
                dt = torch.float32
            elif name + "_scale" in scales:
                if str(x.dtype) not in ("int8", "torch.int8"):
                    raise ValueError(f"param layers.{name} has a scale "
                                     f"sibling but dtype {x.dtype}, want "
                                     "int8")
                dt = torch.int8
            self.layers[name] = leaf(x, dt)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layer_params(self) -> list[dict]:
        """Per-layer views ``[{name: leaf[i]}]`` of the stacked layer
        leaves, through one `unbind` per leaf, whose backward stacks the
        L layer gradients in one op (indexing ``leaf[i]`` per layer
        would materialise a full-size gradient per layer)."""
        names = list(self.layers.keys())
        return [dict(zip(names, per)) for per in
                zip(*(self.layers[n].unbind(0) for n in names))]


def param_tree(model: GPT) -> dict:
    """The model's parameters as the reference's nested dict (the
    tensors themselves, no copy)."""
    return {"embed": model.embed, "pos_embed": model.pos_embed,
            "final_ln_scale": model.final_ln_scale,
            "layers": dict(model.layers.items())}


def quantize_params(model: GPT) -> GPT:
    """A new model on the same device (and mesh) for
    ``weight_dtype="int8"`` serving: every `QUANTIZED_WEIGHTS` leaf ``[L,
    In, Out]`` becomes an int8 leaf beside an ``"<name>_scale"`` f32
    ``[L, Out]`` leaf (`ops.quant.quantize_channels` of the model's
    weights in f32); the other leaves are copied in their dtype.
    ``model`` is left as it was. Counterpart of the reference's
    ``quantize_params``. On a mesh each rank quantizes its block: a
    channel's absmax is the max over the ranks that split its ``In``
    axis, so every rank's int8 and scale blocks are the cut of the whole
    tree's, bit for bit."""
    if model.quantized:
        raise ValueError("quantize_params: the model is quantized already")
    tree = {k: v.detach().clone() for k, v in param_tree(model).items()
            if k != "layers"}
    layers = {}
    with torch.no_grad():
        for name, w in model.layers.items():
            if name in QUANTIZED_WEIGHTS:
                layers[name], layers[name + "_scale"] = \
                    quant.quantize_channels(w, _in_axis_pmax(model, name))
            else:
                layers[name] = w.detach().clone()
    return GPT(model.cfg, {**tree, "layers": layers}, device=model.device,
               dtype=model.embed.dtype, mesh=model.mesh, rules=model.rules)


def _in_axis_pmax(model: GPT, name: str):
    """The max over the mesh axes that split layer weight ``name``'s
    ``In`` axis (None where none does)."""
    if model.mesh is None:
        return None
    axes = model.mesh.live_axes(sharding.spec_axes(
        model.specs[f"layers.{name}"][1:2]))
    if not axes:
        return None
    return functools.partial(col.pmax, axis_name=axes, mesh=model.mesh)


def params_from_numpy(tree: dict, cfg: GPTConfig, device=None,
                      dtype: torch.dtype | None = None,
                      trainable: bool = False, mesh=None,
                      rules: dict | None = None) -> GPT:
    """Carry a JAX param pytree across: ``tree`` is
    ``jax.tree.map(np.asarray, params)`` (nested dict of numpy arrays,
    stacked ``[L, ...]`` layer leaves, ``[in, out]`` weights; a tree from
    the reference's ``quantize_params`` keeps its int8 leaves and f32
    scales). For training pass ``dtype=torch.float32, trainable=True``.
    With ``mesh`` each rank keeps its block of every leaf
    (`param_logical_axes` under ``rules``, default `DEFAULT_RULES`)."""
    return GPT(cfg, tree, device=device, dtype=dtype, trainable=trainable,
               mesh=mesh, rules=rules)


def params_to_numpy(model: GPT) -> dict:
    """The reverse carry: the model's parameters as the JAX package's
    nested dict of numpy arrays, float32 (int8 leaves stay int8), copies
    that later updates of the model leave as they are. On a mesh every
    leaf is gathered whole (all ranks call it)."""
    def host(name, p):
        p = p.detach()
        if model.mesh is not None:
            p = sharding.gather_full(p, model.specs[name], model.mesh)
        return np.array((p if p.dtype == torch.int8 else p.float()).cpu())
    tree = param_tree(model)
    return {k: ({n: host(f"layers.{n}", p) for n, p in v.items()}
                if k == "layers" else host(k, v)) for k, v in tree.items()}


def _full_precision(model: GPT, what: str) -> None:
    if model.quantized:
        raise ValueError(f"{what} runs full-precision weights only; this "
                         "model holds int8 weights (quantize_params), which "
                         "serve the paged forwards")


def _rms_norm(x, scale):
    # Cast order as ray_tpu: normalise in f32, round to x's dtype, then
    # scale in x's dtype.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _mm_f32(x, w):
    """``x @ w`` from activation-dtype operands with f32 accumulation
    AND an f32 result (JAX's ``preferred_element_type=float32``)."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda and not (torch.is_grad_enabled()
                          and (x.requires_grad or w.requires_grad)):
        # torch.mm takes matrices: leading axes fold into the rows
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).view(*x.shape[:-1],
                                                      w.shape[-1])
    # exact operands (bf16 fits in f32), and differentiable
    return torch.matmul(x.float(), w.float())


def _mm(x, w, cfg: GPTConfig):
    """A block matmul: f32 accumulation, output in the activation dtype
    (``matmul_out="float32"`` materialises the f32 product first)."""
    if cfg.matmul_out == "float32":
        return _mm_f32(x, w).to(x.dtype)
    return torch.matmul(x, w)


def _layer(lp: dict, x, cfg: GPTConfig, attend, enter=None, leave=None):
    """One block on rows ``x [N, D]`` with this layer's weights ``lp``
    (one entry of `GPT.layer_params`), each cast to x's dtype at use;
    ``attend(q, k, v)`` takes ``[N, H, Dh]`` projections and returns
    ``[N, H*Dh]``. H is the heads ``wq`` holds (a tensor rank's share on a
    mesh, where ``enter`` takes each normed input into the column-split
    products and ``leave`` combines each row-split product)."""
    adt = x.dtype
    n = x.shape[0]
    hd = cfg.head_dim

    def w(name):
        # an int8 weight: dequantized through its per-channel scale in
        # f32, then cast (the reference's ``_w``)
        scale = lp.get(name + "_scale")
        if scale is None:
            return lp[name].to(adt)
        return (lp[name].float() * scale[..., None, :]).to(adt)

    enter = enter or (lambda y: y)
    leave = leave or (lambda y: y)
    h = enter(_rms_norm(x, w("ln1_scale")))
    q = _mm(h, w("wq"), cfg).view(n, -1, hd)
    k = _mm(h, w("wk"), cfg).view(n, -1, hd)
    v = _mm(h, w("wv"), cfg).view(n, -1, hd)
    x = x + leave(_mm(attend(q, k, v), w("wo"), cfg))
    h = enter(_rms_norm(x, w("ln2_scale")))
    up = _mm(h, w("w_up"), cfg)
    gate = _mm(h, w("w_gate"), cfg)
    return x + leave(_mm(nn.functional.silu(gate) * up, w("w_down"), cfg))


def _unembed(model: GPT, x):
    x = _rms_norm(x, model.final_ln_scale.to(x.dtype))
    return _mm_f32(x, model.embed.to(x.dtype).t())


# ---------------------------------------------------------------------------
# training forward: flash attention, remat, dense loss
# ---------------------------------------------------------------------------

def _attention(q, k, v, cfg: GPTConfig, mesh=None):
    """Causal attention on ``[B, T, H, Dh]``: ``"auto"``/``"flash"`` take
    the flash kernels, ``"xla"`` the plain version (the only way to
    plain attention on the card, as in the reference), ``"ring"`` the
    ring over the mesh's ``seq`` axis. When that axis has more than one
    rank T is the rank's block, and every choice takes the ring (the
    reference's XLA attention over a seq-split array is the whole
    sequence's, never a block's alone)."""
    impl = cfg.attn_impl
    if mesh is not None and mesh.shape["seq"] > 1 and impl in (
            "auto", "flash", "xla"):
        impl = "ring"
    elif impl == "auto":
        impl = "flash"
    if impl == "flash":
        return fa.flash_attention(q, k, v, causal=True)
    if impl == "xla":
        return fa.reference_attention(q, k, v, causal=True)
    if impl == "ring":
        if mesh is None:
            raise ValueError("attn_impl='ring' needs a mesh: the ring runs "
                             "over its 'seq' axis (build the model and "
                             "trainer with mesh=)")
        return ring_attention(q, k, v, mesh, causal=True)
    raise ValueError(f"unknown attn_impl {impl!r} (expected 'auto' | "
                     "'ring' | 'flash' | 'xla')")


def _whole(x, spec, mesh):
    """A leaf gathered over the `ZERO_AXES` that split it (differentiable:
    its gradient is reduce-scattered back); model-axis splits stay."""
    for i, entry in enumerate(spec):
        axes = tuple(a for a in mesh.live_axes(sharding.spec_axes((entry,)))
                     if a in sharding.ZERO_AXES)
        if axes:
            x = col.all_gather(x, axes, mesh, dim=i)
    return x


def tensor_conjugates(mesh):
    """Megatron's pair over ``tensor`` on ``mesh``: ``(enter, leave)``,
    `collectives.copy_to` for a replicated input of a column-split
    product and `collectives.reduce_from` for a row-split product's
    partial sums."""
    return (functools.partial(col.copy_to, axis_name="tensor", mesh=mesh),
            functools.partial(col.reduce_from, axis_name="tensor",
                              mesh=mesh))


def _block(lp: dict, x, cfg: GPTConfig, kv: list | None = None, mesh=None,
           specs: dict | None = None, seq_split: bool = True):
    """One transformer block on ``x [B, T, D]`` in the activation dtype,
    attention through `_attention`; with ``kv`` the block's (k, v)
    ``[B, T, H, Dh]`` are appended to it (what a KV cache stores). On a
    mesh ``lp`` holds this rank's blocks (``specs``: each layer leaf's
    spec without the layer axis), gathered here, inside the remat
    region, so the backward gathers again instead of saving them.
    Without ``seq_split`` the rows are whole sequences on every ``seq``
    rank (a serving prefill repeats the step there): no ring."""
    b, t, d = x.shape
    enter = leave = None
    if mesh is not None:
        lp = {k: _whole(w, specs[k], mesh) for k, w in lp.items()}
        enter, leave = tensor_conjugates(mesh)

    def attend(q, k, v):
        nh, hd = q.shape[1], q.shape[2]
        q, k, v = (z.view(b, t, nh, hd) for z in (q, k, v))
        if kv is not None:
            kv.append((k, v))
        return _attention(q, k, v, cfg, mesh if seq_split else None
                          ).reshape(b * t, nh * hd)

    return _layer(lp, x.reshape(b * t, d), cfg, attend, enter,
                  leave).view(b, t, d)


# What each selective remat policy saves for the backward: the block's
# matmul outputs (JAX's checkpoint_dots_with_no_batch_dims: the batched
# attention products are recomputed) or the flash kernel's output.
_SAVED_OPS = {
    "dots": lambda: {torch.ops.aten.mm.default},
    "attn_out": lambda: {torch.ops.ray_tpu_torch.flash_fwd.default},
}


def _remat_context(cfg: GPTConfig):
    """``context_fn`` for `torch.utils.checkpoint` under
    ``cfg.remat_policy`` (None: recompute everything)."""
    if cfg.remat_policy == "nothing":
        return None
    if cfg.remat_policy not in _SAVED_OPS:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected 'nothing' | 'dots' | 'attn_out')")
    saved = _SAVED_OPS[cfg.remat_policy]()

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


def _mesh_of(model: GPT, mesh):
    """The model's mesh; a caller's ``mesh`` must be that one (or one
    rank)."""
    mesh = active_mesh(mesh)
    if mesh is not None and mesh is not model.mesh:
        raise ValueError(f"the model holds its blocks for {model.mesh}, "
                         f"not {mesh}: build it with mesh=")
    return model.mesh


def _embed_table(model: GPT, cfg: GPTConfig, mesh):
    """The tied embedding in the activation dtype: whole on one card; on
    a mesh this rank's vocabulary block (gathered over `ZERO_AXES`)."""
    if mesh is None:
        return model.embed.to(cfg.activation_dtype())
    return _whole(model.embed, model.specs["embed"], mesh).to(
        cfg.activation_dtype())


def vocab_axes(model: GPT) -> tuple:
    """The mesh axes that split the model's vocabulary ((): whole)."""
    if model.mesh is None:
        return ()
    return tuple(a for a in model.mesh.live_axes(
        sharding.spec_axes(model.specs["embed"][:1]))
        if a not in sharding.ZERO_AXES)


def _lookup(model: GPT, emb, tokens):
    """emb[tokens]; on a vocab-split mesh each rank looks up the ids its
    rows hold (zeros elsewhere) and the ranks' rows are summed."""
    axes = vocab_axes(model)
    if not axes:
        return emb[tokens]
    mesh, v_loc = model.mesh, emb.shape[0]
    local = tokens.long() - mesh.axis_index(axes) * v_loc
    hit = (local >= 0) & (local < v_loc)
    rows = emb[local.clamp(0, v_loc - 1)] * hit[..., None].to(emb.dtype)
    return col.reduce_from(rows, axes, mesh)


def _features(model: GPT, tokens, cfg: GPTConfig, emb, with_kv=False,
              mesh=None, seq_split=True):
    _full_precision(model, "the full-sequence forward")
    t = tokens.shape[1]
    adt = cfg.activation_dtype()
    specs, final_ln = None, model.final_ln_scale
    if mesh is None:
        x = emb[tokens] + model.pos_embed[:t].to(adt)[None]
    else:
        # a seq rank's tokens start at its block's first position (whole
        # rows, repeated on the seq ranks, without ``seq_split``)
        off = mesh.axis_index("seq") * t if seq_split else 0
        pos = _whole(model.pos_embed, model.specs["pos_embed"], mesh)
        x = _lookup(model, emb, tokens) + pos[off:off + t].to(adt)[None]
        specs = model.layer_specs
        final_ln = _whole(final_ln, model.specs["final_ln_scale"], mesh)
    if with_kv:
        kv = []
        for lp in model.layer_params():
            x = _block(lp, x, cfg, kv, mesh, specs, seq_split)
        ks, vs = (torch.stack(z) for z in zip(*kv))
        return _rms_norm(x, final_ln.to(adt)), (ks, vs)
    remat = cfg.remat and torch.is_grad_enabled()
    context = _remat_context(cfg) if cfg.remat else None
    for lp in model.layer_params():
        if remat:
            kw = {} if context is None else {"context_fn": context}
            args = () if mesh is None else (None, mesh, specs)
            x = ckpt.checkpoint(_block, lp, x, cfg, *args,
                                use_reentrant=False, **kw)
        else:
            x = _block(lp, x, cfg, None, mesh, specs)
    return _rms_norm(x, final_ln.to(adt))


def forward_features(model: GPT, tokens, cfg: GPTConfig | None = None,
                     mesh=None, *, with_kv: bool = False):
    """tokens [B, T] int -> final-norm activations [B, T, d_model] in
    the activation dtype: everything except the unembed matmul (the fused
    loss consumes these, so the logits never exist). On a mesh (the
    model's) tokens and activations are this rank's block.

    With ``with_kv`` (the prefill path) it also returns every layer's
    attention keys and values stacked as ``(k, v)``, each ``[L, B, T, H,
    Dh]``, the KV cache's layout; no remat in that mode."""
    cfg = model.cfg if cfg is None else cfg
    mesh = _mesh_of(model, mesh)
    return _features(model, tokens, cfg, _embed_table(model, cfg, mesh),
                     with_kv, mesh)


def forward(model: GPT, tokens, cfg: GPTConfig | None = None, mesh=None):
    """tokens [B, T] int -> logits [B, T, vocab] in ``cfg.logits_dtype``
    (f32 accumulation, rounded once, as JAX's preferred_element_type),
    attention per ``cfg.attn_impl``. On a mesh: this rank's tokens, and
    on a vocab-split one its block of the vocabulary."""
    cfg = model.cfg if cfg is None else cfg
    mesh = _mesh_of(model, mesh)
    emb = _embed_table(model, cfg, mesh)
    x = _features(model, tokens, cfg, emb, False, mesh)
    if vocab_axes(model):
        # a column-split product: x's cotangent sums over the vocab axes
        x = col.copy_to(x, vocab_axes(model), mesh)
    if cfg.logits_dtype == "float32":
        return _mm_f32(x, emb.t())
    return torch.matmul(x, emb.t()).to(getattr(torch, cfg.logits_dtype))


def check_loss_impl(cfg: GPTConfig) -> str:
    """Validate the loss_impl knob (a typo fails the first step)."""
    if cfg.loss_impl not in ("dense", "fused"):
        raise ValueError(f"unknown loss_impl {cfg.loss_impl!r} "
                         "(expected 'dense' | 'fused')")
    return cfg.loss_impl


def fused_nll(model: GPT, inputs, targets, cfg: GPTConfig, mesh=None):
    """Per-token nll [B, T] f32 through the fused cross-entropy kernels:
    the final-norm activations against the tied embedding, with no
    ``[B, T, V]`` logits in the forward or the backward. On a vocab-split
    mesh the kernels run on this rank's vocabulary block
    (`ops.fused_xent.vocab_sharded_xent`)."""
    mesh = _mesh_of(model, mesh)
    if mesh is None:
        x = forward_features(model, inputs, cfg)
        return fx.fused_softmax_xent(x, model.embed.to(cfg.activation_dtype()),
                                     targets, vocab_chunk=cfg.loss_chunk)
    emb = _embed_table(model, cfg, mesh)
    x = _features(model, inputs, cfg, emb, False, mesh)
    return fx.vocab_sharded_xent(x, emb, targets, mesh,
                                 vocab_axis=vocab_axes(model) or None,
                                 vocab_chunk=cfg.loss_chunk)


class _VocabParallelXent(torch.autograd.Function):
    """Dense cross entropy over this rank's logits block ``[..., V / n]``
    of a vocabulary split over ``axes`` (Megatron's vocab-parallel
    loss): a pmax and psums of the sum of exps and the target logit; the
    backward is the block's softmax minus the one-hot, with no
    collective (the nll's cotangent is the same on every rank)."""

    @staticmethod
    def forward(ctx, logits, targets, mesh, axes):
        lf = logits.float()
        m = col.pmax(lf.amax(dim=-1), axes, mesh)
        e = torch.exp(lf - m[..., None])
        sumexp = col.psum(e.sum(dim=-1), axes, mesh)
        v_loc = lf.shape[-1]
        local = targets.long() - mesh.axis_index(axes) * v_loc
        hit = (local >= 0) & (local < v_loc)
        idx = local.clamp(0, v_loc - 1)[..., None]
        tgt = col.psum(torch.where(hit, lf.gather(-1, idx)[..., 0], 0.0),
                       axes, mesh)
        ctx.save_for_backward(e / sumexp[..., None], idx, hit)
        ctx.dtype = logits.dtype
        return m + torch.log(sumexp) - tgt

    @staticmethod
    def backward(ctx, g):
        p, idx, hit = ctx.saved_tensors
        d = p * g[..., None]
        d = d.scatter_add(-1, idx, -(g * hit)[..., None])
        return d.to(ctx.dtype), None, None, None


def dense_nll(model: GPT, inputs, targets, cfg: GPTConfig, mesh=None):
    """Per-token nll [B, T] f32 from the dense logits (`logits_nll`)."""
    mesh = _mesh_of(model, mesh)
    return logits_nll(model, forward(model, inputs, cfg, mesh), targets)


def logits_nll(model, logits, targets):
    """Per-token nll [B, T] f32 of the model's logits [B, T, V] (on a
    vocab-split mesh each rank's block, through `_VocabParallelXent`)."""
    axes = vocab_axes(model)
    if axes:
        return _VocabParallelXent.apply(logits, targets, model.mesh, axes)
    logits = logits.float()
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - tgt


def token_mean(nll, mesh=None, mask=None, rules: dict | None = None,
               axes: tuple | None = None):
    """The mean of a per-token loss over the GLOBAL batch (masked: over
    its unmasked tokens). On a mesh a rank returns its tokens' sum over
    the global count (the mask's all-reduced), so the sum over the axes
    that split tokens (``axes``; default the ``("batch", "length")``
    rules', `parallel.sharding.token_axes`) is the mean: each rank's
    gradients are its tokens' share."""
    mesh = active_mesh(mesh)
    if mesh is None:
        if mask is None:
            return nll.mean()
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if axes is None:
        axes = sharding.token_axes(mesh, rules)
    if mask is None:
        return nll.sum() / (nll.numel() * mesh.axis_size(axes))
    mask = mask.float()
    with torch.no_grad():
        count = col.psum(mask.sum(), axes, mesh)
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def loss_fn(model: GPT, batch: dict, cfg: GPTConfig | None = None,
            mesh=None):
    """Next-token cross entropy. batch: {"tokens": [B, T]}; token t
    predicts token t+1. On a mesh: this rank's rows and its share of the
    global mean (`token_mean`); a split ``seq`` axis needs pre-shifted
    inputs (`train.spmd.gpt_loss_fn`)."""
    cfg = model.cfg if cfg is None else cfg
    tokens = batch["tokens"]
    mesh = _mesh_of(model, mesh)
    if mesh is not None:
        if mesh.shape["seq"] > 1:
            raise ValueError("loss_fn slices tokens[:, :-1], which breaks "
                             "the seq split; use train.spmd.gpt_loss_fn "
                             "on pre-shifted inputs/targets")
        nll = (fused_nll if check_loss_impl(cfg) == "fused" else dense_nll)(
            model, tokens[:, :-1], tokens[:, 1:], cfg, mesh)
        return token_mean(nll, mesh, rules=model.rules)
    if check_loss_impl(cfg) == "fused":
        return fused_nll(model, tokens[:, :-1], tokens[:, 1:], cfg).mean()
    logits = forward(model, tokens[:, :-1], cfg)
    # upcast before the softmax, so bf16 logits keep an f32 logsumexp
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return -ll.mean()


def completion_logprobs(model: GPT, tokens, start, width: int,
                        cfg: GPTConfig | None = None, mesh=None):
    """Per-token natural log-likelihoods of a completion region: the
    differentiable counterpart of the engine's emitted
    ``TokenEvent.logprob`` (one full forward instead of the paged path;
    the same f32 log-softmax, so the two agree to f32 tolerance).

    tokens [B, T] int: full padded sequences (prompt + completion).
    start [B] int: index of each row's first completion token (>= 1).
    width: the completion window; returns [B, width] f32 where
    ``out[b, j] = log p(tokens[b, start[b]+j] | tokens[b, :start[b]+j])``.
    Positions past a row's real sequence are clipped into ``[1, T-1]``
    and scored against padding; the caller masks them. Gradients flow to
    the model's parameters (through the flash kernels' autograd on the
    card). Only the ``[B, width]`` rows the window reads go through the
    log-softmax: each row's values are what the reference's full
    ``[B, T, V]`` log-softmax gives it.

    On a mesh (the model's) ``tokens``/``start`` are this rank's rows
    (`parallel.sharding.shard_batch`) and the result its rows' values;
    over a vocabulary split the log-softmax is a distributed
    log-sum-exp whose backward needs no collective (the window's
    cotangent is the same on every rank of the split). Over a ``seq``
    split ``tokens`` is the rank's block of positions ``[B, T / s]``:
    each rank scores its own positions' next tokens, the ``[B, T]`` f32
    rows are gathered over ``seq`` (`collectives.gather_from`: every seq
    rank then holds the same windows, and the backward keeps each rank's
    own positions' cotangent) and the windows are cut from them."""
    cfg = model.cfg if cfg is None else cfg
    mesh = _mesh_of(model, mesh)
    logits = forward(model, tokens, cfg, mesh)
    b, t, v = logits.shape
    start = torch.as_tensor(start, device=logits.device).long()
    if mesh is not None and mesh.shape["seq"] > 1:
        whole = col.all_gather(tokens.long(), "seq", mesh, dim=1)
        off = mesh.axis_index("seq") * t
        nxt = whole[:, torch.clamp(torch.arange(
            off + 1, off + t + 1, device=logits.device),
            max=whole.shape[1] - 1)]
        # lp[:, q] = log p(tokens[:, q + 1] | tokens[:, :q + 1])
        lp = col.gather_from(-logits_nll(model, logits, nxt), "seq", mesh,
                             dim=1)
        idx = torch.clamp(start[:, None] + torch.arange(
            width, device=logits.device)[None, :], 1, lp.shape[1] - 1)
        return lp.gather(1, idx - 1)
    # absolute position of completion token j, clipped into range so
    # padded tails index safely
    idx = torch.clamp(start[:, None] + torch.arange(
        width, device=logits.device)[None, :], 1, t - 1)       # [B, W]
    rows = logits.gather(1, (idx - 1)[..., None].expand(b, width, v))
    toks = tokens.long().gather(1, idx)
    axes = vocab_axes(model)
    if axes:
        # the rank's vocabulary block: a distributed log-sum-exp (pmax,
        # psum of the exponentials) and the target logit from its owner
        return -_VocabParallelXent.apply(rows, toks, mesh, axes)
    logp = torch.log_softmax(rows.float(), dim=-1)             # [B, W, V]
    return logp.gather(-1, toks[..., None])[..., 0]


# ---------------------------------------------------------------------------
# serving on a mesh: the caches' specs and the forwards' pieces
# ---------------------------------------------------------------------------

def kv_cache_logical_axes() -> dict:
    """Logical axes of the unpaged cache {"k", "v"} ``[L, slots, max_len,
    H, Dh]``: slots over the batch rules, heads over the head rule (the
    wq/wk/wv column split), the rest whole."""
    axes = (None, "batch", None, "heads", None)
    return {"k": axes, "v": axes}


def kv_pool_logical_axes(quantized: bool = False) -> dict:
    """Logical axes of the paged pool {"k", "v"} ``[L, n_blocks,
    block_size, H, Dh]`` (and an int8 pool's {"k_scale", "v_scale"}
    ``[L, n_blocks, block_size, H]``): heads split with their payload
    rows, blocks whole (any block may go to any sequence)."""
    axes = (None, None, None, "heads", None)
    pool = {"k": axes, "v": axes}
    if quantized:
        pool["k_scale"] = pool["v_scale"] = (None, None, None, "heads")
    return pool


def _local_heads(model: GPT) -> int:
    """The heads this rank's wq columns hold (all of them on one card)."""
    return model.layers["wq"].shape[-1] // model.cfg.head_dim


def _serve_layers(model: GPT, mesh) -> list[dict]:
    """Per-layer weights of a serving forward: this rank's blocks,
    gathered over the `ZERO_AXES` that split them."""
    layers = model.layer_params()
    if mesh is None:
        return layers
    return [{k: _whole(w, model.layer_specs[k], mesh) for k, w in lp.items()}
            for lp in layers]


def _serve_leave(mesh):
    """The row products' combine over ``tensor`` (None on one card)."""
    return None if mesh is None else tensor_conjugates(mesh)[1]


def _serve_embed(model: GPT, tokens, positions, adt, mesh):
    """Token + position embeddings of the serving forwards' rows: the
    vocabulary-split lookup and the whole position table on a mesh."""
    if mesh is None:
        return model.embed[tokens].to(adt) + model.pos_embed[positions].to(adt)
    pos = _whole(model.pos_embed, model.specs["pos_embed"], mesh)
    return (_lookup(model, _embed_table(model, model.cfg, mesh), tokens)
            + pos[positions].to(adt))


def _serve_unembed(model: GPT, x, mesh):
    """Final norm and the f32 logits ``[N, V]``: on a vocabulary-split
    mesh each rank's block, gathered over the split."""
    if mesh is None:
        return _unembed(model, x)
    final_ln = _whole(model.final_ln_scale, model.specs["final_ln_scale"],
                      mesh)
    return _serve_logits(model, _rms_norm(x, final_ln.to(x.dtype)), mesh)


def _serve_logits(model: GPT, x, mesh):
    """The f32 logits ``[N, V]`` of final-norm rows ``x`` on a mesh: the
    rank's vocabulary block, gathered over the split, so every rank
    holds the same bits."""
    logits = _mm_f32(x, _embed_table(model, model.cfg, mesh).t())
    axes = vocab_axes(model)
    return col.all_gather(logits, axes, mesh, dim=-1) if axes else logits


def _check_cache_heads(model: GPT, cache: dict) -> None:
    """A cache or pool of another head split than the model's raises."""
    want = _local_heads(model)
    if cache["k"].shape[3] != want:
        raise ValueError(f"the cache holds {cache['k'].shape[3]} heads, the "
                         f"model's rank {want}: allocate it with the "
                         "model's mesh (mesh=)")


def _batch_axes(mesh) -> tuple:
    """The live mesh axes that split an unpaged cache's slots."""
    from ray_tpu_torch.parallel.sharding import kv_cache_specs
    entry = kv_cache_specs(mesh)["k"][1]
    return mesh.live_axes(sharding.spec_axes((entry,)))


# ---------------------------------------------------------------------------
# unpaged KV cache: one contiguous row per slot
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int, device=None,
                  mesh=None) -> dict:
    """Preallocated cache {"k", "v"} of ``[L, batch, max_len, H, Dh]`` in
    the activation dtype, zero-filled. ``batch`` is the number of resident
    decode slots. On a mesh each rank allocates its block
    (`parallel.sharding.kv_cache_specs`): its data block of the slots and
    its tensor block of the heads."""
    if max_len > cfg.max_seq_len:
        raise ValueError(f"max_len {max_len} exceeds cfg.max_seq_len "
                         f"{cfg.max_seq_len} (pos_embed table size)")
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    mesh = active_mesh(mesh)
    if mesh is not None:
        from ray_tpu_torch.parallel.sharding import kv_cache_specs
        shape = sharding.local_shape(shape, kv_cache_specs(mesh)["k"], mesh)
    return {name: torch.zeros(shape, dtype=cfg.activation_dtype(),
                              device=device) for name in ("k", "v")}


@torch.no_grad()
def prefill(model: GPT, tokens, cache: dict, cfg: GPTConfig | None = None,
            *, lengths=None, slot=None):
    """Prompt tokens ``[B, T]`` (right-padded; ``lengths [B]`` gives each
    row's true length, default T) in one full-sequence forward: their K/V
    are written into the cache in place, rows 1:1 onto slots, or into
    slot ``slot`` for ``tokens [1, T]``. Returns ``(logits [B, vocab] f32
    at each row's last real position, cache)``; only those positions are
    unembedded. Padding past a row's length is written too and masked by
    decode's position mask."""
    cfg = model.cfg if cfg is None else cfg
    mesh = model.mesh
    b, t = tokens.shape
    cache_b, max_len = cache["k"].shape[1], cache["k"].shape[2]
    axes = () if mesh is None else _batch_axes(mesh)
    cache_b *= 1 if mesh is None else mesh.axis_size(axes)
    if mesh is not None:
        _check_cache_heads(model, cache)
    if slot is None and b != cache_b:
        raise ValueError(f"prefill batch {b} != cache slots {cache_b}; pass "
                         "slot= to target one slot")
    if slot is not None and b != 1:
        raise ValueError(f"slot-targeted prefill wants tokens [1, T], got "
                         f"batch {b}")
    if slot is not None and not 0 <= int(slot) < cache_b:
        raise ValueError(f"slot {slot} out of range for {cache_b} cache "
                         "slots")
    if t > max_len:
        raise ValueError(f"prompt length {t} exceeds cache max_len "
                         f"{max_len}")
    # A batch prefill runs each data rank's rows (its cache block; all of
    # them on one card); a slot prefill runs on every rank and lands on
    # the rank whose block holds the slot.
    n_loc = cache["k"].shape[1]
    lengths = (torch.full((b,), t, dtype=torch.long, device=tokens.device)
               if lengths is None else
               torch.as_tensor(lengths, device=tokens.device).long())
    if slot is None and axes:
        spec = sharding.PartitionSpec(axes)
        tokens = sharding.local_shard(tokens, spec, mesh)
        lengths = sharding.local_shard(lengths, spec, mesh)
    x, (ks, vs) = _features(model, tokens, cfg,
                            _embed_table(model, cfg, mesh), True, mesh,
                            seq_split=False)
    last = x[torch.arange(x.shape[0], device=x.device), lengths - 1]
    logits = _serve_logits(model, last, mesh)
    if slot is None:
        cache["k"][:, :, :t] = ks
        cache["v"][:, :, :t] = vs
        if axes:
            logits = col.all_gather(logits, axes, mesh, dim=0)
        return logits, cache
    base = (mesh.axis_index(axes) * n_loc) if axes else 0
    local = int(slot) - base
    if 0 <= local < n_loc:
        cache["k"][:, local:local + 1, :t] = ks
        cache["v"][:, local:local + 1, :t] = vs
    return logits, cache


@torch.no_grad()
def decode_step(model: GPT, tokens, cache: dict, pos,
                cfg: GPTConfig | None = None):
    """One autoregressive step for every slot: ``tokens [B]`` at
    positions ``pos [B]``. Writes each token's K/V at ``pos`` in place,
    then attends over cache positions ``<= pos``
    (`ops.decode_attention.decode_attention`, ``cfg.decode_attn_impl``).
    A row at or past max_len writes nothing and attends to the whole
    cache, as JAX's dropped out-of-bounds scatter does, without a host
    sync. Returns ``(logits [B, vocab] f32, cache)``."""
    cfg = model.cfg if cfg is None else cfg
    check_quant_cfg(cfg)
    _full_precision(model, "decode_step")
    mesh = model.mesh
    axes = ()
    if mesh is not None:
        # each data rank steps its block of the slots
        _check_cache_heads(model, cache)
        axes = _batch_axes(mesh)
        spec = sharding.PartitionSpec(axes if axes else None)
        tokens = sharding.local_shard(tokens, spec, mesh)
        pos = sharding.local_shard(pos, spec, mesh)
    adt = cfg.activation_dtype()
    b = tokens.shape[0]
    max_len = cache["k"].shape[2]
    rows = torch.arange(b, device=tokens.device)
    pos = pos.to(device=tokens.device, dtype=torch.int32).contiguous()
    pos_l = pos.long()
    live = (pos_l < max_len)[:, None, None]
    widx = torch.clamp(pos_l, max=max_len - 1)
    x = _serve_embed(model, tokens,
                     torch.clamp(pos_l, max=cfg.max_seq_len - 1), adt, mesh)
    layers = _serve_layers(model, mesh)
    leave = _serve_leave(mesh)

    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            kc, vc = cache["k"][i], cache["v"][i]
            kc[rows, widx] = torch.where(live, k.to(kc.dtype), kc[rows, widx])
            vc[rows, widx] = torch.where(live, v.to(vc.dtype), vc[rows, widx])
            return da.decode_attention(q, kc, vc, pos,
                                       impl=cfg.decode_attn_impl
                                       ).reshape(b, -1)

        x = _layer(layers[i], x, cfg, attend, leave=leave)
    logits = _serve_unembed(model, x, mesh)
    if axes:
        logits = col.all_gather(logits, axes, mesh, dim=0)
    return logits, cache


# ---------------------------------------------------------------------------
# paged KV cache: block pool + block tables
# ---------------------------------------------------------------------------

def init_kv_pool(cfg: GPTConfig, n_blocks: int, block_size: int,
                 device=None, mesh=None) -> dict:
    """Paged cache {"k", "v"} of ``[L, n_blocks, block_size, H, Dh]``,
    zero-filled: the activation dtype, or for ``kv_dtype="int8"`` int8
    payloads beside {"k_scale", "v_scale"} f32 ``[L, n_blocks,
    block_size, H]``, one scale per (position, head) row (a zero row
    dequantizes to zeros). Each entry's ``"<name>_rows"`` is the same
    storage seen as flat rows, ``[L, n_blocks * block_size + 1, ...]``:
    the last row of each layer is the sink that dropped writes land in,
    payload and scale alike. Block 0 is the engine's trash block by
    convention. On a mesh each rank allocates its heads' slice
    (`parallel.sharding.kv_pool_specs`: ``H / tensor`` heads, scales with
    their heads, every block)."""
    quantized = check_quant_cfg(cfg)
    device = resolve_device(device)
    rows = n_blocks * block_size
    payload = torch.int8 if quantized else cfg.activation_dtype()
    heads = cfg.n_heads
    mesh = active_mesh(mesh)
    if mesh is not None:
        from ray_tpu_torch.parallel.sharding import kv_pool_specs
        heads = sharding.local_shape(
            (cfg.n_layers, n_blocks, block_size, cfg.n_heads, cfg.head_dim),
            kv_pool_specs(mesh, quantized=quantized)["k"], mesh)[3]
    entries = {"k": ((heads, cfg.head_dim), payload),
               "v": ((heads, cfg.head_dim), payload)}
    if quantized:
        entries.update(k_scale=((heads,), torch.float32),
                       v_scale=((heads,), torch.float32))
    pool = {}
    for name, (tail, dt) in entries.items():
        flat = torch.zeros((cfg.n_layers, rows + 1) + tail, dtype=dt,
                           device=device)
        pool[name + "_rows"] = flat
        pool[name] = flat[:, :rows].unflatten(1, (n_blocks, block_size))
    return pool


# A pool's block-indexed entries: payloads, then an int8 pool's scales.
# Its "<name>_rows" entries view the same storage and never travel.
POOL_ENTRIES = ("k", "v", "k_scale", "v_scale")


def pool_entries(cache: dict) -> list[str]:
    """The block-indexed entries of ``cache`` (`POOL_ENTRIES` present)."""
    return [name for name in POOL_ENTRIES if name in cache]


def copy_block(cache: dict, src: int, dst: int) -> dict:
    """Copy physical block ``src`` onto ``dst`` in every entry of the
    pool (an int8 pool's scales with their payload), in place — the
    device half of copy-on-write prefix sharing."""
    for name in pool_entries(cache):
        cache[name][:, dst].copy_(cache[name][:, src])
    return cache


def gather_block(cache: dict, idx: int) -> dict:
    """Read physical block ``idx`` out of every entry of the pool, the
    device half of KV-block export for disaggregated prefill/decode
    serving: ``{name: [L, block_size, H, Dh]}`` payload rows (and
    ``[L, block_size, H]`` scale rows for an int8 pool: scales travel
    with their payload, as in `copy_block`), copies that outlive later
    writes to the pool."""
    return {name: cache[name][:, int(idx)].clone()
            for name in pool_entries(cache)}


def scatter_block(cache: dict, block: dict, idx: int) -> dict:
    """Write one exported block's rows (the dict `gather_block` returned)
    onto physical block ``idx`` of this pool, in place: payload and scale
    entries land through the same index, so an int8 pool's rows
    re-install byte-identical. Returns ``cache``."""
    for name in pool_entries(cache):
        cache[name][:, int(idx)].copy_(block[name])
    return cache


def _block_index(idx, device) -> torch.Tensor:
    """Block ids (a sequence of ints or an integer tensor) as an int64
    tensor on ``device``: a host list goes up without a host sync."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.long)
    return torch.tensor(list(idx), dtype=torch.long).to(device,
                                                        non_blocking=True)


def gather_blocks(cache: dict, idx, out: dict | None = None) -> dict:
    """The batched `gather_block`: blocks ``idx`` of every entry in ONE
    indexed copy per entry, block-major ``{name: [n, L, block_size, H,
    Dh]}`` (scales ``[n, L, block_size, H]``), so ``result[name][j]`` is
    `gather_block`'s ``[name]`` for ``idx[j]``. ``out`` (optional) holds
    the destination tensors, of those shapes and the pool's dtypes."""
    device = cache["k"].device
    ix = _block_index(idx, device)
    got = {}
    for name in pool_entries(cache):
        src = cache[name].transpose(0, 1)
        if out is None:
            got[name] = src.index_select(0, ix)
        else:
            got[name] = torch.index_select(src, 0, ix, out=out[name])
    return got


def scatter_blocks(cache: dict, blocks: dict, idx) -> dict:
    """The batched `scatter_block`: ``blocks`` (block-major, as
    `gather_blocks` returns them) onto physical blocks ``idx`` of every
    entry, in ONE indexed copy per entry, in place: the pool keeps its
    storage, so a CUDA graph that reads it by address sees the rows.
    Returns ``cache``."""
    ix = _block_index(idx, cache["k"].device)
    for name in pool_entries(cache):
        cache[name].transpose(0, 1).index_copy_(0, ix, blocks[name])
    return cache


def _scatter_kv(cache: dict, i: int, k, v, widx):
    """Write ``k``/``v`` [N, H, Dh] into layer ``i``'s flat rows (sink
    included) at ``widx [N]`` in place; rows JAX would drop point at the
    sink (``widx == n_blocks * bs``). An int8 pool quantizes at the write
    (`ops.quant.quantize_rows`) and lands each row's scale through the
    same index."""
    if "k_scale" in cache:
        (k, ks), (v, vs) = quant.quantize_rows(k), quant.quantize_rows(v)
        cache["k_scale_rows"][i].index_copy_(0, widx, ks)
        cache["v_scale_rows"][i].index_copy_(0, widx, vs)
    for name, x in (("k", k), ("v", v)):
        rows = cache[name + "_rows"][i]
        rows.index_copy_(0, widx, x.to(rows.dtype))


def _pool_scales(cache: dict, i: int) -> dict:
    """Layer ``i``'s scale arguments of the paged attention wrappers
    (none for a float pool)."""
    if "k_scale" not in cache:
        return {}
    return {"k_scale": cache["k_scale"][i], "v_scale": cache["v_scale"][i]}


def prefill_paged(model: GPT, tokens, cache: dict, cfg: GPTConfig, *,
                  block_table, start: int, length: int | None = None):
    """One chunk of paged prefill for one sequence: ``tokens [1, C]``
    (right-padded to the chunk bucket) at absolute positions ``start ..
    start + length - 1``; their K/V are scattered through ``block_table
    [max_blocks]`` int32 (padded rows go to the sink), attention is causal
    over the whole prefix (`ops.decode_attention.paged_prefill_attention`,
    ``cfg.prefill_attn_impl``), and the returned logits ``[1, vocab]`` f32
    are the chunk's last real position. ``start``/``length`` are host
    ints, or int32 tensors of one element on the device (as the
    reference traces them: nothing here then reads them on the host, so
    a CUDA graph captures the chunk once for every start and length);
    the pool is updated in place and returned. An int8 pool quantizes the
    chunk's K/V at the write; a model from `quantize_params` dequantizes
    each weight at use."""
    check_quant_cfg(cfg)
    mesh = model.mesh
    b, c = tokens.shape
    if b != 1:
        raise ValueError(f"paged prefill wants tokens [1, C], got batch {b}")
    nb, bs = cache["k"].shape[1], cache["k"].shape[2]
    dev = tokens.device
    adt = cfg.activation_dtype()
    table = block_table
    mb = table.shape[0]
    offs = torch.arange(c, device=dev)
    if isinstance(start, torch.Tensor):
        positions = start.reshape(1).long() + offs
    else:
        positions = int(start) + offs
    if isinstance(length, torch.Tensor):
        length = length.reshape(1).long()
        last = length - 1
    else:
        length = c if length is None else int(length)
        last = offs[length - 1:length]
    blk = table[torch.clamp(positions // bs, max=mb - 1)].long()
    widx = torch.where(offs < length, blk * bs + positions % bs, nb * bs)
    x = _serve_embed(model, tokens[0],
                     torch.clamp(positions, max=cfg.max_seq_len - 1), adt,
                     mesh)
    start_t = positions[:1].to(torch.int32)   # device-resident start
    layers = _serve_layers(model, mesh)
    leave = _serve_leave(mesh)

    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            _scatter_kv(cache, i, k, v, widx)
            return da.paged_prefill_attention(
                q, cache["k"][i], cache["v"][i], table, start_t,
                **_pool_scales(cache, i),
                impl=cfg.prefill_attn_impl).reshape(c, -1)

        x = _layer(layers[i], x, cfg, attend, leave=leave)
    logits = _serve_unembed(model, x.index_select(0, last), mesh)
    return logits, cache


def decode_step_paged(model: GPT, tokens, cache: dict, pos, tables,
                      cfg: GPTConfig):
    """One autoregressive step for every slot: ``tokens [B]`` at
    positions ``pos [B]`` int32, blocks named by ``tables [B, max_blocks]``
    int32. Writes each token's K/V at its block/offset (positions past the
    table go to the sink) and attends over logical positions ``<= pos``
    (`ops.decode_attention.paged_decode_attention`,
    ``cfg.decode_attn_impl``). Returns ``(logits [B, vocab] f32, cache)``;
    the pool is updated in place. Int8 pools and weights as in
    `prefill_paged`."""
    check_quant_cfg(cfg)
    mesh = model.mesh
    nb, bs = cache["k"].shape[1], cache["k"].shape[2]
    mb = tables.shape[1]
    pos_l = pos.long()
    blk = torch.gather(tables, 1, torch.clamp(pos_l // bs, max=mb - 1)
                       [:, None])[:, 0].long()
    widx = torch.where(pos_l < mb * bs, blk * bs + pos_l % bs, nb * bs)
    adt = cfg.activation_dtype()
    x = _serve_embed(model, tokens, torch.clamp(pos_l, max=cfg.max_seq_len - 1),
                     adt, mesh)
    b = tokens.shape[0]
    layers = _serve_layers(model, mesh)
    leave = _serve_leave(mesh)

    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            _scatter_kv(cache, i, k, v, widx)
            return da.paged_decode_attention(
                q, cache["k"][i], cache["v"][i], tables, pos,
                **_pool_scales(cache, i),
                impl=cfg.decode_attn_impl).reshape(b, -1)

        x = _layer(layers[i], x, cfg, attend, leave=leave)
    return _serve_unembed(model, x, mesh), cache


def verify_step_paged(model: GPT, tokens, cache: dict, pos, tables,
                      cfg: GPTConfig):
    """Batched W-token verify forward of speculative decoding: ``tokens
    [B, W]`` (column 0 each slot's current token, columns 1..W-1 its
    drafts), token j of row b at position ``pos[b] + j``, blocks named by
    ``tables [B, max_blocks]`` int32. All W tokens' K/V are written
    first (positions past the table go to the sink), then every token
    attends to positions ``<= pos[b] + j`` in one
    `ops.decode_attention.paged_verify_attention` per layer
    (``cfg.decode_attn_impl``): the numbers W sequential
    `decode_step_paged` calls give, up to summation order. Returns
    ``(logits [B, W, vocab] f32, cache)``: ``logits[:, j]`` is the
    next-token distribution after drafts 1..j. Rejected drafts need no
    cleanup: their K/V sit past the slot's next pos, masked until
    overwritten. Int8 pools and weights as in `prefill_paged`."""
    check_quant_cfg(cfg)
    mesh = model.mesh
    b, w = tokens.shape
    nb, bs = cache["k"].shape[1], cache["k"].shape[2]
    mb = tables.shape[1]
    nh, hd = _local_heads(model), cfg.head_dim
    positions = pos.long()[:, None] + torch.arange(w, device=tokens.device)
    blk = torch.gather(tables, 1, torch.clamp(positions // bs, max=mb - 1))
    widx = torch.where(positions < mb * bs, blk.long() * bs + positions % bs,
                       nb * bs).reshape(-1)
    adt = cfg.activation_dtype()
    x = _serve_embed(model, tokens.reshape(-1), torch.clamp(
        positions, max=cfg.max_seq_len - 1).reshape(-1), adt, mesh)
    layers = _serve_layers(model, mesh)
    leave = _serve_leave(mesh)

    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            _scatter_kv(cache, i, k, v, widx)
            return da.paged_verify_attention(
                q.view(b, w, nh, hd), cache["k"][i], cache["v"][i], tables,
                pos, **_pool_scales(cache, i),
                impl=cfg.decode_attn_impl).reshape(b * w, -1)

        x = _layer(layers[i], x, cfg, attend, leave=leave)
    return _serve_unembed(model, x, mesh).view(b, w, -1), cache
