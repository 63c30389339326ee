"""GPT-style decoder-only transformer in PyTorch: the serving half of
`ray_tpu/models/gpt.py`.

Same configuration fields, same parameter tree (stacked ``[L, ...]``
layer leaves in JAX's ``[in, out]`` orientation, so weights carried over
from the JAX package are copied, never transposed) and the same paged
inference math: token + learned position embeddings, then L blocks of
RMSNorm -> QKV -> attention -> ``wo`` -> RMSNorm -> SwiGLU, a final
RMSNorm and the unembed against the tied ``embed``.

Differences from the JAX module, all deliberate:

- `GPT` holds the weights in ONE dtype (the activation dtype for
  serving). The JAX forwards cast f32 master weights at every use
  (``params[...].astype(adt)``); done per step in eager PyTorch that
  would read and write the whole model every decode tick. Casting once at
  load gives the same numbers.
- The paged pool is updated in place (JAX donates it to the jit). Each
  layer's pool storage carries one extra row past its last block, the
  *sink*: writes JAX drops (``.at[].set(mode="drop")`` for padded chunk
  rows and positions past the table) go there, so no write needs a host
  sync or a boolean mask, and no block table can ever name the sink.
- Reads JAX clamps (``table[positions // bs]``, ``pos_embed[positions]``
  for padded rows) are clamped explicitly.
- Large products (QKV, ``wo``, the MLP, the unembed) are `torch.matmul`,
  as the JAX package leaves them to XLA; only attention is a kernel of
  this repository.

Training (`forward_features` with flash attention, the fused loss) and
the int8 paths are later slices of the port (ROADMAP); their config
values raise `NotImplementedError` here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.ops import decode_attention as da

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
    kv_dtype: str = "f32"            # f32 | int8 (int8 not ported yet)
    weight_dtype: str = "f32"        # f32 | int8 (int8 not ported yet)
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
    int8 (never, in this slice: int8 raises `NotImplementedError`)."""
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
    if cfg.kv_dtype == "int8" or cfg.weight_dtype == "int8":
        raise NotImplementedError(
            "int8 KV pools and int8 weights are not ported yet (ROADMAP "
            "queue A: int8 serving; queue B: int8 paths of the paged "
            "kernels)")
    return False


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

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


class GPT(nn.Module):
    """The model's weights, in one dtype on one device. ``params`` is a
    tree shaped like `init_params`'s (tensors or numpy arrays); each leaf
    is copied in as a frozen parameter of ``dtype`` (default: the
    config's activation dtype)."""

    def __init__(self, cfg: GPTConfig, params: dict, *, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.activation_dtype() if dtype is None else dtype

        def leaf(x):
            t = (x if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x)))   # writable copy
            t = t.to(device=device if device is not None else t.device,
                     dtype=dtype)
            return nn.Parameter(t.contiguous(), requires_grad=False)

        n, d, h, f = (cfg.n_layers, cfg.d_model,
                      cfg.n_heads * cfg.head_dim, cfg.d_ff)
        want = {"embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_seq_len, d),
                "final_ln_scale": (d,)}
        want_layers = {"ln1_scale": (n, d), "ln2_scale": (n, d),
                       "wq": (n, d, h), "wk": (n, d, h), "wv": (n, d, h),
                       "wo": (n, h, d), "w_up": (n, d, f),
                       "w_gate": (n, d, f), "w_down": (n, f, d)}
        for name, shape in want.items():
            if tuple(params[name].shape) != shape:
                raise ValueError(f"param {name} has shape "
                                 f"{tuple(params[name].shape)}, config wants "
                                 f"{shape}")
            setattr(self, name, leaf(params[name]))
        self.layers = nn.ParameterDict()
        for name, shape in want_layers.items():
            x = params["layers"][name]
            if tuple(x.shape) != shape:
                raise ValueError(f"param layers.{name} has shape "
                                 f"{tuple(x.shape)}, config wants {shape}")
            self.layers[name] = leaf(x)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def params_from_numpy(tree: dict, cfg: GPTConfig, device=None,
                      dtype: torch.dtype | None = None) -> GPT:
    """Carry a JAX param pytree across: ``tree`` is
    ``jax.tree.map(np.asarray, params)`` (nested dict of numpy arrays,
    stacked ``[L, ...]`` layer leaves, ``[in, out]`` weights)."""
    return GPT(cfg, tree, device=resolve_device(device), dtype=dtype)


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
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())   # exact: bf16 fits in f32


def _mm(x, w, cfg: GPTConfig):
    """A block matmul: f32 accumulation, output in the activation dtype
    (``matmul_out="float32"`` materialises the f32 product first)."""
    if cfg.matmul_out == "float32":
        return _mm_f32(x, w).to(x.dtype)
    return torch.matmul(x, w)


def _layer(model: GPT, x, i: int, cfg: GPTConfig, attend):
    """Block ``i`` on rows ``x [N, D]``; ``attend(q, k, v)`` takes
    ``[N, H, Dh]`` projections and returns ``[N, H*Dh]``."""
    lp = model.layers
    n = x.shape[0]
    nh, hd = cfg.n_heads, cfg.head_dim
    h = _rms_norm(x, lp["ln1_scale"][i])
    q = _mm(h, lp["wq"][i], cfg).view(n, nh, hd)
    k = _mm(h, lp["wk"][i], cfg).view(n, nh, hd)
    v = _mm(h, lp["wv"][i], cfg).view(n, nh, hd)
    x = x + _mm(attend(q, k, v), lp["wo"][i], cfg)
    h = _rms_norm(x, lp["ln2_scale"][i])
    up = _mm(h, lp["w_up"][i], cfg)
    gate = _mm(h, lp["w_gate"][i], cfg)
    return x + _mm(nn.functional.silu(gate) * up, lp["w_down"][i], cfg)


def _unembed(model: GPT, x):
    x = _rms_norm(x, model.final_ln_scale)
    return _mm_f32(x, model.embed.t())


# ---------------------------------------------------------------------------
# dense forward (plain attention): the teacher-forced reference
# ---------------------------------------------------------------------------

def forward(model: GPT, tokens) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] in ``cfg.logits_dtype``
    (rounded from the f32 product, as JAX's preferred_element_type), with
    plain causal attention (``attn_impl="xla"``: the math of
    `ray_tpu.parallel.ring_attention.reference_attention`). The flash
    attention kernel path and ring attention are later slices (ROADMAP
    queue B) and raise."""
    cfg = model.cfg
    if cfg.attn_impl != "xla":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: only the plain 'xla' attention "
            "is ported (flash attention: ROADMAP queue B)")
    b, t = tokens.shape
    x = model.embed[tokens] + model.pos_embed[:t][None]
    causal = torch.ones(t, t, dtype=torch.bool,
                        device=tokens.device).tril()

    def attend(q, k, v):                       # [B*T, H, Dh] rows
        nh, hd = q.shape[1], q.shape[2]
        q, k, v = (z.view(b, t, nh, hd) for z in (q, k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        s = torch.where(causal, s, da.NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
        return o.reshape(b * t, nh * hd)

    x = x.reshape(b * t, -1)
    for i in range(cfg.n_layers):
        x = _layer(model, x, i, cfg, attend)
    logits = _unembed(model, x).view(b, t, -1)
    return logits.to(getattr(torch, cfg.logits_dtype))


# ---------------------------------------------------------------------------
# paged KV cache: block pool + block tables
# ---------------------------------------------------------------------------

def init_kv_pool(cfg: GPTConfig, n_blocks: int, block_size: int,
                 device=None) -> dict:
    """Paged cache {"k", "v"} of ``[L, n_blocks, block_size, H, Dh]`` in
    the activation dtype, zero-filled. ``"k_rows"``/``"v_rows"`` are the
    same storage seen as ``[L, n_blocks * block_size + 1, H, Dh]`` flat
    rows: the last row of each layer is the sink that dropped writes land
    in. Block 0 is the engine's trash block by convention."""
    check_quant_cfg(cfg)
    device = resolve_device(device)
    rows = n_blocks * block_size
    pool = {}
    for name in ("k", "v"):
        flat = torch.zeros((cfg.n_layers, rows + 1, cfg.n_heads,
                            cfg.head_dim), dtype=cfg.activation_dtype(),
                           device=device)
        pool[name + "_rows"] = flat
        pool[name] = flat[:, :rows].unflatten(1, (n_blocks, block_size))
    return pool


def copy_block(cache: dict, src: int, dst: int) -> dict:
    """Copy physical block ``src`` onto ``dst`` in every layer, in place —
    the device half of copy-on-write prefix sharing."""
    for name in ("k", "v"):
        cache[name][:, dst].copy_(cache[name][:, src])
    return cache


def _scatter_kv(k_rows, v_rows, k, v, widx):
    """Write ``k``/``v`` [N, H, Dh] into one layer's flat rows (sink
    included) at ``widx [N]`` in place; rows JAX would drop point at the
    sink (``widx == n_blocks * bs``)."""
    k_rows.index_copy_(0, widx, k.to(k_rows.dtype))
    v_rows.index_copy_(0, widx, v.to(v_rows.dtype))


def prefill_paged(model: GPT, tokens, cache: dict, cfg: GPTConfig, *,
                  block_table, start: int, length: int | None = None):
    """One chunk of paged prefill for one sequence: ``tokens [1, C]``
    (right-padded to the chunk bucket) at absolute positions ``start ..
    start + length - 1``; their K/V are scattered through ``block_table
    [max_blocks]`` int32 (padded rows go to the sink), attention is causal
    over the whole prefix (`ops.decode_attention.paged_prefill_attention`,
    ``cfg.prefill_attn_impl``), and the returned logits ``[1, vocab]`` f32
    are the chunk's last real position. ``start``/``length`` are host
    ints; the pool is updated in place and returned."""
    check_quant_cfg(cfg)
    b, c = tokens.shape
    if b != 1:
        raise ValueError(f"paged prefill wants tokens [1, C], got batch {b}")
    nb, bs = cache["k"].shape[1], cache["k"].shape[2]
    length = c if length is None else int(length)
    start = int(start)
    dev = tokens.device
    table = block_table
    mb = table.shape[0]
    offs = torch.arange(c, device=dev)
    positions = start + offs
    blk = table[torch.clamp(positions // bs, max=mb - 1)].long()
    widx = torch.where(offs < length, blk * bs + positions % bs, nb * bs)
    x = model.embed[tokens[0]] + model.pos_embed[
        torch.clamp(positions, max=cfg.max_seq_len - 1)]
    start_t = positions[:1].to(torch.int32)   # device-resident start

    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            _scatter_kv(cache["k_rows"][i], cache["v_rows"][i], k, v, widx)
            return da.paged_prefill_attention(
                q, cache["k"][i], cache["v"][i], table, start_t,
                impl=cfg.prefill_attn_impl).reshape(c, -1)

        x = _layer(model, x, i, cfg, attend)
    logits = _unembed(model, x[length - 1:length])
    return logits, cache


def decode_step_paged(model: GPT, tokens, cache: dict, pos, tables,
                      cfg: GPTConfig):
    """One autoregressive step for every slot: ``tokens [B]`` at
    positions ``pos [B]`` int32, blocks named by ``tables [B, max_blocks]``
    int32. Writes each token's K/V at its block/offset (positions past the
    table go to the sink) and attends over logical positions ``<= pos``
    (`ops.decode_attention.paged_decode_attention`,
    ``cfg.decode_attn_impl``). Returns ``(logits [B, vocab] f32, cache)``;
    the pool is updated in place."""
    check_quant_cfg(cfg)
    nb, bs = cache["k"].shape[1], cache["k"].shape[2]
    mb = tables.shape[1]
    pos_l = pos.long()
    blk = torch.gather(tables, 1, torch.clamp(pos_l // bs, max=mb - 1)
                       [:, None])[:, 0].long()
    widx = torch.where(pos_l < mb * bs, blk * bs + pos_l % bs, nb * bs)
    x = model.embed[tokens] + model.pos_embed[
        torch.clamp(pos_l, max=cfg.max_seq_len - 1)]
    b = tokens.shape[0]

    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            _scatter_kv(cache["k_rows"][i], cache["v_rows"][i], k, v, widx)
            return da.paged_decode_attention(
                q, cache["k"][i], cache["v"][i], tables, pos,
                impl=cfg.decode_attn_impl).reshape(b, -1)

        x = _layer(model, x, i, cfg, attend)
    return _unembed(model, x), cache
