"""Continuous-batching autoregressive inference engine over a paged KV
cache, in PyTorch: the colocated serving path of
`ray_tpu/serve/engine.py`.

The device shapes are static and the model stays resident: one fixed
block pool (`models.gpt.init_kv_pool`, ``[L, n_blocks, block_size, H,
Dh]``) and ragged traffic streamed through it via int32 block tables.

- **paged allocation**: each request holds exactly the blocks its
  prompt + generation footprint needs. `BlockAllocator` refcounts
  physical blocks; block 0 is the trash block idle decode rows write to.
- **radix prefix sharing**: `RadixTree` maps token prefixes to cached
  blocks at block granularity; a shared prefix is prefilled once and
  later requests take references on its blocks. A prefix that ends
  mid-block is shared copy-on-write (`models.gpt.copy_block`).
- **chunked prefill**: prompts prefill in fixed-size chunks (one chunk
  per tick while anything decodes, so a long admission stalls in-flight
  streams by at most one chunk).
- **decode** advances every slot one token per tick through
  `models.gpt.decode_step_paged`; idle and mid-prefill rows decode
  garbage into the trash block.
- **int8 serving**: ``kv_dtype="int8"`` makes the pool int8 with per-row
  scales (quantized at write, dequantized inside the paged kernels);
  ``weight_dtype="int8"`` quantizes the model the engine is given into
  an engine-owned copy (`models.gpt.quantize_params`), leaving the
  caller's model as it was.
- **weight hot swap**: `InferenceEngine.update_params` copies new weights
  (f32 masters, quantized first on an int8-weight engine) into the
  engine's own tensors in place between ticks, flushes the radix tree
  and bumps ``params_version``, which every later `TokenEvent` carries;
  ``draft_params=`` swaps the draft model the same way.
- **speculative decoding** (``spec="ngram"|"draft"``, ``spec_k`` drafts
  a tick): each slot proposes up to k tokens, by prompt lookup in its
  own history (n-gram) or from a small draft model over its own paged
  pool (W = k + 1 draft `models.gpt.decode_step_paged` calls, tokens
  kept on the device); ONE `models.gpt.verify_step_paged` forward scores
  the window ``[token, drafts]`` and `accept_drafts` keeps the longest
  accepted run plus one corrected or bonus token. Rejection sampling
  against the draft as a point-mass proposal keeps sampled output
  distribution-exact for any proposal; greedy output is token-identical
  to plain decoding.

Each prefill chunk, each decode tick and each speculative tick makes ONE
host sync: the sampled tokens and their logprobs (and a spec tick's
accepted counts) come back to the host together in one copy. Every
emitted token is a `TokenEvent` carrying its natural (temperature-1)
logprob. Sampling draws from a per-engine `torch.Generator` seeded with
``seed``: greedy decoding matches the JAX engine token for token,
sampled decoding only in distribution (JAX's threefry bits are not
reproducible here).

Not ported yet, and refused with `NotImplementedError` when asked for
(ROADMAP queue A): disaggregated prefill/decode handoff, priority
classes and preemption, overload shedding and the tick watchdog,
fault-injection sites, the flight recorder and retrace sentinel, and
device meshes.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.ops import decode_attention as da


class TokenEvent(int):
    """A generated token id that is also an ``int``, carrying
    ``logprob`` (the model's natural log-likelihood of this token given
    its prefix, f32 log_softmax of the logits) and ``params_version``."""

    def __new__(cls, token: int, logprob: float = 0.0,
                params_version: int = 0):
        ev = super().__new__(cls, token)
        ev.logprob = float(logprob)
        ev.params_version = int(params_version)
        return ev

    def __reduce__(self):
        return (TokenEvent, (int(self), self.logprob, self.params_version))

    def __repr__(self):
        return (f"TokenEvent({int(self)}, logprob={self.logprob:.4f}, "
                f"params_version={self.params_version})")


def _default_buckets(max_len: int) -> tuple[int, ...]:
    out, b = [], 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


# ---------------------------------------------------------------------------
# block allocator
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Refcounted free-list allocator over the physical blocks of a
    paged KV pool. Block 0 is reserved as the engine's trash block, so a
    pool of ``n_blocks`` has ``n_blocks - 1`` usable blocks. Invariants
    (`check`): a block is free with refcount 0 or allocated with
    refcount >= 1; used + free == n_blocks - 1; double free raises."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least one usable block")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))   # pop() -> 1, 2…
        self._ref = [0] * n_blocks

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("out of KV cache blocks")
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def ref(self, block: int):
        if self._ref[block] <= 0:
            raise RuntimeError(f"ref of free block {block}")
        self._ref[block] += 1

    def decref(self, block: int):
        if block <= 0 or self._ref[block] <= 0:
            raise RuntimeError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def check(self):
        assert self.used + self.free == self.n_blocks - 1
        free = set(self._free)
        assert len(free) == len(self._free), "free-list duplicate"
        for b in range(1, self.n_blocks):
            if b in free:
                assert self._ref[b] == 0, f"free block {b} has refs"
            else:
                assert self._ref[b] >= 1, f"used block {b} has no refs"


# ---------------------------------------------------------------------------
# radix tree over token prefixes
# ---------------------------------------------------------------------------

def _common(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _RadixNode:
    __slots__ = ("key", "blocks", "children", "parent", "last_access")

    def __init__(self, key, blocks, parent):
        self.key = key              # tuple of tokens, len % bs == 0
        self.blocks = blocks        # physical block per key block
        self.children = {}          # first-block token tuple -> node
        self.parent = parent
        self.last_access = 0


class RadixTree:
    """Host-side radix tree mapping token prefixes to cached KV blocks.

    Keys are block-aligned and path-compressed, split at block
    boundaries where sequences diverge. Tree blocks are immutable (only
    full prompt blocks are inserted, decode never writes into a full
    block), so sharing needs no synchronisation. A match may end
    mid-block; the caller then shares that block read-only and copies it
    before writing. The tree holds one allocator reference per block it
    records; `evict` releases zero-ref leaves in LRU order."""

    def __init__(self, block_size: int, allocator: BlockAllocator):
        self.bs = block_size
        self.alloc = allocator
        self.root = _RadixNode((), [], None)
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _best_child(self, node, rest):
        best, best_c = None, 0
        for child in node.children.values():
            c = _common(child.key, rest)
            if c > best_c:
                best, best_c = child, c
        return best, best_c

    def _split(self, node, fb: int):
        """Split `node`'s edge after `fb` blocks; returns the new upper
        node (which keeps the prefix blocks)."""
        parent = node.parent
        cut = fb * self.bs
        upper = _RadixNode(node.key[:cut], node.blocks[:fb], parent)
        upper.last_access = node.last_access
        del parent.children[node.key[:self.bs]]
        parent.children[upper.key[:self.bs]] = upper
        node.key = node.key[cut:]
        node.blocks = node.blocks[fb:]
        node.parent = upper
        upper.children[node.key[:self.bs]] = node
        return upper

    def _nodes(self):
        stack = [self.root]
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def match(self, tokens):
        """Longest cached prefix of `tokens`: ``(blocks, matched)`` where
        `blocks` covers ``ceil(matched / bs)`` physical blocks; when
        ``matched % bs`` is nonzero the last block is partially matched
        and the caller must copy it before writing."""
        toks = tuple(int(t) for t in tokens)
        node, blocks, matched = self.root, [], 0
        now = self._tick()
        while matched < len(toks):
            rest = toks[matched:]
            best, c = self._best_child(node, rest)
            if best is None or c == 0:
                break
            best.last_access = now
            if c == len(best.key) and c < len(rest):
                blocks += best.blocks
                matched += c
                node = best
                continue
            fb = c // self.bs
            blocks += best.blocks[:fb]
            if c % self.bs:
                blocks.append(best.blocks[fb])
            matched += c
            break
        return blocks, matched

    def insert(self, tokens, blocks):
        """Record `tokens` (truncated to a block multiple) as a cached
        prefix backed by `blocks`; only the unmatched tail is adopted,
        with one tree reference per newly held block."""
        n = (len(tokens) // self.bs) * self.bs
        toks = tuple(int(t) for t in tokens[:n])
        node, i = self.root, 0
        now = self._tick()
        while i < n:
            rest = toks[i:]
            best, c = self._best_child(node, rest)
            fb = c // self.bs if best is not None else 0
            if fb == 0:
                blks = list(blocks[i // self.bs: n // self.bs])
                child = _RadixNode(rest, blks, node)
                child.last_access = now
                node.children[rest[:self.bs]] = child
                for b in blks:
                    self.alloc.ref(b)
                return
            best.last_access = now
            if fb * self.bs < len(best.key):
                best = self._split(best, fb)
                best.last_access = now
            node = best
            i += fb * self.bs

    def evict(self, need: int) -> int:
        """Free zero-ref cached prefixes, LRU leaves first, until `need`
        blocks are released or nothing more is evictable."""
        freed = 0
        while freed < need:
            leaves = [nd for nd in self._nodes()
                      if nd is not self.root and not nd.children
                      and all(self.alloc.refcount(b) == 1
                              for b in nd.blocks)]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_access)
            for b in victim.blocks:
                self.alloc.decref(b)
            freed += len(victim.blocks)
            del victim.parent.children[victim.key[:self.bs]]
        return freed

    def clear(self) -> int:
        """Drop every evictable cached prefix; returns blocks freed."""
        return self.evict(self.n_blocks() or 1)

    def flush(self) -> int:
        """Drop the whole tree, every node, including those whose blocks
        live requests still reference (the tree's references are
        released; the requests keep theirs). Used on a weight swap:
        cached K/V was computed under the old weights. Returns the
        blocks whose last reference was the tree's."""
        freed = 0
        for nd in self._nodes():
            for b in nd.blocks:
                self.alloc.decref(b)
                freed += self.alloc.refcount(b) == 0
        self.root = _RadixNode((), [], None)
        return freed

    def n_blocks(self) -> int:
        return sum(len(nd.blocks) for nd in self._nodes())

    def n_nodes(self) -> int:
        return sum(1 for _ in self._nodes()) - 1   # minus root


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@dataclass
class _Pending:
    rid: int
    prompt: np.ndarray            # [P] int32
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    ts: float = 0.0               # submit time (queue-wait accounting)


@dataclass
class _Slot:
    rid: int = -1
    phase: str = "idle"           # idle | prefill | decode
    prompt: np.ndarray | None = None
    filled: int = 0               # prompt tokens whose KV is resident
    blocks: list = field(default_factory=list)
    table: np.ndarray | None = None   # [max_blocks] int32 (0 = trash)
    order: int = 0                # admission sequence (chunk FIFO)
    token: int = 0                # token the next decode consumes
    token_logp: float = 0.0       # its logprob (parked through prefill)
    pos: int = 0                  # its position in the logical sequence
    remaining: int = 0
    temperature: float = 0.0
    eos_id: int | None = None
    submit_ts: float = 0.0
    # speculative decoding: the request's tokens so far (prompt + emitted,
    # the n-gram proposer's corpus) and, with a draft model, this slot's
    # blocks, table and prefill progress in the DRAFT pool
    history: list = field(default_factory=list)
    draft_blocks: list = field(default_factory=list)
    draft_table: np.ndarray | None = None
    draft_filled: int = 0

    @property
    def active(self) -> bool:
        return self.phase != "idle"


def _gumbel_argmax(scores, gen):
    """One categorical draw along the last dim of ``scores`` (logits or
    log-probabilities, up to a constant) by the Gumbel-max trick, with
    uniforms from ``gen``."""
    u = torch.rand(scores.shape, generator=gen,
                   device=scores.device).clamp_(min=1e-20)
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def accept_drafts(logits, window, temps, gen=None):
    """The accept/correct rule of speculative decoding, on one verify
    forward's ``logits [B, W, V]`` f32 for ``window [B, W]`` (column 0
    each row's current token, columns 1..W-1 its drafts) and per-row
    ``temps [B]``.

    Draft j is judged against column j - 1: a greedy row (temperature 0)
    accepts it iff it is that column's argmax; a sampled row accepts it
    with probability p(draft) under the column's tempered softmax
    (``u < p``). ``accepted`` counts the leading run of accepts. Column
    ``accepted`` then gives the next token: its argmax on a greedy row;
    on a sampled row a draw from its tempered distribution with the
    rejected draft masked to -1e30 (the residual of rejection sampling
    against a point-mass proposal: the emitted token follows the target
    distribution whatever the draft was), unmasked in column W - 1 (the
    bonus token after W - 1 accepts). ``gen`` draws the uniforms and the
    categorical samples; None when no row samples.

    Returns ``(out [B, W], out_lp [B, W] f32, accepted [B])``:
    ``out[:, :accepted + 1]`` are the tokens to emit, ``out_lp`` each
    column's token's natural (untempered f32) logprob."""
    w = logits.shape[1]
    drafts = window[:, 1:].long()
    greedy = torch.argmax(logits, dim=-1)
    match = drafts == greedy[:, :-1]
    nxt = greedy
    if gen is not None:
        hot = (temps > 0)[:, None]
        safe = torch.where(temps > 0, temps, 1.0)
        logp = torch.log_softmax(logits.float() / safe[:, None, None], dim=-1)
        p_draft = logp[:, :-1].gather(-1, drafts[..., None])[..., 0].exp()
        u = torch.rand(drafts.shape, generator=gen, device=logits.device)
        match = torch.where(hot, u < p_draft, match)
        logp[:, :-1].scatter_(-1, drafts[..., None], -1e30)
        nxt = torch.where(hot, _gumbel_argmax(logp, gen), greedy)
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    cols = torch.arange(w, device=logits.device)
    out = torch.where(cols < accepted[:, None],
                      torch.nn.functional.pad(drafts, (0, 1)), nxt)
    out_lp = torch.log_softmax(logits.float(), dim=-1).gather(
        -1, out[..., None])[..., 0]
    return out, out_lp, accepted


# Engine kwargs of ray_tpu's InferenceEngine that this port does not
# implement yet, with the value that means "off". Anything else raises.
_NOT_PORTED = {
    "mesh": None, "telemetry_sample": None, "max_queue": None,
    "shed_high_water": None, "watchdog_s": None, "priority_classes": None,
    "priority_aging_s": None, "priority_weight_base": None,
    "role": "colocated",
}


class InferenceEngine:
    """Slot-based continuous-batching scheduler over one `models.gpt.GPT`
    with a paged, prefix-shared KV cache.

    `slots` is the resident decode batch, `max_len` the per-sequence
    capacity (prompt + generated). `block_size` sets the paging granule
    and `cache_blocks` the pool's usable block count (default: every slot
    at full length). `prefill_chunk` caps prompt tokens absorbed per tick
    while anything decodes; `prefix_cache=False` disables the radix tree.
    `device` defaults to CUDA and raises when there is none; the model
    must live there. All device work happens in `step()`.

    ``cfg.weight_dtype="int8"`` serves an engine-owned quantized copy of
    ``model`` (`models.gpt.quantize_params`); ``cfg.kv_dtype="int8"``
    an int8 pool. `update_params` swaps weights in place.

    ``spec="ngram"`` or ``"draft"`` decodes speculatively, ``spec_k``
    drafts a tick: n-gram lookup of the last ``ngram_max`` down to
    ``ngram_min`` tokens in the request's own history, or a draft model
    (``draft_params``: a `models.gpt.GPT` on the engine's device, like
    ``model``; ``draft_cfg`` its config, same vocabulary, quantized like
    the target when its ``weight_dtype`` is "int8") over its own paged pool of
    ``draft_cache_blocks`` usable blocks (default ``cache_blocks``),
    which holds every resident request's full footprint and shares no
    prefixes."""

    def __init__(self, model: gpt.GPT, cfg: gpt.GPTConfig, *,
                 slots: int = 4, max_len: int | None = None,
                 prefill_buckets: tuple[int, ...] | None = None,
                 block_size: int = 16, cache_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 prefix_cache: bool = True, spec: str | None = None,
                 spec_k: int = 4, ngram_max: int = 3, ngram_min: int = 1,
                 draft_params=None, draft_cfg: gpt.GPTConfig | None = None,
                 draft_cache_blocks: int | None = None, seed: int = 0,
                 device=None, **not_ported):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"InferenceEngine got an unexpected "
                                f"keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"InferenceEngine({name}=...) is not ported yet "
                    "(ROADMAP queue A)")
        if spec not in (None, "ngram", "draft"):
            raise ValueError(f"unknown spec backend {spec!r}")
        if spec is not None and spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if spec == "draft":
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "spec='draft' needs draft_params and draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft model must share the tokenizer")
        self.device = gpt.resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine runs "
                             f"on {self.device}")
        if self.device.type == "cuda":
            # f32 accumulation in every bf16 product and no TF32 in f32
            # ones: the numerics the JAX engine's einsums pin with
            # preferred_element_type.
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
            torch.backends.cuda.matmul.allow_tf32 = False
        gpt.check_quant_cfg(cfg)
        draft = None
        if spec == "draft":
            gpt.check_quant_cfg(draft_cfg)
            if not isinstance(draft_params, gpt.GPT):
                raise TypeError("draft_params must be a models.gpt.GPT, "
                                f"got {type(draft_params).__name__}")
            draft = draft_params
            if draft.device != self.device:
                raise ValueError(f"draft model lives on {draft.device}, "
                                 f"engine runs on {self.device}")
        # The reference counts traces of its jitted quantize, one per
        # distinct tree shape (target and draft): construction quantizes;
        # a swap's tree has the same shapes, so it adds none.
        quantized = set()
        if cfg.weight_dtype == "int8":
            model = gpt.quantize_params(model)
            quantized.add(cfg)
        if draft is not None and draft_cfg.weight_dtype == "int8":
            draft = gpt.quantize_params(draft)
            quantized.add(draft_cfg)
        self.quantize_traces = len(quantized)
        self.model = model
        self.cfg = cfg
        self.spec = spec
        self.spec_k = int(spec_k)
        self.spec_window = self.spec_k + 1   # [current token, k drafts]
        self.ngram_max, self.ngram_min = int(ngram_max), int(ngram_min)
        self.draft_model, self.draft_cfg = draft, draft_cfg
        self.num_slots = slots
        self.max_len = cfg.max_seq_len if max_len is None else max_len
        self.block_size = block_size
        self.max_blocks = -(-self.max_len // block_size)
        self.cache_blocks = (slots * self.max_blocks
                             if cache_blocks is None else cache_blocks)
        self.buckets = tuple(sorted(
            b for b in (prefill_buckets or _default_buckets(self.max_len))
            if b <= self.max_len))
        if not self.buckets:
            raise ValueError("no prefill bucket <= max_len")
        self.prefill_chunk = (min(64, self.buckets[-1])
                              if prefill_chunk is None else prefill_chunk)
        self.chunk_buckets = tuple(sorted(
            {b for b in self.buckets if b < self.prefill_chunk}
            | {self.prefill_chunk}))
        # +1: physical block 0 is the trash block (idle rows write there).
        self.cache = gpt.init_kv_pool(cfg, self.cache_blocks + 1,
                                      block_size, self.device)
        self.draft_cache, self._draft_alloc = None, None
        self.draft_cache_blocks = 0
        if draft is not None:
            self.draft_cache_blocks = (self.cache_blocks
                                       if draft_cache_blocks is None
                                       else draft_cache_blocks)
            self.draft_cache = gpt.init_kv_pool(
                draft_cfg, self.draft_cache_blocks + 1, block_size,
                self.device)
            self._draft_alloc = BlockAllocator(self.draft_cache_blocks + 1)
        # Capacity gauges: the pools' device bytes (sink rows and a draft
        # pool included) and the bytes one cached position costs over all
        # layers, K and V, scales included: the lever kv_dtype pulls.
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for pool in (self.cache, self.draft_cache)
                               if pool is not None
                               for n, t in pool.items()
                               if n.endswith("_rows"))
        self._kv_bytes_per_token = sum(
            t.numel() * t.element_size() for n, t in self.cache.items()
            if not n.endswith("_rows")) / ((self.cache_blocks + 1) *
                                           block_size)
        self._alloc = BlockAllocator(self.cache_blocks + 1)
        self._tree = (RadixTree(block_size, self._alloc)
                      if prefix_cache else None)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self._slots = [_Slot() for _ in range(slots)]
        self._pending: collections.deque[_Pending] = collections.deque()
        self._rid = 0
        self._admit_seq = 0
        # rid -> deque of emitted tokens; dropped when done AND drained
        # (tokens_for pops, then deletes) or cancelled.
        self._out: dict[int, collections.deque] = {}
        self._done: set[int] = set()
        self._lock = threading.RLock()
        self._params_version = 0
        self._swap_pending_ts = None
        # launches of the verify kernel made by this engine's verify
        # forwards (read around each call; never reset)
        self._verify_launches = 0
        self.reset_stats()

    # ------------------------------------------------------------------
    # request side
    # ------------------------------------------------------------------

    def _blocks_for(self, p: int, max_new: int) -> int:
        """Blocks a request's footprint needs: prefill writes positions
        0..p-1, decode writes p..p+max_new-2 (the last sampled token is
        never written)."""
        highest = p - 1 + max(max_new - 1, 0)
        return highest // self.block_size + 1

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: int | None = None,
               priority: int = 0) -> int:
        """Queue a prompt (sequence of token ids); returns a request id
        for `tokens_for`. Admission happens inside `step()`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if priority != 0:
            raise NotImplementedError(
                "priority classes are not ported yet (ROADMAP queue A)")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"exceeds cache max_len {self.max_len}")
        if self._blocks_for(prompt.size, max_new_tokens) > self.cache_blocks:
            raise ValueError(
                f"request footprint "
                f"{self._blocks_for(prompt.size, max_new_tokens)} blocks "
                f"exceeds cache blocks {self.cache_blocks}")
        if self._draft_alloc is not None and self._blocks_for(
                prompt.size, max_new_tokens) > self.draft_cache_blocks:
            raise ValueError(f"request footprint exceeds draft cache "
                             f"blocks {self.draft_cache_blocks}")
        with self._lock:
            rid = self._rid
            self._rid += 1
            self._out[rid] = collections.deque()
            self._pending.append(_Pending(rid, prompt, max_new_tokens,
                                          temperature, eos_id,
                                          time.perf_counter()))
        return rid

    def cancel(self, rid: int) -> bool:
        """Abort a request wherever it is — pending, mid-prefill,
        decoding, or finished-but-undrained — releasing its blocks and
        output queue. Idempotent; returns True if anything was released."""
        with self._lock:
            hit = False
            for i, req in enumerate(self._pending):
                if req.rid == rid:
                    del self._pending[i]
                    hit = True
                    break
            for i, s in enumerate(self._slots):
                if s.rid == rid:
                    self._release(i)
                    hit = True
                    break
            hit |= self._out.pop(rid, None) is not None
            self._done.discard(rid)
            if hit:
                self._cancelled += 1
            return hit

    def tokens_for(self, rid: int):
        """Generator of one request's `TokenEvent`s. Each next() ticks
        `step()` (under the lock) until this request has output, so
        concurrent consumers collectively drive one continuously batched
        device loop. Abandoning the generator cancels the request."""
        try:
            while True:
                tok = None
                fin = False
                with self._lock:   # pop under the lock, yield outside it
                    q = self._out.get(rid)
                    if q is None:
                        return
                    if not q and rid not in self._done:
                        self.step()
                    if q:
                        tok = q.popleft()
                    if rid in self._done and not q:
                        self._done.discard(rid)
                        del self._out[rid]
                        fin = True
                if tok is not None:
                    yield tok
                elif fin:
                    return
        finally:
            self.cancel(rid)

    def generate(self, prompt, **kw) -> list[int]:
        """Blocking convenience: submit + drain one request."""
        return list(self.tokens_for(self.submit(prompt, **kw)))

    # ------------------------------------------------------------------
    # weights: the hot swap
    # ------------------------------------------------------------------

    def update_params(self, new_params, *, draft_params=None) -> int:
        """Hot-swap model weights into the live engine between ticks.

        ``new_params`` is a `models.gpt.GPT` or a tree shaped like
        `models.gpt.init_params`'s (tensors or numpy arrays): f32
        masters. They are placed in the dtype the engine's model holds
        and, on a ``weight_dtype="int8"`` engine, quantized first, so a
        trainer publishes f32 and never handles int8. Every leaf must then
        match the engine's leaf for leaf in shape and dtype. The copy is
        in place (``copy_``): the tensors later steps read stay the same
        objects, and in-flight requests go on (on mixed old/new-weight
        context, which their tokens' ``params_version`` shows). The radix
        prefix cache is flushed: its K/V was computed under the old
        weights. ``params_version`` increments and stamps every later
        `TokenEvent`; `stats` reports ``swaps`` and ``weight_swap_ms``
        (this call to the first token after it). ``draft_params``, the
        same kinds of tree, swaps the draft model of a ``spec="draft"``
        engine in the same call (quantized first on an int8 draft);
        every leaf of both is checked before anything is copied. Returns
        the new ``params_version``."""
        if draft_params is not None and self.draft_model is None:
            raise ValueError("update_params: draft_params given but the "
                             "engine has no draft model")
        t0 = time.perf_counter()
        pairs = self._placed(self.model, self.cfg, new_params, "")
        if draft_params is not None:
            pairs += self._placed(self.draft_model, self.draft_cfg,
                                  draft_params, "draft ")
        with self._lock, torch.no_grad():
            for old, new in pairs:
                old.copy_(new)
            if self._tree is not None:
                self._tree.flush()
            self._params_version += 1
            self._swaps += 1
            self._swap_pending_ts = t0
            return self._params_version

    def _placed(self, model: gpt.GPT, cfg: gpt.GPTConfig, new_params,
                what: str) -> list:
        """``(engine leaf, new leaf)`` pairs for a swap into ``model``:
        ``new_params`` placed on the engine's device in the dtype the
        model holds, quantized on an int8-weight config, and checked leaf
        for leaf in name, shape and dtype."""
        tree = (gpt.param_tree(new_params)
                if isinstance(new_params, gpt.GPT) else new_params)
        placed = gpt.GPT(cfg, tree, device=self.device,
                         dtype=model.embed.dtype)
        if cfg.weight_dtype == "int8":
            placed = gpt.quantize_params(placed)
        old, new = (dict(m.named_parameters()) for m in (model, placed))
        if list(old) != list(new):
            raise ValueError(f"update_params: {what}parameter names "
                             f"{list(new)} != {list(old)}")
        for name, o in old.items():
            n = new[name]
            if n.shape != o.shape or n.dtype != o.dtype:
                raise ValueError(
                    f"update_params: {what}{name} is {tuple(n.shape)}/"
                    f"{n.dtype}, the engine holds {tuple(o.shape)}/"
                    f"{o.dtype}: a swap keeps shapes and dtypes")
        return [(o, new[name]) for name, o in old.items()]

    @property
    def params_version(self) -> int:
        return self._params_version

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def _chunk_bucket_for(self, n: int) -> int:
        for b in self.chunk_buckets:
            if n <= b:
                return b
        raise ValueError(f"no chunk bucket for length {n}")

    def _release(self, slot_idx: int):
        s = self._slots[slot_idx]
        for b in s.blocks:
            self._alloc.decref(b)
        for b in s.draft_blocks:
            self._draft_alloc.decref(b)
        self._slots[slot_idx] = _Slot()

    def _try_admit(self, slot_idx: int, req: _Pending) -> bool:
        """Allocate a slot's blocks (sharing any cached prefix) and put
        it in the prefill phase. Returns False, leaving the request
        pending, if the pool can't supply the footprint even after
        evicting zero-ref cached prefixes."""
        bs = self.block_size
        p = req.prompt.size
        total = self._blocks_for(p, req.max_new_tokens)
        # The draft pool shares no prefixes and evicts nothing: its whole
        # footprint must be free, checked before any main-pool work so a
        # refusal needs no rollback.
        if self._draft_alloc is not None and self._draft_alloc.free < total:
            return False
        blocks, matched = ([], 0)
        if self._tree is not None:
            blocks, matched = self._tree.match(req.prompt)
        # Always leave >= 1 token to prefill: the first generated token
        # is sampled from the final prefill chunk.
        matched = min(matched, p - 1)
        blocks = blocks[:-(-matched // bs)] if matched else []
        n_full = matched // bs
        partial = matched % bs != 0
        # Reference the shared blocks BEFORE any eviction so the tree
        # can't free them out from under this admission.
        for b in blocks:
            self._alloc.ref(b)
        fresh_needed = total - n_full
        if self._alloc.free < fresh_needed and self._tree is not None:
            self._tree.evict(fresh_needed - self._alloc.free)
        if self._alloc.free < fresh_needed:
            for b in blocks:
                self._alloc.decref(b)
            return False
        fresh = [self._alloc.alloc() for _ in range(fresh_needed)]
        slot_blocks = blocks[:n_full] + fresh
        if partial:
            # Copy-on-write: the matched prefix ends inside a shared
            # block this request will write into.
            src, dst = blocks[n_full], fresh[0]
            gpt.copy_block(self.cache, src, dst)
            self._cow_copies += 1
            self._alloc.decref(src)
        table = np.zeros((self.max_blocks,), np.int32)
        table[:len(slot_blocks)] = slot_blocks
        s = self._slots[slot_idx]
        s.rid, s.phase = req.rid, "prefill"
        s.prompt, s.filled = req.prompt, matched
        s.blocks, s.table = slot_blocks, table
        s.order = self._admit_seq
        self._admit_seq += 1
        s.temperature, s.eos_id = req.temperature, req.eos_id
        s.remaining = req.max_new_tokens
        s.submit_ts = req.ts
        s.history = req.prompt.tolist() if self.spec == "ngram" else []
        if self._draft_alloc is not None:
            s.draft_blocks = [self._draft_alloc.alloc() for _ in range(total)]
            s.draft_table = np.zeros((self.max_blocks,), np.int32)
            s.draft_table[:total] = s.draft_blocks
            s.draft_filled = 0
        self._prefix_hit_tokens += matched
        return True

    def _admit_pending(self) -> bool:
        """Move pending requests into free slots, FIFO. A request whose
        first block of tokens matches an in-flight prefill's is deferred
        one tick: once that prefill completes and its full blocks enter
        the radix tree, the latecomer admits by reference instead of
        prefilling the shared prefix again."""
        if not self._pending:
            return False
        bs = self.block_size
        heads = set()
        if self._tree is not None:
            heads = {tuple(s.prompt[:bs].tolist()) for s in self._slots
                     if s.phase == "prefill" and s.prompt.size >= bs}
        admitted, keep = False, []
        for req in self._pending:
            head = (tuple(req.prompt[:bs].tolist())
                    if req.prompt.size >= bs else None)
            if head is not None and head in heads \
                    and self._tree is not None:
                keep.append(req)
                continue
            free = next((i for i, s in enumerate(self._slots)
                         if s.phase == "idle"), None)
            if free is not None and self._try_admit(free, req):
                admitted = True
                if head is not None:
                    heads.add(head)
            else:
                keep.append(req)
        self._pending = collections.deque(keep)
        return admitted

    def _to_device(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Several small host int32 arrays -> device in ONE copy; returns
        views of the packed device buffer, one per array. Non-blocking:
        the host buffer is staged at once and the host does not wait for
        the device."""
        packed = torch.from_numpy(np.concatenate(
            [a.reshape(-1) for a in arrays])).to(self.device,
                                                  non_blocking=True)
        out, i = [], 0
        for a in arrays:
            out.append(packed[i:i + a.size].view(a.shape))
            i += a.size
        return out

    def _draw(self, logits, temps, any_temp: bool):
        """One token per row of ``logits [B, V]``: the argmax, or a draw
        from softmax(logits / T) for rows with temperature T > 0."""
        tok = torch.argmax(logits, dim=-1)
        if any_temp:
            safe = torch.where(temps > 0, temps, 1.0)
            tok = torch.where(temps > 0, _gumbel_argmax(
                logits / safe[:, None], self._gen), tok)
        return tok

    def _sample(self, logits, temps, any_temp: bool):
        """One token per row (`_draw`) and its natural f32 logprob,
        returned as one [2, B] int32 tensor (logprob bits in row 1) so the
        host fetches both in one copy."""
        tok = self._draw(logits, temps, any_temp)
        logp = torch.log_softmax(logits.float(), dim=-1).gather(
            1, tok[:, None])[:, 0]
        return torch.stack([tok.to(torch.int32),
                            logp.contiguous().view(torch.int32)])

    @staticmethod
    def _fetch(packed) -> tuple[np.ndarray, np.ndarray]:
        """The tick's one device->host copy (and sync)."""
        host = packed.cpu().numpy()
        return host[0], host[1].view(np.float32)

    def _chunk(self, s: _Slot, done: int, table):
        """The next prefill chunk of ``s``'s prompt after ``done`` tokens:
        its length and its tokens and ``table`` on the device (one copy),
        the tokens right-padded to their chunk bucket."""
        clen = min(self.prefill_chunk, s.prompt.size - done)
        toks = np.zeros((1, self._chunk_bucket_for(clen)), np.int32)
        toks[0, :clen] = s.prompt[done:done + clen]
        return clen, *self._to_device(toks, table)

    @torch.inference_mode()
    def _run_prefill_chunk(self, slot_idx: int):
        s = self._slots[slot_idx]
        if s.filled < s.prompt.size:
            t0 = time.perf_counter()
            clen, toks_d, table_d = self._chunk(s, s.filled, s.table)
            logits, _ = gpt.prefill_paged(
                self.model, toks_d, self.cache, self.cfg,
                block_table=table_d, start=s.filled, length=clen)
            temps = torch.full((1,), s.temperature, device=self.device)
            tok, lp = self._fetch(self._sample(logits, temps,
                                               s.temperature > 0))
            self._prefill_time += time.perf_counter() - t0
            self._prefill_tokens += clen
            self._prefill_chunks += 1
            s.filled += clen
            if s.filled == s.prompt.size:
                # parked until the draft pool (if any) has the prompt too
                s.token, s.token_logp = int(tok[0]), float(lp[0])
        drafting = self.draft_model is not None
        if drafting and s.draft_filled < s.prompt.size:
            # The draft pool shares no prefixes, so it takes the whole
            # prompt, one chunk a tick beside the main chunk. No host
            # sync: stream order puts these writes before the first
            # proposal.
            t0 = time.perf_counter()
            clen, toks_d, table_d = self._chunk(s, s.draft_filled,
                                                s.draft_table)
            gpt.prefill_paged(self.draft_model, toks_d, self.draft_cache,
                              self.draft_cfg, block_table=table_d,
                              start=s.draft_filled, length=clen)
            self._prefill_time += time.perf_counter() - t0
            s.draft_filled += clen
        if s.filled < s.prompt.size or (
                drafting and s.draft_filled < s.prompt.size):
            return
        # Prefill complete: publish the prompt's full blocks (decode
        # writes only past them, so they are immutable), join decode.
        if self._tree is not None and s.prompt.size >= self.block_size:
            self._tree.insert(s.prompt, s.blocks)
        s.phase = "decode"
        s.pos = s.prompt.size
        s.remaining -= 1
        self._queue_waits.append(time.perf_counter() - s.submit_ts)
        self._emit(s, slot_idx, s.token, s.token_logp)

    def _prefill_tick(self, had_decoders: bool) -> bool:
        """Run prefill chunks: at most ONE while anything is decoding;
        drain freely when the engine is otherwise idle."""
        did = False
        while True:
            prefilling = [i for i, s in enumerate(self._slots)
                          if s.phase == "prefill"]
            if not prefilling:
                return did
            prefilling.sort(key=lambda i: self._slots[i].order)
            self._run_prefill_chunk(prefilling[0])
            did = True
            if had_decoders:
                return did

    def _emit(self, s: _Slot, slot_idx: int, tok: int, logp: float):
        """Route one generated token (stamped with ``params_version``);
        retire the slot when finished."""
        if self._swap_pending_ts is not None:
            # the first token after a swap closes weight_swap_ms's window
            self._last_swap_ms = (time.perf_counter()
                                  - self._swap_pending_ts) * 1e3
            self._swap_pending_ts = None
        self._out[s.rid].append(TokenEvent(tok, logp, self._params_version))
        if self.spec == "ngram":
            s.history.append(tok)
        hit_eos = s.eos_id is not None and tok == s.eos_id
        # pos of the *next* token must still fit in the cache row
        if s.remaining <= 0 or hit_eos or s.pos + 1 >= self.max_len:
            self._done.add(s.rid)
            self._release(slot_idx)

    def step(self) -> bool:
        """One scheduler tick: admit pending requests into free slots,
        run at most one prefill chunk if anything is decoding (all
        pending prefill work otherwise), then one decode step for every
        resident sequence. Returns True if any device work happened."""
        with self._lock:
            had_decoders = any(s.phase == "decode" for s in self._slots)
            admitted = self._admit_pending()
            chunked = self._prefill_tick(had_decoders)
            self._occupancy.append(
                sum(s.active for s in self._slots) / self.num_slots)
            decoding = [i for i, s in enumerate(self._slots)
                        if s.phase == "decode"]
            if not decoding:
                return admitted or chunked
            if self.spec is not None:
                self._spec_tick(decoding)
            else:
                self._decode_tick(decoding)
            return True

    def _batch_arrays(self, field: str = "table"):
        """Per-slot host inputs of a decode or verify step: tokens, pos,
        block tables (each slot's ``field``: "draft_table" for the draft
        pool) and temperatures. Rows not decoding (idle or mid-prefill)
        point at the trash block with pos 0; their write collides
        harmlessly there and their sampled token is never read."""
        zeros = np.zeros((self.max_blocks,), np.int32)
        dec = [s.phase == "decode" for s in self._slots]
        tokens = np.array([s.token if d else 0
                           for s, d in zip(self._slots, dec)], np.int32)
        pos = np.array([s.pos if d else 0
                        for s, d in zip(self._slots, dec)], np.int32)
        tables = np.stack([getattr(s, field) if d else zeros
                           for s, d in zip(self._slots, dec)])
        temps = np.array([s.temperature for s in self._slots], np.float32)
        return tokens, pos, tables, temps

    @torch.inference_mode()
    def _decode_tick(self, decoding: list):
        tokens, pos, tables, temps = self._batch_arrays()
        t0 = time.perf_counter()
        tok_d, pos_d, tables_d, temps_bits = self._to_device(
            tokens, pos, tables, temps.view(np.int32))
        logits, _ = gpt.decode_step_paged(self.model, tok_d, self.cache,
                                          pos_d, tables_d, self.cfg)
        nxt, lps = self._fetch(self._sample(
            logits, temps_bits.view(torch.float32), bool((temps > 0).any())))
        dt = time.perf_counter() - t0
        self._step_times.append(dt)
        self._decode_time += dt
        self._decode_steps += 1
        self._decode_tokens += len(decoding)
        self._decode_slot_steps += len(decoding)
        self._tok_window.append((dt, len(decoding)))
        for i in decoding:
            s = self._slots[i]
            s.token, s.pos = int(nxt[i]), s.pos + 1
            s.remaining -= 1
            self._emit(s, i, s.token, float(lps[i]))

    def _ngram_propose(self, s: _Slot) -> list | None:
        """Prompt-lookup proposal: the longest n-gram (``ngram_max`` down
        to ``ngram_min``) ending the request's history whose latest earlier
        occurrence in it is found, and the up to ``spec_k`` tokens that
        followed that occurrence; None when no suffix recurs."""
        h, n_hist = s.history, len(s.history)
        for n in range(min(self.ngram_max, n_hist - 1),
                       self.ngram_min - 1, -1):
            suf = h[-n:]
            for i in range(n_hist - n - 1, -1, -1):
                if h[i:i + n] == suf:
                    return h[i + n:i + n + self.spec_k]
        return None

    def _draft_propose(self, tok, pos, tables, temps, any_temp: bool):
        """The draft model's proposal, on the device: W = k + 1 draft
        `models.gpt.decode_step_paged` calls consume c_0 (``tok``), c_1,
        ..., c_k at ``pos .. pos + k``, writing their K/V into the draft
        pool, and sample c_1..c_k with the engine's generator (the last
        call only writes c_k's K/V, so the draft pool keeps step with the
        target's). Returns the verify window ``[c_0, ..., c_k]`` [B, W]."""
        window = [tok.long()]
        for i in range(self.spec_window):
            logits, _ = gpt.decode_step_paged(
                self.draft_model, window[-1], self.draft_cache, pos + i,
                tables, self.draft_cfg)
            if i < self.spec_k:
                window.append(self._draw(logits, temps, any_temp))
        return torch.stack(window, dim=1)

    @torch.inference_mode()
    def _spec_tick(self, decoding: list):
        """One speculative tick: propose (n-gram lookup on the host, or
        the draft model on the device), score every slot's window in ONE
        `models.gpt.verify_step_paged` forward, accept on the device
        (`accept_drafts`), fetch the tokens, logprobs and accepted counts
        in one copy and emit ``accepted + 1`` tokens a slot. Falls back to
        a plain decode tick when nothing is worth speculating on. Only
        slots with at least 2 tokens to go speculate; the others ride the
        window with junk drafts (any accept is still exact)."""
        w = self.spec_window
        worth = [i for i in decoding if self._slots[i].remaining >= 2]
        tokens, pos, tables, temps = self._batch_arrays()
        any_temp = bool((temps > 0).any())
        t0 = time.perf_counter()
        if self.spec == "draft":
            if not worth:
                self._decode_tick(decoding)
                return
            proposed = set(worth)
            tok_d, pos_d, tables_d, dtables_d, temps_bits = self._to_device(
                tokens, pos, tables, self._batch_arrays("draft_table")[2],
                temps.view(np.int32))
            temps_d = temps_bits.view(torch.float32)
            window_d = self._draft_propose(tok_d, pos_d, dtables_d, temps_d,
                                           any_temp)
        else:
            proposals = {}
            for i in worth:
                prop = self._ngram_propose(self._slots[i])
                if prop is not None:
                    proposals[i] = prop
            if not proposals:
                self._decode_tick(decoding)
                return
            proposed = set(proposals)
            window = np.repeat(tokens[:, None], w, axis=1)
            for i, prop in proposals.items():
                window[i, 1:] = (prop + [prop[-1]] * (w - 1))[:w - 1]
            window_d, pos_d, tables_d, temps_bits = self._to_device(
                window, pos, tables, temps.view(np.int32))
            temps_d = temps_bits.view(torch.float32)
        n = da.paged_verify_attention.launches
        logits, _ = gpt.verify_step_paged(self.model, window_d, self.cache,
                                          pos_d, tables_d, self.cfg)
        self._verify_launches += da.paged_verify_attention.launches - n
        out, out_lp, acc = accept_drafts(logits, window_d, temps_d,
                                         self._gen if any_temp else None)
        # the tick's one device->host copy (and sync)
        host = torch.cat([out.int(), out_lp.contiguous().view(torch.int32),
                          acc[:, None].int()], dim=1).cpu().numpy()
        out, lps, acc = host[:, :w], host[:, w:2 * w].view(np.float32), \
            host[:, 2 * w]
        dt = time.perf_counter() - t0
        self._step_times.append(dt)
        self._decode_time += dt
        self._decode_steps += 1
        self._spec_steps += 1
        self._decode_slot_steps += len(decoding)
        emitted = 0
        for i in decoding:
            s = self._slots[i]
            if i in proposed:
                self._spec_proposed += w - 1
                self._spec_accepted += int(acc[i])
            for j in range(int(acc[i]) + 1):
                if self._slots[i] is not s:
                    break   # retired mid-window (eos, max_len, budget)
                s.token, s.pos = int(out[i, j]), s.pos + 1
                s.remaining -= 1
                self._decode_tokens += 1
                emitted += 1
                self._emit(s, i, s.token, float(lps[i, j]))
        self._tok_window.append((dt, emitted))

    def run_until_idle(self):
        """Drive the scheduler until every submitted request finished."""
        while True:
            with self._lock:
                if not (self._pending or any(s.active for s in self._slots)):
                    return
                self.step()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def check_invariants(self):
        """Allocator/tree/slot cross-checks: every allocated block is
        accounted for by exactly its holders, and every request lives in
        exactly one place with an output queue. An int8 pool's scale
        arrays must match their payload's rows (one f32 scale per
        (position, head) row, the sink row included); they share the
        payload's block axis, so block refcounts cover them too. A draft
        pool gets the same audits, its blocks held by the slots alone."""
        for pool, label in ((self.cache, ""), (self.draft_cache, "draft ")):
            if pool is None or "k_scale" not in pool:
                continue
            for nm in ("k", "v"):
                for sfx in ("", "_rows"):
                    pay = pool[nm + sfx]
                    sc = pool[nm + "_scale" + sfx]
                    assert tuple(sc.shape) == tuple(pay.shape[:-1]), \
                        f"{label}{nm}_scale{sfx} shape {tuple(sc.shape)} " \
                        f"!= payload rows {tuple(pay.shape[:-1])}"
                    assert sc.dtype == torch.float32, \
                        f"{label}{nm}_scale{sfx} dtype {sc.dtype} != " \
                        "float32"
                    assert pay.dtype == torch.int8, \
                        f"{label}{nm}{sfx} payload dtype {pay.dtype} != " \
                        "int8 despite scale arrays present"
        if self._draft_alloc is not None:
            self._draft_alloc.check()
            dholds = collections.Counter()
            for s in self._slots:
                dholds.update(s.draft_blocks)
            for b in range(1, self._draft_alloc.n_blocks):
                assert self._draft_alloc.refcount(b) == dholds[b], \
                    f"draft block {b}: refcount " \
                    f"{self._draft_alloc.refcount(b)} != {dholds[b]} holders"
        self._alloc.check()
        holds = collections.Counter()
        for s in self._slots:
            holds.update(s.blocks)
        if self._tree is not None:
            for nd in self._tree._nodes():
                holds.update(nd.blocks)
        for b in range(1, self._alloc.n_blocks):
            assert self._alloc.refcount(b) == holds[b], \
                f"block {b}: refcount {self._alloc.refcount(b)} != " \
                f"{holds[b]} holders"
        pend_rids = [q.rid for q in self._pending]
        assert len(pend_rids) == len(set(pend_rids)), \
            f"duplicate pending rids: {pend_rids}"
        slot_rids = [s.rid for s in self._slots if s.active]
        assert len(slot_rids) == len(set(slot_rids)), \
            f"duplicate slot rids: {slot_rids}"
        assert not set(pend_rids) & set(slot_rids), \
            "rid both pending and active"
        for rid in pend_rids + slot_rids:
            assert rid in self._out, f"rid {rid} has no output queue"
            assert rid not in self._done, f"rid {rid} done but scheduled"
        owners = set(pend_rids) | set(slot_rids) | self._done
        for rid in self._out:
            assert rid in owners, f"orphaned output queue for rid {rid}"

    def reset_stats(self):
        """Zero the throughput/latency accounting (benches call this after
        warmup), the speculative counters, the ``swaps`` counter and
        ``weight_swap_ms``. Not reset: ``params_version``,
        ``quantize_traces`` and ``verify_launches`` (identities and
        counts of the engine's life, not rates) and the kernels' launch
        counters."""
        with self._lock:
            self._swaps = 0
            self._last_swap_ms = 0.0
            self._decode_steps = 0
            self._decode_slot_steps = 0
            self._spec_steps = 0
            self._spec_proposed = self._spec_accepted = 0
            self._prefill_tokens = self._decode_tokens = 0
            self._prefill_time = self._decode_time = 0.0
            self._prefill_chunks = 0
            self._prefix_hit_tokens = self._cow_copies = 0
            self._cancelled = 0
            self._step_times = collections.deque(maxlen=512)
            self._occupancy = collections.deque(maxlen=512)
            self._tok_window = collections.deque(maxlen=512)
            self._queue_waits = collections.deque(maxlen=512)

    def stats(self) -> dict:
        """Engine accounting since `reset_stats`:

        ``active`` — occupied slots. ``decode_steps`` (plain and
        speculative ticks), ``prefill_tokens`` / ``decode_tokens`` and
        ``prefill_time_s`` / ``decode_time_s`` (host wall time of each
        device call, ending in its sync; a draft prefill chunk's enqueue
        time counts as prefill);
        ``prefill_tok_s`` / ``decode_tok_s`` the rates (decode over a
        512-tick window); ``prefill_chunks``; ``slot_occupancy``;
        ``p50_token_latency_ms`` / ``p99_token_latency_ms`` decode step
        percentiles; ``ttft_ms_p50`` / ``ttft_ms_p99`` submit to first
        token. Paged cache: ``blocks_in_use``, ``cached_prefix_blocks``,
        ``prefix_hit_tokens``, ``cow_copies``, ``cancelled``;
        ``pool_bytes`` (the pool's device bytes, scales and sink rows
        included, fixed at construction) and ``kv_bytes_per_token`` (the
        pool bytes one cached position costs, all layers, K and V, scales
        included). Weights: ``quantize_traces`` (quantizations of a
        distinct tree shape: 0 for f32 weights, else 1 for the target and
        1 for a draft of other shapes, however many swaps),
        ``params_version`` (bumped by `update_params`, stamped on every
        `TokenEvent`), ``swaps`` and ``weight_swap_ms`` (the last
        `update_params` call to the first token after it).
        Speculative decoding: ``spec`` / ``spec_k`` — backend ('' when
        off) and drafts a tick (0 when off); ``spec_steps`` — verify
        ticks; ``acceptance_rate`` — accepted / proposed drafts;
        ``tokens_per_step`` — emitted decode tokens per decoding-slot step
        (1.0 when spec is off); ``verify_launches`` — verify-kernel
        launches of this engine's verify forwards since construction (0
        on the CPU's plain path; never reset).
        ``kernel_launches`` — each paged-attention
        kernel wrapper's launch counter (process-wide, never reset
        here)."""
        with self._lock:
            times = sorted(self._step_times)
            waits = sorted(self._queue_waits)
            occ = list(self._occupancy)
            win_t = sum(dt for dt, _ in self._tok_window)
            win_toks = sum(n for _, n in self._tok_window)

            def pct(xs, p):
                if not xs:
                    return 0.0
                return xs[min(len(xs) - 1, int(p / 100 * len(xs)))] * 1e3

            return {
                "active": sum(s.active for s in self._slots),
                "decode_steps": self._decode_steps,
                "prefill_tokens": self._prefill_tokens,
                "decode_tokens": self._decode_tokens,
                "prefill_time_s": self._prefill_time,
                "decode_time_s": self._decode_time,
                "prefill_tok_s": (self._prefill_tokens / self._prefill_time
                                  if self._prefill_time else 0.0),
                "decode_tok_s": (win_toks / win_t) if win_t > 0 else 0.0,
                "prefill_chunks": self._prefill_chunks,
                "slot_occupancy": (sum(occ) / len(occ)) if occ else 0.0,
                "p50_token_latency_ms": pct(times, 50),
                "p99_token_latency_ms": pct(times, 99),
                "ttft_ms_p50": pct(waits, 50),
                "ttft_ms_p99": pct(waits, 99),
                "blocks_in_use": self._alloc.used,
                "cached_prefix_blocks": (self._tree.n_blocks()
                                         if self._tree else 0),
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "cow_copies": self._cow_copies,
                "cancelled": self._cancelled,
                "pool_bytes": self._pool_bytes,
                "kv_bytes_per_token": self._kv_bytes_per_token,
                "quantize_traces": self.quantize_traces,
                "params_version": self._params_version,
                "swaps": self._swaps,
                "weight_swap_ms": self._last_swap_ms,
                "spec": self.spec or "",
                "spec_k": self.spec_k if self.spec else 0,
                "spec_steps": self._spec_steps,
                "acceptance_rate": (
                    self._spec_accepted / self._spec_proposed
                    if self._spec_proposed else 0.0),
                "tokens_per_step": (
                    self._decode_tokens / self._decode_slot_steps
                    if self._decode_slot_steps else 0.0),
                "verify_launches": self._verify_launches,
                "kernel_launches": da.kernel_launches(),
            }


class InferenceReplica:
    """Serve deployment hosting one InferenceEngine; `__call__` returns a
    generator of `TokenEvent`s, and concurrent calls continuously batch
    into the shared engine's slots. A consumer that walks away closes the
    generator, which cancels the request and frees its blocks.

    Construction takes config kwargs, not arrays: the model is built on
    the replica from `seed` (`models.gpt.small(**cfg_kwargs)`,
    `models.gpt.init_params`). With ``engine_kwargs={"spec": "draft"}``
    and no ``draft_params`` the replica builds the draft too: the same
    config kwargs with ``draft_layers`` (default 1) layers, weights from
    ``seed + 1``. The actor/HTTP control plane around it is a later slice
    of the port."""

    def __init__(self, cfg_kwargs: dict | None = None, *, slots: int = 4,
                 max_len: int = 64, seed: int = 0,
                 engine_kwargs: dict | None = None, device=None):
        device = gpt.resolve_device(device)
        cfg = gpt.small(**(cfg_kwargs or {}))
        model = gpt.GPT(cfg, gpt.init_params(seed, cfg, device),
                        device=device)
        ek = dict(engine_kwargs or {})
        if ek.get("spec") == "draft" and "draft_params" not in ek:
            dcfg = gpt.small(**{**(cfg_kwargs or {}),
                                "n_layers": ek.pop("draft_layers", 1)})
            ek["draft_cfg"] = dcfg
            ek["draft_params"] = gpt.GPT(
                dcfg, gpt.init_params(seed + 1, dcfg, device), device=device)
        self.engine = InferenceEngine(model, cfg, slots=slots,
                                      max_len=max_len, device=device, **ek)

    def __call__(self, prompt, max_new_tokens: int = 8,
                 temperature: float = 0.0, priority: int | None = None):
        rid = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                 temperature=temperature,
                                 priority=priority or 0)
        return self.engine.tokens_for(rid)

    def cancel(self, rid: int) -> bool:
        return self.engine.cancel(rid)

    def stats(self) -> dict:
        return self.engine.stats()
