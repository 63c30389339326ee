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
- **scheduling under pressure**: requests carry a priority class
  (``priority_classes``; `submit`'s ``priority``). Admission takes
  classes in stride shares of ``priority_weight_base ** class``, and a
  request older than its aging bound jumps that order. A request the
  block pool cannot serve preempts strictly lower-class streams: each
  victim publishes its written blocks to the radix tree and is requeued
  as prompt + emitted under the same request id, so its consumer sees
  one stream (greedy: the same tokens). ``max_queue`` and
  ``shed_high_water`` shed overload as `OverloadedError`, lowest queued
  class first. ``watchdog_s`` counts ticks that overrun it. The fault
  sites ``engine.tick``, ``engine.preempt``, ``engine.alloc`` and
  ``engine.emit`` consult `ray_tpu_torch.util.faults`.
- **disaggregated prefill/decode** (``role="prefill"|"decode"``): a
  prefill-role engine runs chunked prefill only and holds the prompt's
  blocks alone; when a prompt completes, its first token is sampled and
  its written blocks (payload and any int8 scale rows) are gathered to
  host in one indexed copy per pool entry into a pinned buffer, with one
  host sync (`models.gpt.gather_blocks`), and parked as a handoff blob
  (`handoff_for`, `take_handoff`). A decode-role engine (a colocated
  engine that also imports) takes the blob with `import_handoff`:
  prompt blocks the radix tree already holds under the same
  ``params_version`` are shared, the rest go to the device from pinned
  memory (the blob's own ``kv_host`` buffer, which an export and a
  `disagg.DecodeReplica` pull both fill, else one staging buffer) and
  are scattered into the pool IN PLACE
  (`models.gpt.scatter_blocks`: the captured steps read the pool by
  address), and the stream continues at the parked first token, greedy
  token-identical to a colocated engine. `ray_tpu_torch.serve.disagg`
  moves blobs between the two over netaddr.

Compile-once steps, the counterpart of the reference's jitted steps:
the decode tick (`models.gpt.decode_step_paged` + sampling), the
speculative tick (`models.gpt.verify_step_paged` + `accept_drafts`), the
draft proposer's W draft decode steps, and the prefill chunk of the
target and of the draft pool (one per chunk bucket) are each a static
step (`_StaticStep`) over persistent input buffers. On the card each is
captured as a CUDA graph at its first use (after one warm-up run on a
side stream; all graphs share one memory pool) and replayed on every
later tick; on the CPU the same step runs eagerly on the same buffers.
Sampling always draws, and selects by ``temps > 0`` on the device, so
greedy and sampled rows share one step; the draws come from the
engine's generator, which every replay advances. A build (a capture on
the card) counts under the reference's trace counters
(``decode_traces``, ``prefill_traces``, ``verify_traces``,
``draft_traces``, ``draft_prefill_traces``), and the reference's
`RetraceSentinel` (`ray_tpu_torch.util.telemetry`) holds them to their
caps: decode, verify and draft once, ever; the prefill paths once
`arm_retrace_sentinel` declares warm-up over. A capture that fails
raises. The private ``_capture = False``, set before the first `step`,
runs the steps eagerly on the card (the counterpart of
``jax.disable_jit()``).

Each prefill chunk, each decode tick and each speculative tick makes ONE
host-to-device copy of its inputs and ONE host sync: the sampled tokens
and their logprobs (and a spec tick's accepted counts) come back to the
host together in one copy. Every emitted token is a `TokenEvent`
carrying its natural (temperature-1) logprob. Sampling draws from a
per-engine `torch.Generator` seeded with ``seed``: greedy decoding
matches the JAX engine token for token, sampled decoding only in
distribution (JAX's threefry bits are not reproducible here).

Telemetry, as the reference: each engine is a `util.telemetry` stats
source (``engine<N>``) and owns a `FlightRecorder` (``telemetry_sample``
overrides ``RAY_TPU_TELEMETRY_SAMPLE``) whose hooks run at the
reference's sites: submit, admission, each prefill chunk, the first
token, every token, a swap crossing, shed, cancel, preemption, finish,
and the handoff's export and import. Every hook is host-side, between
device steps, and reads no tensor, so a tick's one host sync stays one.

**Serving on a mesh** (``mesh=``, `ray_tpu_torch.parallel`: one process
per rank, every rank building the engine with the same arguments and
driving it with the same calls): the model holds each rank's block
(`models.gpt` on a mesh: heads and vocabulary over ``tensor``; int8
weights as int8 and scale blocks), the pool each rank's heads
(`parallel.sharding.kv_pool_specs`; a draft model's and its pool's
too), and ranks on every other axis (``data``, ``fsdp``, ``seq``,
``expert``, ``pipe``) repeat the step, as the reference's replicated
block axis does. Every rank runs the same host scheduler. At the start
of each tick the ranks all-gather a header of the scheduler's state
(tick, ``params_version``, a digest of the queue, the slots and the
queued imports) and adopt the mesh's first rank's clock reading, which
stamps queued requests for aging; before each step they all-gather a
digest of its host inputs (the `parallel.sharding.engine_io_shardings`
names, a draft step's tables, the step's kind, a chunk's start and
length, the copy-on-write copies since the last step).
`run_until_idle` meets the other ranks at an idle header before it
returns. A rank whose header differs (a rank idle while another has
work among them) makes every rank raise
`ray_tpu_torch.exceptions.MeshDivergenceError` naming the fields, at
the same collective, so nothing hangs. Sampling runs on every rank from
the gathered logits with the engine's seeded generator, so the tokens
agree by construction. Collectives through the host (gloo) cannot be
captured: on a mesh of more than one rank the steps run eagerly, the
trace counters still count one build per geometry, and `stats` reports
``captured`` and ``mesh``. The flight recorder records on the mesh's
first rank only. The handoff on a mesh: an export gathers each rank's
heads of the blocks and all-gathers them over the head axes, so every
rank holds the same blob in the reference's layout with whole heads
(any engine imports it: one card, a mesh, the JAX package's); an
import is made on every rank with the same blob, each rank scattering
its heads, and the blob's digest enters the tick header, so a rank
given another blob raises `MeshDivergenceError` on every rank.

The weight swap has no watch (nor ``swap_traces``):
`InferenceEngine.update_params` copies in place, with nothing to
build. The block gather and scatter build
nothing either; ``kv_gather_traces``/``kv_scatter_traces`` count their
first use per pool geometry, as the reference's jits trace once per
geometry.
"""

from __future__ import annotations

import collections
import gc
import logging
import math
import threading
import time
import weakref
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch import ops
from ray_tpu_torch._private.constants import (ENGINE_PRIORITY_AGING_S,
                                              ENGINE_PRIORITY_CLASSES,
                                              ENGINE_PRIORITY_WEIGHT_BASE)
from ray_tpu_torch.exceptions import MeshDivergenceError, OverloadedError
from ray_tpu_torch.models import gpt
from ray_tpu_torch.ops import decode_attention as da
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import Mesh, active_mesh
from ray_tpu_torch.serve import priority as _prio
from ray_tpu_torch.serve.events import TokenEvent
from ray_tpu_torch.util import faults as _faults
from ray_tpu_torch.util import telemetry

logger = logging.getLogger("ray_tpu_torch.serve")


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
    ts: float = 0.0               # submit time (queue-wait accounting,
    # aging); on a mesh the mesh clock at the first tick that saw the
    # request (inf until then), the same on every rank
    priority: int = 0             # class (0 = lowest): admission, shed
    # and preemption order
    resumed: bool = False         # a preempted stream's re-prefill: the
    # prompt is the original prompt + every token already delivered, so
    # its admission counts no TTFT or queue wait again
    aged: bool = False            # promoted past the stride order by the
    # aging bound (counted once a request)


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
    token_ver: int = 0            # params_version it was computed under
    pos: int = 0                  # its position in the logical sequence
    version: int = 0              # params_version at admission: a slot
    # admitted under older weights publishes no blocks (mixed K/V)
    remaining: int = 0
    temperature: float = 0.0
    eos_id: int | None = None
    submit_ts: float = 0.0
    priority: int = 0
    resumed: bool = False
    # every token this stream emitted, in order: a preemption requeues
    # prompt + emitted as a re-prefill
    emitted: list = field(default_factory=list)
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


def accept_drafts(logits, window, temps, gen):
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
    categorical samples; every row draws (greedy rows ignore the draws),
    so one static step serves greedy and sampled rows alike.

    Returns ``(out [B, W], out_lp [B, W] f32, accepted [B])``:
    ``out[:, :accepted + 1]`` are the tokens to emit, ``out_lp`` each
    column's token's natural (untempered f32) logprob."""
    w = logits.shape[1]
    drafts = window[:, 1:].long()
    greedy = torch.argmax(logits, dim=-1)
    hot = (temps > 0)[:, None]
    safe = torch.where(temps > 0, temps, 1.0)
    logp = torch.log_softmax(logits.float() / safe[:, None, None], dim=-1)
    p_draft = logp[:, :-1].gather(-1, drafts[..., None])[..., 0].exp()
    u = torch.rand(drafts.shape, generator=gen, device=logits.device)
    match = torch.where(hot, u < p_draft, drafts == greedy[:, :-1])
    logp[:, :-1].scatter_(-1, drafts[..., None], -1e30)
    nxt = torch.where(hot, _gumbel_argmax(logp, gen), greedy)
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    cols = torch.arange(w, device=logits.device)
    out = torch.where(cols < accepted[:, None],
                      torch.nn.functional.pad(drafts, (0, 1)), nxt)
    out_lp = torch.log_softmax(logits.float(), dim=-1).gather(
        -1, out[..., None])[..., 0]
    return out, out_lp, accepted


class _Staging:
    """The persistent inputs of static steps: named int32 and float32
    arrays packed in one host array (``host[name]``, numpy views to fill)
    and one int32 device buffer (``dev[name]``, the views a step reads),
    so a tick's inputs go to the device in ONE copy, into the addresses a
    captured graph reads. ``spec`` maps each name to ``(shape, numpy
    dtype)``."""

    def __init__(self, device, **spec):
        sizes = {n: int(np.prod(shape)) for n, (shape, _) in spec.items()}
        self._host = np.zeros(sum(sizes.values()), np.int32)
        self._host_t = torch.from_numpy(self._host)
        self._dev = torch.zeros(self._host.size, dtype=torch.int32,
                                device=device)
        self.host, self.dev, i = {}, {}, 0
        for name, (shape, dt) in spec.items():
            n = sizes[name]
            self.host[name] = self._host[i:i + n].view(dt).reshape(shape)
            self.dev[name] = self._dev[i:i + n].view(
                torch.float32 if dt == np.float32 else torch.int32
            ).view(shape)
            i += n

    def upload(self):
        """The host arrays to the device in one copy, not waited for:
        the source is pageable memory, staged before the call returns,
        so the host arrays may be refilled at once."""
        self._dev.copy_(self._host_t, non_blocking=True)


class _StaticStep:
    """One static-shaped step of the engine: ``fn(inputs.dev)`` reads the
    device views of its `_Staging` (and the engine's weights, pools and
    generator) and returns device tensors. Building it adds one to the
    engine's trace counter ``counter``. On the card (`InferenceEngine`'s
    ``_capture``) the first call runs ``fn`` once on the engine's side
    stream (building the kernels at first use, cuBLAS's workspace and
    the split-K tickets, so nothing compiles or allocates synchronously
    during capture), then captures it as a CUDA graph in the engine's
    graph pool, with the engine's generator registered so every replay
    advances it; every call replays the graph and returns its static
    outputs. A capture that fails raises. Kernel wrappers count their
    launches in Python, which a replay does not run: the launches
    captured are taken back from the counters after the capture and
    added again at every replay (`ops.add_kernel_launches`). Elsewhere
    ``fn`` runs eagerly on the same buffers."""

    def __init__(self, eng, counter: str, inputs: _Staging, fn):
        self.eng, self.inputs, self.fn = eng, inputs, fn
        self.kind = counter[:-len("_traces")]
        self.graph, self.out, self.launches = None, None, {}
        setattr(eng, counter, getattr(eng, counter) + 1)

    def __call__(self):
        if self.eng.mesh is not None:
            self.eng._agree_step(self)
        if self.graph is None and not self.eng._captures():
            return self.fn(self.inputs.dev)
        if self.graph is None:
            self._build_graph()
        self.graph.replay()
        ops.add_kernel_launches(self.launches)
        return self.out

    def _build_graph(self):
        eng = self.eng
        main = torch.cuda.current_stream(eng.device)
        if eng._graph_pool is None:
            eng._graph_pool = torch.cuda.graph_pool_handle()
            eng._side = torch.cuda.Stream(eng.device)
        eng._side.wait_stream(main)
        with torch.cuda.stream(eng._side):
            self.fn(self.inputs.dev)           # warm-up
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(eng._gen)
        before = ops.kernel_launches()
        # No automatic garbage collection inside the capture: engines are
        # reference cycles, and a dropped engine collected here would
        # destroy its graphs mid-capture, which invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            # Thread-local: the capture forbids unsafe CUDA calls in this
            # thread only. A served engine captures lazily, under its
            # lock, while other threads of the process go on: a decode
            # replica's pull allocating a pinned handoff buffer, another
            # stream freeing one, the runtime's threads. Under torch's
            # default ("global") any such call fails and invalidates the
            # capture; a device-wide synchronize still fails here.
            with torch.cuda.graph(graph, pool=eng._graph_pool,
                                  stream=eng._side,
                                  capture_error_mode="thread_local"):
                out = self.fn(self.inputs.dev)
        finally:
            if collecting:
                gc.enable()
        after = ops.kernel_launches()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        ops.add_kernel_launches(self.launches, -1)   # capture ran nothing
        main.wait_stream(eng._side)
        self.graph, self.out = graph, out
        eng._graph_pool_bytes = _pool_bytes(eng._graph_pool)


def _pool_bytes(pool) -> int:
    """Device bytes the caching allocator holds for the graph pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


# The fields of the header the ranks of a mesh all-gather at each tick
# ("tick" phase), before each step ("step" phase) and before
# `run_until_idle` returns ("idle" phase): ints, or digests of
# host arrays; -1 where a phase has no such field. "clock" is the mesh's
# first rank's reading, adopted, not compared.
MESH_FIELDS = ("phase", "tick", "version", "queue", "step", "tokens",
               "window", "pos", "tables", "dtables", "temps", "table",
               "start", "length", "temp", "copies", "clock")
_PHASES = {"tick": 1, "step": 2, "idle": 3}
_STEP_KINDS = {"decode": 1, "prefill": 2, "verify": 3, "draft": 4,
               "draft_prefill": 5}


def _digest(x) -> int:
    """A host value's digest for the mesh header (crc32 of its bytes)."""
    if not isinstance(x, np.ndarray):
        return zlib.crc32(repr(x).encode())
    return zlib.crc32(np.ascontiguousarray(x).view(np.uint8))


def _blob_digest(blob: dict) -> int:
    """A handoff blob's digest for the mesh header: its prompt, its
    stream state and the bytes of its payloads (``kv_host`` when it
    carries one)."""
    host = blob.get("kv_host")
    if host is not None:
        rows = _digest(host.numpy())
    else:
        rows = 0
        for which in ("payload", "draft_payload"):
            for blk in blob.get(which) or ():
                for name in sorted(blk):
                    rows = zlib.crc32(np.ascontiguousarray(
                        blk[name]).view(np.uint8), rows)
    return _digest((_digest(np.asarray(blob["prompt"], np.int32)),
                    blob["token"], blob["token_ver"], blob["max_new_tokens"],
                    blob["temperature"], blob["eos_id"],
                    blob.get("priority", 0), blob["params_version"], rows))


def _on_mesh(model: gpt.GPT, cfg: gpt.GPTConfig, mesh, what: str):
    """``model`` as the engine on ``mesh`` serves it: a model of whole
    weights is cut to this rank's blocks; one built on the mesh is
    kept."""
    if mesh is not None and model.mesh is None:
        return gpt.GPT(cfg, gpt.param_tree(model), device=model.device,
                       dtype=model.embed.dtype, mesh=mesh)
    if model.mesh is not mesh:
        raise ValueError(f"the {what} holds its blocks for {model.mesh}, "
                         f"the engine runs on {mesh}")
    return model


# Host carriers of pool dtypes in a handoff blob: numpy has no bfloat16,
# so bf16 rows travel as their uint16 bit patterns and the blob names the
# logical dtype (the reference's ml_dtypes arrays print as "bfloat16").
_CARRIERS = {torch.float32: (np.float32, "float32"),
             torch.float16: (np.float16, "float16"),
             torch.bfloat16: (np.uint16, "bfloat16"),
             torch.int8: (np.int8, "int8")}


def _block_layout(pools, heads: int = 1) -> tuple[list, int]:
    """The byte layout of ``pools`` (``[(pool, n_blocks)]``) in one flat
    buffer, block-major per entry: ``[(pool index, name, dtype, shape,
    offset, nbytes)]`` and the total, each entry 16-byte aligned. A pool
    that holds ``1 / heads`` of the heads (a rank's share on a mesh) is
    laid out with whole heads: a blob reads the same on any engine."""
    layout, total = [], 0
    for i, (cache, n) in enumerate(pools):
        for name in gpt.pool_entries(cache):
            t = cache[name]
            shape = (n, t.shape[0], t.shape[2], t.shape[3] * heads) \
                + tuple(t.shape[4:])
            nbytes = math.prod(shape) * t.element_size()
            layout.append((i, name, t.dtype, shape, total, nbytes))
            total += -(-nbytes // 16) * 16
    return layout, total


def _fill_blocks(buf, layout, rows):
    """Copy each entry's per-block ``rows`` (carrier arrays, as
    `_block_layout`'s ``layout`` orders them) into the flat host buffer
    ``buf`` at the entry's offset."""
    for (_, _, dt, shape, off, nb), entry in zip(layout, rows):
        dst = buf[off:off + nb].view(_CARRIERS[dt][0]).reshape(shape)
        for j, a in enumerate(entry):
            dst[j] = a


def _host_views(host, layout, n_pools) -> list[dict]:
    """Per pool, ``{name: [n, L, bs, ...]}`` numpy views of the flat host
    buffer ``host`` laid out by `_block_layout`, in the entries' host
    carriers (`_CARRIERS`: bf16 as uint16)."""
    buf = host.numpy()
    out = [{} for _ in range(n_pools)]
    for i, name, dt, shape, off, nb in layout:
        out[i][name] = buf[off:off + nb].view(
            _CARRIERS[dt][0]).reshape(shape)
    return out


def _as_carrier(arr, carrier):
    """A blob array as its entry's host carrier dtype: bf16 rows arrive
    as uint16 (the port's blobs) or as ml_dtypes bfloat16 (the
    reference's), both read as their 2-byte bit patterns."""
    arr = np.asarray(arr)
    if arr.dtype == carrier:
        return arr
    return arr.view(carrier)


def _watchdog_loop(ref, budget: float):
    """Detect a stuck scheduler tick of the engine behind the weakref
    ``ref``: sample the running tick's start time (lock-free reads: the
    watchdog must work precisely when the lock holder is wedged) and
    count and warn once a tick that overruns ``budget`` seconds. Holds
    the engine only between two samples, so the engine (its pools and
    graphs) is freed as if there were no watchdog; the loop ends then."""
    flagged = -1
    while True:
        time.sleep(budget / 4)
        eng = ref()
        if eng is None:
            return
        started, seq = eng._tick_started, eng._tick_seq
        if (started is not None and seq != flagged
                and time.perf_counter() - started > budget):
            flagged = seq
            eng._watchdog_stalls += 1
            logger.warning("engine %s: scheduler tick %d stuck for > %.2fs",
                           eng.name, seq, budget)
        del eng


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
    prefixes.

    ``priority_classes`` (default ``RAY_TPU_ENGINE_PRIORITY_CLASSES``, 3)
    is the number of request classes; ``priority_weight_base`` (4.0) and
    ``priority_aging_s`` (2.0) set their admission shares and aging
    bound. ``max_queue`` and ``shed_high_water`` (a fraction of the pool,
    projected over the queue) shed overload; ``watchdog_s`` starts a
    thread that counts ticks overrunning it. All three are off by
    default.

    ``role`` splits serving across engines: ``"prefill"`` runs chunked
    prefill only (a slot holds the prompt's blocks; each completed
    prompt's KV becomes a handoff blob, `handoff_for`), ``"decode"`` is
    a colocated engine that also imports blobs (`import_handoff`), and
    ``"colocated"`` (the default) serves whole requests. Any engine but a
    prefill-role one imports.

    ``telemetry_sample`` (default ``RAY_TPU_TELEMETRY_SAMPLE``, 1.0) is
    the share of requests the engine's `util.telemetry.FlightRecorder`
    traces.

    ``mesh`` (default: the model's) serves over a `parallel.Mesh`; every
    rank builds the engine with the same arguments and makes the same
    calls. ``model`` (and ``draft_params``) is a `models.gpt.GPT` built
    on that mesh or one holding whole weights, of which each rank keeps
    its blocks (module docstring)."""

    def __init__(self, model: gpt.GPT, cfg: gpt.GPTConfig, *,
                 slots: int = 4, max_len: int | None = None,
                 prefill_buckets: tuple[int, ...] | None = None,
                 block_size: int = 16, cache_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 prefix_cache: bool = True, spec: str | None = None,
                 spec_k: int = 4, ngram_max: int = 3, ngram_min: int = 1,
                 draft_params=None, draft_cfg: gpt.GPTConfig | None = None,
                 draft_cache_blocks: int | None = None, seed: int = 0,
                 max_queue: int | None = None,
                 shed_high_water: float | None = None,
                 watchdog_s: float | None = None,
                 priority_classes: int | None = None,
                 priority_aging_s: float | None = None,
                 priority_weight_base: float | None = None,
                 role: str = "colocated",
                 telemetry_sample: float | None = None, device=None,
                 mesh: Mesh | None = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, got "
                            f"{type(mesh).__name__}")
        mesh = active_mesh(mesh) or model.mesh
        self.mesh = mesh
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"unknown engine role {role!r}")
        self.role = role
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
        model = _on_mesh(model, cfg, mesh, "model")
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
            draft = _on_mesh(draft, draft_cfg, mesh, "draft model")
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
                                      block_size, self.device, mesh=mesh)
        self.draft_cache, self._draft_alloc = None, None
        self.draft_cache_blocks = 0
        if draft is not None:
            self.draft_cache_blocks = (self.cache_blocks
                                       if draft_cache_blocks is None
                                       else draft_cache_blocks)
            self.draft_cache = gpt.init_kv_pool(
                draft_cfg, self.draft_cache_blocks + 1, block_size,
                self.device, mesh=mesh)
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
        # The mesh axes that split the pools' heads: a handoff's blocks
        # travel with whole heads (`_block_layout`).
        self._head_axes = () if mesh is None else mesh.live_axes(
            sharding.spec_axes(sharding.kv_pool_specs(mesh)["k"][3:4]))
        self._head_ranks = 1 if mesh is None else mesh.axis_size(
            self._head_axes)
        self._alloc = BlockAllocator(self.cache_blocks + 1)
        self._tree = (RadixTree(block_size, self._alloc)
                      if prefix_cache else None)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # Compile-once steps (`_StaticStep`, built at first use), keyed
        # (kind, chunk bucket); their builds, the reference's trace
        # counters; the spec tick's inputs, which verify and draft share.
        self._steps: dict = {}
        self.prefill_traces = self.decode_traces = 0
        self.verify_traces = self.draft_traces = 0
        self.draft_prefill_traces = 0
        self._spec_in = None
        # Private: False runs every step eagerly on the card (set before
        # the first step; tests and chip_smoke.py A/B with it).
        self._capture = True
        self._graph_pool = self._side = None
        self._graph_pool_bytes = 0
        # The flight recorder and the retrace sentinel (util.telemetry).
        self.name = telemetry.next_name("engine")
        if mesh is not None and mesh.axis_index(mesh.axis_names):
            telemetry_sample = 0.0    # the mesh's first rank records
        self._recorder = telemetry.FlightRecorder(self.name,
                                                  sample=telemetry_sample)
        # On a mesh: the mesh clock this tick (the first rank's reading),
        # its lead on this rank's clock, and the copy-on-write copies
        # since the last step's header.
        self._mesh_clock = self._mesh_skew = 0.0
        self._mesh_copies: list = []
        self._sentinel = telemetry.RetraceSentinel(self.name)
        self._sentinel.watch("decode", lambda: self.decode_traces, cap=1,
                             registered=True)
        if quantized:
            self._sentinel.watch(
                "quantize", lambda: self.quantize_traces,
                cap=int(cfg.weight_dtype == "int8") + int(
                    draft is not None and draft_cfg.weight_dtype == "int8"),
                registered=True)
        if spec is not None:
            self._sentinel.watch("verify", lambda: self.verify_traces,
                                 cap=1, registered=True)
        if spec == "draft":
            self._sentinel.watch("draft", lambda: self.draft_traces, cap=1,
                                 registered=True)
            self._sentinel.watch("draft_prefill",
                                 lambda: self.draft_prefill_traces,
                                 registered=True)
        self._sentinel.watch("prefill", lambda: self.prefill_traces,
                             registered=True)
        # The handoff's block gather and scatter: first use per pool
        # geometry (target and a draft pool of other shapes), the
        # reference's jit traces.
        self.kv_gather_traces = self.kv_scatter_traces = 0
        self._kv_geometries = {"gather": set(), "scatter": set()}
        for kind in ("gather", "scatter"):
            self._sentinel.watch(
                "kv_" + kind,
                lambda kind=kind: getattr(self, f"kv_{kind}_traces"),
                cap=2 if spec == "draft" else 1, registered=True)

        self._slots = [_Slot() for _ in range(slots)]
        self._pending: collections.deque[_Pending] = collections.deque()
        self._rid = 0
        self._admit_seq = 0
        # rid -> deque of emitted tokens; dropped when done AND drained
        # (tokens_for pops, then deletes) or cancelled.
        self._out: dict[int, collections.deque] = {}
        self._done: set[int] = set()
        # rid -> the exception of a request shed while queued, raised by
        # its tokens_for
        self._errors: dict[int, Exception] = {}
        self._lock = threading.RLock()
        self._params_version = 0
        self._swap_pending_ts = None

        # Disaggregated handoff. Export side (role "prefill"): rid -> the
        # host blob parked when the prompt's prefill completes, until
        # `handoff_for`/`take_handoff` collects it. Import side (any other
        # role): FIFO of (rid, blob) waiting for a slot, mirrored by
        # `_import_rids` (rid -> the blob's digest, which a mesh's tick
        # header carries); and (event, host memory) per import whose
        # host-to-device copies the stream may not have run yet: the
        # memory stays referenced until its event has passed.
        self._handoffs: dict[int, dict] = {}
        self._imports: collections.deque = collections.deque()
        self._import_rids: dict[int, int] = {}
        self._h2d_inflight: collections.deque = collections.deque()

        # Priority classes: stride pass values per backlogged class, and
        # per-class counters and queue waits (made at a class's first use;
        # reset_stats zeroes them in place).
        self.priority_classes = (ENGINE_PRIORITY_CLASSES
                                 if priority_classes is None
                                 else int(priority_classes))
        if self.priority_classes < 1:
            raise ValueError("priority_classes must be >= 1")
        self.priority_aging_s = (ENGINE_PRIORITY_AGING_S
                                 if priority_aging_s is None
                                 else float(priority_aging_s))
        if self.priority_aging_s <= 0:
            raise ValueError("priority_aging_s must be > 0")
        self.priority_weight_base = (ENGINE_PRIORITY_WEIGHT_BASE
                                     if priority_weight_base is None
                                     else float(priority_weight_base))
        if self.priority_weight_base < 1.0:
            raise ValueError("priority_weight_base must be >= 1")
        self._class_pass: dict[int, float] = {}
        self._per_class: dict[int, dict] = {}
        self._class_waits: dict[int, collections.deque] = {}

        # Overload shedding and the tick watchdog, both off by default.
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if shed_high_water is not None and not 0.0 < shed_high_water <= 1.0:
            raise ValueError("shed_high_water must be in (0, 1]")
        self.max_queue = max_queue
        self.shed_high_water = shed_high_water
        self._tick_seq = 0
        self._tick_started: float | None = None
        self.reset_stats()
        if watchdog_s is not None:
            if watchdog_s <= 0:
                raise ValueError("watchdog_s must be > 0")
            threading.Thread(target=_watchdog_loop,
                             args=(weakref.ref(self), float(watchdog_s)),
                             daemon=True, name="engine-watchdog").start()
        telemetry.register_stats_source(self.name, self, kind="engine")

    def arm_retrace_sentinel(self):
        """Declare shape warm-up over: every watched build path,
        including the bucket-dependent prefill ones, is baselined at its
        current count, and ANY further build increments
        ``retraces_unexpected`` and warns. The capped paths (decode,
        verify, draft, quantize) are watched from construction
        regardless."""
        self._sentinel.arm()

    def _captures(self) -> bool:
        return (self.device.type == "cuda" and self._capture
                and self.mesh is None)

    # ------------------------------------------------------------------
    # the mesh: every rank runs the same scheduler
    # ------------------------------------------------------------------

    def _mesh_agree(self, fields: dict) -> np.ndarray:
        """All-gather this rank's header (`MESH_FIELDS`, -1 where absent)
        over the whole mesh and hold every rank's to the first rank's:
        any difference raises `MeshDivergenceError` on every rank (all
        see the same table). Returns the first rank's header."""
        row = np.full(len(MESH_FIELDS), -1, np.int64)
        for name, val in fields.items():
            row[MESH_FIELDS.index(name)] = val
        mesh = self.mesh
        table = col.all_gather(torch.from_numpy(row[None]).to(self.device),
                               mesh.axis_names, mesh, dim=0).cpu().numpy()
        cmp = [i for i, n in enumerate(MESH_FIELDS) if n != "clock"]
        bad = {}
        for r in range(1, table.shape[0]):
            diff = [MESH_FIELDS[i] for i in cmp if table[r, i] != table[0, i]]
            if diff:
                bad[r] = diff
        if bad:
            ranks = mesh.group(mesh.axis_names)[1]
            raise MeshDivergenceError(
                f"engine {self.name}: the mesh's ranks diverge at tick "
                f"{self._tick_seq}: " + "; ".join(
                    f"rank {ranks[r]} differs from rank {ranks[0]} on "
                    f"{', '.join(f)}" for r, f in bad.items()))
        return table[0]

    def _queue_digest(self) -> int:
        state = [(q.rid, q.priority, q.max_new_tokens, q.temperature,
                  _digest(q.prompt)) for q in self._pending]
        state += [(s.rid, s.phase, s.filled, s.pos) for s in self._slots]
        state += list(self._import_rids.items())
        return _digest(state)

    def _agree_tick(self):
        """The tick's header: the scheduler's state, and the first rank's
        clock, which stamps the requests queued since the last tick (the
        aging clock; queue waits read this rank's clock plus its lag)."""
        now = time.perf_counter()
        head = self._mesh_agree({
            "phase": _PHASES["tick"], "tick": self._tick_seq,
            "version": self._params_version, "queue": self._queue_digest(),
            "clock": np.float64(now).view(np.int64)})
        self._mesh_clock = float(head[MESH_FIELDS.index("clock")].view(
            np.float64))
        self._mesh_skew = self._mesh_clock - now
        for q in self._pending:
            if q.ts == math.inf:
                q.ts = self._mesh_clock

    def _agree_idle(self):
        """The idle header: a rank with nothing left to run meets the
        other ranks at a collective before it returns, so a rank that
        still has work (at its tick header) and this one both raise
        `MeshDivergenceError` instead of one waiting forever."""
        self._mesh_agree({"phase": _PHASES["idle"], "tick": self._tick_seq,
                          "version": self._params_version,
                          "queue": self._queue_digest()})

    def _agree_step(self, step: "_StaticStep"):
        """The step's header: its kind and a digest of each host input."""
        fields = {"phase": _PHASES["step"], "tick": self._tick_seq,
                  "step": _STEP_KINDS[step.kind],
                  "copies": _digest(self._mesh_copies)}
        for name, arr in step.inputs.host.items():
            fields[name] = _digest(arr)
        self._mesh_copies = []
        self._mesh_agree(fields)

    # ------------------------------------------------------------------
    # request side
    # ------------------------------------------------------------------

    def _blocks_for(self, p: int, max_new: int) -> int:
        """Blocks a request's footprint needs: prefill writes positions
        0..p-1, decode writes p..p+max_new-2 (the last sampled token is
        never written)."""
        highest = p - 1 + max(max_new - 1, 0)
        return highest // self.block_size + 1

    def _slot_blocks_for(self, p: int, max_new: int) -> int:
        """Blocks THIS engine holds for a request: a prefill-role engine
        never decodes, so its slot writes the prompt's positions only
        before the handoff; every other role holds the whole footprint
        (`_blocks_for`)."""
        if self.role == "prefill":
            return (p - 1) // self.block_size + 1
        return self._blocks_for(p, max_new)

    def _shed_verdict(self, n_blocks: int) -> str | None:
        """Overload decision for one admission of ``n_blocks`` footprint,
        under the lock: None admits, else the reason. The high-water mark
        reads the projected utilization (live blocks, the footprints
        already queued and this one), so a burst of submits between two
        ticks cannot overshoot it."""
        if self.max_queue is not None and \
                len(self._pending) >= self.max_queue:
            return (f"queue full ({len(self._pending)} >= "
                    f"max_queue {self.max_queue})")
        if self.shed_high_water is not None:
            queued = sum(self._slot_blocks_for(q.prompt.size,
                                               q.max_new_tokens)
                         for q in self._pending)
            projected = (self._alloc.used + queued + n_blocks) \
                / max(self.cache_blocks, 1)
            if projected > self.shed_high_water:
                return (f"projected block utilization {projected:.2f} > "
                        f"high water {self.shed_high_water:.2f}")
        return None

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: int | None = None,
               priority: int = 0) -> int:
        """Queue a prompt (sequence of token ids); returns a request id
        for `tokens_for`. Admission happens inside `step()`.

        ``priority`` is the request's class, 0 (lowest) to
        ``priority_classes - 1``: a higher class gets a larger admission
        share, is shed last, and may preempt strictly lower-class active
        streams under block pressure. Under overload (``max_queue``,
        ``shed_high_water``) the lowest-class queued request below this
        one is shed first; when none is, this submit raises
        `OverloadedError`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        priority = int(priority)
        if not 0 <= priority < self.priority_classes:
            raise ValueError(f"priority {priority} outside "
                             f"[0, {self.priority_classes})")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"exceeds cache max_len {self.max_len}")
        need = self._slot_blocks_for(prompt.size, max_new_tokens)
        if need > self.cache_blocks:
            raise ValueError(f"request footprint {need} blocks exceeds "
                             f"cache blocks {self.cache_blocks}")
        if self._draft_alloc is not None and need > self.draft_cache_blocks:
            raise ValueError(f"request footprint exceeds draft cache "
                             f"blocks {self.draft_cache_blocks}")
        with self._lock:
            if self.max_queue is not None or \
                    self.shed_high_water is not None:
                reason = self._shed_verdict(need)
                while reason is not None and \
                        self._shed_lowest_below(priority):
                    reason = self._shed_verdict(need)
                if reason is not None:
                    self._sheds += 1
                    self._class_counter(priority)["sheds"] += 1
                    raise OverloadedError(
                        f"engine overloaded, request shed: {reason}")
            rid = self._rid
            self._rid += 1
            self._out[rid] = collections.deque()
            # on a mesh the next tick stamps it from the mesh clock
            ts = math.inf if self.mesh is not None else time.perf_counter()
            self._pending.append(_Pending(rid, prompt, max_new_tokens,
                                          temperature, eos_id, ts,
                                          priority=priority))
            self._class_counter(priority)["submitted"] += 1
            self._recorder.on_submit(rid, prompt.size)
        return rid

    def _shed_lowest_below(self, priority: int) -> bool:
        """Shed the lowest-class queued request strictly below
        ``priority`` (the newest of that class: least sunk wait), its
        `OverloadedError` delivered through its `tokens_for`. False when
        no queued request ranks below. A resumed (preempted) stream is
        never shed: it has delivered tokens to a live consumer."""
        victim_i = None
        for i, q in enumerate(self._pending):
            if q.priority >= priority or q.resumed:
                continue
            if victim_i is None:
                victim_i = i
                continue
            v = self._pending[victim_i]
            if (q.priority, -q.ts) < (v.priority, -v.ts):
                victim_i = i
        if victim_i is None:
            return False
        victim = self._pending[victim_i]
        del self._pending[victim_i]
        self._errors[victim.rid] = OverloadedError(
            f"engine overloaded: request (class {victim.priority}) "
            f"shed from the queue for a class-{priority} admission")
        self._sheds += 1
        self._class_counter(victim.priority)["sheds"] += 1
        self._recorder.on_finish(victim.rid, "shed")
        return True

    def _class_counter(self, c: int) -> dict:
        """Class ``c``'s counter row, made at its first use (under the
        lock)."""
        d = self._per_class.get(c)
        if d is None:
            d = self._per_class[c] = {
                "submitted": 0, "completed": 0, "sheds": 0,
                "preemptions": 0, "decode_tokens": 0}
            self._class_waits[c] = collections.deque(maxlen=256)
        return d

    def cancel(self, rid: int) -> bool:
        """Abort a request wherever it is — pending (a preempted stream's
        queued resume included), mid-prefill, decoding, finished but
        undrained, shed with its error undelivered, exported and parked
        but not collected (``handoffs_abandoned``), or an import queued
        for a slot — releasing its blocks and output queue. Idempotent;
        returns True if anything was released."""
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
            if self._handoffs.pop(rid, None) is not None:
                # exported but never collected: the device blocks were
                # freed at export, so only the host blob goes
                self._handoffs_abandoned += 1
                hit = True
            if rid in self._import_rids:
                del self._import_rids[rid]
                for i, (irid, _) in enumerate(self._imports):
                    if irid == rid:
                        del self._imports[i]
                        break
                hit = True
            hit |= self._out.pop(rid, None) is not None
            hit |= self._errors.pop(rid, None) is not None
            self._done.discard(rid)
            if hit:
                self._cancelled += 1
                self._recorder.on_finish(rid, "cancelled")
            return hit

    def tokens_for(self, rid: int):
        """Generator of one request's `TokenEvent`s. Each next() ticks
        `step()` (under the lock) until this request has output, so
        concurrent consumers collectively drive one continuously batched
        device loop. A request shed while queued raises its
        `OverloadedError` here, once. Abandoning the generator cancels
        the request."""
        try:
            while True:
                tok = None
                fin = False
                with self._lock:   # pop under the lock, yield outside it
                    q = self._out.get(rid)
                    if q is None:
                        return
                    err = self._errors.pop(rid, None)
                    if err is not None:
                        del self._out[rid]
                        self._done.discard(rid)
                        raise err
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
    # disaggregated prefill/decode handoff
    # ------------------------------------------------------------------

    def _kv_first_use(self, kind: str, cache: dict):
        """Count the first ``kind`` ("gather" or "scatter") on this pool
        geometry under ``kv_<kind>_traces``."""
        geom = tuple((n, tuple(cache[n].shape), cache[n].dtype)
                     for n in gpt.pool_entries(cache))
        if geom not in self._kv_geometries[kind]:
            self._kv_geometries[kind].add(geom)
            name = f"kv_{kind}_traces"
            setattr(self, name, getattr(self, name) + 1)

    def _handoff_pools(self, n_blocks: int, draft: bool) -> list:
        """``[(pool, n_blocks)]`` of a handoff: the target pool's, then
        the draft pool's when ``draft`` and this engine has one."""
        pools = [(self.cache, n_blocks)]
        if draft and self._draft_alloc is not None:
            pools.append((self.draft_cache, n_blocks))
        return pools

    def handoff_buffer(self, n_blocks: int, draft: bool = False):
        """Host memory for ``n_blocks`` blocks of a handoff, laid out as
        an export lays out its blocks (`_block_layout`, the target pool's
        entries, then the draft pool's when ``draft`` and this engine has
        one): ``(host, views, dtypes)``, the flat uint8 tensor (pinned on
        the card) a blob carries as ``kv_host``, per payload (``"payload"``,
        ``"draft_payload"``) ``{name: [n_blocks, L, bs, ...]}`` numpy views
        of it in the entries' host carriers, and ``{name: logical dtype}``
        per payload as a blob's ``dtypes`` names them. An export fills
        one; `disagg.DecodeReplica` receives a pulled blob's frames into
        one, so either imports with one copy an entry."""
        pools = self._handoff_pools(n_blocks, draft)
        layout, total = _block_layout(pools, self._head_ranks)
        host = torch.empty(total, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        which = ("payload", "draft_payload")
        views = dict(zip(which, _host_views(host, layout, len(pools))))
        dtypes = {w: {name: _CARRIERS[cache[name].dtype][1]
                      for name in gpt.pool_entries(cache)}
                  for w, (cache, _) in zip(which, pools)}
        return host, views, dtypes

    def _blocks_to_host(self, slot) -> tuple:
        """The written blocks of ``slot`` (and its draft blocks) on the
        host: ONE indexed copy per entry into one device buffer
        (`models.gpt.gather_blocks`), then on the card ONE copy of it into
        a pinned `handoff_buffer`, the export's one host sync. Returns
        that buffer's ``(host, views, dtypes)``. The copy is synchronous,
        so a blob that only goes over the wire carries no stream use, and
        whichever thread drops its last view (a block server's) frees it
        without a CUDA call. On a mesh each rank gathers its heads' rows
        and all-gathers every rank's over the head axes, so every rank
        holds the whole-head blob."""
        n = (slot.prompt.size - 1) // self.block_size + 1
        ids = [slot.blocks, slot.draft_blocks]
        pools = self._handoff_pools(n, True)
        layout, total = _block_layout(pools, self._head_ranks)
        host, views, dtypes = self.handoff_buffer(n, True)
        flat = host
        if self.device.type == "cuda":
            flat = torch.empty(total, dtype=torch.uint8, device=self.device)
        for i, (cache, _) in enumerate(pools):
            self._kv_first_use("gather", cache)
            out = {name: flat[off:off + nb].view(dt).view(shape)
                   for j, name, dt, shape, off, nb in layout if j == i}
            if not self._head_axes:
                gpt.gather_blocks(cache, ids[i][:n], out=out)
                continue
            for name, rows in gpt.gather_blocks(cache, ids[i][:n]).items():
                out[name].copy_(col.all_gather(rows, self._head_axes,
                                               self.mesh, dim=3))
        if flat is not host:
            host.copy_(flat)
        return host, views, dtypes

    def _blocks_to_device(self, pools, host=None):
        """Host blocks into the pools, in place: for each ``(pool, blocks,
        first, ids)`` of ``pools``, ``blocks[first + j]`` (a blob's
        ``{name: rows}``) onto physical block ``ids[j]``, through one
        device buffer that lands with ONE indexed copy per entry
        (`models.gpt.scatter_blocks`), all on the stream the steps run on.
        ``host``, a blob's ``kv_host``, holds every block of ``pools``
        laid out as `handoff_buffer` lays them out: each entry's rows then
        reach the device buffer in ONE asynchronous copy straight from
        it. Without one (the reference's blobs, or arrays rebuilt by
        hand) the rows are staged: gathered on the host into one pinned
        buffer per import and sent in ONE copy. The source memory stays
        referenced, beside an event recorded after its copies, until the
        stream has run them (`_h2d_inflight`): no copy in flight reads
        freed or refilled memory, and nothing here waits for the
        device."""
        layout, total = _block_layout([(c, len(ids))
                                       for c, _, _, ids in pools],
                                      self._head_ranks)
        if total == 0:
            return
        cuda = self.device.type == "cuda"
        flat = torch.empty(total, dtype=torch.uint8, device=self.device)
        if host is not None:
            src, _ = _block_layout([(c, len(b)) for c, b, _, _ in pools],
                                   self._head_ranks)
            for (i, _, _, _, off, nb), (_, _, _, _, soff, snb) in zip(
                    layout, src):
                start = soff + pools[i][2] * (snb // len(pools[i][1]))
                flat[off:off + nb].copy_(host[start:start + nb],
                                         non_blocking=cuda)
            keep = host
        else:
            keep = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
            _fill_blocks(keep.numpy(), layout, [
                [_as_carrier(blk[name], _CARRIERS[dt][0])
                 for blk in pools[i][1][pools[i][2]:]]
                for i, name, dt, _, _, _ in layout])
            flat.copy_(keep, non_blocking=cuda)
        if cuda:
            while self._h2d_inflight and self._h2d_inflight[0][0].query():
                self._h2d_inflight.popleft()
            done = torch.cuda.Event()
            done.record()
            self._h2d_inflight.append((done, keep))
        for i, (cache, _, _, ids) in enumerate(pools):
            if ids:
                self._kv_first_use("scatter", cache)
                gpt.scatter_blocks(cache, {
                    name: self._my_heads(flat[off:off + nb].view(dt).view(
                        shape))
                    for j, name, dt, shape, off, nb in layout if j == i},
                    ids)

    def _my_heads(self, rows):
        """This rank's heads of whole-head block rows ``[n, L, bs, H,
        ...]`` (all of them on one card)."""
        if not self._head_axes:
            return rows
        return sharding.local_shard(rows, sharding.PartitionSpec(
            None, None, None, self._head_axes), self.mesh)

    def _export_handoff(self, slot_idx: int):
        """Prefill-role endgame of one slot (under the lock, from
        `_run_prefill_chunk` the tick its prompt completes): every written
        block, payload and any int8 scale rows (and the draft pool's),
        goes to host (`_blocks_to_host`, one host sync), the blob is
        parked for collection and the slot is freed. The blob carries
        what a decode-role `import_handoff` needs to continue the stream
        token-identically: the parked first token with its logprob and
        version (sampled from the final prefill chunk here, so the decode
        engine never prefills again), the sampling state and the weight
        version the K/V was computed under. Its per-block arrays are views
        of the one host buffer, which it carries as ``kv_host``;
        ``dtypes`` names each entry's logical dtype."""
        s = self._slots[slot_idx]
        n_written = (s.prompt.size - 1) // self.block_size + 1
        t0 = time.perf_counter()
        host, views, dtypes = self._blocks_to_host(s)
        kv_bytes = sum(int(a.nbytes) for v in views.values()
                       for a in v.values())
        dt = time.perf_counter() - t0
        payloads = {w: [{name: a[j] for name, a in v.items()}
                        for j in range(n_written)]
                    for w, v in views.items()}
        self._handoffs[s.rid] = {
            "rid": s.rid,
            "prompt": s.prompt,
            "token": int(s.token),
            "token_logp": float(s.token_logp),
            "token_ver": int(s.token_ver),
            "max_new_tokens": int(s.remaining),
            "temperature": float(s.temperature),
            "eos_id": s.eos_id,
            "priority": int(s.priority),
            "params_version": int(self._params_version),
            "block_size": self.block_size,
            "n_blocks": n_written,
            "payload": payloads["payload"],
            "draft_payload": payloads.get("draft_payload"),
            "kv_bytes": kv_bytes,
            "dtypes": {"payload": dtypes["payload"],
                       "draft_payload": dtypes.get("draft_payload")},
            "kv_host": host,
        }
        self._handoffs_exported += 1
        self._kv_blocks_exported += n_written * len(views)
        self._kv_export_bytes += kv_bytes
        self._kv_export_s.append(dt)
        self._recorder.on_kv_export(s.rid, n_written, kv_bytes, dt)
        self._recorder.on_finish(s.rid, "handoff")
        # No token consumer on a prefill engine: its output queue goes
        # now and the slot's blocks are released (the prompt's full
        # blocks live on in the radix tree for shared-prefix admissions).
        self._out.pop(s.rid, None)
        self._done.discard(s.rid)
        self._release(slot_idx)

    def handoff_for(self, rid: int) -> dict:
        """Pump the scheduler until ``rid``'s prefill completes, then pop
        and return its handoff blob: the prefill-role counterpart of
        draining `tokens_for`. Raises the parked error of a request shed
        from the queue, KeyError for an unknown or cancelled rid."""
        if self.role != "prefill":
            raise RuntimeError(
                "handoff_for is only available on a prefill-role "
                f"engine (this engine is {self.role!r})")
        while True:
            with self._lock:
                blob = self._handoffs.pop(rid, None)
                if blob is not None:
                    return blob
                err = self._errors.pop(rid, None)
                if err is not None:
                    self._out.pop(rid, None)
                    self._done.discard(rid)
                    raise err
                if rid not in self._out:
                    raise KeyError(f"unknown or cancelled handoff rid {rid}")
                # one tick per lock hold, as in tokens_for
                self.step()

    def take_handoff(self, rid: int) -> dict | None:
        """Non-blocking collect: pop ``rid``'s parked blob if its prefill
        already completed, else None."""
        with self._lock:
            return self._handoffs.pop(rid, None)

    def _check_payload(self, blocks, cache: dict, what: str):
        """Each block of a blob's ``what`` payload holds the pool's
        entries with one block's rows, in a dtype its carrier reads."""
        names = gpt.pool_entries(cache)
        for j, blk in enumerate(blocks):
            if sorted(blk) != sorted(names):
                raise ValueError(f"handoff {what} block {j} has entries "
                                 f"{sorted(blk)}, the pool {sorted(names)}")
            for name in names:
                t, arr = cache[name], np.asarray(blk[name])
                # whole heads (a mesh rank's pool holds its share)
                rows = (t.shape[0], t.shape[2], t.shape[3] * self._head_ranks
                        ) + tuple(t.shape[4:])
                carrier = _CARRIERS[t.dtype][0]
                if arr.shape != rows or not (
                        arr.dtype == carrier
                        or (t.dtype == torch.bfloat16
                            and arr.dtype.name == "bfloat16")):
                    raise ValueError(
                        f"handoff {what} block {j} {name} is "
                        f"{arr.shape}/{arr.dtype}, the pool's rows are "
                        f"{rows}/{t.dtype}")

    def import_handoff(self, blob: dict) -> int:
        """Adopt a prefill-role engine's handoff blob: queue its KV blocks
        for scatter into this pool and its stream for a decode slot.
        Returns a fresh LOCAL rid for `tokens_for`: the stream picks up
        at the first generated token (sampled by the prefill engine and
        delivered from here), greedy token-identical to a colocated run
        of the same prompt. The blob's arrays may be the port's (bf16 as
        uint16) or the reference's (ml_dtypes bfloat16), numpy either
        way. A blob's ``kv_host`` (see `handoff_buffer`), when present,
        holds the bytes of its payloads and is what gets imported."""
        if self.role == "prefill":
            raise RuntimeError(
                "a prefill-role engine cannot import handoffs")
        prompt = np.asarray(blob["prompt"], np.int32).reshape(-1)
        p = prompt.size
        max_new = int(blob["max_new_tokens"])
        if int(blob["block_size"]) != self.block_size:
            raise ValueError(
                f"handoff block_size {blob['block_size']} != engine "
                f"block_size {self.block_size} — prefill and decode "
                f"pools must share the paging granule")
        n_written = (p - 1) // self.block_size + 1
        if len(blob["payload"]) != n_written:
            raise ValueError(
                f"handoff payload has {len(blob['payload'])} blocks, "
                f"expected {n_written} for a {p}-token prompt")
        if p + max_new > self.max_len:
            raise ValueError(
                f"handoff prompt {p} + max_new_tokens {max_new} "
                f"exceeds cache max_len {self.max_len}")
        if self._blocks_for(p, max_new) > self.cache_blocks:
            raise ValueError(
                f"handoff footprint {self._blocks_for(p, max_new)} "
                f"blocks exceeds cache blocks {self.cache_blocks}")
        self._check_payload(blob["payload"], self.cache, "payload")
        if self._draft_alloc is not None:
            if blob.get("draft_payload") is None:
                raise ValueError(
                    "draft-spec engine needs the handoff's draft-pool "
                    "blocks (prefill engine must run the same spec)")
            if self._blocks_for(p, max_new) > self.draft_cache_blocks:
                raise ValueError(
                    "handoff footprint exceeds draft cache blocks "
                    f"{self.draft_cache_blocks}")
            if len(blob["draft_payload"]) != n_written:
                raise ValueError(
                    f"handoff draft payload has "
                    f"{len(blob['draft_payload'])} blocks, expected "
                    f"{n_written} for a {p}-token prompt")
            self._check_payload(blob["draft_payload"], self.draft_cache,
                                "draft payload")
        host = blob.get("kv_host")
        if host is not None:
            need = _block_layout(self._handoff_pools(n_written, True),
                                 self._head_ranks)[1]
            if not (isinstance(host, torch.Tensor)
                    and host.dtype == torch.uint8 and host.dim() == 1
                    and host.device.type == "cpu" and host.numel() >= need):
                raise ValueError(
                    f"handoff kv_host must be a flat uint8 host tensor of "
                    f">= {need} bytes laid out by handoff_buffer")
        priority = int(blob.get("priority", 0))
        if not 0 <= priority < self.priority_classes:
            raise ValueError(
                f"handoff priority {priority} outside "
                f"[0, {self.priority_classes})")
        # on a mesh the tick header carries each queued import's digest:
        # a rank given another blob makes every rank raise
        digest = 0 if self.mesh is None else _blob_digest(blob)
        with self._lock:
            rid = self._rid
            self._rid += 1
            self._out[rid] = collections.deque()
            self._imports.append((rid, blob))
            self._import_rids[rid] = digest
            self._class_counter(priority)["submitted"] += 1
            self._recorder.on_submit(rid, p)
        return rid

    def _admit_imports(self) -> bool:
        """Move queued imports into free slots (FIFO), ahead of pending
        admissions: an import's prefill is already paid for on another
        engine. Under block pressure an import preempts strictly
        lower-class active streams, as `_admit_or_preempt` does."""
        did = False
        while self._imports:
            rid, blob = self._imports[0]
            free = next((i for i, s in enumerate(self._slots)
                         if s.phase == "idle"), None)
            if free is None:
                break
            if not self._try_import(free, rid, blob):
                victim = self._pick_victim(int(blob.get("priority", 0)))
                if victim is None:
                    break
                self._preempt(victim, "import-pressure")
                continue
            self._imports.popleft()
            del self._import_rids[rid]
            did = True
        return did

    def _try_import(self, slot_idx: int, rid: int, blob: dict) -> bool:
        """Install one handoff into a slot: share the radix tree's full
        prompt blocks by reference (same ``params_version`` only: blocks
        of other weights would splice stale context in), scatter the rest
        of the transferred blocks into fresh ones (`_blocks_to_device`)
        and a fresh draft-pool footprint, and enter the decode phase at
        the parked first token. No copy-on-write: a match that ends
        mid-block re-scatters that block from the payload. Returns False,
        leaving the import queued, when the pool cannot supply the
        footprint even after eviction."""
        bs = self.block_size
        prompt = np.asarray(blob["prompt"], np.int32).reshape(-1)
        p = prompt.size
        max_new = int(blob["max_new_tokens"])
        total = self._blocks_for(p, max_new)
        payload = blob["payload"]
        n_written = len(payload)
        try:
            _faults.check("engine.alloc")
        except _faults.FaultInjected:
            return False
        if self._draft_alloc is not None and self._draft_alloc.free < total:
            return False
        same_version = int(blob["params_version"]) == self._params_version
        blocks, matched = ([], 0)
        if self._tree is not None and same_version:
            blocks, matched = self._tree.match(prompt)
        n_full = min(matched // bs, n_written)
        for b in blocks[:n_full]:
            self._alloc.ref(b)
        fresh_needed = total - n_full
        if self._alloc.free < fresh_needed and self._tree is not None:
            self._evicted_blocks += self._tree.evict(
                fresh_needed - self._alloc.free)
        if self._alloc.free < fresh_needed:
            for b in blocks[:n_full]:
                self._alloc.decref(b)
            return False
        fresh = [self._alloc.alloc() for _ in range(fresh_needed)]
        slot_blocks = blocks[:n_full] + fresh
        t0 = time.perf_counter()
        pools = [(self.cache, payload, n_full,
                  slot_blocks[n_full:n_written])]
        dblocks = []
        if self._draft_alloc is not None:
            dblocks = [self._draft_alloc.alloc() for _ in range(total)]
            pools.append((self.draft_cache, blob["draft_payload"], 0,
                          dblocks[:n_written]))
        self._blocks_to_device(pools, blob.get("kv_host"))
        scattered = sum(len(ids) for _, _, _, ids in pools)
        table = np.zeros((self.max_blocks,), np.int32)
        table[:len(slot_blocks)] = slot_blocks
        s = self._slots[slot_idx]
        s.rid, s.phase = rid, "decode"
        s.prompt, s.filled = prompt, p
        s.blocks, s.table = slot_blocks, table
        s.order = self._admit_seq
        self._admit_seq += 1
        s.temperature, s.eos_id = float(blob["temperature"]), blob["eos_id"]
        s.remaining = max_new - 1
        s.pos = p
        s.token, s.token_logp = int(blob["token"]), float(blob["token_logp"])
        s.token_ver = int(blob["token_ver"])
        s.submit_ts = time.perf_counter()
        s.priority = int(blob.get("priority", 0))
        # resumed: the prefill engine counted this stream's TTFT
        s.resumed = True
        s.emitted = []
        s.history = prompt.tolist() if self.spec == "ngram" else []
        if dblocks:
            s.draft_blocks = dblocks
            s.draft_table = np.zeros((self.max_blocks,), np.int32)
            s.draft_table[:total] = dblocks
            s.draft_filled = p
        # Version trust: a same-version import's prompt blocks are as
        # publishable as a local prefill's; a cross-version one's never
        # are (its K/V predates the current weights), nor on preemption.
        if same_version:
            s.version = self._params_version
            if self._tree is not None and p >= bs:
                self._tree.insert(prompt, slot_blocks)
        else:
            s.version = self._params_version - 1
        dt = time.perf_counter() - t0
        kv_bytes = int(blob.get("kv_bytes", 0))
        self._imports_completed += 1
        self._kv_blocks_imported += scattered
        self._kv_import_bytes += kv_bytes
        self._kv_import_s.append(dt)
        self._prefix_hit_tokens += n_full * bs
        self._prompt_tokens += p
        self._recorder.on_kv_import(rid, scattered, kv_bytes, dt)
        self._recorder.on_admit(rid, n_full * bs, False)
        # The parked first token goes out through the normal emit path
        # with the logprob and version the prefill engine computed; a
        # max_new_tokens=1 request retires right here.
        self._emit(s, slot_idx, s.token, s.token_logp, s.token_ver)
        return True

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
        the new ``params_version``. On a mesh (every rank calls it) a
        tree of whole leaves is cut to each rank's blocks, and a model
        built on the same mesh (a learner's) gives its blocks as they
        are."""
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

    @torch.no_grad()
    def _placed(self, model: gpt.GPT, cfg: gpt.GPTConfig, new_params,
                what: str) -> list:
        """``(engine leaf, new leaf)`` pairs for a swap into ``model``:
        ``new_params`` placed on the engine's device in the dtype the
        model holds (on a mesh: cut to the rank's blocks), quantized on an
        int8-weight config unless it is an int8 tree already, and checked
        leaf for leaf in name, shape and dtype."""
        tree = (gpt.param_tree(new_params)
                if isinstance(new_params, gpt.GPT) else new_params)
        placed = gpt.GPT(cfg, tree, device=self.device,
                         dtype=model.embed.dtype, mesh=model.mesh,
                         rules=model.rules)
        if cfg.weight_dtype == "int8" and not placed.quantized:
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
        total = self._slot_blocks_for(p, req.max_new_tokens)
        # fault site: 'fail' reads as allocator exhaustion, the admission
        # refused as if the pool had no free blocks (it drives the
        # preemption path and never reaches the consumer)
        try:
            _faults.check("engine.alloc")
        except _faults.FaultInjected:
            return False
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
            self._evicted_blocks += self._tree.evict(
                fresh_needed - self._alloc.free)
        if self._alloc.free < fresh_needed:
            for b in blocks:
                self._alloc.decref(b)
            return False
        fresh = [self._alloc.alloc() for _ in range(fresh_needed)]
        slot_blocks = blocks[:n_full] + fresh
        if partial:
            # Copy-on-write: the matched prefix ends inside a shared
            # block this request will write into. The copy is queued on
            # the stream the steps replay on, after every earlier write
            # and before this slot's first chunk.
            src, dst = blocks[n_full], fresh[0]
            gpt.copy_block(self.cache, src, dst)
            self._mesh_copies.append((src, dst))
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
        s.version = self._params_version
        s.priority = req.priority
        s.resumed = req.resumed
        s.emitted = []
        if req.resumed:
            # the blocks' worth of K/V this resume recomputes (the radix
            # match covered the rest)
            self._reprefill_blocks += -(-(p - matched) // bs)
        s.history = req.prompt.tolist() if self.spec == "ngram" else []
        if self._draft_alloc is not None:
            s.draft_blocks = [self._draft_alloc.alloc() for _ in range(total)]
            s.draft_table = np.zeros((self.max_blocks,), np.int32)
            s.draft_table[:total] = s.draft_blocks
            s.draft_filled = 0
        self._prefix_hit_tokens += matched
        self._prompt_tokens += p
        self._recorder.on_admit(req.rid, matched, partial)
        return True

    def _admission_order(self) -> list[_Pending]:
        """The pending queue in class-aware admission order: a stride
        scheduler over the backlogged classes with weight
        ``priority_weight_base ** class`` (class c + 1 gets base times
        class c's share; every backlogged class keeps a share), after
        the requests older than their aging bound,
        ``(priority_classes - class) * priority_aging_s``, oldest first.
        Within a class the order is FIFO."""
        # on a mesh the first rank's clock, the same on every rank
        now = (self._mesh_clock if self.mesh is not None
               else time.perf_counter())
        aged: list[_Pending] = []
        backlog: dict[int, collections.deque] = {}
        for req in self._pending:
            bound = (self.priority_classes - req.priority) \
                * self.priority_aging_s
            if now - req.ts > bound:
                if not req.aged:
                    req.aged = True
                    self._aging_promotions += 1
                aged.append(req)
            else:
                backlog.setdefault(req.priority,
                                   collections.deque()).append(req)
        aged.sort(key=lambda r: (r.ts, r.rid))
        order = aged
        # A class entering the backlog starts at the current pass floor,
        # so it cannot claim credit for the time it was idle.
        floor = max(self._class_pass.values(), default=0.0)
        for c in backlog:
            self._class_pass.setdefault(c, floor)
        sim = dict(self._class_pass)
        while backlog:
            c = min(backlog, key=lambda k: (sim[k], -k))
            order.append(backlog[c].popleft())
            sim[c] += 1.0 / (self.priority_weight_base ** c)
            if not backlog[c]:
                del backlog[c]
        return order

    def _pick_victim(self, below: int) -> int | None:
        """The preemption victim: the active slot of the lowest class
        strictly below ``below``, the latest admitted on a tie (least
        progress: the cheapest re-prefill)."""
        best = None
        for i, s in enumerate(self._slots):
            if not s.active or s.priority >= below:
                continue
            if best is None or (s.priority, -s.order) < (
                    self._slots[best].priority, -self._slots[best].order):
                best = i
        return best

    def _preempt(self, slot_idx: int, why: str):
        """Evict one active stream: publish its written blocks to the
        radix tree (the resume admits them by reference), release the
        slot, and requeue prompt + emitted at the front as a re-prefill
        under the same rid and output queue, so the consumer sees one
        stream. The resume recomputes only the K/V past the published
        full blocks, with the prefill path: in f32 it matches the K/V
        decode wrote to summation order, so a greedy stream resumes with
        the same tokens."""
        s = self._slots[slot_idx]
        seq = s.prompt.tolist() + s.emitted
        # K/V written so far: seq[:pos] in decode (the parked last token
        # is sampled but not written yet), prompt[:filled] mid-prefill
        written = s.pos if s.phase == "decode" else s.filled
        if self._tree is not None and written >= self.block_size \
                and s.version == self._params_version:
            self._tree.insert(seq[:written], s.blocks)
        resume = _Pending(s.rid, np.asarray(seq, np.int32), s.remaining,
                          s.temperature, s.eos_id, s.submit_ts,
                          priority=s.priority, resumed=True)
        self._preemptions += 1
        self._class_counter(s.priority)["preemptions"] += 1
        logger.info("engine %s: preempted rid=%d class=%d (%s) after %d "
                    "tokens", self.name, s.rid, s.priority, why,
                    len(s.emitted))
        self._recorder.on_finish(s.rid, f"preempted:{why}")
        self._release(slot_idx)
        self._pending.appendleft(resume)

    def _force_preempt(self) -> bool:
        """Fault-injected preemption (site ``engine.preempt``): evict the
        lowest-class active stream whatever the pressure."""
        victim = self._pick_victim(self.priority_classes)
        if victim is None:
            return False
        self._preempt(victim, "forced")
        return True

    def _admit_or_preempt(self, req: _Pending) -> bool:
        """Admit one request, preempting strictly lower-class active
        streams while the block pool cannot serve it. No free slot
        defers instead of preempting: the stride order already decided
        who gets the slots. Bounded: each retry removes one victim."""
        free = next((i for i, s in enumerate(self._slots)
                     if s.phase == "idle"), None)
        if free is None:
            return False
        while not self._try_admit(free, req):
            victim = self._pick_victim(req.priority)
            if victim is None:
                return False
            self._preempt(victim, "block-pressure")
        return True

    def _admit_pending(self) -> bool:
        """Move pending requests into free slots in `_admission_order`.
        A request whose first block of tokens matches an in-flight
        prefill's is deferred one tick: once that prefill completes and
        its full blocks enter the radix tree, the latecomer admits by
        reference instead of prefilling the shared prefix again. When a
        request fails admission even after preemption, strictly lower
        classes are locked out for the rest of the tick, so freed blocks
        accrue to the blocked class."""
        if not self._pending:
            return False
        bs = self.block_size
        heads = set()
        if self._tree is not None:
            heads = {tuple(s.prompt[:bs].tolist()) for s in self._slots
                     if s.phase == "prefill" and s.prompt.size >= bs}
        order = self._admission_order()
        # Preemptions in the loop put their resumes at the front of the
        # emptied queue (admitted next tick); deferred requests follow.
        self._pending = collections.deque()
        admitted, keep = False, []
        blocked_pri: int | None = None
        for req in order:
            head = (tuple(req.prompt[:bs].tolist())
                    if req.prompt.size >= bs else None)
            if head is not None and head in heads \
                    and self._tree is not None:
                keep.append(req)
                continue
            if blocked_pri is not None and req.priority < blocked_pri:
                keep.append(req)
                continue
            if self._admit_or_preempt(req):
                admitted = True
                self._class_pass[req.priority] = \
                    self._class_pass.get(req.priority, 0.0) \
                    + 1.0 / (self.priority_weight_base ** req.priority)
                if head is not None:
                    heads.add(head)
            else:
                keep.append(req)
                if blocked_pri is None or req.priority > blocked_pri:
                    blocked_pri = req.priority
        self._pending.extend(keep)
        # a class with no backlog left banks no credit
        live = {q.priority for q in self._pending}
        for c in [c for c in self._class_pass if c not in live]:
            del self._class_pass[c]
        return admitted

    # ------------------------------------------------------------------
    # static steps
    # ------------------------------------------------------------------

    def _step(self, kind: str, bucket: int | None = None) -> _StaticStep:
        """The static step of ``kind`` ("decode", "verify", "draft",
        "prefill" or "draft_prefill", the last two per chunk
        ``bucket``), built at its first use."""
        step = self._steps.get((kind, bucket))
        if step is None:
            step = self._steps[(kind, bucket)] = self._build_step(kind,
                                                                  bucket)
        return step

    def _build_step(self, kind: str, bucket: int | None) -> _StaticStep:
        b, mb = self.num_slots, self.max_blocks
        i32, f32 = np.int32, np.float32
        if kind in ("prefill", "draft_prefill"):
            spec = dict(tokens=((1, bucket), i32), table=((mb,), i32),
                        start=((1,), i32), length=((1,), i32))
            if kind == "prefill":
                spec["temp"] = ((1,), f32)
            fn = (self._prefill_fn if kind == "prefill"
                  else self._draft_prefill_fn)
            return _StaticStep(self, kind + "_traces",
                               _Staging(self.device, **spec), fn)
        if kind == "decode":
            return _StaticStep(self, "decode_traces", _Staging(
                self.device, tokens=((b,), i32), pos=((b,), i32),
                tables=((b, mb), i32), temps=((b,), f32)), self._decode_fn)
        # verify and draft share the spec tick's inputs: the draft step
        # writes its proposal into the window that verify reads
        if self._spec_in is None:
            spec = dict(window=((b, self.spec_window), i32),
                        pos=((b,), i32), tables=((b, mb), i32),
                        temps=((b,), f32))
            if self.spec == "draft":
                spec["dtables"] = ((b, mb), i32)
            self._spec_in = _Staging(self.device, **spec)
        fn = self._verify_fn if kind == "verify" else self._draft_fn
        return _StaticStep(self, kind + "_traces", self._spec_in, fn)

    def _decode_fn(self, i):
        logits, _ = gpt.decode_step_paged(self.model, i["tokens"], self.cache,
                                          i["pos"], i["tables"], self.cfg)
        return self._sample(logits, i["temps"])

    def _prefill_fn(self, i):
        logits, _ = gpt.prefill_paged(
            self.model, i["tokens"], self.cache, self.cfg,
            block_table=i["table"], start=i["start"], length=i["length"])
        return self._sample(logits, i["temp"])

    def _draft_prefill_fn(self, i):
        gpt.prefill_paged(self.draft_model, i["tokens"], self.draft_cache,
                          self.draft_cfg, block_table=i["table"],
                          start=i["start"], length=i["length"])

    def _draft_fn(self, i):
        """The draft model's proposal written into the verify window's
        draft columns, on the device."""
        window = self._draft_propose(i["window"][:, 0], i["pos"],
                                     i["dtables"], i["temps"])
        i["window"][:, 1:].copy_(window[:, 1:])

    def _verify_fn(self, i):
        """The verify forward and the accept rule: tokens, logprobs (f32
        bits) and accepted counts as one [B, 2W + 1] int32 tensor, so
        the host fetches them in one copy."""
        logits, _ = gpt.verify_step_paged(self.model, i["window"], self.cache,
                                          i["pos"], i["tables"], self.cfg)
        out, out_lp, acc = accept_drafts(logits, i["window"], i["temps"],
                                         self._gen)
        return torch.cat([out.int(), out_lp.contiguous().view(torch.int32),
                          acc[:, None].int()], dim=1)

    def _draw(self, logits, temps):
        """One token per row of ``logits [B, V]``: the argmax for rows
        with temperature 0, a draw from softmax(logits / T) for rows with
        T > 0. Every row draws, so one static step serves greedy and
        sampled rows alike; the argmax rows do not depend on the draw."""
        tok = torch.argmax(logits, dim=-1)
        safe = torch.where(temps > 0, temps, 1.0)
        return torch.where(temps > 0, _gumbel_argmax(
            logits / safe[:, None], self._gen), tok)

    def _sample(self, logits, temps):
        """One token per row (`_draw`) and its natural f32 logprob,
        returned as one [2, B] int32 tensor (logprob bits in row 1) so the
        host fetches both in one copy."""
        tok = self._draw(logits, temps)
        logp = torch.log_softmax(logits.float(), dim=-1).gather(
            1, tok[:, None])[:, 0]
        return torch.stack([tok.to(torch.int32),
                            logp.contiguous().view(torch.int32)])

    @staticmethod
    def _fetch(packed) -> tuple[np.ndarray, np.ndarray]:
        """The tick's one device->host copy (and sync)."""
        host = packed.cpu().numpy()
        return host[0], host[1].view(np.float32)

    def _chunk(self, kind: str, s: _Slot, done: int, table):
        """The next prefill chunk of ``s``'s prompt after ``done`` tokens
        staged on the device (one copy) for the static step ``kind`` of
        its chunk bucket: the tokens right-padded to the bucket, ``table``,
        start and length (and the slot's temperature for the target).
        Returns its length and the step."""
        clen = min(self.prefill_chunk, s.prompt.size - done)
        step = self._step(kind, self._chunk_bucket_for(clen))
        h = step.inputs.host
        h["tokens"][0] = 0
        h["tokens"][0, :clen] = s.prompt[done:done + clen]
        h["table"][:] = table
        h["start"][0], h["length"][0] = done, clen
        if "temp" in h:
            h["temp"][0] = s.temperature
        step.inputs.upload()
        return clen, step

    @torch.inference_mode()
    def _run_prefill_chunk(self, slot_idx: int):
        s = self._slots[slot_idx]
        if s.filled < s.prompt.size:
            t0 = time.perf_counter()
            clen, step = self._chunk("prefill", s, s.filled, s.table)
            tok, lp = self._fetch(step())
            dt = time.perf_counter() - t0
            self._prefill_time += dt
            self._recorder.on_prefill_chunk(
                s.rid, clen, self._chunk_bucket_for(clen), dt)
            self._prefill_tokens += clen
            self._prefill_chunks += 1
            s.filled += clen
            if s.filled == s.prompt.size:
                # parked, with the version it was computed under, until
                # the draft pool (if any) has the prompt too
                s.token, s.token_logp = int(tok[0]), float(lp[0])
                s.token_ver = self._params_version
        drafting = self.draft_model is not None
        if drafting and s.draft_filled < s.prompt.size:
            # The draft pool shares no prefixes, so it takes the whole
            # prompt, one chunk a tick beside the main chunk. No host
            # sync: stream order puts these writes before the first
            # proposal.
            t0 = time.perf_counter()
            clen, step = self._chunk("draft_prefill", s, s.draft_filled,
                                     s.draft_table)
            step()
            self._prefill_time += time.perf_counter() - t0
            s.draft_filled += clen
        if s.filled < s.prompt.size or (
                drafting and s.draft_filled < s.prompt.size):
            return
        # Prefill complete: publish the prompt's full blocks (decode
        # writes only past them, so they are immutable), join decode. A
        # slot admitted under older weights spanned a swap: its K/V mixes
        # two versions and stays out of the prefix cache.
        if self._tree is not None and s.prompt.size >= self.block_size \
                and s.version == self._params_version:
            self._tree.insert(s.prompt, s.blocks)
        if not s.resumed:
            # TTFT closes at the first token (a resumed stream delivered
            # its own before it was preempted; on a prefill-role engine
            # the decode side never counts it again)
            wait = time.perf_counter() + self._mesh_skew - s.submit_ts
            self._queue_waits.append(wait)
            self._class_waits[s.priority].append(wait)
            self._recorder.on_first_token(s.rid, wait)
        if self.role == "prefill":
            # the handoff: the written blocks go to host and the slot
            # frees; nothing decodes on this engine
            self._export_handoff(slot_idx)
            return
        s.phase = "decode"
        s.pos = s.prompt.size
        s.remaining -= 1
        self._emit(s, slot_idx, s.token, s.token_logp, s.token_ver)

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

    def _emit(self, s: _Slot, slot_idx: int, tok: int, logp: float,
              ver: int | None = None):
        """Route one generated token, stamped with ``ver`` (the version
        it was computed under; default ``params_version``); retire the
        slot when finished."""
        # fault site: 'kill' here dies between two tokens of a stream
        _faults.check("engine.emit")
        if self._swap_pending_ts is not None:
            # the first token after a swap closes weight_swap_ms's window
            self._last_swap_ms = (time.perf_counter()
                                  - self._swap_pending_ts) * 1e3
            self._swap_pending_ts = None
            self._recorder.on_swap_crossing(s.rid)
        self._out[s.rid].append(TokenEvent(
            tok, logp, self._params_version if ver is None else ver))
        s.emitted.append(int(tok))
        cc = self._class_counter(s.priority)
        cc["decode_tokens"] += 1
        self._recorder.on_token(s.rid)
        if self.spec == "ngram":
            s.history.append(tok)
        hit_eos = s.eos_id is not None and tok == s.eos_id
        # pos of the *next* token must still fit in the cache row
        if s.remaining <= 0 or hit_eos or s.pos + 1 >= self.max_len:
            self._done.add(s.rid)
            cc["completed"] += 1
            self._release(slot_idx)
            self._recorder.on_finish(s.rid, "finished")

    def step(self) -> bool:
        """One scheduler tick: admit queued imports, then pending requests,
        into free slots (preempting lower classes under block pressure),
        run at most one
        prefill chunk if anything is decoding (all pending prefill work
        otherwise), then one decode step for every resident sequence.
        Returns True if any device work happened."""
        with self._lock:
            t_tick = time.perf_counter()
            # the watchdog's window: seq first, then the start, cleared
            # in the finally (a failed tick must not read as stuck)
            self._tick_seq += 1
            self._tick_started = t_tick
            try:
                if self.mesh is not None:
                    self._agree_tick()
                # fault site: 'fail' reaches the pumping consumer as
                # FaultInjected; 'delay' wedges the tick (the watchdog's
                # case)
                _faults.check("engine.tick")
                # fault site: 'fail' preempts the lowest-class active
                # stream this tick (absorbed: the consumer sees the resume)
                try:
                    _faults.check("engine.preempt")
                except _faults.FaultInjected:
                    self._force_preempt()
                had_decoders = any(s.phase == "decode" for s in self._slots)
                imported = self._admit_imports()
                admitted = self._admit_pending() or imported
                chunked = self._prefill_tick(had_decoders)
                if had_decoders and (admitted or chunked):
                    self._max_admission_stall = max(
                        self._max_admission_stall,
                        time.perf_counter() - t_tick)
                self._occupancy.append(
                    sum(s.active for s in self._slots) / self.num_slots)
                self._block_util.append(
                    self._alloc.used / max(self.cache_blocks, 1))
                decoding = [i for i, s in enumerate(self._slots)
                            if s.phase == "decode"]
                if not decoding:
                    self._sentinel.check()
                    return admitted or chunked
                if self.spec is not None:
                    self._spec_tick(decoding)
                else:
                    self._decode_tick(decoding)
                self._sentinel.check()
                return True
            finally:
                self._tick_started = None

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
        step = self._step("decode")
        h = step.inputs.host
        h["tokens"][:], h["pos"][:] = tokens, pos
        h["tables"][:], h["temps"][:] = tables, temps
        step.inputs.upload()
        nxt, lps = self._fetch(step())
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

    def _draft_propose(self, tok, pos, tables, temps):
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
                window.append(self._draw(logits, temps))
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
        t0 = time.perf_counter()
        if self.spec == "draft":
            if not worth:
                self._decode_tick(decoding)
                return
            proposed = set(worth)
            draft = self._step("draft")
            h = draft.inputs.host
            h["window"][:, 0] = tokens     # drafts: written on the device
            h["dtables"][:] = self._batch_arrays("draft_table")[2]
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
            h = self._step("verify").inputs.host
            h["window"][:] = tokens[:, None]
            for i, prop in proposals.items():
                h["window"][i, 1:] = (prop + [prop[-1]] * (w - 1))[:w - 1]
        h["pos"][:], h["tables"][:], h["temps"][:] = pos, tables, temps
        self._spec_in.upload()
        if self.spec == "draft":
            draft()
        # the tick's one device->host copy (and sync)
        host = self._step("verify")().cpu().numpy()
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
        """Drive the scheduler until every submitted request (and every
        queued import) finished."""
        while True:
            with self._lock:
                if not (self._pending or self._imports
                        or any(s.active for s in self._slots)):
                    if self.mesh is not None:
                        self._agree_idle()
                    return
                self.step()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def check_invariants(self):
        """Allocator/tree/slot cross-checks: every allocated block is
        accounted for by exactly its holders, and every request lives in
        exactly one place with an output queue (a queued import in the
        import queue, a parked handoff nowhere but there). An int8 pool's scale
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
        # After any preempt -> resume -> cancel interleaving a request
        # lives in one place, and a shed request only in the error queue.
        for rid in self._errors:
            assert rid in self._out, f"errored rid {rid} has no queue"
            assert rid not in set(pend_rids) | set(slot_rids), \
                f"errored rid {rid} still scheduled"
        # Disaggregation registries: a queued import owns an output queue
        # and is scheduled nowhere else yet; a parked handoff's slot and
        # queue went at export, so its rid appears nowhere else.
        import_rids = {irid for irid, _ in self._imports}
        assert import_rids == set(self._import_rids), \
            f"import registry drift: {import_rids} != {self._import_rids}"
        assert not import_rids & (set(pend_rids) | set(slot_rids)), \
            "import rid also pending/active"
        for irid in import_rids:
            assert irid in self._out, f"import rid {irid} has no queue"
        handoff_rids = set(self._handoffs)
        assert not handoff_rids & (set(pend_rids) | set(slot_rids)
                                   | import_rids), \
            "handoff rid still scheduled"
        for hrid in handoff_rids:
            assert hrid not in self._out, \
                f"handoff rid {hrid} still owns an output queue"
        owners = set(pend_rids) | set(slot_rids) | self._done \
            | set(self._errors) | import_rids
        for rid in self._out:
            assert rid in owners, f"orphaned output queue for rid {rid}"
        for q in self._pending:
            assert 0 <= q.priority < self.priority_classes
            assert q.max_new_tokens >= 1, \
                f"rid {q.rid} requeued with no token budget"

    def reset_stats(self):
        """Zero the throughput/latency accounting (benches call this after
        warmup), the speculative counters, the ``swaps`` counter and
        ``weight_swap_ms``, and the pressure counters (sheds, watchdog
        stalls, preemptions, re-prefilled blocks, aging promotions, the
        per-class rows, zeroed in place) and the handoff counters and
        windows. Not reset: ``params_version``, the trace counters (the
        block gather's and scatter's among them), ``retraces_unexpected`` and
        ``graph_pool_bytes`` (identities and counts of the engine's life,
        not rates) and the kernels' launch counters."""
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
            self._prefix_hit_tokens = self._prompt_tokens = 0
            self._cow_copies = self._evicted_blocks = 0
            self._cancelled = 0
            self._max_admission_stall = 0.0
            self._sheds = self._watchdog_stalls = 0
            self._preemptions = self._reprefill_blocks = 0
            self._aging_promotions = 0
            self._handoffs_exported = self._imports_completed = 0
            self._handoffs_abandoned = 0
            self._kv_blocks_exported = self._kv_blocks_imported = 0
            self._kv_export_bytes = self._kv_import_bytes = 0
            self._kv_export_s = collections.deque(maxlen=256)
            self._kv_import_s = collections.deque(maxlen=256)
            self._step_times = collections.deque(maxlen=512)
            self._occupancy = collections.deque(maxlen=512)
            self._block_util = collections.deque(maxlen=512)
            self._tok_window = collections.deque(maxlen=512)
            self._queue_waits = collections.deque(maxlen=512)
            # admitted slots append to _class_waits by class, so the rows
            # are zeroed, not dropped
            for cc in self._per_class.values():
                for k in cc:
                    cc[k] = 0
            for w in self._class_waits.values():
                w.clear()

    def stats(self) -> dict:
        """Engine accounting since `reset_stats`:

        ``slots`` / ``active`` / ``pending`` — slot capacity, occupied
        slots, queued requests (resumes included); ``queue_depth`` —
        the queued requests and queued imports, the autoscaler's demand
        signal.
        ``decode_steps`` (plain and
        speculative ticks), ``prefill_tokens`` / ``decode_tokens`` and
        ``prefill_time_s`` / ``decode_time_s`` (host wall time of each
        device call, ending in its sync; a draft prefill chunk's enqueue
        time counts as prefill);
        ``prefill_tok_s`` / ``decode_tok_s`` the rates (decode over a
        512-tick window); ``prefill_chunks``; ``slot_occupancy``;
        ``p50_token_latency_ms`` / ``p99_token_latency_ms`` decode step
        percentiles; ``ttft_ms_p50`` / ``ttft_ms_p99`` submit to first
        token, and ``queue_wait_ms_p50`` / ``queue_wait_ms_p99`` the same
        window under the autoscaler's names (a resumed stream counts
        once, at its first admission). Paged cache: ``block_size``,
        ``cache_blocks``, ``blocks_in_use``, ``blocks_free``,
        ``cached_prefix_blocks``, ``cache_block_utilization`` (the
        pool's mean utilization a tick), ``prefix_hit_tokens`` and
        ``prefix_hit_rate`` (over admitted prompt tokens),
        ``cow_copies``, ``evicted_blocks`` (cached prefixes evicted for
        an admission), ``cancelled``, ``max_admission_stall_ms`` (the
        longest admission and prefill work of a tick while anything
        decoded);
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
        (1.0 when spec is off).
        Compile-once: ``decode_traces``, ``prefill_traces`` (one per
        chunk bucket used), ``verify_traces``, ``draft_traces`` and
        ``draft_prefill_traces`` — builds of each static step (a CUDA
        graph capture on the card; never reset); ``retraces_unexpected``
        — builds beyond the sentinel's allowances
        (`arm_retrace_sentinel`); ``graph_pool_bytes`` — device bytes of
        the graphs' shared memory pool, read after the latest capture (0
        with no graph).
        ``kernel_launches`` — each paged-attention kernel wrapper's
        launch counter (process-wide, never reset here): launches made,
        eager ones and each graph's captured launches once a replay.
        Scheduling under pressure: ``sheds`` (requests refused or shed
        from the queue with `OverloadedError`), ``watchdog_stalls``
        (ticks the watchdog saw overrun ``watchdog_s``),
        ``priority_classes``, ``preemptions`` (active streams evicted
        for a higher class or by the ``engine.preempt`` site),
        ``reprefill_blocks`` (blocks a resume prefilled again that the
        radix tree did not cover), ``aging_promotions`` (requests
        admitted ahead of the stride order by the aging bound) and
        ``per_class``: by class id (a string), ``submitted``,
        ``completed``, ``sheds``, ``preemptions`` and ``decode_tokens``
        since reset, ``pending`` and ``active`` now, and
        ``queue_wait_ms_p50`` / ``queue_wait_ms_p99`` over the class's
        last 256 first tokens.
        Disaggregation: ``role``; ``handoffs`` (blobs exported),
        ``imports`` (blobs installed in a slot), ``handoffs_abandoned``
        (parked blobs cancelled before collection), ``handoffs_pending``
        (blobs parked now), ``imports_queued`` (imports waiting for a
        slot now); ``kv_blocks_exported`` / ``kv_blocks_imported`` —
        blocks gathered to host / scattered into this engine's pools
        (shared prefix blocks are not scattered), ``kv_export_bytes`` /
        ``kv_import_bytes`` the host bytes (payload and int8 scales);
        ``kv_export_ms_p50`` / ``_p99`` the gather and its device-to-host
        copy to the sync, ``kv_import_ms_p50`` / ``_p99`` the staging and
        the queued copy and scatter (host time, not waited for), over
        the last 256 handoffs; ``kv_gather_traces`` /
        ``kv_scatter_traces`` — the first gather and scatter on each pool
        geometry (target, and a draft pool of other shapes): the port
        builds nothing for them, so these are the reference's traces
        counted by use, held to their caps by the sentinel.
        The port's own: ``captured`` (the steps replay CUDA graphs: on the
        card, off a mesh of more than one rank) and ``mesh`` (its axis
        sizes, or None)."""
        with self._lock:
            self._sentinel.check()
            times = sorted(self._step_times)
            waits = sorted(self._queue_waits)
            occ = list(self._occupancy)
            util = list(self._block_util)
            win_t = sum(dt for dt, _ in self._tok_window)
            win_toks = sum(n for _, n in self._tok_window)
            xms = sorted(self._kv_export_s)
            ims = sorted(self._kv_import_s)

            def pct(xs, p):
                if not xs:
                    return 0.0
                return xs[min(len(xs) - 1, int(p / 100 * len(xs)))] * 1e3

            pend_by = collections.Counter(q.priority for q in self._pending)
            act_by = collections.Counter(s.priority for s in self._slots
                                         if s.active)
            per_class = {}
            for c in sorted(set(self._per_class) | set(pend_by)
                            | set(act_by)):
                cw = sorted(self._class_waits.get(c, ()))
                per_class[str(c)] = {
                    **self._per_class.get(c, {}),
                    "pending": pend_by.get(c, 0),
                    "active": act_by.get(c, 0),
                    "queue_wait_ms_p50": pct(cw, 50),
                    "queue_wait_ms_p99": pct(cw, 99)}
            return {
                "slots": self.num_slots,
                "active": sum(s.active for s in self._slots),
                "pending": len(self._pending),
                "queue_depth": len(self._pending) + len(self._imports),
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
                "queue_wait_ms_p50": pct(waits, 50),
                "queue_wait_ms_p99": pct(waits, 99),
                "block_size": self.block_size,
                "cache_blocks": self.cache_blocks,
                "blocks_in_use": self._alloc.used,
                "blocks_free": self._alloc.free,
                "cached_prefix_blocks": (self._tree.n_blocks()
                                         if self._tree else 0),
                "cache_block_utilization": (sum(util) / len(util)
                                            if util else 0.0),
                "prefix_hit_rate": (
                    self._prefix_hit_tokens / self._prompt_tokens
                    if self._prompt_tokens else 0.0),
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "cow_copies": self._cow_copies,
                "evicted_blocks": self._evicted_blocks,
                "cancelled": self._cancelled,
                "max_admission_stall_ms": self._max_admission_stall * 1e3,
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
                "prefill_traces": self.prefill_traces,
                "decode_traces": self.decode_traces,
                "verify_traces": self.verify_traces,
                "draft_traces": self.draft_traces,
                "draft_prefill_traces": self.draft_prefill_traces,
                "retraces_unexpected": self._sentinel.retraces_unexpected,
                "graph_pool_bytes": self._graph_pool_bytes,
                "kernel_launches": da.kernel_launches(),
                "sheds": self._sheds,
                "watchdog_stalls": self._watchdog_stalls,
                "priority_classes": self.priority_classes,
                "preemptions": self._preemptions,
                "reprefill_blocks": self._reprefill_blocks,
                "aging_promotions": self._aging_promotions,
                "per_class": per_class,
                "role": self.role,
                "handoffs": self._handoffs_exported,
                "imports": self._imports_completed,
                "handoffs_abandoned": self._handoffs_abandoned,
                "handoffs_pending": len(self._handoffs),
                "imports_queued": len(self._imports),
                "kv_blocks_exported": self._kv_blocks_exported,
                "kv_blocks_imported": self._kv_blocks_imported,
                "kv_export_bytes": self._kv_export_bytes,
                "kv_import_bytes": self._kv_import_bytes,
                "kv_export_ms_p50": pct(xms, 50),
                "kv_export_ms_p99": pct(xms, 99),
                "kv_import_ms_p50": pct(ims, 50),
                "kv_import_ms_p99": pct(ims, 99),
                "kv_gather_traces": self.kv_gather_traces,
                "kv_scatter_traces": self.kv_scatter_traces,
                "captured": self._captures(),
                "mesh": None if self.mesh is None else dict(self.mesh.shape),
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
    ``seed + 1``. Deployed through `serve` (``serve.deployment(
    InferenceReplica).bind(...)``), the replica actor turns the generator
    into a ``next_chunks`` stream, so ``handle.stream(prompt)`` yields
    tokens as they are decoded."""

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
        # An explicit priority wins; otherwise the class stamped on this
        # request's context (`serve.priority`).
        if priority is None:
            priority = _prio.get_request_priority()
        rid = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                 temperature=temperature,
                                 priority=priority)
        return self.engine.tokens_for(rid)

    def cancel(self, rid: int) -> bool:
        return self.engine.cancel(rid)

    def update_params(self, new_params, *, draft_params=None) -> int:
        """Hot-swap weights into this replica's live engine (the serve
        path the flywheel publishes through); returns the new
        params_version."""
        return self.engine.update_params(new_params,
                                         draft_params=draft_params)

    def stats(self) -> dict:
        return self.engine.stats()
