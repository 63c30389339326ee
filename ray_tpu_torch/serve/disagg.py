"""Disaggregated prefill/decode serving: role-split replicas and the
KV-block stream between them, the port of `ray_tpu/serve/disagg.py`.

Colocating prefill (compute-bound, bursty) and decode (bandwidth-bound,
steady) on one engine lets a burst of long prompts steal decode ticks
from every active stream. Splitting the fleet keeps decode ticks pure
(the architecture of DistServe and Splitwise):

- `PrefillReplica` runs an `InferenceEngine(role="prefill")`: chunked
  prefill only, with the prompt's blocks alone. A request returns a
  small *handoff descriptor*; the finished KV blocks (payload and any
  int8 scale rows, block-aligned) stay parked on the replica as host
  arrays until the decode side pulls them over netaddr.
- `DecodeReplica` runs ``role="decode"``: it dials the prefill
  replica's block server, receives the blob's frames straight into one
  host buffer laid out as the engine imports it
  (`InferenceEngine.handoff_buffer`, pinned on the card), imports it
  into its own pool with `InferenceEngine.import_handoff` and serves the
  token stream from the first generated token the prefill engine
  already sampled: greedy token-identical to a colocated run. A plain
  prompt, or a descriptor whose blocks cannot be pulled, is prefilled
  locally.

Wire format per pulled handoff (one exchange per request):
  -> {"handoff_id": rid}                      (pickled)
  <- header: blob metadata + frame manifest   (pickled)
  <- one raw byte frame per payload array, manifest order
A manifest entry names each array's logical dtype: bf16 rows travel as
their uint16 bit patterns under the name "bfloat16", the bytes the
reference's ml_dtypes arrays put on the wire.

Every wait on a socket is bounded (`netaddr`: the dial, the handshake,
and each read and write give up after the channel's timeout); the block
server's threads poll with a timeout and end on `close` or once the
replica is gone, holding it only through a weak reference between
polls. They touch host arrays and sockets only, never a CUDA API.
`DecodeReplica`'s pull records the end-to-end handoff on its engine's
flight recorder (``on_handoff``), as the reference's does.

Not ported yet (ROADMAP A5, with the serve control plane): the
deployment-handle pairing `DisaggHandle` and ``serve.run_disagg``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import weakref
from multiprocessing import AuthenticationError

import numpy as np

from ray_tpu_torch._private import netaddr
from ray_tpu_torch.serve import priority as _prio
from ray_tpu_torch.serve.engine import InferenceReplica


def _np_frames(blob: dict):
    """Split a handoff blob into (meta, manifest, arrays): every array of
    the payload (and the draft payload) becomes one raw wire frame,
    described by a manifest entry ``(which, block, name, shape, dtype)``
    the receiver rebuilds it from; ``dtype`` is the logical dtype the
    blob's ``dtypes`` names (bf16 for the port's uint16 rows)."""
    meta = {k: v for k, v in blob.items()
            if k not in ("payload", "draft_payload", "prompt", "kv_host")}
    meta["prompt"] = [int(t) for t in np.asarray(blob["prompt"]).ravel()]
    meta["has_draft"] = blob.get("draft_payload") is not None
    names = blob.get("dtypes") or {}
    manifest, arrays = [], []
    for which in ("payload", "draft_payload"):
        logical = names.get(which) or {}
        for i, blk in enumerate(blob.get(which) or []):
            for name in sorted(blk):
                arr = np.ascontiguousarray(blk[name])
                manifest.append((which, i, name, arr.shape,
                                 logical.get(name, str(arr.dtype))))
                arrays.append(arr)
    meta["manifest"] = manifest
    return meta, manifest, arrays


def _blob_from_frames(meta: dict, frames: list) -> dict:
    """Inverse of `_np_frames`: the engine-shaped blob from the header and
    the received raw frames, any buffers (bf16 arrays as uint16, named in
    the rebuilt ``dtypes``)."""
    payload: dict[int, dict] = {}
    draft: dict[int, dict] = {}
    dtypes: dict[str, dict] = {}
    for (which, i, name, shape, dtype), buf in zip(meta["manifest"],
                                                   frames):
        carrier = np.uint16 if dtype == "bfloat16" else np.dtype(dtype)
        arr = np.frombuffer(buf, dtype=carrier).reshape(shape)
        (payload if which == "payload" else draft).setdefault(
            i, {})[name] = arr
        dtypes.setdefault(which, {})[name] = dtype
    blob = {k: v for k, v in meta.items()
            if k not in ("manifest", "has_draft")}
    blob["payload"] = [payload[i] for i in sorted(payload)]
    blob["draft_payload"] = ([draft[i] for i in sorted(draft)]
                             if meta["has_draft"] else None)
    blob["dtypes"] = {"payload": dtypes.get("payload", {}),
                      "draft_payload": dtypes.get("draft_payload")}
    return blob


_POLL_S = 0.2          # a block server thread's wait between checks


def _accept_loop(ref, sock, stop):
    """Accept pullers on the listening ``sock`` of the `PrefillReplica`
    behind the weakref ``ref``, each served on a thread of its own,
    until ``stop`` is set or the replica is gone; then close ``sock``.
    Holds the replica only while it registers a connection."""
    sock.settimeout(_POLL_S)
    try:
        while not stop.is_set() and ref() is not None:
            try:
                peer, _ = sock.accept()
            except TimeoutError:
                continue
            except OSError:
                return         # the listener is gone
            rep = ref()
            if rep is None or stop.is_set():
                peer.close()
                return
            t = threading.Thread(target=_serve_conn,
                                 args=(ref, peer, rep._authkey, stop),
                                 daemon=True, name="disagg-kv-conn")
            with rep._lock:
                rep._served = [x for x in rep._served
                               if x.is_alive()] + [t]
            del rep
            t.start()
    finally:
        sock.close()


def _serve_conn(ref, peer, authkey, stop):
    """One puller connection: the handshake, then any number of handoff
    pulls until EOF, ``stop``, or the replica behind ``ref`` is gone.
    Each pull pops the blob: a handoff streams out once."""
    try:
        conn = netaddr.serve(peer, authkey, PrefillReplica._IO_TIMEOUT_S)
    except (OSError, EOFError, AuthenticationError):
        return             # a peer that failed the handshake
    try:
        while not stop.is_set() and ref() is not None:
            if not conn.poll(_POLL_S):
                continue
            rid = int(conn.recv()["handoff_id"])
            rep = ref()
            if rep is None:
                return
            entry = rep._take(rid)
            del rep
            if entry is None:
                conn.send({"error": f"unknown handoff {rid} "
                                    "(expired or already pulled)"})
                continue
            meta, _, arrays = _np_frames(entry)
            conn.send(meta)
            for arr in arrays:
                conn.send_bytes(arr)
    except (EOFError, OSError):
        pass
    finally:
        conn.close()


class PrefillReplica:
    """A prefill-role engine plus the netaddr block server the decode side
    pulls finished KV from.

    `__call__` runs the chunked prefill to completion and returns a
    handoff *descriptor*, small enough for a control plane, with the dial
    address of this replica's block server. The KV blob itself stays
    parked here until exactly one decode replica streams it out (or the
    park TTL reaps it, so an abandoned descriptor cannot pin host memory).
    Construction takes `InferenceReplica`'s arguments; `close` stops the
    server. The server's threads hold the replica only through a weak
    reference, so a replica dropped without `close` is freed all the
    same, its threads end within a poll and close their sockets
    (``__del__`` is that backstop)."""

    _PARK_TTL_S = 120.0
    _IO_TIMEOUT_S = 30.0   # a puller's handshake, and each later read/write
    _JOIN_S = 5.0          # close's bound on each thread it joins

    def __init__(self, cfg_kwargs: dict | None = None, *,
                 slots: int = 4, max_len: int = 64, seed: int = 0,
                 engine_kwargs: dict | None = None, device=None):
        inner = InferenceReplica(cfg_kwargs, slots=slots, max_len=max_len,
                                 seed=seed,
                                 engine_kwargs={**(engine_kwargs or {}),
                                                "role": "prefill"},
                                 device=device)
        self.engine = inner.engine
        self._lock = threading.Lock()
        self._parked: dict[int, tuple[dict, float]] = {}
        self._served: list = []      # a thread per puller connection
        self._authkey = os.urandom(16)
        sock = netaddr.listener(("0.0.0.0", 0))
        self._addr = netaddr.bound_address(sock)
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=_accept_loop, args=(weakref.ref(self), sock, self._stop),
            daemon=True, name="disagg-kv-server")
        self._accept_thread.start()

    # -- request path -----------------------------------------------------

    def __call__(self, prompt, max_new_tokens: int = 8,
                 temperature: float = 0.0, priority: int | None = None):
        if priority is None:
            priority = _prio.get_request_priority()
        rid = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                 temperature=temperature,
                                 priority=priority)
        blob = self.engine.handoff_for(rid)
        now = time.time()
        with self._lock:
            stale = [r for r, (_, ts) in self._parked.items()
                     if now - ts > self._PARK_TTL_S]
            for r in stale:
                self._parked.pop(r, None)
            self._parked[rid] = (blob, now)
        return {
            "handoff_addr": self._addr,
            "handoff_key": self._authkey.hex(),
            "handoff_id": rid,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "priority": int(priority),
            "kv_bytes": int(blob["kv_bytes"]),
        }

    def _take(self, rid: int) -> dict | None:
        """Pop the parked blob of ``rid`` (the block server's pull)."""
        with self._lock:
            entry = self._parked.pop(rid, None)
        return None if entry is None else entry[0]

    # -- control surface --------------------------------------------------

    def cancel(self, rid: int) -> bool:
        with self._lock:
            parked = self._parked.pop(rid, None) is not None
        return self.engine.cancel(rid) or parked

    def update_params(self, new_params, *, draft_params=None) -> int:
        return self.engine.update_params(new_params,
                                         draft_params=draft_params)

    def stats(self) -> dict:
        out = self.engine.stats()
        with self._lock:
            out["handoffs_parked"] = len(self._parked)
        return out

    def close(self):
        """Stop the block server: the accept thread and every puller
        connection's thread see the stop within a poll, close their
        sockets and end; each join is bounded by ``_JOIN_S``. Parked
        blobs are dropped. Idempotent."""
        self._stop.set()
        self._accept_thread.join(timeout=self._JOIN_S)
        with self._lock:
            served, self._served = self._served, []
            self._parked.clear()
        for t in served:
            t.join(timeout=self._JOIN_S)

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()


class DecodeReplica:
    """A decode-role engine that resumes handoff descriptors: it streams
    the KV blob from the prefill replica's block server, imports it into
    its own pool and serves the tokens. It also takes a plain prompt
    (a full local prefill: the fallback path). Construction takes
    `InferenceReplica`'s arguments; `close` closes the pulled
    connections."""

    _PULL_TIMEOUT_S = 30.0   # the dial, and each read/write of a pull

    def __init__(self, cfg_kwargs: dict | None = None, *,
                 slots: int = 4, max_len: int = 64, seed: int = 0,
                 engine_kwargs: dict | None = None, device=None):
        inner = InferenceReplica(cfg_kwargs, slots=slots, max_len=max_len,
                                 seed=seed,
                                 engine_kwargs={**(engine_kwargs or {}),
                                                "role": "decode"},
                                 device=device)
        self.engine = inner.engine
        self._lock = threading.Lock()
        # serializes whole pull exchanges, dials included: a blocking
        # wire wait never runs under self._lock, which stats() needs
        # promptly
        self._pull_mu = threading.Lock()
        # (addr, key) -> connection, reused across pulls
        self._conns: dict = {}
        self._pull_s: collections.deque = collections.deque(maxlen=256)
        self._handoff_fallbacks = 0
        self._kv_pulled_bytes = 0
        self._kv_pull_s = 0.0

    def _pull_blob(self, desc: dict) -> dict:
        """One exchange with the descriptor's block server, on the
        connection to it (dialed on first use). A failed exchange closes
        its connection, which then holds a stream broken off mid-way."""
        key = (desc["handoff_addr"], bytes.fromhex(desc["handoff_key"]))
        # one exchange at a time: request/response pairs must not
        # interleave on the shared connection
        with self._pull_mu:
            with self._lock:
                conn = self._conns.get(key)
            if conn is None or conn.closed:
                conn = netaddr.client(key[0], key[1], self._PULL_TIMEOUT_S)
                with self._lock:
                    self._conns[key] = conn
            try:
                return self._exchange(conn, desc["handoff_id"])
            except BaseException:
                with self._lock:
                    self._conns.pop(key, None)
                conn.close()
                raise

    def _exchange(self, conn, rid) -> dict:
        """Request ``rid`` and rebuild its blob. Each frame lands in its
        slot of one `InferenceEngine.handoff_buffer` when the manifest
        matches this engine's pools, and the blob then carries that
        buffer as ``kv_host``; a frame without a slot (another geometry,
        which the import rejects) is read into its own array."""
        conn.send({"handoff_id": rid})
        meta = conn.recv()
        if "error" in meta:
            raise KeyError(meta["error"])
        host, views, dtypes = self.engine.handoff_buffer(
            int(meta["n_blocks"]), meta["has_draft"])
        frames, landed = [], 0
        for which, i, name, shape, dtype in meta["manifest"]:
            dst = views.get(which, {}).get(name)
            if (dst is not None and i < len(dst)
                    and tuple(shape) == dst.shape[1:]
                    and dtype == dtypes[which][name]):
                n = conn.recv_bytes_into(memoryview(dst[i]).cast("B"))
                if n != dst[i].nbytes:
                    raise ValueError(
                        f"handoff frame {which} {i} {name} holds {n} "
                        f"bytes, its manifest {dst[i].nbytes}")
                frames.append(dst[i])
                landed += 1
            else:
                frames.append(conn.recv_bytes())
        blob = _blob_from_frames(meta, frames)
        if landed == sum(v.shape[0] for d in views.values()
                         for v in d.values()):
            blob["kv_host"] = host
        return blob

    def __call__(self, request, max_new_tokens: int = 8,
                 temperature: float = 0.0, priority: int | None = None):
        if isinstance(request, dict) and "handoff_addr" in request:
            return self.resume_from(request)
        if priority is None:
            priority = _prio.get_request_priority()
        rid = self.engine.submit(request, max_new_tokens=max_new_tokens,
                                 temperature=temperature,
                                 priority=priority)
        return self.engine.tokens_for(rid)

    def resume_from(self, desc: dict):
        """Pull the descriptor's KV blob, import it, and return the token
        generator continuing at the first generated token. If the prefill
        replica is gone, silent or not a block server of this key (or the
        blob expired) between descriptor and pull, prefill the
        descriptor's prompt locally instead: greedy decoding makes that
        token-identical, without the transfer's savings."""
        t0 = time.perf_counter()
        try:
            blob = self._pull_blob(desc)
        except (KeyError, OSError, EOFError, AuthenticationError):
            with self._lock:
                self._handoff_fallbacks += 1
            rid = self.engine.submit(
                desc["prompt"],
                max_new_tokens=int(desc["max_new_tokens"]),
                temperature=float(desc["temperature"]),
                priority=int(desc.get("priority", 0)))
            return self.engine.tokens_for(rid)
        rid = self.engine.import_handoff(blob)
        dt = time.perf_counter() - t0
        with self._lock:
            self._pull_s.append(dt)
            self._kv_pulled_bytes += int(blob.get("kv_bytes", 0))
            self._kv_pull_s += dt
        # the end-to-end handoff (pull + import) on the flight recorder
        self.engine._recorder.on_handoff(rid, dt)
        return self.engine.tokens_for(rid)

    def cancel(self, rid: int) -> bool:
        return self.engine.cancel(rid)

    def update_params(self, new_params, *, draft_params=None) -> int:
        return self.engine.update_params(new_params,
                                         draft_params=draft_params)

    def stats(self) -> dict:
        """The engine's stats and the pulls': ``handoff_fallbacks``
        (descriptors prefilled locally), ``kv_pulled_bytes``,
        ``kv_transfer_gbps`` (pulled bytes over the pulls' wall time:
        pull, rebuild and queueing the import) and
        ``handoff_pull_ms_p50`` / ``_p99`` over the last 256 pulls."""
        out = self.engine.stats()
        with self._lock:
            pulls = sorted(self._pull_s)
            out["handoff_fallbacks"] = self._handoff_fallbacks
            out["kv_pulled_bytes"] = self._kv_pulled_bytes
            out["kv_transfer_gbps"] = (
                self._kv_pulled_bytes / max(self._kv_pull_s, 1e-9) / 1e9)
            out["handoff_pull_ms_p50"] = (
                pulls[len(pulls) // 2] * 1e3 if pulls else 0.0)
            out["handoff_pull_ms_p99"] = (
                pulls[min(len(pulls) - 1, int(len(pulls) * 0.99))] * 1e3
                if pulls else 0.0)
        return out

    def close(self):
        """Close every pulled connection. Idempotent."""
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()

    def __del__(self):
        try:
            self.close()
        except AttributeError:
            pass


def disagg_resume(args, kwargs, emitted):
    """The decode leg's failover policy (for a deployment handle's
    ``stream(..., failover=)``): the original submission was a handoff
    descriptor, so rebuild a plain prompt + emitted resubmission from the
    prompt the descriptor carries; a fresh decode replica prefills it
    locally and the spliced stream stays token-identical under greedy
    decoding. Returns None when the token budget is already spent."""
    desc = args[0]
    if not (isinstance(desc, dict) and "prompt" in desc):
        raise TypeError("disagg_resume needs a handoff descriptor")
    remaining = int(desc["max_new_tokens"]) - len(emitted)
    if remaining <= 0:
        return None
    prompt = list(desc["prompt"]) + [int(t) for t in emitted]
    return (prompt,), {"max_new_tokens": remaining,
                       "temperature": float(desc["temperature"]),
                       "priority": int(desc.get("priority", 0))}
