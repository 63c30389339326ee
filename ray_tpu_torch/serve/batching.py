"""@serve.batch — transparent request batching: a copy of
`ray_tpu/serve/batching.py` (the port imports nothing of `ray_tpu`).

Counterpart of Ray Serve's `serve/batching.py` (`@serve.batch`): calls
from concurrent requests accumulate until max_batch_size or
batch_wait_timeout_s, then the wrapped function runs once on the list of
inputs and each caller gets its element back. It is what turns
request-at-a-time serving into device-shaped work: the card's tensor
cores want batched matmuls.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Callable, List, Optional


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self._queue: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="serve-batcher")
                self._thread.start()

    def _loop(self):
        while True:
            first = self._queue.get()
            batch = [first]
            # Accumulate until size or timeout, BLOCKING on the remaining
            # deadline each wait (the old loop spun on get(timeout=1ms),
            # burning a core and adding up to 1 ms of jitter per item).
            # A full batch falls out of the size check immediately; a
            # timed-out get ends the window without a timer thread.
            deadline = time.monotonic() + self.timeout
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            inputs = [item[0] for item in batch]
            events = [item[1] for item in batch]
            results = [item[2] for item in batch]
            try:
                outs = self.fn(inputs)
                if len(outs) != len(inputs):
                    raise ValueError(
                        f"@serve.batch function returned {len(outs)} "
                        f"results for {len(inputs)} inputs")
                for slot, out, ev in zip(results, outs, events):
                    slot.append(out)
                    ev.set()
            except Exception as e:
                for slot, ev in zip(results, events):
                    slot.append(e)
                    slot.append(None)     # marker: error in slot[0]
                    ev.set()

    def submit(self, item):
        self._ensure_thread()
        ev = threading.Event()
        slot: List = []
        self._queue.put((item, ev, slot))
        ev.wait()
        if len(slot) == 2:                # error marker
            raise slot[0]
        return slot[0]


# Batchers hold threads/locks and therefore must NOT be captured in the
# decorated wrapper's closure or referenced-globals set: deployments are
# cloudpickled to replicas, and cloudpickle serializes __main__-module
# wrappers BY VALUE together with every module global they name. All
# state lives behind _dispatch (an importable global, pickled by
# reference); batchers are created lazily per process.
import weakref

_FN_BATCHERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_FN_LOCK = threading.Lock()


def _dispatch(f, wrapper, cfg, args):
    max_batch_size, batch_wait_timeout_s = cfg
    if len(args) == 2:          # bound method: (self, item)
        owner, item = args
        attr = f"_serve_batcher_{f.__name__}"   # one batcher PER method
        b = owner.__dict__.get(attr)
        if b is None:
            b = _Batcher(functools.partial(f, owner),
                         max_batch_size, batch_wait_timeout_s)
            setattr(owner, attr, b)
        return b.submit(item)
    (item,) = args              # plain function
    with _FN_LOCK:
        b = _FN_BATCHERS.get(wrapper)
        if b is None:
            b = _Batcher(f, max_batch_size, batch_wait_timeout_s)
            _FN_BATCHERS[wrapper] = b
    return b.submit(item)


def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: `fn(list_of_inputs) -> list_of_outputs` is called on
    accumulated batches; each caller passes/receives a single element."""

    def wrap(f):
        cfg = (max_batch_size, batch_wait_timeout_s)

        @functools.wraps(f)
        def inner(*args):
            return _dispatch(f, inner, cfg, args)

        return inner

    if fn is not None:
        return wrap(fn)
    return wrap
