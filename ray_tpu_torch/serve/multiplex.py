"""Model multiplexing: many models per deployment, LRU-cached per replica;
a copy of `ray_tpu/serve/multiplex.py` (the port imports nothing of
`ray_tpu`).

Counterpart of Ray Serve's `serve/multiplex.py`
(`@serve.multiplexed` + `serve.get_multiplexed_model_id`): one
deployment serves N models; each replica lazily loads the models routed
to it and keeps at most `max_num_models_per_replica` resident (LRU).
Requests carry a model id via
``handle.options(multiplexed_model_id="m1").remote(...)``; the handle
routes a given model id to a stable replica (rendezvous hashing), so a
model's cache hits keep landing where it's already loaded.
"""

from __future__ import annotations

import contextvars
import threading
from collections import OrderedDict
from functools import wraps

# ContextVar, not threading.local: replica requests run as asyncio tasks
# interleaved on ONE event-loop thread, and each task carries its own
# context (the replica's sync-callable executor propagates it with
# copy_context)
_MODEL_ID: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_multiplexed_model_id", default="")

# Guards lazy creation of per-instance multiplex state (two first-ever
# requests racing the `_mux_cache is None` check would otherwise each
# build a cache and one set of loads would be orphaned).
_MUX_INIT_LOCK = threading.Lock()


def _mux_get(f, max_models: int, self, model_id: str):
    """Body of the multiplexed wrapper. Lives at module level so the
    decorated method's closure/referenced-globals stay free of lock
    objects: deployments are cloudpickled to replicas, and cloudpickle
    serializes test-/__main__-module classes BY VALUE together with
    every global their methods name (same rule as batching._dispatch) —
    a captured threading.Lock would make the deployment unpicklable."""
    # Lazy per-instance state; _mux_lock is assigned LAST so any thread
    # that sees it also sees the cache/in-flight dicts.
    if getattr(self, "_mux_lock", None) is None:
        with _MUX_INIT_LOCK:
            if getattr(self, "_mux_lock", None) is None:
                self._mux_cache = OrderedDict()
                self._mux_inflight = {}
                self._mux_lock = threading.Lock()
    # The load runs OUTSIDE the lock (it is the expensive part), but a
    # per-key in-flight event makes exactly one caller the loader; the
    # rest wait on the event and re-check the cache. Without it,
    # concurrent misses for the same id each loaded the model, and
    # eviction could close() a copy still in use by a loser.
    while True:
        with self._mux_lock:
            cache = self._mux_cache
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            event = self._mux_inflight.get(model_id)
            if event is None:
                event = threading.Event()
                self._mux_inflight[model_id] = event
                loading = True
            else:
                loading = False
        if not loading:
            event.wait()
            continue   # loaded (hit) or failed (become loader)
        try:
            model = f(self, model_id)
        except BaseException:
            with self._mux_lock:
                self._mux_inflight.pop(model_id, None)
            event.set()   # wake waiters; one of them retries
            raise
        with self._mux_lock:
            cache[model_id] = model
            cache.move_to_end(model_id)
            self._mux_inflight.pop(model_id, None)
            while len(cache) > max_models:
                _evicted_id, evicted = cache.popitem(last=False)
                close = getattr(evicted, "close", None)
                if callable(close):
                    try:
                        close()
                    except Exception:
                        pass
        event.set()
        return model


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the CURRENT request (reference:
    serve.get_multiplexed_model_id)."""
    return _MODEL_ID.get()


def _set_model_id(value: str):
    _MODEL_ID.set(value)


def multiplexed(func=None, *, max_num_models_per_replica: int = 3):
    """Decorator for the replica method that loads a model by id::

        @serve.deployment
        class ModelServer:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return load_model(model_id)      # expensive

            def __call__(self, x):
                model = self.get_model(serve.get_multiplexed_model_id())
                return model(x)

    The wrapped method becomes an LRU cache keyed by model id, scoped to
    the replica instance; evicted models with a ``__del__``/``close`` are
    released to the GC.
    """

    def wrap(f):
        @wraps(f)
        def cached(self, model_id: str):
            return _mux_get(f, max_num_models_per_replica, self,
                            model_id)

        cached.__ray_tpu_multiplexed__ = True
        return cached

    if func is not None:
        return wrap(func)
    return wrap
