"""The port's native shared-memory arena store
(`ray_tpu_torch/_private/native/store.cc`, built into
`ray_tpu_torch/_build/`), held to the units of `tests/test_native_store.py`
against the port's own build: create/seal visibility, zero-copy reads,
delete/coalescing, LRU eviction of unpinned objects, pin protection,
cross-process sharing, and the ObjectStore integration (arena-backed
descriptors end to end). Then what is the port's own: the library it
loads is its build (never the JAX package's ``libstore.so``), the store
says which backend it runs, ``RAY_TPU_DISABLE_NATIVE=1`` is the explicit
switch to the file store, and a failed build raises with the compiler's
error instead of falling back without a word.
"""

import multiprocessing as mp
import os
import sys

import numpy as np
import pytest

from ray_tpu_torch._private import native
from ray_tpu_torch._private.native.arena import Arena
from ray_tpu_torch._private.object_store import ObjectStore


@pytest.fixture
def arena(tmp_path):
    a = Arena.open(str(tmp_path), capacity=4 * 1024 * 1024)
    yield a
    a.close()


def test_create_seal_lookup(arena):
    buf = arena.create("obj_a", 100)
    assert buf is not None and len(buf) == 100
    buf[:3] = b"xyz"
    # invisible until sealed (plasma create->seal contract)
    assert arena.lookup("obj_a") is None
    assert not arena.contains("obj_a")
    assert arena.seal("obj_a")
    view = arena.lookup("obj_a")
    assert bytes(view[:3]) == b"xyz"
    assert view.readonly
    assert arena.contains("obj_a")


def test_duplicate_create_rejected(arena):
    assert arena.create("obj_d", 10) is not None
    assert arena.create("obj_d", 10) is None


def test_delete_frees_and_coalesces(arena):
    used0 = arena.stats()["used"]
    for i in range(8):
        arena.create(f"obj_{i}", 50_000)
        arena.seal(f"obj_{i}")
    for i in range(8):
        assert arena.delete(f"obj_{i}")
    assert arena.stats()["used"] == used0
    # freed space is reusable as one large block (coalescing)
    assert arena.create("obj_big", 350_000) is not None


def test_lru_eviction_unpinned_only(arena):
    cap = arena.stats()["capacity"]
    n = 0
    while True:
        buf = arena.create(f"obj_e{n}", 100_000)
        if buf is None:
            break
        arena.seal(f"obj_e{n}")
        n += 1
        if n > 200:
            break
    st = arena.stats()
    assert st["num_evictions"] > 0          # old ones were evicted to fit
    assert not arena.contains("obj_e0")     # LRU victim
    assert st["used"] <= cap


def test_pin_blocks_eviction(arena):
    arena.create("obj_pinned", 100_000)
    arena.seal("obj_pinned")
    assert arena.pin("obj_pinned", 1) == 1
    for i in range(100):
        if arena.create(f"obj_f{i}", 100_000) is None:
            break
        arena.seal(f"obj_f{i}")
    assert arena.contains("obj_pinned")
    assert arena.pin("obj_pinned", -1) == 0


def test_acquire_protects_live_views_from_delete(arena):
    buf = arena.create("obj_live", 50_000)
    buf[:4] = b"data"
    arena.seal("obj_live")
    view = arena.acquire("obj_live")          # reader pin
    assert arena.delete("obj_live")           # condemned, not freed
    # object invisible to new readers
    assert arena.lookup("obj_live") is None
    assert not arena.contains("obj_live")
    # but the pinned view's bytes must still be intact after new allocations
    for i in range(10):
        w = arena.create(f"obj_churn{i}", 50_000)
        if w is None:
            break
        w[:4] = b"XXXX"
        arena.seal(f"obj_churn{i}")
    assert bytes(view[:4]) == b"data"


def test_condemned_block_freed_on_release(arena):
    arena.create("obj_rel", 60_000)
    arena.seal("obj_rel")
    arena.pin("obj_rel", 1)                   # owner pin (put() path)
    view = arena.acquire("obj_rel")           # reader pin -> refcnt 2
    used_full = arena.stats()["used"]
    assert arena.pin("obj_rel", -1) == 1      # owner releases (delete path)
    assert arena.delete("obj_rel")            # reader remains -> condemned
    assert arena.stats()["used"] == used_full  # still allocated (reader)
    view.release()
    assert arena.pin("obj_rel", -1) == 0      # reader releases -> freed
    assert arena.stats()["used"] < used_full


def test_create_failure_cleanup_path(tmp_path):
    """put() must reclaim the reservation if serialization fails midway."""
    store = ObjectStore(str(tmp_path))
    assert store.backend == "native"

    class Evil:
        def __reduce__(self):
            raise RuntimeError("unpicklable")

    used0 = store._arena.stats()["used"]
    big = np.zeros(200_000, dtype=np.uint8)
    with pytest.raises(Exception):
        store.put("obj_evil", [big, Evil()])
    assert store._arena.stats()["used"] == used0
    store.close()


def test_payload_cacheline_alignment(arena):
    """Zero-copy numpy views get 64-byte-aligned buffers."""
    import ctypes
    for name, size in (("obj_al1", 100), ("obj_al2", 70_000)):
        buf = arena.create(name, size)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        assert addr % 64 == 0
        arena.seal(name)


def _crash_child_pins(session_dir):
    """Simulate a worker that pins objects then dies without releasing:
    owner pin on its own put, reader pin on another object, plus an
    unsealed create (crash mid-put)."""
    a = Arena.open(session_dir)
    a.create("obj_mine", 50_000)
    a.pin("obj_mine", 1)         # put-time owner pin
    a.seal("obj_mine")
    a.acquire("obj_theirs")      # reader pin
    a.create("obj_unsealed", 50_000)   # crash before seal
    os._exit(1)                  # no cleanup — hard crash


def test_release_all_reclaims_dead_process_pins(tmp_path):
    """A crashed client's pins are force-released (plasma disconnected-
    client analog): condemned blocks free, unsealed creations reclaim."""
    a = Arena.open(str(tmp_path), capacity=4 * 1024 * 1024)
    used0 = a.stats()["used"]
    buf = a.create("obj_theirs", 50_000)
    a.seal("obj_theirs")

    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_crash_child_pins, args=(str(tmp_path),))
    p.start()
    p.join(60)                   # child pins, then hard-exits
    child_pid = p.pid

    # Without reclamation both deletes would condemn forever.
    a.delete("obj_theirs")       # child reader pin -> condemned
    a.delete("obj_mine")         # child owner pin -> condemned
    assert a.stats()["used"] > used0
    touched = a.release_all(child_pid)
    assert touched >= 3          # reader pin + owner pin + unsealed create
    assert a.stats()["used"] == used0
    a.close()


def _xproc_child(session_dir, q):
    a = Arena.open(session_dir)
    v = a.lookup("obj_shared")
    q.put(bytes(v[:6]) if v is not None else None)
    a.close()


def test_cross_process_visibility(tmp_path):
    a = Arena.open(str(tmp_path), capacity=2 * 1024 * 1024)
    buf = a.create("obj_shared", 150_000)
    buf[:6] = b"shared"
    a.seal("obj_shared")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_xproc_child, args=(str(tmp_path), q))
    p.start()
    assert q.get(timeout=60) == b"shared"
    p.join(60)
    a.close()


def test_object_store_arena_roundtrip(tmp_path):
    store = ObjectStore(str(tmp_path))
    assert store.backend == "native"
    arr = np.arange(200_000, dtype=np.float32)   # > inline threshold
    desc = store.put("obj_np", arr)
    assert desc.arena and desc.path is None
    out = store.get(desc)
    np.testing.assert_array_equal(out, arr)
    # zero-copy: result is read-only (backed by the shm mapping)
    assert not out.flags.writeable
    from ray_tpu_torch._private import serialization
    payload = serialization.dumps(arr)
    desc2 = store.put_serialized("obj_np2", payload)
    np.testing.assert_array_equal(store.get(desc2), arr)
    store.delete(desc)
    store.close()


def test_zero_copy_view_survives_delete_and_reuse(tmp_path):
    """Freeing an object while a deserialized zero-copy array still
    borrows its bytes must NOT let the allocator reuse them: the free
    path probes the per-object mmap for live exports and condemns the
    block instead (the bug this guards against surfaced as replay
    batches whose int columns held float bit patterns)."""
    store = ObjectStore(str(tmp_path))
    assert store.backend == "native"
    arr = np.arange(100_000, dtype=np.int32)
    desc = store.put("victim", arr)
    assert desc.arena
    out = store.get(desc)            # zero-copy borrower
    store.delete(desc)               # freed while borrowed
    # hammer the allocator: without the borrow probe these allocations
    # reuse the victim's block and corrupt `out`
    descs = []
    for i in range(20):
        d = store.put(f"churn{i}", np.full(100_000, i, np.float32))
        descs.append(d)
    np.testing.assert_array_equal(out, arr)
    # once the borrower dies, a later store operation reclaims the block
    del out
    import gc
    gc.collect()
    for d in descs:
        store.delete(d)
    store._sweep_condemned()
    assert not store._condemned
    store.close()


def test_object_store_file_fallback_when_arena_full(tmp_path):
    os.environ["RAY_TPU_OBJECT_STORE_BYTES"] = "1048576"
    try:
        store = ObjectStore(str(tmp_path))
        assert store.backend == "native"
        # bigger than the whole arena -> file-backed, still readable
        arr = np.arange(1_000_000, dtype=np.float64)
        desc = store.put("obj_huge", arr)
        assert not desc.arena and desc.path is not None
        np.testing.assert_array_equal(store.get(desc), arr)
        store.close()
    finally:
        del os.environ["RAY_TPU_OBJECT_STORE_BYTES"]


def test_loads_the_ports_build_and_never_the_jax_packages(tmp_path):
    """A fresh process that puts and gets through the port's store maps
    exactly one libstore: the port's build under ray_tpu_torch/_build/."""
    import subprocess
    code = (
        "import sys, numpy as np\n"
        "from ray_tpu_torch._private.object_store import ObjectStore\n"
        "from ray_tpu_torch._private.native.arena import loaded_library\n"
        f"s = ObjectStore({str(tmp_path)!r})\n"
        "d = s.put('obj_a', np.arange(100_000.0))\n"
        "assert d.arena and s.get(d)[7] == 7.0\n"
        "maps = sorted({l.split()[-1] for l in open('/proc/self/maps')\n"
        "               if 'libstore' in l})\n"
        "print(s.backend, loaded_library(), repr(maps))\n"
        "s.close()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    backend, lib, maps = out.stdout.split(" ", 2)
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ray_tpu_torch", "_build")
    assert backend == "native"
    assert os.path.dirname(lib) == build
    assert eval(maps) == [lib]                 # nothing else is mapped
    assert "ray_tpu/_private/native" not in maps


def test_library_is_named_by_its_source(tmp_path, monkeypatch):
    """An edited source (or other flags) gets a new library; the old one
    is never loaded for it."""
    lib = native.library_path("store")
    assert os.path.basename(lib).startswith("libstore-")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-DRTT_PROBE",))
    assert native.library_path("store") != lib


def test_disable_native_is_the_switch_to_the_file_store(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("RAY_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setenv("RAY_TPU_TORCH_OBJECT_SPILL_ROOT",
                       str(tmp_path / "spill"))
    store = ObjectStore(str(tmp_path))
    assert store.backend == "file" and store.arena_stats() is None
    arr = np.arange(200_000, dtype=np.float32)
    desc = store.put("obj_f", arr)
    assert not desc.arena and desc.path.startswith(str(tmp_path / "spill"))
    out = store.get(desc)
    np.testing.assert_array_equal(out, arr)
    assert not out.flags.writeable
    del out
    store.delete(desc)
    assert not os.path.exists(desc.path)
    store.purge_spill()
    store.close()


def test_a_failed_build_raises_with_the_compilers_error(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ("-fno-such-option-rtt",))
    with pytest.raises(native.NativeCompileError,
                       match="no-such-option-rtt") as e:
        native.build_extension("store")
    assert "RAY_TPU_DISABLE_NATIVE=1" in str(e.value)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".so")]
