"""Zero-copy-friendly serialization, copied from
`ray_tpu/_private/serialization.py` (the port imports nothing of
`ray_tpu`).

Pickle 5 with out-of-band buffers. Envelope layout (all
little-endian):

    [u32 magic][u32 nbuf][u64 meta_len][u64 buf_len * nbuf]
    [meta(pickle bytes)][pad to 64][buf0][pad to 64][buf1]...

Large contiguous buffers (numpy arrays, bytes) are carried out-of-band so a
reader backed by an mmap can expose them zero-copy; pickle5's buffer protocol
does the heavy lifting, cloudpickle handles closures/lambdas/classes.
"""

import pickle
import struct
from typing import Callable

import cloudpickle

from ray_tpu_torch._private.constants import BUFFER_ALIGNMENT

_MAGIC = 0x52545055  # "RTPU"
_HEADER = struct.Struct("<II Q")


def _align(n: int) -> int:
    return (n + BUFFER_ALIGNMENT - 1) // BUFFER_ALIGNMENT * BUFFER_ALIGNMENT


def _dumps_with_buffers(value) -> tuple[bytes, list[pickle.PickleBuffer]]:
    buffers: list[pickle.PickleBuffer] = []
    # Fast path: plain pickle (C pickler, no reducer_override dispatch) —
    # this is most of the put() cost for small data values. Two escapes
    # to cloudpickle: anything plain pickle can't handle (lambdas,
    # closures, locally-defined classes) raises, and anything that
    # pickled BY REFERENCE into __main__ would unpickle against the
    # wrong __main__ in another process — cloudpickle serializes those
    # by value. The b"__main__" scan is conservative: a false hit only
    # costs the fallback.
    try:
        meta = pickle.dumps(value, protocol=5,
                            buffer_callback=buffers.append)
        if b"__main__" not in meta:
            return meta, buffers
    except Exception:
        pass
    buffers.clear()
    # cloudpickle.dumps supports protocol 5 + buffer_callback and falls back to
    # pickling by value for interactively-defined functions/classes.
    meta = cloudpickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    return meta, buffers


def serialized_size(value) -> tuple[int, bytes, list[pickle.PickleBuffer]]:
    """Compute the envelope size without materializing it (so the object
    store can allocate the mmap first and write in place)."""
    meta, buffers = _dumps_with_buffers(value)
    raws = [b.raw() for b in buffers]
    size = _HEADER.size + 8 * len(raws)
    size += len(meta)
    for r in raws:
        size = _align(size) + r.nbytes
    return size, meta, buffers


def write_envelope(dest: memoryview, meta: bytes,
                   buffers: list[pickle.PickleBuffer]) -> int:
    """Write the envelope into `dest`; returns bytes written."""
    raws = [b.raw() for b in buffers]
    off = 0
    _HEADER.pack_into(dest, off, _MAGIC, len(raws), len(meta))
    off += _HEADER.size
    for r in raws:
        struct.pack_into("<Q", dest, off, r.nbytes)
        off += 8
    dest[off:off + len(meta)] = meta
    off += len(meta)
    for r in raws:
        aligned = _align(off)
        off = aligned
        dest[off:off + r.nbytes] = r  # raw() is always 1-D contiguous "B"
        off += r.nbytes
    for b in buffers:
        b.release()
    return off


def dumps(value) -> bytes:
    """One-shot serialize to a standalone bytes envelope (inline objects)."""
    size, meta, buffers = serialized_size(value)
    out = bytearray(size)
    n = write_envelope(memoryview(out), meta, buffers)
    return bytes(out[:n])


def loads(view) -> object:
    """Deserialize from a bytes-like/memoryview envelope.

    Buffers are passed as sub-views of `view`: zero-copy when `view` is an
    mmap over the store file (arrays come out read-only, matching the
    reference's immutable plasma-backed numpy views, serialization.py:373).
    """
    view = memoryview(view)
    magic, nbuf, meta_len = _HEADER.unpack_from(view, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt object envelope (bad magic)")
    off = _HEADER.size
    buf_lens = []
    for _ in range(nbuf):
        (n,) = struct.unpack_from("<Q", view, off)
        buf_lens.append(n)
        off += 8
    meta = view[off:off + meta_len]
    off += meta_len
    buffers = []
    for n in buf_lens:
        off = _align(off)
        buffers.append(pickle.PickleBuffer(view[off:off + n]))
        off += n
    return pickle.loads(meta, buffers=buffers)


def dumps_message(msg) -> bytes:
    """Serialize a control-plane message (no out-of-band buffers)."""
    return cloudpickle.dumps(msg, protocol=5)


loads_message: Callable[[bytes], object] = pickle.loads
