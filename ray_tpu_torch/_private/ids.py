"""Unique identifiers for objects/tasks/actors/jobs, copied from
`ray_tpu/_private/ids.py` (the port imports nothing of `ray_tpu`).

16 random bytes rendered as hex; IDs are plain strings so they pickle
cheaply and hash fast in Python dicts.
"""

import os
import random

# Uniqueness, not secrecy: a per-process PRNG seeded from the OS avoids
# one urandom syscall per id on the task-submission hot path.
# getrandbits is a single C call under the GIL, so concurrent submitters
# can share it safely.
_rng = random.Random(os.urandom(16))


def _rand_hex(nbytes: int = 16) -> str:
    return f"{_rng.getrandbits(nbytes * 8):0{nbytes * 2}x}"


def reseed() -> None:
    """Re-seed after fork (child processes must not replay the parent's
    id stream)."""
    global _rng
    _rng = random.Random(os.urandom(16))


# Any fork site gets a fresh stream: id collisions between forked
# children would silently alias distinct objects in the store.
os.register_at_fork(after_in_child=reseed)


def new_object_id() -> str:
    return "obj_" + _rand_hex()


def new_task_id() -> str:
    return "task_" + _rand_hex(8)


def new_actor_id() -> str:
    return "actor_" + _rand_hex(8)


def new_worker_id() -> str:
    return "worker_" + _rand_hex(6)


def new_job_id() -> str:
    return "job_" + _rand_hex(4)


def new_node_id() -> str:
    return "node_" + _rand_hex(6)
