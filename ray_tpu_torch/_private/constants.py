"""The port's tunables, copied from `ray_tpu/_private/constants.py` (the
port imports nothing of `ray_tpu`). Each is read once at import and
overridable by the same environment variable the reference's `define`
reads, ``RAY_TPU_<NAME>``."""

import os


def define(name: str, type_: type, default, doc: str):
    """The option's value: ``RAY_TPU_<name>`` parsed as ``type_`` when
    set, else ``default``. ``doc`` documents it where it is defined."""
    raw = os.environ.get("RAY_TPU_" + name)
    if raw is None:
        return default
    try:
        return type_(raw)
    except ValueError:
        raise ValueError(f"invalid value {raw!r} for RAY_TPU_{name} "
                         f"(expected {type_.__name__})") from None


# --- multi-tenant inference: priority classes + preemption ---

ENGINE_PRIORITY_CLASSES = define(
    "ENGINE_PRIORITY_CLASSES", int, 3,
    "Number of request priority classes the inference engine admits "
    "(0 = lowest .. N-1 = highest). submit(priority=) must be in "
    "range; the admission queue weights, sheds, and preempts by "
    "class.")

ENGINE_PRIORITY_AGING_S = define(
    "ENGINE_PRIORITY_AGING_S", float, 2.0,
    "Admission aging quantum: a pending request older than "
    "(priority_classes - its class) * this jumps the weighted-share "
    "order entirely (FIFO among the escalated), bounding how long a "
    "low class can wait behind sustained high-class load.")

ENGINE_PRIORITY_WEIGHT_BASE = define(
    "ENGINE_PRIORITY_WEIGHT_BASE", float, 4.0,
    "Weighted-share base for class admission: class c gets stride "
    "weight base**c, so each step up the class ladder gets base x the "
    "admission share of the class below while every backlogged class "
    "keeps a nonzero guaranteed share (no starvation even before "
    "aging kicks in).")
