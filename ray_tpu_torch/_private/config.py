"""Typed, documented, env-overridable runtime options: the parts of
`ray_tpu/_private/config.py` the port's channels read (the port imports
nothing of `ray_tpu`).

Every tunable is declared ONCE with its type, default and doc through
`define`; the environment override is ``RAY_TPU_<NAME>``, the same
variable the reference reads. `get` re-resolves an option against the
current environment, and modules that memoize a value derived from one
(netaddr's advertised host) register an invalidation hook with
`on_reset`, which `reset_caches` runs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: dict[type, Callable[[str], Any]] = {
    int: int,
    float: float,
    str: str,
    bool: _parse_bool,
}


@dataclass(frozen=True)
class ConfigOption:
    name: str            # env override: RAY_TPU_<name>
    type: type
    default: Any
    doc: str

    @property
    def env_var(self) -> str:
        return "RAY_TPU_" + self.name

    def current(self) -> Any:
        raw = os.environ.get(self.env_var)
        if raw is None:
            return self.default
        try:
            return _PARSERS[self.type](raw)
        except (ValueError, KeyError):
            raise ValueError(
                f"invalid value {raw!r} for {self.env_var} "
                f"(expected {self.type.__name__})") from None


OPTIONS: dict[str, ConfigOption] = {}


def define(name: str, type_: type, default: Any, doc: str) -> Any:
    """Register an option and return its effective value (resolved once
    at import)."""
    if name in OPTIONS:
        raise ValueError(f"config option {name} defined twice")
    opt = ConfigOption(name, type_, default, doc)
    OPTIONS[name] = opt
    return opt.current()


def get(name: str) -> Any:
    """Re-resolve an option against the current environment (code paths
    that must see fresh overrides)."""
    return OPTIONS[name].current()


# Modules that memoize a derived value of a config option (the advertised
# host in netaddr) register an invalidation hook here; anything that
# changes an override mid-process (tests flipping RAY_TPU_NODE_IP) calls
# reset_caches() to flush every derived value at once.
_reset_hooks: list[Callable[[], None]] = []


def on_reset(fn: Callable[[], None]) -> Callable[[], None]:
    """Register an invalidation hook run by reset_caches(); returns the
    hook so it can double as a decorator."""
    _reset_hooks.append(fn)
    return fn


def reset_caches() -> None:
    """Invalidate every registered config-derived cache."""
    for fn in _reset_hooks:
        fn()
