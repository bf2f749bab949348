"""Environment reads of the port (counterpart of ``dr_tpu/utils/env.py``).

The port's switches are ``DR_GPU_*`` variables; names of the form
``DR_TPU_*`` belong to the JAX package and are not read here.  Parsing
is tolerant, as in the JAX package: a malformed value reads as the
default instead of failing every caller.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["env_int", "env_float", "env_str", "env_flag", "env_raw",
           "env_override"]


@contextlib.contextmanager
def env_override(**vars_):
    """Scoped override with exact restore: sets each ``VAR=value``
    (``None`` deletes the variable for the scope) and puts every variable
    back on exit, to its prior value if it had one, else removed."""
    prior = {v: os.environ.get(v) for v in vars_}
    try:
        for v, val in vars_.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
        yield
    finally:
        for v, val in prior.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val


def env_int(name: str, default: int, floor: int = 1) -> int:
    """``max(floor, int($name))``; ``default`` on a missing or malformed
    value."""
    raw = os.environ.get(name)
    try:
        v = int(raw) if raw is not None else default
    except ValueError:
        v = default
    return max(floor, v)


def env_float(name: str, default: float) -> float:
    """``float($name)``; ``default`` on a missing or malformed value."""
    raw = os.environ.get(name)
    try:
        return float(raw) if raw not in (None, "") else default
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    """``$name`` stripped of surrounding whitespace; ``default`` when
    unset."""
    raw = os.environ.get(name)
    return default if raw is None else raw.strip()


def env_raw(name: str):
    """``os.environ.get($name)``: None when unset, for the call sites
    where unset and set differ."""
    return os.environ.get(name)


def env_flag(name: str) -> bool:
    """True iff ``$name`` is ``1`` (whitespace-tolerant)."""
    return env_str(name) == "1"
