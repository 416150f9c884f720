"""Strict integer env-var parsing shared across the package (a copy of
``repro._env``).

Every ``REPRO_*`` integer knob (fleet in-flight cap, router queue cap,
retry attempts, trace buffer, the ``REPRO_SCALE_*`` family) resolves
through ``env_int``.  Historically each module hand-rolled its parser
and *silently* repaired bad input -- ``REPRO_FLEET_MAX_INFLIGHT=0``
became 1, ``REPRO_TRACE_BUF=bogus`` fell back to the default -- which
turned an operator typo into a confusing downstream mystery (a fleet
that serializes every round, a trace that silently kept its old size).
A mis-set knob now fails loudly at construction time with the variable
named in the error.
"""

from __future__ import annotations

import os

__all__ = ["env_int"]


def env_int(name: str, default: int, min: int = 1) -> int:
    """``int(os.environ[name])``, or ``default`` when unset/empty.

    Garbage and out-of-range values raise ``ValueError`` naming the
    variable -- a typo'd knob should fail where the operator set it,
    not surface later as a stalled fleet or an unbounded queue.
    ``min`` is the smallest acceptable value (watermarks that may
    legitimately be 0 pass ``min=0``).
    """
    raw = os.environ.get(name, "")
    if raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r}: expected an integer >= {min}") from None
    if value < min:
        raise ValueError(f"{name}={value}: expected an integer >= {min}")
    return value
