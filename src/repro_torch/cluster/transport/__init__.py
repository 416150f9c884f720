"""Pluggable cluster transports, as far as the port has them: memory | pipe.

One ``Transport`` interface (``base.Transport``: start / ship-shard /
submit / cancel / uniform result+heartbeat stream / close), two
implementations so far:

  * ``memory`` -- in-process serve threads (deterministic default);
  * ``pipe``   -- spawned subprocesses over ``multiprocessing`` pipes,
    heartbeat-capable.

The JAX package's ``tcp`` (asyncio localhost sockets with a hello
handshake and sha256-verified shard shipping) and ``shm`` (payloads in
shared-memory segments) are not ported yet: naming either raises
``NotImplementedError`` (ROADMAP.md §1 item 9).

``make_transport(None, ...)`` resolves the default from the
``REPRO_CLUSTER_TRANSPORT`` env var (falling back to ``memory``), so a
deployment can flip the whole stack without touching call sites --
mirroring how ``REPRO_CODED_BACKEND`` picks the compute backend.
Keywords beyond the name reach the transport's constructor: ``faults``,
``heartbeat_s``, and ``device`` / ``backend``, what its workers compute
with.
"""

from __future__ import annotations

import os

from .base import Transport  # noqa: F401
from .memory import MemoryTransport
from .pipe import PipeTransport

TRANSPORTS: dict[str, type] = {
    "memory": MemoryTransport,
    "pipe": PipeTransport,
}

# the JAX package's transports this port does not have yet
UNPORTED = ("tcp", "shm")

ENV_TRANSPORT = "REPRO_CLUSTER_TRANSPORT"


def resolve_transport(name: str | None) -> str:
    """Explicit name > ``REPRO_CLUSTER_TRANSPORT`` env var > ``memory``."""
    name = name or os.environ.get(ENV_TRANSPORT) or "memory"
    if name in UNPORTED:
        raise NotImplementedError(
            f"the {name} cluster transport is not ported yet (ROADMAP.md "
            f"§1 item 9); use one of {sorted(TRANSPORTS)}")
    if name not in TRANSPORTS:
        raise ValueError(f"cluster transport must be one of "
                         f"{sorted(TRANSPORTS)}, got {name!r}")
    return name


def make_transport(name: str | None, n_workers: int, **kw) -> Transport:
    return TRANSPORTS[resolve_transport(name)](n_workers, **kw)
