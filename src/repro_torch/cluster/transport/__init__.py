"""Pluggable cluster transports: memory | pipe | tcp | shm (the port of
``repro.cluster.transport``).

One ``Transport`` interface (``base.Transport``: start / ship-shard /
submit / cancel / uniform result+heartbeat stream / close), four
implementations:

  * ``memory`` -- in-process serve threads (deterministic default);
  * ``pipe``   -- spawned subprocesses over ``multiprocessing`` pipes,
    heartbeat-capable;
  * ``tcp``    -- asyncio sockets speaking length-prefixed frames of the
    versioned wire format, with a hello handshake (wire version +
    worker id), sha256-verified shard shipping, and remote workers
    (``python -m repro_torch.cluster.worker --connect``);
  * ``shm``    -- the pipe transport's control plane with payloads in
    ``multiprocessing.shared_memory`` segments (wire v6): shards land
    once, tasks ship segment references instead of bytes, results
    write into a per-round slab the coordinator decodes in place --
    the zero-copy path for co-located workers.

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
from .shm import ShmTransport
from .tcp import TcpTransport

TRANSPORTS: dict[str, type] = {
    "memory": MemoryTransport,
    "pipe": PipeTransport,
    "tcp": TcpTransport,
    "shm": ShmTransport,
}

ENV_TRANSPORT = "REPRO_CLUSTER_TRANSPORT"


def resolve_transport(name: str | None) -> str:
    """Explicit name > ``REPRO_CLUSTER_TRANSPORT`` env var > ``memory``."""
    name = name or os.environ.get(ENV_TRANSPORT) or "memory"
    if name not in TRANSPORTS:
        raise ValueError(f"cluster transport must be one of "
                         f"{sorted(TRANSPORTS)}, got {name!r}")
    return name


def make_transport(name: str | None, n_workers: int, **kw) -> Transport:
    return TRANSPORTS[resolve_transport(name)](n_workers, **kw)
