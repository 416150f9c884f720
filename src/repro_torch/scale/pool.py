"""Provisioners: where autoscaling capacity actually comes from (the
port of ``repro.scale.pool``).

A ``WorkerPool`` turns the controller's abstract "add one member" /
"remove one member" decisions into cluster mutations through the
*existing* elastic paths -- nothing here invents a new join or leave
protocol:

* ``LocalPool``   -- one member == one worker of a ``CodedFleet`` on
  this host; ``provision`` spawns through ``fleet.add_worker`` (the
  transport's own spawn: a thread for memory, a process for pipe/shm,
  a child + socket for tcp; a card fleet's worker computes on the
  card) and ``decommission`` drains through
  ``fleet.remove_worker(drain=True)``.
* ``RemotePool``  -- one member == one standalone ``--connect`` worker
  dialing a coordinator-mode tcp fleet; a ``launch`` callback starts
  the remote process and the pool waits out the join handshake under
  the shared ``RetryPolicy``.
* ``ReplicaPool`` -- one member == one whole replica fleet behind a
  ``Router`` endpoint, via ``router.add_replica`` /
  ``router.remove_replica`` (drain-before-close built in).

Chaos safety: a provision that dies mid-join (child killed before the
handshake, channel lost during catch-up) is retried under the pool's
``RetryPolicy``; between attempts any half-joined channel is torn back
down so a failed provision leaves no zombie membership behind.  A
provision that exhausts its attempts raises ``ProvisionError`` -- the
controller records the failure and carries on; it never wedges the
control loop.
"""

from __future__ import annotations

import threading

from ..cluster.retry import RetryPolicy

_TRANSIENT = (TimeoutError, ConnectionError, OSError)


class ProvisionError(RuntimeError):
    """A pool could not supply (or retire) a member after retries."""


def _default_retry() -> RetryPolicy:
    # short, bounded: the control loop re-evaluates every interval
    # anyway, so a provision that keeps failing should surface fast
    return RetryPolicy(max_attempts=3, base_s=0.05, max_backoff_s=1.0)


class WorkerPool:
    """Capacity-supply interface the controller scales through.

    ``provision`` returns the new member's id (worker id or replica
    index); ``decommission`` retires one member gracefully (drain
    before remove -- in-flight work finishes or re-homes, no future
    fails because capacity left).  ``capacity_hint`` says how much
    serving capacity one member adds, in workers, so policies can
    reason in worker units regardless of pool granularity.
    """

    #: human-readable pool flavor for decision logs / traces
    kind = "base"

    def members(self) -> list[int]:
        """Ids of the currently-serving members, sorted."""
        raise NotImplementedError

    def size(self) -> int:
        return len(self.members())

    def provision(self) -> int:
        raise NotImplementedError

    def decommission(self, member: int) -> None:
        raise NotImplementedError

    def capacity_hint(self) -> int:
        """Workers one member contributes (1 unless overridden)."""
        return 1

    def metrics(self) -> dict:
        return {"kind": self.kind, "size": self.size(),
                "members": self.members(),
                "provisioned": self.provisioned,
                "decommissioned": self.decommissioned,
                "provision_failures": self.provision_failures}

    # shared bookkeeping -----------------------------------------------------

    def __init__(self, retry: RetryPolicy | None = None):
        self.retry = retry if retry is not None else _default_retry()
        self.provisioned = 0
        self.decommissioned = 0
        self.provision_failures = 0
        self._lock = threading.Lock()

    def _count(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)


class LocalPool(WorkerPool):
    """Members are workers of one ``CodedFleet`` on this host.

    The transport does the actual spawning (memory: serve thread,
    pipe/shm: child process, tcp with ``spawn=True``: child + socket),
    ``fleet.add_worker`` blocks through shard catch-up, and
    ``fleet.remove_worker(drain=True)`` is the graceful exit -- the
    same elastic path a human operator uses.
    """

    kind = "local"

    def __init__(self, fleet, *, retry: RetryPolicy | None = None,
                 join_timeout: float = 30.0, drain_timeout: float = 10.0):
        super().__init__(retry)
        self.fleet = fleet
        self.join_timeout = join_timeout
        self.drain_timeout = drain_timeout

    def members(self) -> list[int]:
        return self.fleet.live_workers()

    def provision(self) -> int:
        def attempt() -> int:
            before = set(self.fleet.transport.workers())
            try:
                return self.fleet.add_worker(timeout=self.join_timeout)
            except _TRANSIENT:
                # abandon the half-joined channel, if the transport
                # admitted one, so the retry starts from a clean roster
                for w in set(self.fleet.transport.workers()) - before:
                    try:
                        self.fleet.transport.remove_worker(w)
                    except Exception:
                        pass
                raise

        try:
            w = self.retry.call(attempt, retry_on=_TRANSIENT)
        except _TRANSIENT as e:
            self._count("provision_failures")
            raise ProvisionError(f"local provision failed: {e!r}") from e
        self._count("provisioned")
        return w

    def decommission(self, member: int) -> None:
        self.fleet.remove_worker(member, drain=True,
                                 timeout=self.drain_timeout)
        self._count("decommissioned")


class RemotePool(WorkerPool):
    """Members are standalone ``--connect`` workers dialing a
    coordinator-mode tcp fleet (``TcpTransport(spawn=False)``).

    ``launch(worker_id, port)`` is the deployment hook: start the
    remote process (ssh, container API, ...) that runs
    ``python -m repro_torch.cluster.worker --connect HOST:PORT --id N
    [--device DEVICE]`` (on the card unless ``--device cpu``).
    The pool picks the id, fires the launcher, then waits out the join
    handshake + shard catch-up; a launch whose dial never lands is
    torn down and retried under the shared ``RetryPolicy``.
    """

    kind = "remote"

    def __init__(self, fleet, launch, *, retry: RetryPolicy | None = None,
                 join_timeout: float = 60.0, drain_timeout: float = 10.0):
        super().__init__(retry)
        if fleet.transport_name != "tcp":
            raise ValueError(
                f"RemotePool needs a tcp coordinator fleet, got "
                f"transport {fleet.transport_name!r}")
        self.fleet = fleet
        self.launch = launch
        self.join_timeout = join_timeout
        self.drain_timeout = drain_timeout

    @property
    def port(self) -> int:
        return self.fleet.transport.port

    def members(self) -> list[int]:
        return self.fleet.live_workers()

    def provision(self) -> int:
        def attempt() -> int:
            w = self.fleet.transport.next_worker_id()
            self.launch(w, self.port)
            try:
                return self.fleet.add_worker(w, timeout=self.join_timeout)
            except (*_TRANSIENT, RuntimeError):
                # the dial never completed (or died mid-catch-up):
                # drop the channel so the next attempt gets a clean id
                try:
                    self.fleet.transport.remove_worker(w)
                except Exception:
                    pass
                raise

        try:
            w = self.retry.call(attempt,
                                retry_on=(*_TRANSIENT, RuntimeError))
        except (*_TRANSIENT, RuntimeError) as e:
            self._count("provision_failures")
            raise ProvisionError(f"remote provision failed: {e!r}") from e
        self._count("provisioned")
        return w

    def decommission(self, member: int) -> None:
        self.fleet.remove_worker(member, drain=True,
                                 timeout=self.drain_timeout)
        self._count("decommissioned")


class ReplicaPool(WorkerPool):
    """Members are whole replica fleets behind one ``Router`` endpoint.

    ``provision`` wraps ``router.add_replica`` (the router owns the new
    fleet and attaches the endpoint's plan), ``decommission`` wraps
    ``router.remove_replica`` -- which already drains in-flight batches
    before detaching, so a scale-down never fails a routed future.
    The router refuses to remove the last live replica; the pool lets
    that surface as ``ProvisionError`` so the controller logs it
    instead of crashing the loop.
    """

    kind = "replica"

    def __init__(self, router, endpoint: str, *,
                 n_workers: int | None = None,
                 transport: str | None = None,
                 max_inflight: int | None = None,
                 retry: RetryPolicy | None = None,
                 drain_timeout: float = 30.0):
        super().__init__(retry)
        self.router = router
        self.endpoint = endpoint
        self.n_workers = n_workers
        self.transport = transport
        self.max_inflight = max_inflight
        self.drain_timeout = drain_timeout

    def members(self) -> list[int]:
        eps = self.router.metrics()["endpoints"]
        ep = eps.get(self.endpoint)
        if ep is None:
            return []
        return sorted(r["index"] for r in ep["replicas"]
                      if not r["draining"])

    def capacity_hint(self) -> int:
        return self.n_workers if self.n_workers is not None else 1

    def provision(self) -> int:
        try:
            idx = self.retry.call(
                lambda: self.router.add_replica(
                    self.endpoint, n_workers=self.n_workers,
                    transport=self.transport,
                    max_inflight=self.max_inflight),
                retry_on=_TRANSIENT)
        except (*_TRANSIENT, RuntimeError) as e:
            self._count("provision_failures")
            raise ProvisionError(f"replica provision failed: {e!r}") from e
        self._count("provisioned")
        return idx

    def decommission(self, member: int) -> None:
        try:
            self.router.remove_replica(self.endpoint, member,
                                       timeout=self.drain_timeout)
        except ValueError as e:
            # "cannot remove the last live replica": a floor the router
            # enforces below even the pool's min -- report, don't crash
            raise ProvisionError(str(e)) from e
        self._count("decommissioned")
