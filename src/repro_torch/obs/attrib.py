"""Straggler attribution from traced round records (a copy of
``repro.obs.attrib``: plain Python over event dicts, nothing of it
changes in the port).

``attribute(events)`` consumes the tracer buffer -- specifically the
``cat="round"`` complete records the fleet emits at decode time (one
per traced round, carrying the per-task coordinator-timeline stamps
and the critical-chain segment breakdown) plus the
``fleet.late-result`` waste instants -- and answers the operational
questions the paper's straggler model raises:

- which worker is slow, and in which *phase* (wire vs queue vs
  compute)?
- which rounds decoded *without* a worker's results at all (the
  fastest-k set formed before it answered)?
- how much computed work was wasted (cancelled tasks whose results
  arrived after decode)?

The per-worker compute rates (work units per second of pure compute)
plug straight into ``CodedFleet.worker_capacities(rates=...)`` as a
higher-fidelity capacity signal than the heartbeat-path EWMAs.

No ``repro_torch.cluster`` imports: everything here is plain dicts, so the
module is usable offline on a saved event dump.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_PHASES = ("coord_queue", "wire_out", "worker_queue", "compute",
           "wire_back", "decode_wait", "decode")


@dataclass
class RoundBreakdown:
    """One traced round: wall, per-phase critical-chain segments, and
    which workers the decode did / did not use."""

    plan: int
    round: int
    op: str
    trace: int
    wall_s: float
    decode_s: float
    requeues: int
    segments: dict
    tasks: list
    decoded_without: list
    cancelled_rows: list

    @property
    def segment_sum(self) -> float:
        return sum(self.segments.values())

    def dominant_phase(self) -> str | None:
        if not self.segments:
            return None
        return max(self.segments, key=self.segments.get)


@dataclass
class WorkerStats:
    """Aggregated per-worker view across every traced round."""

    worker: int
    tasks: int = 0
    used: int = 0                  # results the decoder consumed
    work: float = 0.0              # work units across stamped tasks
    compute_s: float = 0.0         # pure compute seconds (start->finish)
    wire_s: float = 0.0            # send->recv + finish->arrival
    queue_s: float = 0.0           # recv->start (worker inbox wait)
    decoded_without: int = 0       # rounds that finished without us
    wasted_tasks: int = 0          # cancelled / late results
    wasted_work: float = 0.0
    wasted_compute_s: float = 0.0
    _per_task: list = field(default_factory=list, repr=False)

    @property
    def rate(self) -> float:
        """Work units per compute second (0.0 when unmeasured)."""
        return self.work / self.compute_s if self.compute_s > 0 else 0.0

    @property
    def mean_compute_s(self) -> float:
        return self.compute_s / self.tasks if self.tasks else 0.0


@dataclass
class Attribution:
    """The full report: per-round breakdowns + per-worker aggregates."""

    rounds: list
    workers: dict

    def compute_rates(self) -> dict:
        """worker -> work/s, for ``worker_capacities(rates=...)``."""
        return {w: s.rate for w, s in self.workers.items() if s.rate > 0}

    def suspects(self) -> list:
        """Workers ranked most-suspect first: primarily by how often
        rounds decoded without them, then by slowest compute rate
        (a worker rounds skipped but whose compute was never even
        measured is maximally suspect), then by wasted work."""
        rates = self.compute_rates()
        top = max(rates.values(), default=0.0)

        def badness(s: WorkerStats) -> tuple:
            r = rates.get(s.worker)
            if r is None:
                slow = 1.0 if s.decoded_without else 0.0
            else:
                slow = 1.0 - r / top if top else 0.0
            return (s.decoded_without, slow, s.wasted_tasks)

        ranked = sorted(self.workers.values(), key=badness, reverse=True)
        return [s.worker for s in ranked]

    def phase_totals(self) -> dict:
        """Summed critical-chain segments across rounds (where does
        round latency actually go?)."""
        tot = dict.fromkeys(_PHASES, 0.0)
        for r in self.rounds:
            for k, v in r.segments.items():
                tot[k] = tot.get(k, 0.0) + v
        return tot

    def wasted_work(self) -> float:
        return sum(s.wasted_work for s in self.workers.values())

    def table(self) -> str:
        """Printable per-worker summary, most-suspect first."""
        head = (f"{'worker':>6} {'tasks':>6} {'used':>5} {'rate':>10} "
                f"{'compute_s':>10} {'queue_s':>8} {'without':>8} "
                f"{'wasted':>7}")
        lines = [head, "-" * len(head)]
        for w in self.suspects():
            s = self.workers[w]
            lines.append(
                f"{s.worker:>6} {s.tasks:>6} {s.used:>5} "
                f"{s.rate:>10.1f} {s.compute_s:>10.4f} "
                f"{s.queue_s:>8.4f} {s.decoded_without:>8} "
                f"{s.wasted_tasks:>7}")
        return "\n".join(lines)


def attribute(events: list[dict]) -> Attribution:
    """Build the attribution report from a tracer event snapshot."""
    rounds: list[RoundBreakdown] = []
    workers: dict[int, WorkerStats] = {}

    def stats(w: int) -> WorkerStats:
        s = workers.get(w)
        if s is None:
            s = workers[w] = WorkerStats(worker=int(w))
        return s

    for e in events:
        a = e.get("args", {})
        if e.get("cat") == "round" and e.get("ph") == "X":
            rnd = RoundBreakdown(
                plan=a.get("plan", 0), round=a.get("round", 0),
                op=a.get("op", "?"), trace=e.get("trace", 0),
                wall_s=a.get("wall_s", e.get("dur", 0.0)),
                decode_s=a.get("decode_s", 0.0),
                requeues=a.get("requeues", 0),
                segments=dict(a.get("segments", {})),
                tasks=list(a.get("tasks", [])),
                decoded_without=list(a.get("decoded_without", [])),
                cancelled_rows=list(a.get("cancelled_rows", [])))
            rounds.append(rnd)
            for w in rnd.decoded_without:
                stats(w).decoded_without += 1
            for t in rnd.tasks:
                s = stats(t["worker"])
                s.tasks += 1
                if t.get("used"):
                    s.used += 1
                if t.get("start") is not None \
                        and t.get("finish") is not None:
                    dt = max(0.0, t["finish"] - t["start"])
                    s.compute_s += dt
                    s.work += float(t.get("work", 1.0))
                    if not t.get("used"):
                        # arrived, decoded around: computed for nothing
                        s.wasted_tasks += 1
                        s.wasted_work += float(t.get("work", 1.0))
                        s.wasted_compute_s += dt
                    if t.get("recv") is not None:
                        s.queue_s += max(0.0, t["start"] - t["recv"])
                    if t.get("sent") is not None \
                            and t.get("arrival") is not None:
                        s.wire_s += (max(0.0, t["recv"] - t["sent"])
                                     + max(0.0,
                                           t["arrival"] - t["finish"]))
        elif e.get("name") == "fleet.late-result":
            # a cancelled task's result landing after its round closed
            s = stats(a.get("worker", -1))
            s.wasted_tasks += 1
            s.wasted_work += float(a.get("work", 1.0))
            s.wasted_compute_s += float(a.get("compute_s", 0.0))
            serve_s = float(a.get("serve_s", 0.0))
            if serve_s > 0:
                # late answers still measure the worker's speed (the
                # only samples a hard straggler ever provides)
                s.compute_s += serve_s
                s.work += float(a.get("work", 1.0))
    return Attribution(rounds=rounds, workers=workers)
