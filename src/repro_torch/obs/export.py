"""Exporters: Chrome trace-event JSON (Perfetto) and Prometheus text
(a copy of ``repro.obs.export``).

Consumes only plain data -- tracer record dicts, fleet/router
``metrics()`` snapshots, event-log entries -- never ``repro_torch.cluster``
or ``repro_torch.serve`` types, so importing this module can never cycle
back into the runtime it observes.

``chrome_trace`` maps the tracer's internal record shape (see
``repro_torch.obs.trace``) onto the Chrome trace-event format: complete
spans become ``ph="X"`` events, instants ``ph="i"``, every distinct
``track`` becomes a tid with a ``thread_name`` metadata event, and all
timestamps move from perf_counter seconds to microseconds relative to
the earliest record.  Open the result at https://ui.perfetto.dev.
"""

from __future__ import annotations

import json

_PID = 1


def chrome_trace(events: list[dict], *, process_name: str = "repro_torch"
                 ) -> dict:
    """Chrome trace-event JSON object for a list of tracer records."""
    events = [e for e in events if "t" in e]
    t0 = min((e["t"] for e in events), default=0.0)
    tids: dict[str, int] = {}
    out: list[dict] = [{
        "ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]

    def tid_of(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            out.append({"ph": "M", "pid": _PID, "tid": tid,
                        "name": "thread_name", "args": {"name": track}})
        return tid

    for e in events:
        rec = {
            "name": e.get("name", "?"),
            "cat": e.get("cat", "event"),
            "ph": e.get("ph", "i"),
            "pid": _PID,
            "tid": tid_of(str(e.get("track", "main"))),
            "ts": (e["t"] - t0) * 1e6,
            "args": dict(e.get("args", {})),
        }
        if e.get("trace"):
            rec["args"]["trace"] = e["trace"]
        if rec["ph"] == "X":
            rec["dur"] = e.get("dur", 0.0) * 1e6
        else:
            rec["s"] = "t"              # instant scope: thread
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _log_records(entries, track: str, t0_wall: float, t0_mono: float
                 ) -> list[dict]:
    """Fleet/router event-log dicts -> internal instant records.

    Entries stamp both clocks (``t`` wall + ``t_mono``); an entry with
    only a wall stamp is re-anchored through the tracer's
    ``(wall, mono)`` pair."""
    recs = []
    for e in entries:
        e = dict(e)
        t = e.pop("t_mono", None)
        wall = e.pop("t", None)
        if t is None:
            if wall is None:
                continue
            t = t0_mono + (wall - t0_wall)
        name = e.pop("kind", None) or e.pop("event", None) or "log"
        recs.append({"name": str(name), "cat": "log", "ph": "i",
                     "track": track, "t": t, "trace": 0, "args": e})
    return recs


def write_chrome_trace(path: str, tracer, *, fleet=None, router=None
                       ) -> int:
    """Merge the tracer buffer with the fleet event log and router
    dispatch logs (all on the perf_counter timeline) and write one
    Chrome trace JSON file.  Returns the number of trace events."""
    events = list(tracer.events())
    if fleet is not None:
        events += _log_records(getattr(fleet, "event_log", []),
                               "fleet-log", tracer.t0_wall,
                               tracer.t0_mono)
    if router is not None:
        for name in getattr(router, "endpoints", lambda: [])():
            events += _log_records(router.dispatch_log(name),
                                   f"router-{name}", tracer.t0_wall,
                                   tracer.t0_mono)
    events.sort(key=lambda e: e.get("t", 0.0))
    doc = chrome_trace(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


# -- Prometheus text exposition ---------------------------------------------


def _sanitize(s: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in str(s))


def _flatten(prefix: str, obj, lines: list[str]) -> None:
    if isinstance(obj, bool):
        lines.append(f"{prefix} {int(obj)}")
    elif isinstance(obj, (int, float)):
        lines.append(f"{prefix} {obj}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}_{_sanitize(k)}", v, lines)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}_{i}", v, lines)
    # strings and None are identity, not measurements: skipped


def prometheus_text(*, fleet=None, router=None, tracer=None) -> str:
    """Flatten ``metrics()`` snapshots into Prometheus text exposition
    (gauges; nested keys join with ``_``).  Scrape-ready as-is."""
    lines: list[str] = []
    if fleet is not None:
        snap = {k: v for k, v in fleet.metrics().items()
                if k != "transport"}
        _flatten("repro_fleet", snap, lines)
    if router is not None:
        _flatten("repro_router", router.metrics(), lines)
    if tracer is not None:
        lines.append(f"repro_trace_buffer_events {len(tracer)}")
        lines.append(f"repro_trace_buffer_capacity {tracer.capacity}")
    return "\n".join(lines) + "\n"
