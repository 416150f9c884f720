"""``repro_torch.obs`` -- end-to-end round tracing and straggler
attribution (the port of ``repro.obs``; plain Python, no torch).

- ``trace``  -- ``Tracer``: spans/events into a bounded monotonic-clock
  ring buffer; near-zero cost when disabled (a ``None`` check on the
  hot path).  Enable with ``REPRO_TRACE=1`` or pass
  ``CodedFleet(tracer=)`` explicitly.
- ``export`` -- Chrome trace-event JSON (Perfetto-loadable) and
  Prometheus text exposition of the fleet counters.
- ``attrib`` -- straggler attribution: per-worker per-round latency
  breakdown (queue / wire / worker-queue / compute / decode), which
  rounds decoded *without* which workers, wasted work from cancelled
  and late tasks, and measured compute rates that feed
  ``fleet.worker_capacities(rates=...)``.

``python -m repro_torch.obs`` runs a small traced fleet on the card
(``--device cpu`` asks for the host) and writes both export formats.
"""

from .attrib import Attribution, RoundBreakdown, WorkerStats, attribute
from .export import chrome_trace, prometheus_text, write_chrome_trace
from .trace import (DEFAULT_BUF, ENV_TRACE, ENV_TRACE_BUF, Tracer,
                    default_tracer)

__all__ = [
    "Attribution",
    "DEFAULT_BUF",
    "ENV_TRACE",
    "ENV_TRACE_BUF",
    "RoundBreakdown",
    "Tracer",
    "WorkerStats",
    "attribute",
    "chrome_trace",
    "default_tracer",
    "prometheus_text",
    "write_chrome_trace",
]
