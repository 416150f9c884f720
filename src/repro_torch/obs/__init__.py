"""``repro_torch.obs`` -- round tracing, as far as the port has it.

``trace`` holds the ``Tracer``: spans and events in a bounded
monotonic-clock ring buffer, near-zero cost when disabled (the tracer
is ``None``).  Enable it with ``REPRO_TRACE=1`` or pass
``CodedFleet(tracer=)``.  The JAX package's straggler attribution
(``attrib``), its exporters (``export``) and its demo (``__main__``)
are not ported yet (ROADMAP.md §1 item 11).
"""

from .trace import DEFAULT_BUF, ENV_TRACE, ENV_TRACE_BUF, Tracer, default_tracer

__all__ = [
    "DEFAULT_BUF",
    "ENV_TRACE",
    "ENV_TRACE_BUF",
    "Tracer",
    "default_tracer",
]
