"""Cluster runtime, as far as the port has it: fault injection.

``faults`` turns the straggler models of ``repro_torch.core.straggler``
into deterministic injectors (latency, fail-stop, hang, scripted
windows) and samples the serve engine's per-step straggler mask.  The
wire format, workers, transports, fleet and dispatcher of
``repro.cluster`` are not ported yet.
"""

from .faults import (  # noqa: F401
    FailStop,
    Hang,
    NoFaults,
    ScriptedFaults,
    StragglerFaults,
    WorkerFailure,
    WorkerHang,
    adversarial_faults,
    faulty,
    from_spec,
    straggler_mask,
)
