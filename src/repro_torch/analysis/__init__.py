"""Analytic FLOP / byte models (``flops``), the collectives a step
dispatches (``collectives``, the counterpart of the reference's HLO
parser ``hlo``), and the roofline over dry-run artifacts
(``roofline``)."""
