"""Coded layers: ``CodedLinear`` and ``CodedAggregator`` (coded
gradients).  The mesh, sharding and context rules wait for the mesh
slice (ROADMAP.md §1 item 14)."""

from .coded_grads import CodedAggregator  # noqa: F401
from .coded_layer import CodedLinear  # noqa: F401
