"""Coded layers.  ``CodedLinear`` is ported; ``CodedAggregator`` (the
trainer's coded gradients) and the mesh sharding rules wait for the
training and mesh slices."""

from .coded_layer import CodedLinear  # noqa: F401
