"""Plain references the benchmark judges the program's outputs against.

Plain PyTorch only: nothing here imports the program (``repro_torch``),
the JAX package or JAX.  Each reference works its answer out again from
the raw inputs the benchmark made, in float64, and each has a control:
the same reference computed one precision step below the one the
configuration states, which the comparison must refuse.
"""
