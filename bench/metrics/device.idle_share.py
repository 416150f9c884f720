"""The share of the traced window in which no device activity ran, from
the profiler's kernel, copy and set intervals, merged."""

from devtrace import idle_share


def read(run):
    return idle_share(run.trace)
