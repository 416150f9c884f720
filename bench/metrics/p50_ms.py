"""Median request-to-result latency over every call of the window that
returned."""

from stats import percentile


def read(run):
    lat = run.record.latency_s
    return percentile(lat, 50) * 1e3 if lat else None
