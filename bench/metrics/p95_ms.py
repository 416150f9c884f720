"""95th percentile of request-to-result latency over every call of the
window that returned: one percentile of all of them, never a median of
chunks."""

from stats import percentile


def read(run):
    lat = run.record.latency_s
    return percentile(lat, 95) * 1e3 if lat else None
