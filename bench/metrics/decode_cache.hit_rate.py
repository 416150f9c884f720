"""Decode-cache hits over lookups in the window (``DecodeCache.hits`` and
``misses``, read before and after it)."""


def read(run):
    if "decode_cache" not in run.after:
        return None
    hits = run.delta("decode_cache", "hits")
    misses = run.delta("decode_cache", "misses")
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
