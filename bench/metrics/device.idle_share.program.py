"""The share of the traced window in idle gaps that the reduction names
by one of the program's own host ranges (``repro_torch.obs.trace.scope``:
the plan API's operations, the decode cache, each kernel wrapper's host
side): device idle spent inside the program's host code, and not in
the loop, the profiler or an allocation.  None where no gap carries
such a name, as with a program that opens no ranges."""

# the program's range names begin with these; written here, so the
# reader imports nothing of the program
PREFIXES = ("plan.", "decode_cache.", "kernel.")


def read(run):
    trace = run.trace
    if trace is None or trace["window_s"] <= 0:
        return None
    named = [s for name, s in trace["gaps"] if name.startswith(PREFIXES)]
    if not named:
        return None
    return 100.0 * sum(named) / trace["window_s"]
