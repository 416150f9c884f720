"""The share of the traced window in idle gaps that the reduction names
by one of the model's host ranges (``repro_torch.obs.trace.MODEL_SPANS``:
a prefill or decode step, latent attention, the MoE's routing, experts
and shared expert, the head): device idle spent inside the model's host
code.  None where no gap carries such a name, as with a program that
opens no such ranges."""

# the model's range names begin with these; written here, so the reader
# imports nothing of the program
PREFIXES = ("model.", "mla.", "moe.")


def read(run):
    trace = run.trace
    if trace is None or trace["window_s"] <= 0:
        return None
    named = [s for name, s in trace["gaps"] if name.startswith(PREFIXES)]
    if not named:
        return None
    return 100.0 * sum(named) / trace["window_s"]
