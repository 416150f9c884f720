"""The coded head's share of its roofline: the least time the uncoded
``x @ head`` of every call completed in the traced window needs
(``System.work``: the head read once, x read and the logits written
once, the operations; the larger of bytes over the card's bandwidth and
operations over its rate for the head's dtype), over the device's busy
time in that window.  No coded intermediate is counted, so the count
holds whatever implements the call."""


def read(run):
    least, trace = run.work.get("least_s"), run.trace
    if not least or trace is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * least / trace["busy_s"]
