"""The decode step's share of its roofline: the least time of every step
completed in the traced window (``System.work``'s ``step_least_s``: the
larger of the step's least bytes over the card's bandwidth -- the
weights it uses read once, the latent cache read once to the step's
length, the logits written once -- and its operations over the card's
rates), summed, over the device's busy time in that window."""


def read(run):
    least, trace = run.work.get("step_least_s"), run.trace
    if not least or trace is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * least / trace["busy_s"]
