"""The whole coded call's share of the card's peak: the operations the
uncoded product of every call completed in the traced window needs
(``System.work``: 2 * hidden_size * vocab_size per row of a head call),
over the traced window at the card's dense bf16 peak."""

from yardstick import PEAK_FLOPS_PER_S


def read(run):
    flops = run.work.get("flops")
    if not flops or run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * flops / (run.trace["window_s"] * PEAK_FLOPS_PER_S)
