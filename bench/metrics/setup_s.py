"""Process start to the first timed call: imports, the card, the inputs
from the seed, the plan's compile and pack, the kernels' build or load
and the warm-up calls."""


def read(run):
    return run.setup_s
