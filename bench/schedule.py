"""What every traffic generator shares: the mix's data file, the seed's
random streams, straggler masks, balanced draws and the sample of calls
the comparison judges.

A mix is a data file, ``bench/traffic/<mix>.json``, of parameters only.
Its ``generator`` names the module of ``bench/generators/`` that reads
it and drives the system through the window, so a mix with new
parameters is a new data file, and an arrival process the generators
lack is a new module beside them; neither edits a file that is there.
The parameters every generator reads:

- ``stragglers``: ``"race"`` (no mask: the system takes the fastest k),
  ``"random"`` (each call leaves out s of the n workers, drawn uniformly
  and independently per call) or ``"patterns"`` (each call leaves out
  one of the C(n, s) patterns of s workers, every pattern equally often
  within each block of calls, in an order drawn from the seed);
- ``pattern_count`` (optional, with ``"patterns"``): only that many
  patterns, the first of one fixed order that no seed changes, so that
  every seed sends the same set;
- ``rows``: ``[lo, hi]``: each call takes a block of that many
  consecutive rows of the system's pool of operands (every width equally
  often within each block of calls, in an order drawn from the seed),
  from an offset drawn from the seed and at most ``pool - hi``;
- ``check_calls``: how many of the window's calls the comparison
  samples, uniformly, by a reservoir drawn from the seed.

Every random draw comes from ``numpy.random.default_rng([seed, stream])``
with one stream per purpose, so two runs of one seed make the same calls.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

# independent random streams of one seed; the warm-up's calls come from
# streams of their own (``base=WARM_BASE``)
STREAM_CALLS, STREAM_ORDER, STREAM_SAMPLE = 1, 2, 3
WARM_BASE = 100
# calls are drawn this many at a time, each block balanced on its own
BLOCK = 1024
# the fixed order ``pattern_count`` takes its patterns from
PATTERN_ORDER_SEED = 0


def load(name: str, root: Path = TRAFFIC_DIR) -> dict:
    path = root / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def mask(n: int, out) -> np.ndarray:
    """The done mask of n workers with ``out`` left out."""
    done = np.ones(n, bool)
    done[np.asarray(out, dtype=np.intp)] = False
    return done


def patterns(n: int, s: int, count: int | None = None) -> list[np.ndarray]:
    """The masks that leave out s of n workers: all of them, or the first
    ``count`` of one fixed order."""
    pats = list(itertools.combinations(range(n), s))
    if count is not None:
        order = np.random.default_rng(PATTERN_ORDER_SEED).permutation(
            len(pats))
        pats = [pats[i] for i in sorted(order[:count])]
    return [mask(n, out) for out in pats]


def balanced(values, count: int, gen: np.random.Generator) -> np.ndarray:
    """``count`` draws that take each of ``values`` equally often (up to
    one), in an order drawn from ``gen``."""
    return gen.permutation(np.resize(np.asarray(values), count))


def straggler_block(traffic: dict, n: int, s: int, count: int,
                    gen: np.random.Generator) -> list:
    """The masks of ``count`` calls, by the mix's ``stragglers``."""
    mode = traffic["stragglers"]
    if mode == "race":
        return [None] * count
    if mode == "random":
        outs = np.argsort(gen.random((count, n)), axis=1)[:, :s]
        return [mask(n, out) for out in outs]
    if mode == "patterns":
        pats = patterns(n, s, traffic.get("pattern_count"))
        return [pats[i] for i in balanced(np.arange(len(pats)), count, gen)]
    raise ValueError(f"stragglers {mode!r} not supported")


def row_block(traffic: dict, pool_rows: int, count: int,
              gen: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(widths, offsets) of ``count`` calls, by the mix's ``rows``."""
    lo, hi = traffic["rows"]
    if pool_rows < hi:
        raise ValueError(f"a pool of {pool_rows} rows cannot give {hi}")
    widths = balanced(np.arange(lo, hi + 1), count, gen)
    offsets = gen.integers(0, pool_rows - hi + 1, size=count)
    return widths, offsets


class Reservoir:
    """A uniform sample of ``k`` calls from a stream of unknown length
    (Algorithm R), drawn from the seed.  Holding a call's output is
    holding a reference: nothing is copied in the timed path."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.gen = rng(seed, STREAM_SAMPLE)
        self.kept: list = []
        self.seen = 0

    def offer(self, item, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((item, out))
        else:
            j = int(self.gen.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (item, out)
        self.seen += 1
