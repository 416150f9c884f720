"""Decode steps of a batch of sessions, back to back: an engine that holds
``sessions`` sessions on one chip and answers every one of them each
step, waiting for the step's logits before the next.

The mix's data file (``bench/traffic/<mix>.json``, ``"generator":
"steps"``) gives:

- ``sessions``: the rows of every step;
- ``prompt``: each session's prompt length; the prompts' ids are drawn
  from the seed;
- ``cache``: the positions the serving cache holds per session;
- ``prefill_group``: how many sessions one prefill call takes (sized to
  fit the prefill's activations); the groups' caches are joined into one;
- ``warm_steps``: decode steps run at set-up, before the window;
- ``check_steps``, ``check_per_group``: how many of the window's steps
  the comparison samples (a reservoir drawn from the seed), and how many
  sessions of each prefill group it reads in every sampled step (drawn
  from the seed once a run: every group is read, and each checked
  session at every sampled step).

Step i (warm-up first, from 0, then the window, numbering on) writes
position ``prompt + i mod (cache - prompt)``: when the cache is full the
step rewinds to the end of the prompt, and the same sessions are
answered again.  Each step feeds one id per session, drawn from the seed
(teacher forcing: never sampled, since with random weights an argmax
flips on rounding).  Every item carries ``history()``: the ids fed since
the last rewind up to its own step, for its checked sessions, which the
comparison appends to their prompts.
"""

from __future__ import annotations

import functools

import numpy as np

import schedule
from loops import closed_loop

# random streams of one seed, beside ``schedule``'s
STREAM_PROMPT, STREAM_FED, STREAM_ROWS = 11, 12, 13
# steps drawn at once per stream
BLOCK = 64


def prompts(traffic: dict, vocab: int, seed: int) -> np.ndarray:
    """(sessions, prompt) int64 ids."""
    gen = schedule.rng(seed, STREAM_PROMPT)
    return gen.integers(0, vocab, (traffic["sessions"], traffic["prompt"]))


@functools.lru_cache(maxsize=64)
def _fed_block(seed: int, block: int, sessions: int,
               vocab: int) -> np.ndarray:
    gen = np.random.default_rng([int(seed), STREAM_FED, block])
    return gen.integers(0, vocab, (BLOCK, sessions))


def fed(traffic: dict, vocab: int, seed: int, i: int) -> np.ndarray:
    """The ids step ``i`` feeds, one per session."""
    return _fed_block(seed, i // BLOCK, traffic["sessions"],
                      vocab)[i % BLOCK]


def checked(traffic: dict, seed: int) -> np.ndarray:
    """The sessions the comparison reads of every sampled step, sorted:
    ``check_per_group`` of each prefill group."""
    gen = schedule.rng(seed, STREAM_ROWS)
    n, group = traffic["sessions"], traffic["prefill_group"]
    return np.concatenate([
        np.sort(gen.choice(np.arange(at, min(at + group, n)),
                           traffic["check_per_group"], replace=False))
        for at in range(0, n, group)])


def position(traffic: dict, i: int) -> int:
    return traffic["prompt"] + i % (traffic["cache"] - traffic["prompt"])


def history(traffic: dict, vocab: int, seed: int, i: int,
            rows: np.ndarray) -> np.ndarray:
    """(len(rows), steps) ids fed to ``rows`` since the last rewind, up to
    and including step ``i``, in position order."""
    first = i - (position(traffic, i) - traffic["prompt"])
    return np.stack([fed(traffic, vocab, seed, j)[rows]
                     for j in range(first, i + 1)], axis=1)


def items(system, traffic: dict, seed: int, start: int = 0):
    """Step items from step ``start``, without end: the index, the
    position, the fed ids on the system's device, the checked sessions
    and their history."""
    import torch
    vocab = system.vocab
    rows = checked(traffic, seed)
    i = start
    while True:
        ids = torch.as_tensor(fed(traffic, vocab, seed, i)[:, None],
                              device=system.dev)
        yield {"index": i, "pos": position(traffic, i), "ids": ids,
               "rows": rows,
               "history": functools.partial(history, traffic, vocab, seed,
                                            i, rows)}
        i += 1


def warm(system, traffic: dict, seed: int) -> None:
    """Prefill every session's prompt into one cache, then run the warm
    steps, copying each one's checked rows as the window's sampler does."""
    system.prefill(prompts(traffic, system.vocab, seed), traffic["cache"],
                   traffic["prefill_group"])
    steps = items(system, traffic, seed)
    held = []
    for _ in range(traffic["warm_steps"]):
        item = next(steps)
        held.append(_rows(system.call(item), item))
    del held


def _rows(out, item):
    import torch
    return out[torch.as_tensor(item["rows"], device=out.device)].clone()


class RowReservoir(schedule.Reservoir):
    """``schedule.Reservoir`` over steps that keeps, of a kept step's
    output, only its checked sessions' rows (a copy of a few MB, not the
    step's whole logits)."""

    def offer(self, item, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((item, _rows(out, item)))
        else:
            j = int(self.gen.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (item, _rows(out, item))
        self.seen += 1


def measure(system, traffic: dict, seconds: float, seed: int, dev, window,
            label: bool):
    """The window: ``loops.closed_loop`` over the steps after the warm
    ones, ``check_steps`` of them sampled."""
    sampler = RowReservoir(traffic["check_steps"], seed)
    rec = closed_loop(system.call,
                      items(system, traffic, seed, traffic["warm_steps"]),
                      seconds, dev, sampler, window, label=label)
    rec.samples = sampler.kept
    return rec
