"""Decode steps of a batch of sessions at long contexts: ``steps`` with
the checked sessions drawn from every session, not from every prefill
group.

``steps`` checks ``check_per_group`` sessions of each prefill group, so
that a fault in one group's cache shows; with two sessions a group and
32k-token prompts that would be half the sessions, each an f32
reference forward of ~33k tokens.  Here the mix's data file
(``bench/traffic/<mix>.json``, ``"generator": "long_steps"``) gives
``check_sessions``, how many sessions the comparison reads of every
sampled step, drawn from the seed once a run over all sessions; every
other key, and everything else, is ``steps``'s: the prompts, the ids
fed, the positions and the rewind, the warm steps, the reservoir of
``check_steps`` sampled steps, where a sampled step keeps what the
system's ``answer(out, item)`` gives (its checked rows of the logits and
whatever else its comparison reads).
"""

from __future__ import annotations

import functools

import harness
import schedule
from loops import closed_loop

steps = harness.load_module("generators", "steps")


def checked(traffic: dict, seed: int):
    """The sessions the comparison reads of every sampled step, sorted:
    ``check_sessions`` of all sessions."""
    gen = schedule.rng(seed, steps.STREAM_ROWS)
    return sorted(gen.choice(traffic["sessions"], traffic["check_sessions"],
                             replace=False).tolist())


def items(system, traffic: dict, seed: int, start: int = 0):
    """``steps.items`` with this module's checked sessions."""
    import numpy as np
    import torch
    vocab = system.vocab
    rows = np.asarray(checked(traffic, seed))
    i = start
    while True:
        ids = torch.as_tensor(steps.fed(traffic, vocab, seed, i)[:, None],
                              device=system.dev)
        yield {"index": i, "pos": steps.position(traffic, i), "ids": ids,
               "rows": rows,
               "history": functools.partial(steps.history, traffic, vocab,
                                            seed, i, rows)}
        i += 1


class AnswerReservoir(steps.RowReservoir):
    """``steps.RowReservoir`` keeping ``answer(out, item)`` of a kept
    step."""

    def __init__(self, k: int, seed: int, answer):
        super().__init__(k, seed)
        self.answer = answer

    def offer(self, item, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((item, self.answer(out, item)))
        else:
            j = int(self.gen.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (item, self.answer(out, item))
        self.seen += 1



def warm(system, traffic: dict, seed: int) -> None:
    """Prefill every session's prompt into one cache, then run the warm
    steps, keeping each one's answer as the window's sampler does."""
    system.prefill(steps.prompts(traffic, system.vocab, seed),
                   traffic["cache"], traffic["prefill_group"])
    it = items(system, traffic, seed)
    held = []
    for _ in range(traffic["warm_steps"]):
        item = next(it)
        held.append(system.answer(system.call(item), item))
    del held


def measure(system, traffic: dict, seconds: float, seed: int, dev, window,
            label: bool):
    """The window: ``loops.closed_loop`` over the steps after the warm
    ones, ``check_steps`` of them sampled."""
    sampler = AnswerReservoir(traffic["check_steps"], seed, system.answer)
    rec = closed_loop(system.call,
                      items(system, traffic, seed, traffic["warm_steps"]),
                      seconds, dev, sampler, window, label=label)
    rec.samples = sampler.kept
    return rec
