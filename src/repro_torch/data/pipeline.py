"""Synthetic deterministic data pipeline with host sharding + prefetch.

A production loader would stream tokenized shards; here the substrate is
faithful (deterministic per-step batches, host-sharded slicing, double-
buffered prefetch, checkpointable cursor) while the bytes are synthetic:
a mixture of Zipf-distributed tokens with short copy motifs, so tiny LMs
trained on it show a real, monotonically-decreasing loss (used by the
end-to-end example and the trainer test).

The port's copy of ``repro.data.pipeline``: plain numpy, so a batch is
bitwise the JAX package's for any (config, step, host split).  Batches
are host arrays (``labels`` int32); the trainer moves them to the
model's device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    host_count: int = 1
    host_index: int = 0


class SyntheticTokens:
    """Deterministic, seekable synthetic token stream.

    ``batch_at(step)`` is a pure function of (config, step) so restart-
    from-checkpoint reproduces the exact stream on any host layout.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.host_count:
            raise ValueError("global_batch must divide by host_count")
        self.local_batch = cfg.global_batch // cfg.host_count

    def _gen_row(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        n = cfg.seq_len + 1
        base = rng.zipf(cfg.zipf_a, size=n).astype(np.int64)
        row = (base - 1) % (cfg.vocab - 2) + 2        # reserve 0=pad, 1=bos
        # plant copy motifs: short repeated spans (gives the LM signal);
        # clamp the motif so it always fits twice in short sequences
        m = min(cfg.motif_len, max(1, (n - 1) // 2))
        for _ in range(max(1, n // (4 * m))):
            start = int(rng.integers(0, max(1, n - 2 * m)))
            span = row[start: start + m]
            row[start + m: start + 2 * m] = span
        row[0] = 1
        return row

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        for b in range(self.local_batch):
            global_row = step * cfg.global_batch + \
                cfg.host_index * self.local_batch + b
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, global_row]))
            rows.append(self._gen_row(rng))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}


class PrefetchIterator:
    """Double-buffered background prefetch over a seekable source."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                batch = self.source.batch_at(step)
                item = (step, batch)
            except Exception as e:  # noqa: BLE001 - propagate to consumer
                item = ("error", e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "error":
                return
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        if step == "error":
            raise batch          # re-raise worker failures, never deadlock
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()


def make_pipeline(cfg: DataConfig, start_step: int = 0) -> PrefetchIterator:
    return PrefetchIterator(SyntheticTokens(cfg), start_step)
