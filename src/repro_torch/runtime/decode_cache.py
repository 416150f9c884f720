"""Decode planner: per-straggler-pattern decode plans, LRU-cached.

The server-side decode solves ``G[rows] @ U = Y[rows]`` for the k
unknowns, where ``rows`` are the fastest-k completed tasks.  The k x k
factorisation depends *only* on the straggler pattern, and on a real
cluster the same handful of patterns recurs step after step.

``DecodeCache`` keys the precomputed inverse on the ``done`` mask's host
bytes: a hit costs a dict lookup, a miss one host-side k x k inversion
in f64, cast to f32 -- exactly the reference's arithmetic, so the
decode tolerances do not drift.  Each plan also holds the inverse and
the live rows on the plan's device for the ``decode_matmul`` and
``bcsr_matmul`` kernels.  A done mask that lives on the card is copied
to the host first, which synchronises with the stream.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .._device import host_mask


@dataclass(frozen=True)
class DecodePlan:
    """Precomputed decode for one straggler pattern."""

    key: bytes                 # canonical done-mask bytes
    rows: np.ndarray           # (k,) fastest-k task rows (host ints)
    hinv: np.ndarray           # (k, k) f32 inverse of G[rows] (host)
    hinv_dev: torch.Tensor     # same, on the plan's device
    rows_dev: torch.Tensor     # rows as int32, on the plan's device


class DecodeCache:
    """LRU cache of ``DecodePlan`` keyed on the done mask."""

    def __init__(self, G, k: int, maxsize: int = 64, device="cpu"):
        self._G = np.asarray(G, dtype=np.float64)
        if self._G.shape[1] != k:
            raise ValueError(f"G has {self._G.shape[1]} unknowns, expected {k}")
        self.k = k
        self.maxsize = maxsize
        self.device = torch.device(device)
        self._plans: OrderedDict[bytes, DecodePlan] = OrderedDict()
        self.hits = 0
        self.misses = 0   # == number of host-side k x k inversions run
        self._lock = threading.Lock()

    def plan(self, done) -> DecodePlan:
        mask = host_mask(done)
        if mask.ndim != 1 or mask.shape[0] != self._G.shape[0]:
            raise ValueError(
                f"done mask shape {mask.shape} incompatible with "
                f"{self._G.shape[0]} tasks")
        key = np.packbits(mask).tobytes()
        with self._lock:
            cached = self._plans.get(key)
            if cached is not None:
                self._plans.move_to_end(key)
                self.hits += 1
                return cached

        rows = np.flatnonzero(mask)[: self.k]
        if rows.shape[0] < self.k:
            raise ValueError(
                f"only {rows.shape[0]} tasks done, need k={self.k}")
        hinv = np.linalg.inv(self._G[rows]).astype(np.float32)
        plan = DecodePlan(
            key=key, rows=rows, hinv=hinv,
            hinv_dev=torch.from_numpy(hinv).to(self.device),
            rows_dev=torch.from_numpy(rows.astype(np.int32)).to(self.device))
        with self._lock:
            self._plans[key] = plan
            self.misses += 1
            if len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
        return plan

    def patterns(self) -> np.ndarray:
        """(P, n_tasks) bool -- the cached straggler patterns, LRU order."""
        n = self._G.shape[0]
        with self._lock:
            keys = list(self._plans)
        if not keys:
            return np.zeros((0, n), bool)
        rows = [np.unpackbits(np.frombuffer(key, np.uint8))[:n]
                for key in keys]
        return np.asarray(rows, bool)

    def __len__(self) -> int:
        return len(self._plans)

    def clear(self) -> None:
        self._plans.clear()
        self.hits = self.misses = 0
