"""A model's coded LM head, called in process under a straggler mask at
every decode step.

The benchmark draws the head (hidden_size, vocab_size) on the device
from the seed, in the served dtype, and a pool of f32 hidden states,
and compiles the head as the serve launcher does: ``compile_plan(head,
scheme=, n=, s=, seed=, backend=)``, which encodes the n workers'
shards and packs them.  Each call is ``plan.matvec(x, done)`` with x a
block of rows of the pool: one ``bcsr_matmul`` over the k live
workers' shards and one ``decode_matmul``, the decode's inverse from
the plan's cache, as ``ServeEngine.coded_logits`` runs outside router
mode.  The reference (``reference/head.py``) works ``x @ head`` out
again from the same head and rows; ``reference/code.py`` builds the
paper's code again to tell how far each call's decode may amplify the
head's rounding.
"""

from __future__ import annotations

import itertools
from statistics import median

import numpy as np
import torch

from reference import code as ref_code
from reference import head as ref_head
from yardstick import (HBM_BYTES_PER_S, bcsr_bytes, bcsr_flops, bound_s,
                       decode_bytes, peak_flops_per_s)


class System:
    """The head, its compiled plan, and the pool of hidden states."""

    # the traced kernel names (prefixes) of each of the port's kernels
    kernel_rows = {"bcsr_matmul": ("bcsr_",), "decode_matmul": ("decode_",)}

    def __init__(self, cfg: dict, seed: int, dev: torch.device):
        from repro_torch.api import compile_plan
        self.cfg, self.dev = cfg, dev
        d, vocab = cfg["hidden_size"], cfg["vocab_size"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.head = torch.randn((d, vocab), generator=gen, device=dev,
                                dtype=getattr(torch, cfg["torch_dtype"]))
        self.head.mul_(cfg["initializer_range"])
        self.pool = torch.randn((cfg["hidden_pool"], d), generator=gen,
                                device=dev)
        self.pool_rows = cfg["hidden_pool"]
        coded = cfg["coded"]
        self.plan = compile_plan(self.head, scheme=coded["scheme"],
                                 n=coded["n_workers"],
                                 s=coded["stragglers"], seed=coded["seed"],
                                 backend=coded["backend"])
        self.n, self.s = self.plan.n, self.plan.s
        self.k = self.n - self.s
        # the paper's code, built again here, never read from the plan
        self.code = ref_code.system_matrix(self.n, self.k, coded["seed"])
        self._control = None

    # -- the timed call ------------------------------------------------------

    def rows(self, item: dict) -> torch.Tensor:
        """The call's block of the pool: a view, nothing is copied."""
        return self.pool[item["row"]:item["row"] + item["width"]]

    def call(self, item: dict) -> torch.Tensor:
        return self.plan.matvec(self.rows(item), item["done"])

    def counters(self) -> dict:
        cache = self.plan.executor.cache
        if cache is None:
            return {}
        return {"decode_cache": {"hits": cache.hits, "misses": cache.misses}}

    def work(self, item: dict) -> dict:
        """What one uncoded ``x @ head`` of the call needs: its operations,
        the head read once, x read and the logits written once, and the
        least time those take on the card.  No coded intermediate is
        counted, so the count holds whatever implements the call."""
        d, vocab = self.head.shape
        w = item["width"]
        flops = 2.0 * d * vocab * w
        nbytes = float(d * vocab * self.head.element_size()
                       + w * d * 4 + w * vocab * 4)
        least, _ = bound_s(nbytes, flops, peak_flops_per_s(self.head.dtype))
        return {"flops": flops, "bytes": nbytes, "least_s": least}

    def kernel_bounds(self, items) -> dict:
        """Per-launch least times (s) of the port's kernels on a sample of
        the window's calls, a diagnostic: the product over the live
        workers' packed shards and the decode."""
        ex = self.plan.executor
        packed = ex.packed
        flops_per_s = peak_flops_per_s(packed.a_data.dtype)
        prods, decs = [], []
        for item in items:
            live = ref_code.decode_rows(item["done"], self.k) \
                if item["done"] is not None else np.arange(self.k)
            w = item["width"]
            prods.append(bound_s(
                bcsr_bytes(packed, live, (packed.t, w), 4, False,
                           self.k * packed.c_pad),
                bcsr_flops(packed, live, w), flops_per_s)[0])
            decs.append(decode_bytes(self.k, packed.c_pad, w)
                        / HBM_BYTES_PER_S)
        if not items:
            return {}
        return {"bcsr_matmul": float(np.mean(prods)),
                "decode_matmul": float(np.mean(decs))}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.plan = None

    # -- the comparison -------------------------------------------------------

    def control(self, item: dict) -> torch.Tensor:
        """The call's logits one precision step below the configuration's
        (``reference/head.py``'s fp8 control), for the program's place."""
        if self._control is None:
            self._control = ref_head.Control(self.head)
        return self._control(self.rows(item))

    def amplification(self, done) -> float:
        """How far the call's decode may amplify the shards' rounding;
        with no mask, the most over every pattern of s stragglers."""
        if done is not None:
            return ref_code.amplification(self.code, done)
        return max(ref_code.amplification(self.code, np.isin(
            np.arange(self.n), out, invert=True))
            for out in itertools.combinations(range(self.n), self.s))

    def check(self, samples) -> dict:
        """Each sampled call's relative error against the reference's
        ``x @ head`` of the same rows.  Compared: their median, and the
        largest of each call's error over its amplification; the widest
        error is reported beside them."""
        logits = ref_head.Logits(self.head)
        errs, scaled = [], []
        for item, out in samples:
            err = ref_head.rel_err(out, logits(self.rows(item)))
            errs.append(err)
            scaled.append(err / self.amplification(item["done"]))
        del logits
        return {"head_rel_err_median": median(errs) if errs else 0.0,
                "head_err_per_amplification_max": max(scaled, default=0.0),
                "head_rel_err_max": max(errs, default=0.0),
                "per_call": errs, "per_call_scaled": scaled,
                "checked_calls": len(samples)}
