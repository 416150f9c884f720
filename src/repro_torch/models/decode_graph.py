"""A sparse-attention model's decode step replayed as one CUDA graph.

``TransformerLM.decode_step`` launches some 900 kernels a step from
Python at DeepSeek-V3.2's widths.  At 128 sessions over 33k cached
positions the host needs about as long to launch them as the card needs
to run them (~13 against ~15 ms a step on an H100), so the host sets the
step's pace whenever it runs slower.  ``DecodeGraph`` captures the step
once and replays it: the host launches one graph a step.

What a capture cannot take, and what the step does instead:

- the position is a host int that changes every step: the graph passes
  ``decode_step`` a cache whose ``step`` is a (1,) int64 tensor on the
  device, written before each replay, and each layer writes its cache
  there with ``index_copy_`` (``mla.write_latent``, ``dsa.dsa_decode``);
- the indexer's keys grow by one a step: the graph scores every position
  of the cache and masks those past the step, up to ``max_len - step -
  1`` keys more than the eager step scores;
- the layers' host counters (``LatentBlock.attended`` and ``cached``)
  are added once a replay.

It takes a model whose every layer is a ``SparseLatentBlock`` (a dense
latent layer reads its cache's length as a host int), on a CUDA device,
at positions from ``index_topk`` on (before it a step attends every
position up to its own, a length that changes every step).  The graph
holds the cache it was made with; ``__call__`` answers as
``decode_step``: the logits (B, V), a copy, and the cache advanced.  Each
layer's ``selected`` is the graph's own tensor, overwritten by the next
replay.
"""

from __future__ import annotations

import torch

from ..obs.trace import scope
from .transformer import SparseLatentBlock, TransformerLM


class DecodeGraph:
    """``model.decode_step`` over ``cache`` replayed as one CUDA graph
    (see the module docstring).  Captured at the first call."""

    def __init__(self, model: TransformerLM, cache: dict):
        blocks = model._blocks()
        if not all(isinstance(blk, SparseLatentBlock) for blk in blocks):
            raise ValueError("a decode graph takes a model whose every "
                             "layer is a SparseLatentBlock")
        if model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{model.device}")
        self.model, self.blocks, self.layers = model, blocks, cache["layers"]
        self.batch, self.max_len = self.layers[0]["c"].shape[:2]
        self.topk = model.cfg.indexer.topk
        dev = model.device
        self.tokens = torch.zeros((self.batch, 1), dtype=torch.long,
                                  device=dev)
        self.pos = torch.zeros((1,), dtype=torch.long, device=dev)
        self.graph = None
        self.logits = None

    def _capture(self) -> None:
        """One eager step on a side stream (kernels built, one-time state
        set, nothing created on the host inside the capture), then the
        capture.  The eager step writes the cache at ``pos``, which the
        first replay writes again before it reads it."""
        side = torch.cuda.Stream(self.pos.device)
        side.wait_stream(torch.cuda.current_stream(self.pos.device))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(self.pos.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = self._step()

    def _step(self) -> torch.Tensor:
        """``decode_step`` at the device position ``pos``."""
        return self.model.decode_step({"layers": self.layers,
                                       "step": self.pos}, self.tokens)[0]

    def __call__(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One step of ``cache`` (the one the graph was made with) at its
        ``step`` -> (logits (B, V), the cache at ``step + 1``)."""
        step = cache["step"]
        if cache["layers"] is not self.layers:
            raise ValueError("a decode graph replays the cache it was "
                             "made with")
        if not self.topk <= step < self.max_len:
            raise ValueError(f"a decode graph takes positions {self.topk} "
                             f"to {self.max_len - 1}, not {step}")
        with scope("model.decode_step"):
            self.tokens.copy_(tokens)
            self.pos.fill_(step)
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for blk in self.blocks:
                blk._count(self.batch, self.topk, step + 1)
            return self.logits.clone(), {"layers": self.layers,
                                         "step": step + 1}
