"""The held experts' SwiGLU FFN over the slots routed to them, in a decode
step: each held expert's gated product on the tokens that chose it,
weighted by the routing weight, and each token's held slots summed in
top-k order in f32 (``repro_torch.models.moe.moe_block_held``'s decode
arm).

Replaces no TPU kernel: the JAX package has no held-expert path.  It was
added because the decode step ran every held expert over every token (8
experts x 1024 rows for ~171 routed slots at the Kimi-K2 decode cell's
batch, ~48x the products) and weighted and summed the (8, t, d) result in
f32: ~5 ms of a ~23 ms step on an H100.  A path sized by the routed slots
needed a host read of the counts, which left the card idle.

What bounds it on an H100: bytes.  Each held expert's three matrices (3 x
7168 x 2048 bf16, 88 MB) are read once for the ~21 tokens routed to it,
~21 flops a byte against the ~295 at which the tensor cores would set the
pace: 8 experts, 704 MB a layer, 0.21 ms at 3.35 TB/s.

What the design does about it (``csrc/held_experts.cu``): the slot lists
(the slots stably sorted by held expert, and the running counts, which
``held_slots`` builds in plain PyTorch) are built on the card by a
one-block counting sort, so no launch waits on the host.  A gather writes the routed rows in expert
order, only as many as the card counted.
The gate-and-up kernel runs a block per (expert, 64 intermediate
columns); the down kernel a block per (expert, 64 hidden columns).  In
each one producer thread streams the expert's weight tiles (and its
gathered rows) through a ring of stages by TMA, and one warpgroup adds
their products into f32 registers by ``wgmma``: every weight byte crosses
the bus once while an expert holds at most 64 slots (more are walked in
tiles of 64).  h = silu(g) u is stored once in bf16, as the plain chain
feeds ``w_down`` a bf16 operand; each slot's output row times its routing
weight in f32 at its (token, place); a last pass sums each token's held
places in order, with no atomics, so two calls give the same bits.

The kernel is built for bf16 with both widths multiples of 64 (Kimi-K2's
7168 and 2048).  ``moe_block_held`` launches it for those tensors on the
card (``takes``) and runs the plain version for anything else: other
widths, other dtypes, the CPU.  ``held_expert_ffn.launches`` counts calls:
one a layer a step, each five device launches (sort, gather, gate and up,
down, combine).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

TILE = 64

_Geometry = ctypes.c_longlong * 6


def takes(device: torch.device, dtype: torch.dtype, d: int, fe: int,
          held: int) -> bool:
    """Whether the kernel runs for tensors of this device and dtype at
    these widths (hidden, expert intermediate) and held count: bf16 on the
    card, both widths multiples of 64."""
    return (device.type == "cuda" and dtype == torch.bfloat16
            and d >= TILE and fe >= TILE and d % TILE == 0
            and fe % TILE == 0 and held >= 1)


def held_slots(key: torch.Tensor, held: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The slot lists, in plain PyTorch (the kernel builds its own).

    key : (t, k) int64, the held expert of each (token, place), ``held``
          where the expert is not held here
    Returns (order, ends): ``order`` (t k,) the flat index token * k +
    place of every slot, stably sorted by held expert (the slots of
    expert e are ``order[ends[e-1]:ends[e]]``, in token order, those not
    held last); ``ends`` (held + 1,) the running counts."""
    flat = key.reshape(-1)
    per = torch.zeros(held + 1, dtype=torch.long, device=key.device)
    per.scatter_add_(0, flat, torch.ones_like(flat))
    return torch.argsort(flat, stable=True), torch.cumsum(per, 0)


def _check(tokens, w_gate, w_up, w_down, weights, key) -> None:
    if tokens.ndim != 2 or w_gate.ndim != 3:
        raise ValueError("held_expert_ffn: tokens must be 2-d and the "
                         "expert weights 3-d")
    t, d = tokens.shape
    held, _, fe = w_gate.shape
    k = key.shape[-1]
    want = ((held, d, fe), (held, d, fe), (held, fe, d), (t, k), (t, k))
    got = (w_gate.shape, w_up.shape, w_down.shape, weights.shape, key.shape)
    if got != want:
        names = ("w_gate", "w_up", "w_down", "weights", "key")
        bad = {n: (tuple(g), w) for n, g, w in zip(names, got, want)
               if g != w}
        raise ValueError(f"held_expert_ffn: tokens {tuple(tokens.shape)} "
                         f"and {held} held experts of width {fe}: (got, "
                         f"want) {bad}")


def held_expert_ffn_plain(tokens: torch.Tensor, w_gate: torch.Tensor,
                          w_up: torch.Tensor, w_down: torch.Tensor,
                          weights: torch.Tensor, key: torch.Tensor
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments): the
    gathered arithmetic, one expert at a time over its slots
    (``held_slots``, then one host read of ``ends``), products in f32, h
    rounded to the tokens' dtype, each slot's row weighted in f32 at its
    (token, place), and the places summed in order."""
    _check(tokens, w_gate, w_up, w_down, weights, key)
    t, d = tokens.shape
    held, k = w_gate.shape[0], key.shape[1]
    order, ends = held_slots(key, held)
    bounds = [0, *ends[:held].tolist()]
    y = torch.zeros((t * k, d), dtype=torch.float32, device=tokens.device)
    for e in range(held):
        slots = order[bounds[e]:bounds[e + 1]]
        if not len(slots):
            continue
        xe = tokens[torch.div(slots, k, rounding_mode="floor")].float()
        h = (F.silu(xe @ w_gate[e].float())
             * (xe @ w_up[e].float())).to(tokens.dtype)
        y[slots] = (h.float() @ w_down[e].float()) \
            * weights.reshape(-1)[slots, None]
    y = y.view(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=tokens.device)
    for j in range(k):
        out += torch.where((key[:, j] < held)[:, None], y[:, j], 0.0)
    return out


def held_expert_ffn(tokens: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor,
                    weights: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """sum over each token's held places j of weights[token, j] *
    (silu(x Wg[e]) * (x Wu[e])) Wd[e], e = key[token, j].

    tokens  : (t, d)          the layer's input rows
    w_gate, w_up : (held, d, fe), w_down : (held, fe, d)  the held experts
    weights : (t, k) f32      routing weights
    key     : (t, k) int64    held expert of each place, ``held`` if none
    Returns (t, d) f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (bf16, both widths multiples of 64) or raises."""
    if tokens.device.type == "cpu":
        return held_expert_ffn_plain(tokens, w_gate, w_up, w_down, weights,
                                     key)
    return _launch(tokens, w_gate, w_up, w_down, weights, key)[0]


def scratch_layout(t: int, d: int, fe: int, held: int, k: int
                   ) -> tuple[list[int], int]:
    """Byte offsets in a call's one scratch allocation, each on a 256-byte
    boundary, of the slot lists ``order`` (t k int64) and ``ends`` (held
    + 1 int64), the gathered rows (t min(k, held), d) and h (t min(k,
    held), fe) bf16, and the slots' rows (t k, d) f32; and its size."""
    slots = t * min(k, held)
    offsets, at = [], 0
    for nbytes in (t * k * 8, (held + 1) * 8, slots * d * 2, slots * fe * 2,
                   t * k * d * 4):
        offsets.append(at)
        at += -(-nbytes // 256) * 256
    return offsets, at


def _launch(tokens, w_gate, w_up, w_down, weights, key):
    """``held_expert_ffn`` on the card -> (out, scratch): the output, and
    the call's scratch (``scratch_layout``), which holds the slot lists
    the kernel built."""
    _check(tokens, w_gate, w_up, w_down, weights, key)
    dev = tokens.device
    if dev.type != "cuda":
        raise ValueError(f"held_expert_ffn: unsupported device {dev}")
    t, d = tokens.shape
    held, _, fe = w_gate.shape
    k = key.shape[1]
    for name, x in (("tokens", tokens), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        _build.require(x, name, dev, torch.bfloat16)
        if x.data_ptr() % 16:
            raise ValueError(f"held_expert_ffn: {name} must start on a "
                             f"16-byte boundary")
    _build.require(weights, "weights", dev, torch.float32)
    _build.require(key, "key", dev, torch.int64)
    if not takes(dev, tokens.dtype, d, fe, held):
        raise ValueError(f"held_expert_ffn: the kernel takes widths that "
                         f"are multiples of {TILE}; got d = {d}, fe = {fe}")
    offsets, nbytes = scratch_layout(t, d, fe, held, k)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    if t == 0:
        return out, scratch
    base = scratch.data_ptr()
    arr = _Geometry(t, d, fe, held, k, dev.index if dev.index is not None
                    else torch.cuda.current_device())
    err = _build.library().repro_held_experts(
        tokens.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), weights.data_ptr(), key.data_ptr(),
        *(base + at for at in offsets), out.data_ptr(),
        ctypes.addressof(arr), _build.stream_ptr(dev))
    _build.check(err, "held_expert_ffn")
    _build.count_launch(held_expert_ffn)
    return out, scratch


held_expert_ffn.launches = 0
