"""Latent attention's absorbed decode: the scores of every head over a
session's cached ``[c | kr]``, their softmax, and the probability-weighted
sum of ``c`` (``repro_torch.models.mla.mla_decode``'s core).

Replaces no TPU kernel: the JAX package has no latent attention.  It was
added because the plain chain (six eager ops a layer: a product over
``kr``, one over ``c`` that writes bf16 scores (B, L, H) to device memory,
a transposing copy, the softmax, another copy, and the product of the
probabilities with ``c``) took 60-70% of a Kimi-K2 decode step's busy
time on an H100: the scores went through device memory about eight
times and ``c`` was read twice.

What bounds it on an H100: bytes.  A session's 64 heads share its latent
cache, so each cached position (1,152 bytes in bf16) is read once for
2 * 64 * (576 + 512) flops, about 120 flops a byte, below the ~295 at
which the tensor cores would be the limit: at 1024 sessions of 2,200
positions, 2.6 GB, 0.78 ms at 3.35 TB/s.

What the design does about it (``csrc/mla_decode.cu``): a persistent
grid, one block an SM, walks the sessions; a session's heads are one
64-row ``wgmma`` tile.  One producer thread streams 64-position tiles of
``[c | kr]`` through two shared-memory stages by TMA in the swizzled
layout ``wgmma`` reads, so ``c`` crosses the memory bus once; the tensor
maps end at ``length``, so rows past it arrive as zeros and a stale row
of the buffer is never read.  Two consumer warpgroups keep the scores in
f32 registers (half the tile's positions each), run an online softmax
in f32, round the probabilities to bf16 in shared memory (as the plain
chain rounds them) and each adds them times its half of ``c``'s columns
into f32 accumulators; ``o_lat`` is written once, in bf16.

The kernel is built for bf16 at Kimi-K2's (and DeepSeek-V3's) latent
widths: ``kv_lora_rank`` 512, ``qk_rope_head_dim`` 64, up to 64 heads.
``mla_decode`` launches it for exactly those tensors on the card
(``takes``) and runs the plain version for everything else: other
widths, other dtypes, the CPU.  ``mla_decode_attention.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEADS_MAX = 64
LATENT = 512
ROPE = 64

_Geometry = ctypes.c_longlong * 12


def takes(device: torch.device, dtype: torch.dtype, n_heads: int,
          latent: int, rope: int) -> bool:
    """Whether the kernel runs for tensors of this device and dtype at
    these widths (heads, ``c``'s and ``kr``'s): bf16 on the card, up to 64
    heads, R = 512, P = 64."""
    return (device.type == "cuda" and dtype == torch.bfloat16
            and 1 <= n_heads <= HEADS_MAX and latent == LATENT
            and rope == ROPE)


def mla_decode_attention_plain(q_hat: torch.Tensor, q_pe: torch.Tensor,
                               c: torch.Tensor, kr: torch.Tensor,
                               length: int, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments): six eager
    ops, in the cache's dtype."""
    c, kr = c[:, :length], kr[:, :length]
    # scores laid out (B, L, H): each session's cache is the GEMM's
    # tall operand, which cuBLAS streams ~3x faster than as the wide
    # one of (B, H, L); the softmax runs on a (B, H, L) copy, and the
    # probabilities go back to (B, L, H) for the same reason
    scores = torch.bmm(kr, q_pe.transpose(1, 2))               # (B, L, H)
    scores.baddbmm_(c, q_hat.transpose(1, 2), beta=scale, alpha=scale)
    # the softmax sums in f32 whatever its operand's type, and writes
    # the probabilities in the cache's type, which the next product
    # reads them in
    probs = torch.softmax(scores.transpose(1, 2).contiguous(), dim=-1)
    probs = probs.transpose(1, 2).contiguous()                 # (B, L, H)
    return torch.bmm(probs.transpose(1, 2), c)                 # (B, H, c)


def _strides(t: torch.Tensor, name: str) -> tuple[int, int]:
    """``t``'s (session, row) strides in elements, as the tensor maps take
    them: unit column stride, both 16-byte multiples (a lone session's
    stride is not read)."""
    if t.stride(2) != 1:
        raise ValueError(f"mla_decode_attention: {name} must have stride 1 "
                         f"in its last dim, got strides {t.stride()}")
    s_b = t.stride(0) if t.shape[0] > 1 else t.shape[1] * t.stride(1)
    s_r = t.stride(1) if t.shape[1] > 1 else t.shape[2]
    if s_b % 8 or s_r % 8 or t.data_ptr() % 16:
        raise ValueError(f"mla_decode_attention: {name}'s strides "
                         f"{t.stride()} and start must be 16-byte multiples")
    return s_b, s_r


def mla_decode_attention(q_hat: torch.Tensor, q_pe: torch.Tensor,
                         c: torch.Tensor, kr: torch.Tensor, length: int,
                         scale: float) -> torch.Tensor:
    """softmax(scale * [q_hat | q_pe] [c | kr]^T) c over positions
    ``0 .. length-1``, per session and head.

    q_hat : (B, H, R)  the query folded through W_kvb's key half
    q_pe  : (B, H, P)  the rotated query
    c     : (B, L, R)  the latent cache (``cache["c"]``, whole: any
            session stride, rows contiguous)
    kr    : (B, L, P)  the rotated keys (``cache["kr"]``)
    Returns o_lat : (B, H, R) in the cache's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bf16, H <= 64, R = 512, P = 64) or raises.
    """
    if q_hat.ndim != 3 or q_pe.ndim != 3 or c.ndim != 3 or kr.ndim != 3:
        raise ValueError("mla_decode_attention: q_hat, q_pe, c and kr must "
                         "be 3-d")
    b, h, r = q_hat.shape
    p, length_max = q_pe.shape[2], c.shape[1]
    if (q_pe.shape[:2] != (b, h) or c.shape != (b, length_max, r)
            or kr.shape != (b, length_max, p)):
        raise ValueError(f"mla_decode_attention: shapes q_hat "
                         f"{tuple(q_hat.shape)}, q_pe {tuple(q_pe.shape)}, "
                         f"c {tuple(c.shape)}, kr {tuple(kr.shape)} disagree")
    if not 1 <= length <= length_max:
        raise ValueError(f"mla_decode_attention: length {length} outside a "
                         f"cache of {length_max}")
    dev = q_hat.device
    for name, t in (("q_pe", q_pe), ("c", c), ("kr", kr)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type == "cpu":
        return mla_decode_attention_plain(q_hat, q_pe, c, kr, length, scale)
    if dev.type != "cuda":
        raise ValueError(f"mla_decode_attention: unsupported device {dev}")
    for name, t in (("q_hat", q_hat), ("q_pe", q_pe), ("c", c), ("kr", kr)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mla_decode_attention: {name} must be "
                            f"torch.bfloat16, got {t.dtype}")
    if not takes(dev, q_hat.dtype, h, r, p):
        raise ValueError(f"mla_decode_attention: the kernel takes up to "
                         f"{HEADS_MAX} heads, R = {LATENT}, P = {ROPE}; got "
                         f"H = {h}, R = {r}, P = {p}")
    geom = [*_strides(q_hat, "q_hat"), *_strides(q_pe, "q_pe")]
    for name, t in (("c", c), ("kr", kr)):
        s_b, s_r = _strides(t, name)
        if b > 1 and s_b < length_max * s_r:
            raise ValueError(f"mla_decode_attention: {name}'s sessions "
                             f"overlap (strides {t.stride()})")
        geom += [s_b, s_r]
    out = torch.empty((b, h, r), dtype=torch.bfloat16, device=dev)
    if b == 0:
        return out
    arr = _Geometry(b, h, length, *geom, dev.index if dev.index is not None
                    else torch.cuda.current_device())
    err = _build.library().repro_mla_decode(
        q_hat.data_ptr(), q_pe.data_ptr(), c.data_ptr(), kr.data_ptr(),
        out.data_ptr(), ctypes.addressof(arr), float(scale),
        _build.stream_ptr(dev))
    _build.check(err, "mla_decode_attention")
    _build.count_launch(mla_decode_attention)
    return out


mla_decode_attention.launches = 0
