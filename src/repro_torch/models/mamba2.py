"""Mamba-2 (SSD, state-space duality) block in plain PyTorch.

The counterpart of ``repro.models.mamba2``: the chunked SSD algorithm of
Dao & Gu (arXiv:2405.21060), an intra-chunk quadratic attention-like
term plus an inter-chunk state recurrence, with the reference's
arithmetic step for step.  The reference scans over chunks with
``lax.scan``; here it is a Python loop over chunks, so live memory stays
O(chunk^2) per head.  Single-token recurrent decode keeps (conv window,
SSD state), the constant-size cache of the SSM archs, and writes both in
place, as the attention cache is written.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from .layers import normal_, rms_norm


def mamba_param_shapes(d_model: int, s: SSMConfig) -> dict:
    """name -> shape; ``A_log``, ``D`` and ``dt_bias`` are always f32."""
    d_in = s.expand * d_model
    n_h = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return {
        # projections: [z, x, B, C, dt]
        "w_in": (d_model, 2 * d_in + 2 * s.d_state + n_h),
        "conv_w": (s.d_conv, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": (n_h,),
        "D": (n_h,),
        "dt_bias": (n_h,),
        "norm_w": (d_in,),
        "w_out": (d_in, d_model),
    }


F32_PARAMS = ("A_log", "D", "dt_bias")


def init_mamba_params(p: dict, d_model: int, s: SSMConfig,
                      gen: torch.Generator) -> dict:
    """Draw a mamba layer's weights into the tensors of ``p`` with the
    reference's values: A = -[1 .. 16] log-spaced over the heads, D = 1,
    dt_bias = 0, conv bias 0, norm 1, projections N(0, 1/fan_in), the
    conv taps N(0, 0.01)."""
    d_in = s.expand * d_model
    n_h = d_in // s.head_dim
    normal_(p["w_in"], d_model ** -0.5, gen)
    normal_(p["conv_w"], 0.1, gen)
    p["conv_b"].zero_()
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, n_h)))
    p["D"].fill_(1.0)
    p["dt_bias"].zero_()
    p["norm_w"].fill_(1.0)
    normal_(p["w_out"], d_in ** -0.5, gen)
    return p


def _split_proj(proj, d_in, n, n_h):
    z = proj[..., :d_in]
    xbc = proj[..., d_in: 2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    if dt.shape[-1] != n_h:
        raise ValueError(f"projection leaves {dt.shape[-1]} dt heads, "
                         f"expected {n_h}")
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv, xbc (B, S, C), w (K, C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _ssd_scan(xdt, dA, B, C, chunk: int, state0=None):
    """Chunked SSD.  xdt (b,S,h,p) [= x*dt], dA (b,S,h), B/C (b,S,n).

    Returns (y (b,S,h,p), final_state (b,h,p,n)), both f32.
    """
    b, s_len, h, p = xdt.shape
    n = B.shape[-1]
    q = min(chunk, s_len)
    if s_len % q:
        raise ValueError(f"S={s_len} not a multiple of chunk={q}")
    nc = s_len // q
    dev = xdt.device

    xc = xdt.float().reshape(b, nc, q, h, p)
    dac = dA.float().reshape(b, nc, q, h)
    bc = B.float().reshape(b, nc, q, n)
    cc = C.float().reshape(b, nc, q, n)

    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
             if state0 is None else state0.float())

    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    mask = tri[None, :, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ys = []
    for c in range(nc):
        x_c, da_c, b_c, c_c = xc[:, c], dac[:, c], bc[:, c], cc[:, c]
        acum = torch.cumsum(da_c, dim=1)                         # (b,q,h)
        # intra-chunk: L[qi,pj] = exp(acum[qi] - acum[pj]) for qi >= pj.
        # double-where keeps exp's argument finite on the masked triangle
        diff = acum[:, :, None, :] - acum[:, None, :, :]         # (b,q,p,h)
        ldec = torch.where(mask, torch.exp(torch.where(mask, diff, zero)),
                           zero)
        scores = torch.einsum("bqn,bpn->bqp", c_c, b_c)          # (b,q,p)
        y_diag = torch.einsum("bqp,bqph,bphd->bqhd", scores, ldec, x_c)
        # carry-in contribution
        y_off = torch.einsum("bqn,bhdn,bqh->bqhd", c_c, state,
                             torch.exp(acum))
        # state update
        decay_to_end = torch.exp(acum[:, -1:, :] - acum)         # (b,q,h)
        contrib = torch.einsum("bqh,bqn,bqhd->bhdn", decay_to_end, b_c, x_c)
        state = state * torch.exp(acum[:, -1])[:, :, None, None] + contrib
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, s_len, h, p)
    return y, state


def _mamba_seq(params: dict, u: torch.Tensor, s: SSMConfig, eps: float):
    """A whole sequence through the block -> (out, raw conv input, final
    SSD state)."""
    b, sl, d_model = u.shape
    d_in = s.expand * d_model
    n, n_h, p = s.d_state, d_in // s.head_dim, s.head_dim

    proj = torch.einsum("bsd,de->bse", u, params["w_in"])
    z, xbc_raw, dt = _split_proj(proj, d_in, n, n_h)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    x = xbc[..., :d_in].reshape(b, sl, n_h, p)
    bmat = xbc[..., d_in: d_in + n]
    cmat = xbc[..., d_in + n:]

    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])                      # (h,)
    da = dt * a                                          # (b,s,h)
    y, state = _ssd_scan(x.float() * dt[..., None], da, bmat, cmat, s.chunk)
    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(b, sl, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"], eps)
    return torch.einsum("bse,ed->bsd", y, params["w_out"]), xbc_raw, state


def mamba_block(params: dict, u: torch.Tensor, s: SSMConfig, *, eps: float
                ) -> torch.Tensor:
    """Training/prefill forward.  u (B, S, d_model) -> (B, S, d_model)."""
    return _mamba_seq(params, u, s, eps)[0]


def mamba_prefill(params: dict, u: torch.Tensor, s: SSMConfig, *,
                  eps: float) -> tuple[torch.Tensor, dict]:
    """The prompt through the block -> (out, the decode cache): the last
    ``d_conv - 1`` raw conv inputs (left-padded with zeros for a short
    prompt) and the final SSD state."""
    out, xbc_raw, state = _mamba_seq(params, u, s, eps)
    pad = s.d_conv - 1
    sl = u.shape[1]
    conv_tail = (xbc_raw[:, -pad:] if sl >= pad
                 else F.pad(xbc_raw, (0, 0, pad - sl, 0)))
    return out, {"conv": conv_tail.contiguous(), "state": state}


# ---------------------------------------------------------------------------
# Recurrent decode
# ---------------------------------------------------------------------------


def init_mamba_cache(batch: int, d_model: int, s: SSMConfig,
                     dtype=torch.float32, device=None) -> dict:
    d_in = s.expand * d_model
    n_h = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, n_h, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def mamba_decode_step(params: dict, u: torch.Tensor, cache: dict,
                      s: SSMConfig, *, eps: float
                      ) -> tuple[torch.Tensor, dict]:
    """u (B, 1, d_model) -> (y (B, 1, d_model), cache); the conv window
    and the state are advanced in place and returned."""
    b, _, d_model = u.shape
    d_in = s.expand * d_model
    n, n_h, p = s.d_state, d_in // s.head_dim, s.head_dim

    proj = torch.einsum("bsd,de->bse", u, params["w_in"])[:, 0]   # (b, e)
    z, xbc_new, dt = _split_proj(proj, d_in, n, n_h)
    # conv over [cache window, new]
    win = torch.cat([cache["conv"], xbc_new[:, None, :].to(
        cache["conv"].dtype)], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", win, params["conv_w"])
                 + params["conv_b"])
    cache["conv"].copy_(win[:, 1:])

    x = xbc[:, :d_in].reshape(b, n_h, p)
    bmat = xbc[:, d_in: d_in + n]
    cmat = xbc[:, d_in + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])               # (b,h)
    a = -torch.exp(params["A_log"])
    da = torch.exp(dt * a)                                         # (b,h)

    contrib = torch.einsum("bhp,bn->bhpn", x.float() * dt[..., None],
                           bmat.float())
    state = cache["state"] * da[:, :, None, None] + contrib
    cache["state"].copy_(state)
    y = torch.einsum("bhpn,bn->bhp", state, cmat.float())
    y = y + params["D"][None, :, None] * x.float()
    y = y.reshape(b, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"], eps)
    out = torch.einsum("be,ed->bd", y, params["w_out"])[:, None, :]
    return out, cache
