"""Mixture-of-Experts layer with sort-based token dispatch, and its coded
(straggler-resilient) expert FFN.

The counterpart of ``repro.models.moe``:

  * Dispatch is gather-based: each token's slot comes from an argsort +
    rank (integer ops), tokens are scattered into an (E, C, d) buffer,
    the expert FFN runs batched, and the slots are gathered back.
  * Capacity-and-drop (cf * T * top_k / E slots per expert, rounded up
    to a multiple of 4); a dropped slot falls back to the residual
    stream.  The reference's out-of-range scatter (``mode="drop"``) has
    no torch counterpart, so the dispatch buffer has one spare row at
    ``E * C`` that takes every dropped slot and is cut off.
  * Every token has exactly ``top_k`` slots in token order, so the
    combine adds each token's slots in slot order (the reference's
    ``segment_sum`` order), with no atomics.
  * Routing logits are f32 and stay full f32 on the card (no TF32):
    routing is discontinuous, and a logit off in its last bit can flip
    the k-th expert.

``moe_block_ep`` is the expert-parallel execution on a mesh (``local_map``
with functional collectives), which ``moe_apply`` takes when an
expert-parallel context is set (``repro_torch.parallel.ctx``).

``moe_block_held`` is DeepSeek-V3's noaux_tc layer (``scoring ==
"sigmoid"``): top-k of sigmoid scores plus a correction bias over the
router's ``n_experts``, weights from the unbiased scores, normalised and
scaled; dropless; only the ``n_held`` experts from ``held_from`` are
computed here (one chip of an expert-parallel deployment, with no
exchange), the shared expert once.  It shares nothing with the softmax
path's routing, dispatch or combine.

``CodedMoE`` runs every expert weight matmul through a compiled
``repro_torch.api.CodedPlan``: on the card (``backend="auto"`` resolves
to ``cuda``) each plan's compile is one ``cyclic_encode`` and each
expert matmul one ``bcsr_matmul`` + one ``decode_matmul``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..kernels.held_experts import (
    held_expert_ffn,
    held_expert_ffn_plain,
    held_slots,
    takes,
)
from ..obs.trace import scope
from ..parallel.ctx import (
    all_gather,
    ep_context,
    pmean,
    psum,
    rank_local,
    shard,
    shard_map_compat,
)
from .layers import normal_


def moe_param_shapes(d_model: int, moe: MoEConfig) -> dict:
    """name -> shape; ``router`` (and sigmoid routing's correction
    ``bias``) always f32, ``shared`` a nested dict when the config has
    shared experts.  The router spans all ``n_experts``; the expert
    weights only the held ones."""
    e, h, held = moe.n_experts, moe.d_expert, moe.held
    shapes = {"router": (d_model, e), "w_gate": (held, d_model, h),
              "w_up": (held, d_model, h), "w_down": (held, h, d_model)}
    if moe.scoring == "sigmoid":
        shapes["bias"] = (e,)
    if moe.n_shared_experts:
        hs = moe.n_shared_experts * h
        shapes["shared"] = {"w_gate": (d_model, hs), "w_up": (d_model, hs),
                            "w_down": (hs, d_model)}
    return shapes


def init_moe_params(p: dict, d_model: int, moe: MoEConfig,
                    gen: torch.Generator, std: float | None = None) -> dict:
    """Draw an MoE layer's weights into the tensors of ``p`` with the
    reference's scales: 1/sqrt(d_model) into the experts and the router,
    1/sqrt(d_expert) out (the shared experts' too); every matrix N(0,
    std) when ``std`` is given.  A correction bias is drawn N(0,
    ``bias_init_std``) last."""
    si, so = d_model ** -0.5, moe.d_expert ** -0.5
    if std is not None:
        si = so = std
    normal_(p["router"], si, gen)
    for name in ("w_gate", "w_up"):
        normal_(p[name], si, gen)
    normal_(p["w_down"], so, gen)
    if moe.n_shared_experts:
        sp = p["shared"]
        normal_(sp["w_gate"], si, gen)
        normal_(sp["w_up"], si, gen)
        normal_(sp["w_down"], so, gen)
    if "bias" in p:
        normal_(p["bias"], moe.bias_init_std, gen)
    return p


def _capacity(tokens: int, moe: MoEConfig) -> int:
    c = int(tokens * moe.top_k * moe.capacity_factor / moe.n_experts) + 1
    return max(4, -(-c // 4) * 4)    # round up to a multiple of 4


@contextlib.contextmanager
def _full_f32():
    """f32 products in full f32 on the card while the block runs."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _route_tokens(router: torch.Tensor, tokens: torch.Tensor,
                  moe: MoEConfig, cap: int):
    """Top-k routing + sort-based slot assignment (integer only).

    Shared by the dense (``moe_block``) and coded (``CodedMoE``) expert
    paths so the dispatch semantics cannot diverge.  Returns ``(aux, fp,
    tok_id, keep, dest)``: the Switch load-balancing aux loss, flattened
    combine weights, token ids, capacity-keep mask and slot destinations
    (``E * cap`` -> dropped).
    """
    t = tokens.shape[0]
    e, k = moe.n_experts, moe.top_k
    dev = tokens.device
    with _full_f32():
        logits = torch.einsum("td,de->te", tokens.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)             # (t, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch): top-1 share x mean prob
    frac_tokens = F.one_hot(top_e[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))

    fe = top_e.reshape(-1)                                   # (t*k,)
    fp = top_p.reshape(-1)
    tok_id = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(fe, stable=True)
    # bincount's integers from a scatter-add, which meta tensors have
    counts = torch.zeros(e, dtype=fe.dtype, device=dev).scatter_add(
        0, fe, torch.ones_like(fe))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    ranks = torch.arange(t * k, device=dev) - starts[fe[order]]
    pos = torch.zeros(t * k, dtype=torch.long, device=dev)
    pos[order] = ranks
    keep = pos < cap
    dest = torch.where(keep, fe * cap + pos, e * cap)        # -> dropped
    return aux, fp, tok_id, keep, dest


def _dispatch(tokens: torch.Tensor, tok_id, dest, e: int, cap: int
              ) -> torch.Tensor:
    """Tokens into their slots -> (E, cap, d); dropped slots land on the
    spare row ``E * cap``, which is cut off."""
    d = tokens.shape[1]
    buf = tokens.new_zeros((e * cap + 1, d))
    buf[dest] = tokens[tok_id]
    return buf[: e * cap].reshape(e, cap, d)


def _combine_slots(ye: torch.Tensor, fp, tok_id, keep, dest, t: int, dtype
                   ) -> torch.Tensor:
    """Expert outputs (E, C, d) -> per-token combine (t, d).  Token
    ``tok_id[j]`` owns slots ``j`` in blocks of top_k, so the sum over
    them is taken in slot order, as the reference's ``segment_sum``."""
    n_slots = ye.shape[0] * ye.shape[1]
    y_flat = ye.reshape(n_slots, -1)
    y_slot = torch.where(keep[:, None],
                         y_flat[torch.clamp(dest, max=n_slots - 1)],
                         torch.zeros((), dtype=y_flat.dtype,
                                     device=y_flat.device))
    slots = (y_slot * fp[:, None].to(dtype)).reshape(t, -1, y_flat.shape[1])
    out = slots[:, 0]
    for j in range(1, slots.shape[1]):
        out = out + slots[:, j]
    return out


def _shared_expert(sp: dict, tokens: torch.Tensor) -> torch.Tensor:
    gs = torch.einsum("td,dh->th", tokens, sp["w_gate"])
    us = torch.einsum("td,dh->th", tokens, sp["w_up"])
    return torch.einsum("th,hd->td", F.silu(gs) * us, sp["w_down"])


def moe_block(p: dict, x: torch.Tensor, moe: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    e = moe.n_experts
    cap = _capacity(t, moe)
    tokens = x.reshape(t, d)

    # on a mesh the routing, the slot scatter and the combine run on
    # every rank's gathered tokens (ctx.rank_local): the same global
    # routing and capacity as off a mesh; the experts are DTensor ops
    aux, fp, tok_id, keep, dest = rank_local(outs=5)(
        lambda router, toks: _route_tokens(router, toks, moe, cap))(
            p["router"], tokens)

    # --- dispatch -> expert FFN -> combine ----------------------------------
    xe = shard("moe_xe", rank_local()(
        lambda toks, ids, to: _dispatch(toks, ids, to, e, cap))(
            tokens, tok_id, dest))
    # FSDP cut point: regather the expert weights over the 'data' axis
    # once per layer instead of contracting over the sharded d_model dim
    w_gate = shard("moe_w", p["w_gate"])
    w_up = shard("moe_w", p["w_up"])
    w_down = shard("moe_w", p["w_down"])
    g = torch.einsum("ecd,edh->ech", xe, w_gate)
    u = torch.einsum("ecd,edh->ech", xe, w_up)
    ye = torch.einsum("ech,ehd->ecd", F.silu(g) * u, w_down)
    out = rank_local()(lambda *a: _combine_slots(*a, t, x.dtype))(
        ye, fp, tok_id, keep, dest)

    if moe.n_shared_experts:
        out = out + _shared_expert(p["shared"], tokens)

    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Expert-parallel local_map path
# ---------------------------------------------------------------------------


def _ep_specs(mesh, dp_axes: tuple[str, ...], model_axis: str):
    """(in_specs, in_grad_specs, out_specs) of ``moe_block_ep``'s body:
    the reference's in/out specs as placements, and where each input's
    gradient is partial (summed over ranks that each hold a part)."""
    from torch.distributed.tensor import Partial  # noqa: PLC0415

    from ..parallel.sharding import placements  # noqa: PLC0415

    data = dp_axes[-1]
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(dp_axes)
    specs = [(None, None), (model_axis, data, None), (model_axis, data, None),
             (model_axis, None, data), (dp, None, None)]
    ins = [placements(mesh, sp) for sp in specs]
    # the router's gradient is each rank's part; an expert shard's is
    # summed over the gathered 'data' ranks by the gather's backward,
    # partial over the other DP axes; x's is partial over 'model'
    held = [(), (model_axis, data), (model_axis, data), (model_axis, data),
            dp]
    grads = [[pl if name in keep else Partial()
              for name, pl in zip(names, pls)]
             for pls, keep in zip(ins, held)]
    outs = [placements(mesh, (dp, None, None)), placements(mesh, ())]
    return ins, grads, outs


def moe_block_ep(p: dict, x: torch.Tensor, moe: MoEConfig, mesh,
                 dp_axes: tuple[str, ...], model_axis: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """local_map MoE: the scalable EP execution.

    Per (data x model) rank:
      * route ALL local tokens (router compute duplicated across the
        model axis -- negligible);
      * build the dispatch buffer ONLY for this model-shard's
        E/model_parallelism experts -- local integer ops, no
        collectives;
      * all-gather this shard's expert weights over 'data' (FSDP
        regather, once per layer; none on a one-rank 'data' axis);
      * FFN + local combine, then ONE sum over 'model' adds the expert
        contributions into the (T_local, d) output.

    Capacity is enforced per data shard (GShard "local groups"
    semantics); ``aux`` is averaged over every rank; the shared expert is
    added outside.  ``p`` and ``x`` may be DTensors on ``mesh`` (then
    ``out`` is one) or plain tensors, the global values (then ``out`` is
    plain, as the reference's shard_map returns a global array).  With
    ``E % model != 0`` this is ``moe_block``, as in the reference.
    """
    b, s, d = x.shape
    e = moe.n_experts
    names = tuple(mesh.mesh_dim_names)
    n_model = mesh.size(names.index(model_axis))
    if e % n_model:
        return moe_block(p, x, moe)   # EP needs E % model == 0
    e_local = e // n_model
    data_group = mesh.get_group(dp_axes[-1])
    model_group = mesh.get_group(model_axis)
    groups = [mesh.get_group(a) for a in dp_axes] + [model_group]
    e0 = mesh.get_local_rank(model_axis) * e_local

    def inner(router, w_gate, w_up, w_down, xx):
        bl, sl, _ = xx.shape
        t = bl * sl
        cap = _capacity(t, moe)
        toks = xx.reshape(t, d)
        # weights arrive as (E_local, d_local, h): regather over data
        w_g = all_gather(w_gate, data_group, 1)
        w_u = all_gather(w_up, data_group, 1)
        w_d = all_gather(w_down, data_group, 2)

        aux, fp, tok_id, keep, dest = _route_tokens(router, toks, moe, cap)
        aux = pmean(aux, groups)
        # keep only this shard's experts
        mine = keep & (dest >= e0 * cap) & (dest < (e0 + e_local) * cap)
        dest = torch.where(mine, dest - e0 * cap, e_local * cap)
        xe = _dispatch(toks, tok_id, dest, e_local, cap)
        g = torch.einsum("ecd,edh->ech", xe, w_g)
        u = torch.einsum("ecd,edh->ech", xe, w_u)
        ye = torch.einsum("ech,ehd->ecd", F.silu(g) * u, w_d)
        out = _combine_slots(ye, fp.to(xx.dtype), tok_id, mine, dest, t,
                             xx.dtype)
        out = psum(out.float(), model_group)
        return out.to(xx.dtype).reshape(bl, sl, d), aux

    ins, grads, outs = _ep_specs(mesh, dp_axes, model_axis)
    fn = shard_map_compat(inner, mesh=mesh, in_specs=ins, out_specs=outs,
                          in_grad_specs=grads)
    out, aux = fn(p["router"], p["w_gate"], p["w_up"], p["w_down"], x)

    if moe.n_shared_experts:
        out = out + _shared_expert(p["shared"], x.reshape(-1, d)).reshape(
            b, s, d)
    return out, aux


# ---------------------------------------------------------------------------
# Sigmoid (noaux_tc) routing over held experts, dropless
# ---------------------------------------------------------------------------


def route_sigmoid(router: torch.Tensor, bias: torch.Tensor,
                  tokens: torch.Tensor, moe: MoEConfig):
    """DeepSeek-V3's noaux_tc: logits in full f32, scores =
    sigmoid(logits), the top ``top_k`` of scores + bias, weights = the
    unbiased scores there / (their sum + 1e-20) x ``routed_scale``.  With
    ``n_group`` > 1 (DeepSeek-V3.2: 8 groups of 32) each group is scored
    by the sum of its two largest biased scores, and the experts of all
    but the ``topk_group`` best groups are out of the choice (-inf, as
    the published inference code masks them).
    -> (weights (t, k) f32, experts (t, k) int64)."""
    with _full_f32():
        logits = tokens.float() @ router.float()
    scores = torch.sigmoid(logits)
    biased = scores + bias.float()
    if moe.n_group > 1:
        grouped = biased.view(biased.shape[0], moe.n_group, -1)
        best = grouped.topk(2, dim=-1).values.sum(-1)        # (t, n_group)
        kept = best.topk(moe.topk_group, dim=-1).indices
        out = torch.ones_like(best, dtype=torch.bool).scatter_(1, kept, False)
        biased = grouped.masked_fill(out[..., None], float("-inf")).flatten(1)
    top_e = torch.topk(biased, moe.top_k, dim=-1).indices
    w = scores.gather(1, top_e)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * moe.routed_scale
    return w, top_e


def _decoding(x: torch.Tensor) -> bool:
    """One token per row: a decode step.  Its host must not wait for the
    card, so the held experts run in ``held_expert_ffn``, which builds its
    slot lists on the card and reads each expert's weights once for the
    slots routed to it.  A prompt's one host read of the held counts
    (``_held_gathered``) is set-up, in no timed step."""
    return x.shape[1] == 1


def _held_gathered(p: dict, tokens, w, key, moe) -> torch.Tensor:
    """Only the chosen slots of the held experts, in the slot lists'
    expert order (``held_slots``), each expert's padded to the most any
    holds (one host read of the counts sizes them): one batched product
    per weight -> (t, d) f32."""
    t, d = tokens.shape
    held = moe.held
    order, ends = held_slots(key, held)
    bounds = [0, *ends[:held].tolist()]
    n = bounds[-1]
    m = max(b - a for a, b in zip(bounds, bounds[1:]))
    out = torch.zeros((t, d), dtype=torch.float32, device=tokens.device)
    if not n:
        return out
    slots = order[:n]
    rows = torch.div(slots, moe.top_k, rounding_mode="floor")
    grp = key.reshape(-1)[slots]
    first = torch.cat([ends.new_zeros(1), ends[:held]])
    dest = grp * m + torch.arange(n, device=tokens.device) - first[grp]
    xe = tokens.new_zeros((held * m, d))
    xe[dest] = tokens[rows]
    xe = xe.view(held, m, d)
    ye = torch.bmm(F.silu(torch.bmm(xe, p["w_gate"]))
                   * torch.bmm(xe, p["w_up"]), p["w_down"])
    y = ye.view(held * m, d)[dest].float() * w.reshape(-1)[slots, None]
    return out.index_add_(0, rows, y)


def moe_block_held(p: dict, x: torch.Tensor, moe: MoEConfig,
                   counts: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, aux = 0).  Routes every token over all
    ``n_experts``; computes each chosen slot of a held expert (no
    capacity: nothing drops), weighted and summed per token in f32, then
    adds the shared expert once: ``held_expert_ffn`` in a decode step
    (its plain version where the kernel does not take the tensors: that
    one reads the held counts on the host, so a decode step on the card
    in f32 or f16, or at other widths, waits for the card once a layer),
    ``_held_gathered`` over a prompt (``_decoding``).  The
    held experts' slot counts, when ``counts`` (n_held,) is given, are
    added into it on the device."""
    b, s, d = x.shape
    t = b * s
    held, e0 = moe.held, moe.held_from
    tokens = x.reshape(t, d)
    with scope("moe.route"):
        w, top_e = route_sigmoid(p["router"], p["bias"], tokens, moe)
        local = top_e - e0
        key = torch.where((local >= 0) & (local < held), local, held)
        if counts is not None:
            flat = key.reshape(-1)
            per = torch.zeros(held + 1, dtype=torch.long, device=x.device)
            counts.add_(per.scatter_add_(0, flat, torch.ones_like(flat))
                        [:held])
    with scope("moe.experts"):
        if _decoding(x):
            ffn = (held_expert_ffn
                   if takes(x.device, x.dtype, d, moe.d_expert, held)
                   else held_expert_ffn_plain)
            out = ffn(tokens, p["w_gate"], p["w_up"], p["w_down"], w, key)
        else:
            out = _held_gathered(p, tokens, w, key, moe)
    with scope("moe.shared"):
        y = out.to(x.dtype)
        if moe.n_shared_experts:
            sp = p["shared"]
            y = y + (F.silu(tokens @ sp["w_gate"]) * (tokens @ sp["w_up"])) \
                @ sp["w_down"]
    return y.reshape(b, s, d), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def moe_apply(p: dict, x: torch.Tensor, moe: MoEConfig,
              counts: torch.Tensor | None = None):
    """Dispatch to the EP path when an expert-parallel context is set;
    sigmoid routing takes ``moe_block_held`` (``counts``: its held-slot
    counter), which has no expert-parallel form on a mesh."""
    ep = ep_context()
    if moe.scoring == "sigmoid":
        if ep is not None:
            raise NotImplementedError(
                "sigmoid routing over held experts has no mesh path")
        return moe_block_held(p, x, moe, counts)
    if ep is not None:
        mesh, dp, model_axis = ep
        return moe_block_ep(p, x, moe, mesh, dp, model_axis)
    return moe_block(p, x, moe)


# ---------------------------------------------------------------------------
# Straggler-resilient expert FFN (coded plan path)
# ---------------------------------------------------------------------------


class CodedMoE:
    """Expert FFN with straggler resilience: every expert weight matmul
    runs through a precompiled ``repro_torch.api.CodedPlan``.

    Each expert's three (d x h / h x d) matrices are plan-compiled once
    (scheme + encoding + packed shards + backend, seed ``seed + i`` for
    expert i) for ``n_workers`` virtual workers tolerating
    ``stragglers`` losses per matmul -- the MoE analogue of the coded LM
    head.  ``backend="auto"`` picks ``cuda`` for weights on the card,
    else the density pick per weight.

    Routing (top-k, sort-based slotting, capacity drop) is identical to
    ``moe_block``.  Per step a single ``done`` mask applies to all expert
    matmuls (the workers are the same physical devices); outputs match
    ``moe_block`` to f32 tolerance under any <= s straggler pattern.

    Pass ``fleet=`` (a ``repro_torch.api.fleet.CodedFleet``) to
    *dispatch* the expert matmuls instead of computing them in-process:
    every expert plan attaches to the shared session (the same workers
    that serve the coded LM head), all experts' gate+up products go in
    flight together, and each expert's down product is submitted the
    moment its activation is ready.  The fleet's owner closes it;
    ``detach()`` withdraws this layer's plans early.
    """

    def __init__(self, p: dict, moe: MoEConfig, n_workers: int = 6,
                 stragglers: int = 2, seed: int = 0,
                 scheme: str = "proposed", backend: str | None = "auto",
                 fleet=None):
        from ..api.plan import compile_plan  # noqa: PLC0415 - layering
        from ..api.schemes import make_scheme  # noqa: PLC0415

        self.p = p
        self.moe = moe
        self.n = n_workers
        self.s = stragglers
        self.fleet = fleet
        sch = make_scheme(scheme, n=n_workers, k_A=n_workers - stragglers)
        e = moe.n_experts

        def plans(w):          # w: (E, din, dout) stacked expert weights
            built = [compile_plan(w[i], scheme=sch, seed=seed + i,
                                  backend=backend) for i in range(e)]
            if fleet is None:
                return built
            return [fleet.attach(pl) for pl in built]

        self.gate = plans(p["w_gate"])
        self.up = plans(p["w_up"])
        self.down = plans(p["w_down"])

    def backends(self) -> list[str]:
        """Resolved backend per expert-gate plan (density may differ)."""
        return [pl.plan.backend if self.fleet is not None else pl.backend
                for pl in self.gate]

    def detach(self) -> None:
        """Withdraw this layer's plans from the shared fleet (no-op for
        the in-process path)."""
        if self.fleet is None:
            return
        for handle in self.gate + self.up + self.down:
            handle.detach()

    def __call__(self, x: torch.Tensor, done=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (out, aux); ``done`` masks the coded workers."""
        p, moe = self.p, self.moe
        b, s, d = x.shape
        t = b * s
        e = moe.n_experts
        cap = _capacity(t, moe)
        tokens = x.reshape(t, d)

        aux, fp, tok_id, keep, dest = _route_tokens(
            p["router"], tokens, moe, cap)
        xe = _dispatch(tokens, tok_id, dest, e, cap)

        if self.fleet is not None:
            outs = self._dispatch_experts(xe, done)
        else:
            # --- coded expert FFN: three plan.matvec calls per expert --
            outs = []
            for i in range(e):
                g = self.gate[i].matvec(xe[i], done)      # (cap, h)
                u = self.up[i].matvec(xe[i], done)
                y = self.down[i].matvec((F.silu(g) * u).to(xe.dtype), done)
                outs.append(y)
        ye = torch.stack(outs).to(x.dtype)                # (e, cap, d)
        out = _combine_slots(ye, fp, tok_id, keep, dest, t, x.dtype)

        if moe.n_shared_experts:
            out = out + _shared_expert(p["shared"], tokens)
        return out.reshape(b, s, d), aux

    def _dispatch_experts(self, xe: torch.Tensor, done) -> list:
        """Fleet path: pipeline every expert's FFN through futures.

        All gate+up rounds go in flight at once; each down round is
        submitted as soon as its expert's activation is available, so
        expert i+1's gate product overlaps expert i's down product on
        the shared workers.
        """
        e = xe.shape[0]
        gate_f = [self.gate[i].submit_matvec(xe[i], done) for i in range(e)]
        up_f = [self.up[i].submit_matvec(xe[i], done) for i in range(e)]
        down_f = []
        for i in range(e):
            h = (F.silu(gate_f[i].result())
                 * up_f[i].result()).to(xe.dtype)
            down_f.append(self.down[i].submit_matvec(h, done))
        return [f.result() for f in down_f]
