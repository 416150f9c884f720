"""One ``TransformerLM.decode_step`` of every session an engine holds:
the model's whole decode step, as ``ServeEngine._run_wave`` calls it.

The port model comes from a configuration file of this kind: its
``port`` entry names the registry's arch (``"smoke": true`` for its
smoke config) and the fields set on it, dotted for a nested config
(``"moe.n_held": 8``), and the file's published keys must agree with
the model that builds (``PUBLISHED``), so the reference and the
yardstick read the model that runs.  The weights are drawn here, with
plain torch on the device from the seed (``draw_weights``), by the
state-dict names the reference lists, and loaded into the model; the
reference draws them again from the same seed.  ``weight_shapes`` knows
DeepSeek-V3's layout (latent attention, leading dense layers, sigmoid-
routed experts), which Kimi-K2 uses; a model of another layout adds its
names there and a reference of its own.

``prefill`` (the generator's set-up) runs ``TransformerLM.prefill`` over
the prompts in groups of sessions and joins the groups' caches along
the batch with ``repro_torch.models.join_caches``.  Each ``call`` sets
the cache's position to the step's (a rewind is a position set back)
and runs one ``decode_step`` of all sessions: (sessions, vocab) f32
logits.  ``check`` runs the plain reference (``reference/kimi_k2.py``)
in f32 over each checked session's prompt and the ids fed since the last
rewind, after the program's state is released, and compares the logits
at every sampled step's position.

``step_counts`` is the yardstick of a step: its model operations and
least bytes, from the published configuration and the step's shapes,
never from the program's state.
"""

from __future__ import annotations

import dataclasses
from statistics import median

import numpy as np
import torch

from reference import kimi_k2 as ref_model
from stats import percentile
from yardstick import BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S

# published key -> the built ModelConfig's field (dotted: nested)
PUBLISHED = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "vocab_size": "vocab", "intermediate_size": "d_ff",
    "first_k_dense_replace": "first_dense",
    "num_attention_heads": "mla.n_heads", "q_lora_rank": "mla.q_lora_rank",
    "kv_lora_rank": "mla.kv_lora_rank",
    "qk_nope_head_dim": "mla.qk_nope_head_dim",
    "qk_rope_head_dim": "mla.qk_rope_head_dim",
    "v_head_dim": "mla.v_head_dim", "rope_theta": "mla.rope_theta",
    "moe_intermediate_size": "moe.d_expert",
    "num_experts_per_tok": "moe.top_k",
    "n_routed_experts": "moe.held", "experts_held_from": "moe.held_from",
    "n_shared_experts": "moe.n_shared_experts",
    "routed_scaling_factor": "moe.routed_scale",
    "rms_norm_eps": "norm_eps",
}


def _get(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def model_config(cfg: dict):
    """The port's ModelConfig that ``cfg`` names, its fields set, checked
    against the file's published keys."""
    from repro_torch.configs import get_config, get_smoke_config
    port = dict(cfg["port"])
    arch = port.pop("arch")
    mc = get_smoke_config(arch) if port.pop("smoke", False) \
        else get_config(arch)
    nested: dict = {}
    for key, value in port.items():
        head, _, rest = key.partition(".")
        if rest:
            nested.setdefault(head, {})[rest] = value
        else:
            mc = mc.with_(**{key: value})
    for head, fields in nested.items():
        mc = mc.with_(**{head: dataclasses.replace(getattr(mc, head),
                                                   **fields)})
    wrong = {k: (cfg[k], _get(mc, f)) for k, f in PUBLISHED.items()
             if k in cfg and _get(mc, f) != cfg[k]}
    if wrong:
        raise ValueError(f"the file and the port's model differ: {wrong}")
    if cfg["published"].get("n_routed_experts", cfg["n_routed_experts"]) \
            != mc.moe.n_experts:
        raise ValueError("the router's width is not the published count")
    return mc


def weight_shapes(cfg: dict) -> dict:
    """name -> (shape, how it is drawn): the port's state-dict names as
    the reference lists them, each matrix ``(d_in, d_out)``, from the
    file's keys alone.  ``"w"``: N(0, ``initializer_range``); ``"norm"``:
    ones; ``"bias"``: the correction bias, N(0, ``correction_bias_std``),
    kept in f32 as the published checkpoint keeps it."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, ql, kvr = (cfg["num_attention_heads"], cfg["q_lora_rank"],
                  cfg["kv_lora_rank"])
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    ff, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    held, width = cfg["n_routed_experts"], cfg["published"]["n_routed_experts"]
    fs = fe * cfg["n_shared_experts"]
    out = {"embed": ((v, d), "w")}
    for i in range(cfg["num_hidden_layers"]):
        at = f"layers.{i}."
        out.update({
            at + "norm1": ((d,), "norm"), at + "norm2": ((d,), "norm"),
            at + "attn.wq_a": ((d, ql), "w"), at + "attn.q_norm": ((ql,),
                                                                 "norm"),
            at + "attn.wq_b": ((ql, h * (dn + dr)), "w"),
            at + "attn.wkv_a": ((d, kvr + dr), "w"),
            at + "attn.kv_norm": ((kvr,), "norm"),
            at + "attn.wkv_b": ((kvr, h * (dn + dv)), "w"),
            at + "attn.wo": ((h * dv, d), "w")})
        if i < cfg["first_k_dense_replace"]:
            out.update({at + "mlp.w_gate": ((d, ff), "w"),
                        at + "mlp.w_up": ((d, ff), "w"),
                        at + "mlp.w_down": ((ff, d), "w")})
            continue
        out.update({at + "moe.router": ((d, width), "w"),
                    at + "moe.w_gate": ((held, d, fe), "w"),
                    at + "moe.w_up": ((held, d, fe), "w"),
                    at + "moe.w_down": ((held, fe, d), "w"),
                    at + "moe.bias": ((width,), "bias")})
        if fs:
            out.update({at + "moe.shared.w_gate": ((d, fs), "w"),
                        at + "moe.shared.w_up": ((d, fs), "w"),
                        at + "moe.shared.w_down": ((fs, d), "w")})
    out.update({"final_norm": ((d,), "norm"), "head": ((d, v), "w")})
    return out


def draw_weights(cfg: dict, seed: int, dev: torch.device) -> dict:
    """Every weight of ``weight_shapes`` drawn in that order from one
    generator on ``dev`` seeded with ``seed``: the same seed and device
    give the same tensors.  Matrices and norms in ``torch_dtype``."""
    dtype = getattr(torch, cfg["torch_dtype"])
    std = {"w": cfg["initializer_range"], "bias": cfg["correction_bias_std"]}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, (shape, how) in weight_shapes(cfg).items():
        if how == "norm":
            out[name] = torch.ones(shape, dtype=dtype, device=dev)
            continue
        t = torch.randn(shape, generator=gen, device=dev).mul_(std[how])
        out[name] = t if how == "bias" else t.to(dtype)
    return out


def step_counts(cfg: dict, batch: int, length: int) -> dict:
    """One decode step of ``batch`` sessions whose attention reads
    ``length`` positions: the model operations by operand type, and the
    least bytes (every weight the step uses read once, the embedding's
    ``batch`` rows, the latent cache read once to ``length``, the logits
    written once).  Held experts count their expected slots, batch x
    top_k x held / router width; norms and the softmax are left out."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    n_layers, n_dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    h, ql, kvr = (cfg["num_attention_heads"], cfg["q_lora_rank"],
                  cfg["kv_lora_rank"])
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    ff, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    held, width = cfg["n_routed_experts"], cfg["published"]["n_routed_experts"]
    k, shared = cfg["num_experts_per_tok"], cfg["n_shared_experts"]
    esz = 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4
    attn_w = (d * ql + ql * h * (dn + dr) + d * (kvr + dr)
              + kvr * h * (dn + dv) + h * dv * d)
    attn_ops = 2 * batch * (attn_w + h * length * (kvr + dr)
                            + h * length * kvr)
    n_moe = n_layers - n_dense
    slots = batch * k * held / width
    mm = (n_layers * attn_ops + n_dense * 2 * batch * 3 * d * ff
          + n_moe * (2 * batch * 3 * d * fe * shared + 2 * slots * 3 * d * fe)
          + 2 * batch * d * v)
    router = n_moe * 2 * batch * d * width
    weights = (n_layers * (attn_w + ql + kvr + 2 * d) + n_dense * 3 * d * ff
               + n_moe * (held + shared) * 3 * d * fe + d * v + d) * esz \
        + n_moe * (d * width + width) * 4 + batch * d * esz
    cache = n_layers * batch * length * (kvr + dr) * esz
    peak = BF16_FLOPS_PER_S if esz == 2 else F32_FLOPS_PER_S
    nbytes = float(weights + cache + batch * v * 4)
    ops_s = mm / peak + router / F32_FLOPS_PER_S
    return {"flops": float(mm + router), "step_bytes": nbytes,
            "step_least_s": max(nbytes / HBM_BYTES_PER_S, ops_s)}


class System:
    """The model, its weights, and the sessions' cache once prefilled."""

    # no kernel of the port's own runs here: the step is PyTorch's ops
    kernel_rows: dict = {}
    # sessions the reference runs at once (its activations, in f32)
    REFERENCE_ROWS = 8

    def __init__(self, cfg: dict, seed: int, dev: torch.device):
        from repro_torch.models import build_model
        self.cfg, self.seed, self.dev = cfg, seed, dev
        self.mc = model_config(cfg)
        self.vocab = self.mc.vocab
        self.model = build_model(self.mc, getattr(torch, cfg["torch_dtype"]),
                                 device=dev)
        self.model.load_state_dict(draw_weights(cfg, seed, dev))
        self.weights = None            # the reference's, drawn again
        self.cache = None
        self.prompts = None
        self.prompt_len = None

    # -- set-up and the timed call -------------------------------------------

    def prefill(self, prompts: np.ndarray, max_len: int, group: int) -> None:
        """Every prompt through ``TransformerLM.prefill``, ``group``
        sessions a call, the caches joined into one of ``max_len``."""
        from repro_torch.models import join_caches
        self.prompts, self.prompt_len = prompts, prompts.shape[1]
        parts = []
        with torch.inference_mode():
            for at in range(0, len(prompts), group):
                toks = torch.as_tensor(prompts[at:at + group],
                                       device=self.dev)
                parts.append(self.model.prefill(toks, prompts.shape[1])[1])
            self.cache = join_caches(parts, max_len)
        del parts

    def call(self, item: dict) -> torch.Tensor:
        with torch.inference_mode():
            self.cache["step"] = item["pos"]
            logits, self.cache = self.model.decode_step(self.cache,
                                                        item["ids"])
        return logits

    def counters(self) -> dict:
        """The held experts' routed slots, summed over the MoE layers (a
        device counter, read here only); none where the program keeps
        none."""
        counts = [] if self.model is None else [
            blk.held_tokens for blk in self.model.layers
            if hasattr(blk, "held_tokens")]
        if not counts:
            return {}
        return {"moe": {"held_tokens": int(torch.stack(counts).sum()),
                        "held_experts": sum(c.numel() for c in counts)}}

    def work(self, item: dict) -> dict:
        c = step_counts(self.cfg, len(self.prompts), item["pos"] + 1)
        return {"flops": c["flops"], "step_least_s": c["step_least_s"]}

    def kernel_bounds(self, items) -> dict:
        return {}

    def release(self) -> None:
        """Free the program's state (the cache and the model, with its
        weights) before the reference runs."""
        self.cache = None
        self.model = None

    # -- the comparison -------------------------------------------------------

    def reference(self, items, **control) -> list:
        """The plain reference's f32 logits of each item's checked sessions
        at its position, (sessions, vocab) an item.  Items of one stretch
        between rewinds share one forward over the prompts and the ids fed
        up to the last of them; ``control``: ``fp8`` or ``cache_fp8``
        (``reference/kimi_k2.py``)."""
        if self.weights is None:
            self.weights = draw_weights(self.cfg, self.seed, self.dev)
        stretches: dict = {}
        for k, item in enumerate(items):
            first = item["index"] - (item["pos"] - self.prompt_len)
            stretches.setdefault(first, []).append(k)
        out: list = [None] * len(items)
        for ks in stretches.values():
            last = max(ks, key=lambda k: items[k]["index"])
            if any(not np.array_equal(items[k]["rows"], items[last]["rows"])
                   for k in ks):
                raise ValueError("sampled steps check different sessions")
            seq = np.concatenate([self.prompts[items[last]["rows"]],
                                  items[last]["history"]()], axis=1)
            positions = [items[k]["pos"] for k in ks]
            parts = []
            for at in range(0, len(seq), self.REFERENCE_ROWS):
                toks = torch.as_tensor(seq[at:at + self.REFERENCE_ROWS],
                                       device=self.dev)
                parts.append(ref_model.forward(self.weights, self.cfg, toks,
                                               positions=positions,
                                               **control))
            logits = torch.cat(parts)
            for j, k in enumerate(ks):
                out[k] = logits[:, j]
        return out

    def control(self, items) -> list:
        """The reference with every weight and the hidden state between
        layers in fp8 e4m3, one step below bf16."""
        return self.reference(items, fp8=True)

    def cache_control(self, items) -> list:
        """The reference with only the latent cache (c and the rotated
        k_pe) in fp8 e4m3: a program that stored its cache so."""
        return self.reference(items, cache_fp8=True)

    def check(self, samples) -> dict:
        """Each checked row's max |out - ref| / max |ref| against the f32
        reference.  Compared: the median and the 90th percentile over
        every row, and the largest of the checked sessions' medians over
        their sampled steps (a fault in a few sessions, one prefill
        group's or one cache row's, shows there; a routing choice that
        flips between bf16 and f32 moves one row).  The widest row is
        reported beside them."""
        wants = self.reference([item for item, _ in samples])
        errs, per_session = [], {}
        for (item, rows), want in zip(samples, wants):
            for session, out, ref in zip(item["rows"], rows, want):
                diff = (out.to(ref.device, torch.float32) - ref).abs().max()
                err = float(diff / ref.abs().max())
                errs.append(err)
                per_session.setdefault(int(session), []).append(err)
        return {"logits_rel_err_median": median(errs) if errs else 0.0,
                "logits_rel_err_p90": percentile(errs, 90) if errs else 0.0,
                "logits_rel_err_session_max": max(
                    (median(v) for v in per_session.values()), default=0.0),
                "logits_rel_err_max": max(errs, default=0.0),
                "per_call": errs, "checked_calls": len(samples)}
