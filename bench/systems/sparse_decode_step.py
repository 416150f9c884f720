"""One ``TransformerLM.decode_step`` of every session an engine holds, for a
model with DeepSeek Sparse Attention (DeepSeek-V3.2): ``decode_step``'s
system with the indexer, group-limited routing and long prompts.

What differs from ``decode_step`` (whose class and functions this
reuses):

- ``PUBLISHED`` adds the indexer's and the router groups' keys, and
  YaRN's, and the built model must agree with them;
- ``weight_shapes`` adds each layer's indexer (``attn.indexer.wq_b``,
  ``wk``, ``k_norm``, ``k_bias``, ``w_proj``), drawn after the rest
  (``"zeros"``: the LayerNorm's bias, 0 as HF initialises it);
- ``prefill`` writes each group's cache into the one cache allocated
  for every session (``TransformerLM.init_cache``) as it goes: at 32k
  positions a join at the end would hold the cache twice;
- ``step_counts`` counts what a sparse step needs: the indexer's
  operations and its whole key cache, and only the selected
  ``index_topk`` rows of the latent cache;
- ``call`` replays each step past ``index_topk`` on the card as one
  CUDA graph (``repro_torch.models.decode_graph``), made at the first
  warm step: launched from Python, the step's ~900 kernels took the host
  about as long as the card took to run them, and the step's time
  followed the host's speed;
- ``counters`` adds the positions attended and held (``dsa``);
- the reference is ``reference/deepseek_v32.py`` (one session at a
  time), and ``dense_control`` is that reference attending every
  position, which the comparison must refuse;
- a sampled step keeps, beside its checked sessions' logits, what their
  layer 0 held and chose (``answer``): the rows of its cache at
  ``CACHE_ROWS`` prompt positions and at the step's own, and the
  positions it attended.  Layer 0 reads the same ids in the program and
  the reference, so these are held tightly where the logits cannot be:
  with seeded weights an index puts ~1% of the 2,048 positions it keeps
  on the other side of the reference's top-k within bf16's rounding,
  each swap moves a layer's output as much as any other, and the logits
  of the sound program read ~0.17 (PERF.md).  ``check`` adds the largest
  share of a step's attended positions outside the reference's choice
  (``select_outside_max``: a program that attends densely or
  otherwise) and the largest row error of the cache
  (``cache_rel_err_max``: a cache stored below bf16).

A program without the arch (``model_config``: the registry has no such
entry) fails the run at once with ``harness.BenchError``.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from harness import BenchError, load_module
from reference import deepseek_v32 as ref_model
from yardstick import BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S

base = load_module("systems", "decode_step")

# published key -> the built ModelConfig's field, beside ``decode_step``'s
PUBLISHED = {
    "index_n_heads": "indexer.n_heads", "index_head_dim": "indexer.head_dim",
    "index_topk": "indexer.topk", "n_group": "moe.n_group",
    "topk_group": "moe.topk_group",
}
# prompt positions, evenly spaced from the first to the last, whose rows
# of layer 0's cache each sampled step keeps beside its own position's
CACHE_ROWS = 16
ROPE_SCALING = {
    "factor": "mla.rope_factor", "beta_fast": "mla.beta_fast",
    "beta_slow": "mla.beta_slow", "mscale": "mla.mscale",
    "mscale_all_dim": "mla.mscale_all_dim",
    "original_max_position_embeddings": "mla.rope_original_max",
}


def model_config(cfg: dict):
    """``decode_step.model_config``, and the keys above checked too."""
    try:
        mc = base.model_config(cfg)
    except KeyError as exc:
        raise BenchError(f"the program has no arch {cfg['port']['arch']!r}"
                         f" ({exc})") from None
    wrong = {k: (cfg[k], base._get(mc, f)) for k, f in PUBLISHED.items()
             if base._get(mc, f) != cfg[k]}
    wrong.update({k: (cfg["rope_scaling"][k], base._get(mc, f))
                  for k, f in ROPE_SCALING.items()
                  if base._get(mc, f) != cfg["rope_scaling"][k]})
    if wrong:
        raise ValueError(f"the file and the port's model differ: {wrong}")
    return mc


def weight_shapes(cfg: dict) -> dict:
    """``decode_step.weight_shapes``, then each layer's indexer."""
    d, ql = cfg["hidden_size"], cfg["q_lora_rank"]
    hi, di = cfg["index_n_heads"], cfg["index_head_dim"]
    out = base.weight_shapes(cfg)
    for i in range(cfg["num_hidden_layers"]):
        at = f"layers.{i}.attn.indexer."
        out.update({at + "wq_b": ((ql, hi * di), "w"),
                    at + "wk": ((d, di), "w"), at + "k_norm": ((di,), "norm"),
                    at + "k_bias": ((di,), "zeros"),
                    at + "w_proj": ((d, hi), "w")})
    return out


def draw_weights(cfg: dict, seed: int, dev: torch.device) -> dict:
    """Every weight of ``weight_shapes`` drawn in that order from one
    generator on ``dev`` seeded with ``seed``, as
    ``decode_step.draw_weights`` draws."""
    dtype = getattr(torch, cfg["torch_dtype"])
    std = {"w": cfg["initializer_range"], "bias": cfg["correction_bias_std"]}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, (shape, how) in weight_shapes(cfg).items():
        if how in ("norm", "zeros"):
            fill = torch.ones if how == "norm" else torch.zeros
            out[name] = fill(shape, dtype=dtype, device=dev)
            continue
        t = torch.randn(shape, generator=gen, device=dev).mul_(std[how])
        out[name] = t if how == "bias" else t.to(dtype)
    return out


def step_counts(cfg: dict, batch: int, length: int) -> dict:
    """One decode step of ``batch`` sessions at ``length`` cached
    positions, each attending k = min(index_topk, length) of them:
    ``decode_step.step_counts`` at k (latent attention over k rows, the
    selected rows of the latent cache read once), plus per layer the
    indexer's weights read once, its key cache read once to ``length``,
    and its operations (its projections, the per-head scores of every
    cached position and their weighted sum).  Held experts count their
    expected slots, batch x top_k x held / router width: the groups are
    alike, so a group limit leaves that expectation as it is."""
    d, n_layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    ql, hi, di = cfg["q_lora_rank"], cfg["index_n_heads"], cfg[
        "index_head_dim"]
    width = cfg["published"]["n_routed_experts"]
    n_moe = n_layers - cfg["first_k_dense_replace"]
    esz = 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4
    c = base.step_counts(cfg, batch, min(cfg["index_topk"], length))
    router = n_moe * 2 * batch * d * width
    ix_w = ql * hi * di + d * di + d * hi
    ix_ops = n_layers * 2 * batch * (ix_w + length * hi * di + length * hi)
    mm = c["flops"] - router + ix_ops
    nbytes = c["step_bytes"] + n_layers * (
        (ix_w + 2 * di) * esz + batch * length * di * esz)
    peak = BF16_FLOPS_PER_S if esz == 2 else F32_FLOPS_PER_S
    ops_s = mm / peak + router / F32_FLOPS_PER_S
    return {"flops": float(mm + router), "step_bytes": float(nbytes),
            "step_least_s": max(nbytes / HBM_BYTES_PER_S, ops_s)}


class System(base.System):
    """``decode_step.System`` for a sparse-attention model."""

    # one 33k-token session of the f32 reference at a time
    REFERENCE_ROWS = 1

    def __init__(self, cfg: dict, seed: int, dev: torch.device):
        from repro_torch.models import build_model
        self.cfg, self.seed, self.dev = cfg, seed, dev
        self.mc = model_config(cfg)
        self.vocab = self.mc.vocab
        self.model = build_model(self.mc, getattr(torch, cfg["torch_dtype"]),
                                 device=dev)
        self.model.load_state_dict(draw_weights(cfg, seed, dev))
        self.weights = None
        self.cache = None
        self.prompts = None
        self.prompt_len = None
        self.graph = None

    def prefill(self, prompts: np.ndarray, max_len: int, group: int) -> None:
        """Every prompt through ``TransformerLM.prefill``, ``group``
        sessions a call, each group's cache copied into one cache of
        ``max_len`` positions allocated first."""
        self.prompts, self.prompt_len = prompts, prompts.shape[1]
        with torch.inference_mode():
            self.cache = self.model.init_cache(len(prompts), max_len)
            for at in range(0, len(prompts), group):
                toks = torch.as_tensor(prompts[at:at + group],
                                       device=self.dev)
                part = self.model.prefill(toks, self.prompt_len)[1]
                for whole, layer in zip(self.cache["layers"],
                                        part["layers"]):
                    for name, t in layer.items():
                        whole[name][at:at + len(toks), :t.shape[1]] = t
                del part
            self.cache["step"] = self.prompt_len

    def call(self, item: dict) -> torch.Tensor:
        """One step of every session: on the card past ``index_topk`` a
        replay of the step's CUDA graph (made at the first such step),
        else ``TransformerLM.decode_step``."""
        past = item["pos"] >= self.mc.indexer.topk
        with torch.inference_mode():
            self.cache["step"] = item["pos"]
            if self.graph is None and past and self.dev.type == "cuda":
                from repro_torch.models.decode_graph import DecodeGraph
                self.graph = DecodeGraph(self.model, self.cache)
            step = self.graph if past and self.graph is not None \
                else self.model.decode_step
            logits, self.cache = step(self.cache, item["ids"])
        return logits

    def release(self) -> None:
        """``decode_step``'s, and the graph with the memory it holds."""
        self.graph = None
        super().release()

    def counters(self) -> dict:
        """``decode_step``'s held-slot counter, and the latent layers'
        positions attended and held (host ints, summed over layers)."""
        out = super().counters()
        if self.model is None:
            return out
        blocks = [blk for blk in self.model.layers
                  if hasattr(blk, "attended")]
        out["dsa"] = {"attended": sum(b.attended for b in blocks),
                      "cached": sum(b.cached for b in blocks)}
        return out

    def work(self, item: dict) -> dict:
        c = step_counts(self.cfg, len(self.prompts), item["pos"] + 1)
        return {"flops": c["flops"], "step_least_s": c["step_least_s"]}

    def cache_positions(self, pos: int) -> list:
        """The positions of layer 0's cache a step at ``pos`` keeps."""
        return np.linspace(0, self.prompt_len - 1, CACHE_ROWS).round() \
            .astype(int).tolist() + [pos]

    def answer(self, out: torch.Tensor, item: dict) -> dict:
        """What a sampled step is held to, of each checked session: its
        logits, the positions its layer 0 attended (every one up to the
        step's where it attended all), and its layer 0's cache rows
        ``{"c", "kr", "ik"}`` at ``cache_positions``."""
        rows = torch.as_tensor(item["rows"], device=out.device)
        at = torch.as_tensor(self.cache_positions(item["pos"]),
                             device=out.device)
        chosen = self.model.layers[0].selected
        chosen = (torch.arange(item["pos"] + 1, device=out.device)
                  .expand(len(rows), -1) if chosen is None
                  else chosen[rows, 0])
        return {"logits": out[rows].clone(), "chosen": chosen.clone(),
                "cache": {name: t[rows[:, None], at[None, :]]
                          for name, t in self.cache["layers"][0].items()}}

    def reference(self, items, **control) -> list:
        """The plain reference's answers (``answer``'s) of each item's
        checked sessions at its position, in f32, from
        ``reference/deepseek_v32.py``, one forward a session over its
        prompt and the ids fed to the last item of the item's stretch;
        ``control``: ``fp8``, ``cache_fp8`` or ``dense``."""
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
            wanted = sorted(set(positions))
            logits, probes = [], []
            for at in range(0, len(seq), self.REFERENCE_ROWS):
                toks = torch.as_tensor(seq[at:at + self.REFERENCE_ROWS],
                                       device=self.dev)
                probes.append({})
                logits.append(ref_model.forward(
                    self.weights, self.cfg, toks, positions=positions,
                    probe=probes[-1], **control))
            logits = torch.cat(logits)
            probe = {name: torch.cat([p[name] for p in probes])
                     for name in ("c", "kr", "ik", "chosen")}
            for j, k in enumerate(ks):
                pos = items[k]["pos"]
                at = torch.as_tensor(self.cache_positions(pos),
                                     device=self.dev)
                mask = probe["chosen"][:, wanted.index(pos)]
                out[k] = {"logits": logits[:, j],
                          "chosen": [m.nonzero()[:, 0] for m in mask],
                          "cache": {name: probe[name][:, at]
                                    for name in ("c", "kr", "ik")}}
        return out

    def check(self, samples) -> dict:
        """``decode_step``'s readings of the logits, and of layer 0:
        ``select_outside_max``, the largest share of a checked row's
        attended positions that the reference's top-k leaves out, and
        ``cache_rel_err_max``, the largest max |out - ref| / max |ref|
        of a cached row (``c``, ``kr`` or ``ik``) against the
        reference's."""
        wants = self.reference([item for item, _ in samples])
        # decode_step's comparison of the logits, over the answers above
        found = base.System.check(
            types.SimpleNamespace(
                reference=lambda items: [w["logits"] for w in wants]),
            [(item, got["logits"]) for item, got in samples])
        outside, cache_err = [], []
        for (item, got), want in zip(samples, wants):
            for mine, theirs in zip(got["chosen"], want["chosen"]):
                keep = torch.zeros(item["pos"] + 1, dtype=torch.bool,
                                   device=theirs.device)
                keep[theirs] = True
                outside.append(
                    1.0 - float(keep[mine.to(theirs.device)].float().mean()))
            for name, ref in want["cache"].items():
                diff = (got["cache"][name].to(ref.device, torch.float32)
                        - ref).abs().amax(-1)
                cache_err.append(float((diff / ref.abs().amax(-1)).max()))
        found["select_outside_max"] = max(outside, default=0.0)
        found["cache_rel_err_max"] = max(cache_err, default=0.0)
        return found

    def dense_control(self, items) -> list:
        """The reference attending every position: a program that left
        the indexer's selection out."""
        return self.reference(items, dense=True)
