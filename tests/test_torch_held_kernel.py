"""The held experts' decode FFN (``kernels/held_experts.py``) on the CPU:
the slot lists (``held_slots``) and the plain version against the loops
written out here, the edges of the counts (an expert with no token, every
token on one expert, a token whose k places are all held, the second
share of a layer's experts), the route between the kernel and the plain
version (by device, dtype and widths), and the launch counter.  The
kernel itself runs only on the card (``test_torch_cuda.py``).

Tolerance: the plain version and the loop compute the same f32 products
grouped otherwise (one matrix product over an expert's slots against one
row at a time): 1e-5 in f32.  In bf16 both round h once; a value near a
rounding boundary may round either way, one bf16 step of h: 2e-2."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch.models.moe as moe_module
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import (
    held_expert_ffn,
    held_expert_ffn_plain,
    held_slots,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.held_experts import takes
from repro_torch.models import build_model
from repro_torch.models.moe import moe_block_held, route_sigmoid

ARCH = "kimi-k2-instruct"
CASES = ["seeded", "held_from_8", "empty_expert", "one_expert", "all_held"]


def routed(case: str, t: int = 24):
    """(cfg, layer params, x (t, d), weights, key) of the smoke config's
    MoE layer: seeded tokens routed by its router (all 16 experts, 8 held
    from 0 or from 8), or a key made for an edge of the counts."""
    cfg = get_smoke_config(ARCH)
    if case == "held_from_8":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, held_from=8))
    model = build_model(cfg, torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(21))
    p, moe = model.layers[1].moe, cfg.moe
    gen = torch.Generator().manual_seed(22)
    x = torch.randn(t, cfg.d_model, generator=gen)
    w, top = route_sigmoid(p["router"], p["bias"], x, moe)
    local = top - moe.held_from
    key = torch.where((local >= 0) & (local < moe.held), local, moe.held)
    k, held = moe.top_k, moe.held
    if case == "empty_expert":      # expert 5 routed nowhere
        key = torch.where(key == 5, held, key)
    elif case == "one_expert":      # every token on expert 2 (count t)
        key = torch.full((t, k), held)
        key[:, 1] = 2
    elif case == "all_held":        # token 3's k places all held
        key[3] = torch.tensor([6, 0, 7, 4])
    return cfg, p, x, w, key


@pytest.mark.parametrize("case", CASES)
def test_slot_lists_are_the_written_out_loop(case):
    """Expert e's slots are the flat places token * k + j keyed e, in
    increasing order, after every slot of the experts before it; the
    places held nowhere here come last; ``ends`` counts them through."""
    cfg, _, _, _, key = routed(case)
    held, flat = cfg.moe.held, key.reshape(-1).tolist()
    order, ends = held_slots(key, held)
    want, counted = [], []
    for e in range(held + 1):
        want += [i for i, v in enumerate(flat) if v == e]
        counted.append(len(want))
    assert order.tolist() == want
    assert ends.tolist() == counted
    if case == "one_expert":
        assert np.diff([0, *counted[:held]]).tolist() == \
            [0, 0, len(key), 0, 0, 0, 0, 0]
    if case == "empty_expert":
        assert counted[5] == counted[4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_lists_are_stable_in_expert_order_with_first_slots(seed):
    """Random keys with ties everywhere: the held experts' keys read in
    ``order`` do not decrease, equal keys keep their places' order, and
    expert e's first slot is ``ends[e - 1]``, the first place keyed e."""
    rng = np.random.default_rng(seed)
    held, t, k = 8, 50, 6
    key = torch.as_tensor(rng.integers(0, held + 1, (t, k)))
    order, ends = held_slots(key, held)
    flat = key.reshape(-1)
    keys = flat[order]
    assert (keys[1:] >= keys[:-1]).all()
    same = keys[1:] == keys[:-1]
    assert (order[1:][same] > order[:-1][same]).all()
    for e in range(held):
        first = int(ends[e - 1]) if e else 0
        places = (flat == e).nonzero().flatten()
        assert int(ends[e]) - first == len(places)
        if len(places):
            assert int(order[first]) == int(places[0])


def written_out(x, p, w, key, held, dtype):
    """Every token's held places one at a time, in top-k order: h in f32
    rounded to ``dtype``, its product in f32 times the place's weight."""
    out = torch.zeros(x.shape, dtype=torch.float32)
    for i in range(x.shape[0]):
        for j in range(key.shape[1]):
            e = int(key[i, j])
            if e >= held:
                continue
            xi = x[i].float()
            h = (F.silu(xi @ p["w_gate"][e].float())
                 * (xi @ p["w_up"][e].float())).to(dtype)
            out[i] += (h.float() @ p["w_down"][e].float()) * w[i, j]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_is_the_written_out_loop(case, dtype):
    cfg, p, x, w, key = routed(case)
    held = cfg.moe.held
    p = {n: p[n].to(dtype) for n in ("w_gate", "w_up", "w_down")}
    x = x.to(dtype)
    args = (x, p["w_gate"], p["w_up"], p["w_down"], w, key)
    got = held_expert_ffn_plain(*args)
    assert got.dtype == torch.float32 and got.shape == x.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    want = written_out(x, p, w, key, held, dtype)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # a token with no held place gets zeros
    assert not got[(key >= held).all(1)].any()


def test_wrapper_on_the_cpu_runs_the_plain_version_and_counts_nothing():
    cfg, p, x, w, key = routed("seeded")
    args = (x.bfloat16(), p["w_gate"].bfloat16(), p["w_up"].bfloat16(),
            p["w_down"].bfloat16(), w, key)
    saved = held_expert_ffn.launches
    try:
        reset_launch_counts()
        assert torch.equal(held_expert_ffn(*args),
                           held_expert_ffn_plain(*args))
        assert launch_counts()["held_expert_ffn"] == 0
        held_expert_ffn.launches = 3
        assert launch_counts()["held_expert_ffn"] == 3
        reset_launch_counts()
        assert held_expert_ffn.launches == 0
    finally:
        held_expert_ffn.launches = saved


@pytest.mark.parametrize("device,dtype,d,fe,kernel", [
    ("cuda", torch.bfloat16, 7168, 2048, True),      # Kimi-K2's
    ("cuda:1", torch.bfloat16, 7168, 2048, True),
    ("cuda", torch.bfloat16, 64, 64, True),
    ("cuda", torch.float32, 7168, 2048, False),
    ("cuda", torch.float16, 7168, 2048, False),
    ("cpu", torch.bfloat16, 7168, 2048, False),
    ("meta", torch.bfloat16, 7168, 2048, False),
    ("cuda", torch.bfloat16, 64, 32, False),         # the smoke config's
    ("cuda", torch.bfloat16, 7200, 2048, False),
    ("cuda", torch.bfloat16, 7168, 2000, False),
])
def test_only_bf16_on_the_card_at_tile_widths_is_the_kernels(device, dtype,
                                                             d, fe, kernel):
    assert takes(torch.device(device), dtype, d, fe, 8) is kernel


@pytest.mark.parametrize("bad,msg", [
    ("key", "want"), ("w_down", "want"), ("w_up", "want"),
    ("weights", "want"), ("ndim", "2-d"),
])
def test_wrapper_rejects_bad_arguments(bad, msg):
    _, p, x, w, key = routed("seeded")
    args = {"tokens": x, "w_gate": p["w_gate"], "w_up": p["w_up"],
            "w_down": p["w_down"], "weights": w, "key": key}
    if bad == "ndim":
        args["tokens"] = x[None]
    else:
        args[bad] = args[bad][:-1]
    with pytest.raises(ValueError, match=msg):
        held_expert_ffn(**args)


@pytest.mark.parametrize("shape,arm", [((5, 1), "decode"),
                                       ((2, 6), "prompt")])
def test_moe_block_held_takes_the_slot_lists_only_in_a_decode_step(
        monkeypatch, shape, arm):
    """A decode step's input (one token a row) runs the held experts'
    function (its plain version on the CPU, which builds the slot lists);
    a prompt's gathers the chosen slots; both give the layer's output."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(23))
    p = model.layers[1].moe
    called = []

    def spy(name):
        fn = getattr(moe_module, name)

        def wrapped(*args):
            called.append(name)
            return fn(*args)
        monkeypatch.setattr(moe_module, name, wrapped)

    for name in ("held_expert_ffn", "held_expert_ffn_plain",
                 "_held_gathered"):
        spy(name)
    x = torch.randn(*shape, cfg.d_model, generator=torch.Generator()
                    .manual_seed(24))
    counts = torch.zeros(cfg.moe.held, dtype=torch.long)
    out, _ = moe_block_held(p, x, cfg.moe, counts)
    assert called == (["held_expert_ffn_plain"] if arm == "decode"
                      else ["_held_gathered"])
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert int(counts.sum()) <= x.shape[0] * x.shape[1] * cfg.moe.top_k


@pytest.mark.parametrize("t,d,fe,held,k", [(1024, 7168, 2048, 8, 8),
                                           (3, 64, 64, 16, 4),
                                           (5, 128, 64, 2, 8)])
def test_scratch_layout_keeps_each_piece_aligned_and_apart(t, d, fe, held,
                                                           k):
    """The one scratch allocation a call makes: the slot lists, the
    gathered rows, h and the slots' rows, each on a 256-byte boundary (TMA
    reads need 16), in that order, none overlapping the next."""
    from repro_torch.kernels.held_experts import scratch_layout
    offsets, nbytes = scratch_layout(t, d, fe, held, k)
    slots = t * min(k, held)
    sizes = [t * k * 8, (held + 1) * 8, slots * d * 2, slots * fe * 2,
             t * k * d * 4]
    assert offsets[0] == 0 and all(at % 256 == 0 for at in offsets)
    for at, size, nxt in zip(offsets, sizes, offsets[1:] + [nbytes]):
        assert at + size <= nxt
    assert nbytes - offsets[-1] - sizes[-1] < 256
