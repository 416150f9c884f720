"""The port's dry run, collective counter and roofline.

The dry runs and the ``fake`` process-group checks run in subprocesses
(a fake group is never set up inside the test worker), started together
by a module fixture; each case reads their artifacts.  The roofline runs
in process, against the JAX package's ``analyze_cell`` on the same
artifact.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis.roofline as ref_roofline
import repro_torch.analysis.roofline as roofline
from repro_torch.analysis.flops import cell_flops, cell_hbm_bytes
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as port_mesh

ROOT = Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "HOME": "/root"}
TIMEOUT_S = 300

COUNTER = """
    import json, sys
    import torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.analysis.collectives import CollectiveCounter

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    group = init_device_mesh("cpu", (8,), mesh_dim_names=("x",)).get_group()
    out = {}
    with CollectiveCounter() as c:          # 5 x 3 nested all-to-alls
        for _ in range(5):
            for _ in range(3):
                y = funcol.all_to_all_single(
                    torch.zeros(32, dtype=torch.bfloat16), None, None, group)
                y.wait()
    out["nested"] = c.result()
    with CollectiveCounter() as c:          # no collective at all
        torch.ones(4, 4) @ torch.ones(4, 4)
    out["none"] = c.result()
    with CollectiveCounter() as c:          # a gather and its backward
        w = torch.zeros(4, 3, requires_grad=True)
        funcol.all_gather_single_autograd(w, 0, group).wait().sum().backward()
        funcol.all_reduce(torch.zeros(5), "sum", group).wait()
    out["autograd"] = c.result()
    dist.destroy_process_group()
    print(json.dumps(out))
"""


def _dryrun(out: Path, *args) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out), *args], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    procs = {
        "whisper": _dryrun(d / "whisper", "--arch", "whisper-tiny",
                           "--shape", "decode_32k"),
        "multipod": _dryrun(d / "multipod", "--arch", "whisper-tiny",
                            "--shape", "decode_32k", "--multi-pod", "on"),
        "kimi": _dryrun(d / "kimi", "--arch", "kimi-k2-1t-a32b", "--shape",
                        "decode_32k", "--opts", "moe_ep", "--smoke"),
        "all": _dryrun(d / "all", "--arch", "whisper-tiny", "--all",
                       "--smoke"),
        "counter": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(COUNTER)], cwd=ROOT,
            env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
    }
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        out[name] = (p.returncode, stdout, stderr)
    out["dir"] = d
    return out


def _art(runs, sub: str, name: str) -> dict:
    return json.loads((runs["dir"] / sub / name).read_text())


def test_one_cell_traces_and_reports(runs):
    """The counterpart of ``TestDryRunEntrypoint``: whisper-tiny's
    decode_32k on the one-pod mesh (256 ranks)."""
    rc, _, err = runs["whisper"]
    assert rc == 0, err[-2000:]
    art = _art(runs, "whisper", "whisper-tiny__decode_32k__32x8.json")
    assert art["status"] == "ok"
    assert art["devices"] == 256
    assert art["flops"] > 0
    assert "all-gather" in art["collective_bytes"]
    assert art["collective_bytes"]["all-gather"] > 0
    assert art["collective_counts"]["all-gather"] > 0
    mem = art["memory"]
    assert set(mem) == set(art["memory_notes"])
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_memory_in_bytes"]


def test_multi_pod_cell_has_512_ranks(runs):
    rc, _, err = runs["multipod"]
    assert rc == 0, err[-2000:]
    art = _art(runs, "multipod", "whisper-tiny__decode_32k__2x32x8.json")
    assert art["status"] == "ok" and art["devices"] == 512
    assert art["mesh"] == port_mesh.mesh_name(True) == "2x32x8"


def test_expert_parallel_cell_counts_its_all_reduce(runs):
    """kimi-k2-1t-a32b at smoke width with ``--opts moe_ep``: the MoE runs
    through ``moe_block_ep``, whose sum over 'model' is an all-reduce."""
    rc, _, err = runs["kimi"]
    assert rc == 0, err[-2000:]
    art = _art(runs, "kimi",
               "kimi-k2-1t-a32b__decode_32k__32x8__moe_ep__smoke.json")
    assert art["status"] == "ok", art.get("traceback")
    assert art["opts"] == ["moe_ep"] and art["smoke"]
    assert art["collective_counts"]["all-reduce"] > 0
    assert art["collective_bytes"]["all-reduce"] > 0


def test_all_shapes_of_one_arch_write_one_artifact_each(runs):
    """``--all`` on one arch: one artifact per shape, the skipped cell
    too; a cell that raised is an ``error`` artifact with its traceback,
    and the exit code says so."""
    rc, out, _ = runs["all"]
    arts = {p.name: json.loads(p.read_text())
            for p in (runs["dir"] / "all").glob("*.json")}
    assert sorted(arts) == sorted(
        f"whisper-tiny__{s}__32x8__smoke.json" for s in SHAPES)
    skipped = arts["whisper-tiny__long_500k__32x8__smoke.json"]
    assert skipped["status"] == "skipped" and "quadratic" in skipped["reason"]
    assert arts["whisper-tiny__decode_32k__32x8__smoke.json"]["status"] \
        == "ok"
    errors = [a for a in arts.values() if a["status"] == "error"]
    for a in errors:
        assert a["error"] and a["traceback"]
    assert rc == (1 if errors else 0)
    assert f"4 cells, {len(errors)} failures" in out


def test_collective_counter_nested_loops(runs):
    """The counterpart of ``test_synthetic_nested``: 5 x 3 all-to-alls
    of bf16[32] count 15 ops and 5 * 3 * 32 * 2 bytes, each executed
    instance once."""
    rc, out, err = runs["counter"]
    assert rc == 0, err[-2000:]
    res = json.loads(out.splitlines()[-1])
    nested = res["nested"]
    assert nested["counts"]["all-to-all"] == 15
    assert nested["all-to-all"] == 5 * 3 * 32 * 2 == 960
    assert sum(nested["counts"].values()) == 15
    none = res["none"]
    assert all(v == 0 for k, v in none.items() if k != "counts")
    assert all(v == 0 for v in none["counts"].values())
    grad = res["autograd"]
    assert grad["counts"]["all-gather"] == 1
    assert grad["counts"]["reduce-scatter"] == 1      # the gather's backward
    assert grad["counts"]["all-reduce"] == 1
    assert grad["all-gather"] == 8 * 4 * 3 * 4


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

ARTIFACT = {"arch": "qwen3-14b", "shape": "train_4k", "mesh": "32x8",
            "status": "ok", "devices": 256, "microbatches": 4, "opts": [],
            "flops": 1.0e15,
            "collective_bytes": {"all-gather": 3.0e9, "all-reduce": 2.0e9,
                                 "reduce-scatter": 1.0e9, "all-to-all": 0.0,
                                 "collective-permute": 0.0}}


def test_roofline_terms_from_the_h100_constants():
    row = roofline.analyze_cell(ARTIFACT)
    cfg, shape = get_config("qwen3-14b"), SHAPES["train_4k"]
    rep = cell_flops(cfg, shape, microbatches=4)
    hbm = cell_hbm_bytes(cfg, shape, 256, microbatches=4)
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BW == 3.35e12
    assert port_mesh.IB_BW == roofline.COLLECTIVE_BW == 50e9
    assert port_mesh.NVLINK_BW == 450e9
    assert row["t_compute_s"] == rep.total / (256 * 989e12)
    assert row["t_memory_s"] == hbm["total"] / 3.35e12
    assert row["t_collective_s"] == (3e9 + 2 * 2e9 + 1e9) / 50e9
    t = max(row["t_compute_s"], row["t_memory_s"], row["t_collective_s"])
    assert row["t_step_s"] == t
    assert row["projected_mfu"] == rep.model_flops / (256 * 989e12 * t)
    assert row["dominant"] in ("compute", "memory", "collective")
    assert roofline.analyze_cell({**ARTIFACT, "status": "error"}) is None


@pytest.mark.parametrize("mesh,link", (("16x16", "ICI_BW"),
                                       ("2x16x16", "DCN_BW")))
def test_roofline_equals_the_reference_under_its_constants(monkeypatch,
                                                           mesh, link):
    """With the reference's TPU v5e constants patched in, the port's
    ``analyze_cell`` is the reference's on the same artifact (the
    reference charges a multi-pod cell at its DCN rate)."""
    art = {**ARTIFACT, "mesh": mesh}
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16",
                        ref_roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "COLLECTIVE_BW",
                        getattr(ref_roofline, link))
    got, want = roofline.analyze_cell(art), ref_roofline.analyze_cell(art)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_roofline_main_writes_its_table(tmp_path, capsys):
    arts = tmp_path / "arts"
    arts.mkdir()
    (arts / "a.json").write_text(json.dumps(ARTIFACT))
    (arts / "b.json").write_text(json.dumps(
        {**ARTIFACT, "shape": "long_500k", "status": "skipped"}))
    roofline.main(["--artifacts", str(arts), "--out",
                   str(tmp_path / "roofline.json")])
    out = capsys.readouterr().out
    assert "| qwen3-14b | train_4k | 32x8 |" in out
    assert "1 skipped cells" in out
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert len(rows) == 1 and rows[0]["chips"] == 256
