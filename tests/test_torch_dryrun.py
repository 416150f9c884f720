"""The port's dry run, collective counter and roofline.

The dry runs and the ``fake`` process-group checks run in subprocesses
(a fake group is never set up inside the test worker), started together
by a module fixture; each case reads their artifacts.  Every arch's
smoke config is traced at every shape: one ``--all --smoke`` run per
arch, and the slow archs (gemma3, mamba2, zamba2) cell by cell.  Three
cells that trace for minutes here and were ``ok`` before the dry run's
repair are left to the chip host's full-width ``--all`` (``LEFT_OUT``).
The roofline runs in process, against the JAX package's
``analyze_cell`` on the same artifact.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis.roofline as ref_roofline
import repro_torch.analysis.roofline as roofline
from repro_torch.analysis.flops import cell_flops, cell_hbm_bytes
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import supports_shape

ROOT = Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "HOME": "/root",
       "OMP_NUM_THREADS": "1"}
# each run's own limit: a smoke prefill walks 64 x 64 attention chunks
# per layer (gemma3's 6 layers: ~170 s alone here, more beside other
# test files)
TIMEOUT_S = 900

# smoke cells that trace for minutes on this host (mamba2's train_4k and
# prefill_32k, zamba2's train_4k), ok before the repair; the chip host's
# full-width --all holds them
LEFT_OUT = {("mamba2-1.3b", "train_4k"), ("mamba2-1.3b", "prefill_32k"),
            ("zamba2-2.7b", "train_4k")}
CELL_BY_CELL = ("gemma3-12b", "mamba2-1.3b", "zamba2-2.7b")

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
    meta = lambda *shape, dtype=torch.bool: torch.empty(
        shape, dtype=dtype, device="meta")
    with CollectiveCounter():               # equal has no meta kernel
        out["equal"] = [torch.equal(meta(4, 2), meta(4, 2)),
                        torch.equal(meta(4, 2), meta(4, 3)),
                        torch.equal(meta(4), meta(4, dtype=torch.int64))]
    dist.destroy_process_group()
    print(json.dumps(out))
"""

# a cell whose build raises: its artifact, and the run's exit code
FORCED_ERROR = """
    import sys
    from repro_torch.launch import dryrun

    def build_cell(*args, **kwargs):
        raise RuntimeError("this cell was told to fail")

    dryrun.build_cell = build_cell
    dryrun.main(sys.argv[1:])
"""


def _command(out: Path, *args) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
            str(out), *args]


def _jobs(d: Path) -> dict:
    """name -> command.  Every arch's smoke config: one ``--all --smoke``
    run per arch, the slow archs one run per cell (``LEFT_OUT`` aside),
    each arch's artifacts in its own dir."""
    jobs = {
        "whisper": _command(d / "whisper", "--arch", "whisper-tiny",
                            "--shape", "decode_32k"),
        "multipod": _command(d / "multipod", "--arch", "whisper-tiny",
                             "--shape", "decode_32k", "--multi-pod", "on"),
        "kimi": _command(d / "kimi", "--arch", "kimi-k2-1t-a32b", "--shape",
                         "decode_32k", "--opts", "moe_ep", "--smoke"),
        "counter": [sys.executable, "-c", textwrap.dedent(COUNTER)],
        "error": [sys.executable, "-c", textwrap.dedent(FORCED_ERROR),
                  "--arch", "whisper-tiny", "--shape", "decode_32k",
                  "--smoke", "--out", str(d / "error")],
    }
    for arch in ARCH_IDS:
        if arch not in CELL_BY_CELL:
            jobs[("smoke", arch)] = _command(d / "smoke" / arch, "--arch",
                                             arch, "--all", "--smoke")
            continue
        for shape in SHAPES:
            if (arch, shape) not in LEFT_OUT:
                jobs[("smoke", arch, shape)] = _command(
                    d / "smoke" / arch, "--arch", arch, "--shape", shape,
                    "--smoke")
    return jobs


def _slow_first(name) -> int:
    """The longest runs start first: the cell-by-cell prefills, then the
    archs' ``--all`` runs (each holds a prefill), then the rest."""
    if isinstance(name, tuple) and name[-1] == "prefill_32k":
        return 0
    return 1 if isinstance(name, tuple) and len(name) == 2 else 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    jobs = _jobs(d)

    def run(cmd):
        # a run past its limit fails only the cases that read it; the
        # traces run at a lower priority than the other test files, whose
        # cases are paced by the clock
        try:
            p = subprocess.run(cmd, cwd=ROOT, env=ENV, capture_output=True,
                               text=True, timeout=TIMEOUT_S,
                               preexec_fn=lambda: os.nice(10))
        except subprocess.TimeoutExpired as e:
            return "timeout", str(e.stdout or ""), str(e.stderr or "")
        return p.returncode, p.stdout, p.stderr

    # three at a time: the file takes minutes, but the other files'
    # clock-paced cases keep their cores
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {name: pool.submit(run, jobs[name])
                for name in sorted(jobs, key=_slow_first)}
        out = {name: f.result() for name, f in futs.items()}
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
    too, every other cell ``ok``, and the exit code 0."""
    rc, out, err = runs[("smoke", "whisper-tiny")]
    arts = {p.name: json.loads(p.read_text())
            for p in (runs["dir"] / "smoke" / "whisper-tiny").glob("*.json")}
    assert sorted(arts) == sorted(
        f"whisper-tiny__{s}__32x8__smoke.json" for s in SHAPES)
    skipped = arts["whisper-tiny__long_500k__32x8__smoke.json"]
    assert skipped["status"] == "skipped" and "quadratic" in skipped["reason"]
    for name, art in arts.items():
        if art is not skipped:
            assert art["status"] == "ok", (name, art.get("traceback"))
    assert rc == 0, err[-2000:]
    assert "4 cells, 0 failures" in out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_smoke_cell_builds(runs, arch):
    """Every shape the arch's ``supports_shape`` allows traces ``ok`` on
    the production mesh at smoke width (kimi on its default MoE path, no
    ``moe_ep``); the rest are ``skipped`` with its reason."""
    for key in runs:
        if isinstance(key, tuple) and key[:2] == ("smoke", arch):
            rc, _, err = runs[key]
            assert rc == 0, (key, err[-3000:])
    arts = {a["shape"]: a for a in (
        json.loads(p.read_text())
        for p in (runs["dir"] / "smoke" / arch).glob("*.json"))}
    cfg = get_smoke_config(arch)
    for shape, spec in SHAPES.items():
        if (arch, shape) in LEFT_OUT:
            assert shape not in arts
            continue
        art = arts[shape]
        assert art["smoke"] and art["opts"] == [] and art["mesh"] == "32x8"
        ok, reason = supports_shape(cfg, spec)
        if ok:
            assert art["status"] == "ok", (shape, art.get("traceback"))
            assert art["devices"] == 256 and art["flops"] > 0
        else:
            assert art["status"] == "skipped" and art["reason"] == reason


def test_a_cell_that_raises_is_an_error_artifact(runs):
    """A cell whose step raises is written with ``status: error``, its
    error and the tail of its traceback, and the run exits 1."""
    rc, out, _ = runs["error"]
    assert rc == 1
    assert "1 cells, 1 failures" in out
    art = json.loads((runs["dir"] / "error" /
                      "whisper-tiny__decode_32k__32x8__smoke.json").read_text())
    assert art["status"] == "error"
    assert art["error"] == "RuntimeError: this cell was told to fail"
    assert "build_cell" in art["traceback"]
    assert art["traceback"].rstrip().endswith(
        "RuntimeError: this cell was told to fail")


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
    assert res["equal"] == [True, False, False]


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
