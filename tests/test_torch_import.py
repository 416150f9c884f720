"""The PyTorch port stands alone: importing it (the cluster, the fleet
API and ``obs`` included) loads neither JAX, nor the JAX package, nor
``ml_dtypes``; no port file imports them, and its entry points run on
the card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)"
    r"|from\s+repro(\.|\s)|import\s+ml_dtypes\b|from\s+ml_dtypes\b)",
    re.M)

# the one place the port touches ml_dtypes: handing bf16 weights to the
# JAX package, which only the tests (JAX's side) call
ML_DTYPES_ALLOWED = {"src/repro_torch/convert.py"}

# a reference module whose port counterpart has another name: torch has
# no XLA HLO to parse, so the port counts collectives as they are
# dispatched
COUNTERPARTS = {"analysis/hlo.py": "analysis/collectives.py"}


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.core, "
        "repro_torch.runtime, repro_torch.kernels, repro_torch.convert\n"
        "import repro_torch.api.__main__, repro_torch.cluster.faults, "
        "repro_torch.configs, repro_torch.models, repro_torch.parallel, "
        "repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.cluster, repro_torch.cluster.transport, "
        "repro_torch.api.fleet, repro_torch.obs, repro_torch._env\n"
        "import repro_torch.cluster.transport.tcp, "
        "repro_torch.cluster.transport.shm, repro_torch.cluster.chaos, "
        "repro_torch.cluster.retry, repro_torch.obs.attrib, "
        "repro_torch.obs.export, repro_torch.obs.__main__\n"
        "import repro_torch.serve.router, repro_torch.scale, "
        "repro_torch.scale.pool, repro_torch.scale.controller\n"
        "import repro_torch.models.moe, repro_torch.models.mamba2, "
        "repro_torch.models.whisper, repro_torch.parallel.coded_grads\n"
        "import repro_torch.data, repro_torch.optim, repro_torch.train, "
        "repro_torch.train.checkpoint, repro_torch.analysis.flops, "
        "repro_torch.launch.train\n"
        "import repro_torch.parallel.ctx, repro_torch.parallel.sharding, "
        "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
        "repro_torch.analysis.collectives, repro_torch.analysis.roofline\n"
        "repro_torch.compile_plan, repro_torch.CodedFleet, "
        "repro_torch.ClusterPlan, repro_torch.Autoscaler\n"
        "repro_torch.configs.get_config('phi3-mini-3.8b')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_public_names_match_the_reference():
    """Every top-level name of the JAX package, and every name its
    ``repro.api``, ``repro.serve``, ``repro.models``, ``repro.data``,
    ``repro.optim``, ``repro.train`` and ``repro.parallel`` export,
    resolves in the port (the top level lazily); the port adds
    ``plan_from_reference_arrays``.  Every module of the JAX package has
    its counterpart in the port, under the same path but for
    ``COUNTERPARTS``."""
    import repro
    import repro.api
    import repro.models
    import repro.models.moe
    import repro.parallel
    import repro.serve
    import repro_torch
    import repro_torch.api
    import repro_torch.models
    import repro_torch.models.moe
    import repro_torch.parallel
    import repro_torch.serve

    assert set(repro_torch.__all__) == set(repro.__all__) | {
        "plan_from_reference_arrays"}
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None, name
    import repro.data
    import repro.optim
    import repro.train
    import repro_torch.data
    import repro_torch.optim
    import repro_torch.train

    for ref, port in ((repro.api, repro_torch.api),
                      (repro.serve, repro_torch.serve),
                      (repro.models, repro_torch.models),
                      (repro.data, repro_torch.data),
                      (repro.optim, repro_torch.optim),
                      (repro.train, repro_torch.train),
                      (repro.parallel, repro_torch.parallel)):
        names = {n for n in vars(ref) if not n.startswith("_")
                 and not isinstance(getattr(ref, n), type(repro))}
        missing = sorted(n for n in names if not hasattr(port, n))
        assert not missing, (port.__name__, missing)
    from repro_torch.api import CodedFleet, PlanHandle
    from repro_torch.cluster.fleet import CodedFleet as Fleet

    assert CodedFleet is Fleet is repro_torch.CodedFleet
    assert PlanHandle is repro_torch.PlanHandle
    for name in ("CodedAggregator", "CodedLinear"):
        assert hasattr(repro.parallel, name)
        assert getattr(repro_torch.parallel, name).__name__ == name
    assert repro_torch.models.WhisperLM.__name__ == "WhisperLM"
    for name in ("CodedMoE", "moe_block_ep", "moe_apply"):
        assert getattr(repro_torch.models.moe, name).__name__ == \
            getattr(repro.models.moe, name).__name__
    ref_root = ROOT / "src" / "repro"
    missing = sorted(
        rel for rel in (p.relative_to(ref_root).as_posix()
                        for p in ref_root.rglob("*.py"))
        if not (PORT / COUNTERPARTS.get(rel, rel)).is_file())
    assert not missing, missing


SCANNED = sorted([p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
                 + ["chip_smoke.py"])


def test_scan_covers_every_subpackage():
    packages = {p.parent.relative_to(PORT).as_posix()
                for p in PORT.rglob("__init__.py")}
    assert {"analysis", "api", "cluster", "cluster/transport", "configs",
            "core", "data", "kernels", "launch", "models", "obs", "optim",
            "parallel", "runtime", "scale", "serve", "train"} <= packages
    for pkg in packages:
        assert any(path.startswith(f"src/repro_torch/{pkg}/".replace("/./", "/"))
                   for path in SCANNED), pkg


@pytest.mark.parametrize("path", SCANNED)
def test_no_jax_or_reference_import_in_source(path):
    src = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
    if path in ML_DTYPES_ALLOWED:
        hits = [h for h in hits if "ml_dtypes" not in h]
    assert not hits, f"{path} imports {hits}"


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.api import compile_plan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.ones((8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_plan(A, scheme="proposed", n=6, k_A=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_plan(torch.ones(8, 8), scheme="proposed", n=6, k_A=4,
                     device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_plan(scheme="proposed", n=6, s=2)     # aggregation-only
    # an explicit CPU request runs on the CPU
    plan = compile_plan(A, scheme="proposed", n=6, k_A=4, device="cpu")
    assert plan.device.type == "cpu"
    plan = compile_plan(torch.ones(8, 8), scheme="proposed", n=6, k_A=4)
    assert plan.device.type == "cpu" and plan.backend == "reference"


def test_cuda_wrappers_never_fall_back():
    """A CUDA tensor reaches the kernel path: on a machine without a
    card the wrapper cannot even make one, so the only CPU route is a
    CPU tensor.  A tensor on another device raises."""
    from repro_torch.kernels import bcsr_matmul, cyclic_encode, decode_matmul

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_matmul(torch.ones(2, 2, device=meta),
                      torch.ones(2, 4, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        cyclic_encode(torch.ones(2, 4, 4, device=meta),
                      torch.zeros(3, 1, dtype=torch.int32, device=meta),
                      torch.ones(3, 1, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        bcsr_matmul(torch.ones(1, 1, 8, 8, device=meta),
                    torch.zeros(1, 1, dtype=torch.int32, device=meta),
                    torch.ones(8, 4, device=meta))
