"""One run of one cell: resolve it, set it up, measure, judge, report.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- the workload's ``config`` names ``configs[].file``
  (``bench/configs/<config>.json``), whose ``system`` names the module of
  ``bench/systems/`` that builds the system under test;
- the workload's ``traffic`` names ``bench/traffic/<traffic>.json``, whose
  ``generator`` names the module of ``bench/generators/`` that warms the
  system up and drives it through the window (``schedule.py`` holds what
  the generators share);
- every metric names ``bench/metrics/<metric>.py``, whose ``read(run)``
  returns the number, or None where the run holds nothing to read.

A system module's ``System(cfg, seed, device)`` gives ``n``, ``s`` and
``pool_rows``; ``call(item)``, the timed call; ``counters()``, the
program's counters; ``work(item)``, what the uncoded call needs;
``kernel_bounds(items)`` and ``kernel_rows``, each port kernel's least
time per launch and its traced names; ``release()``, which frees the
program's state; ``control(item)``, the reference one precision step
down; and ``check(samples)``, the numbers compared against the
configuration's ``correct`` limits.

A run reports the cell's end-to-end metrics with ``--trace 0`` and its
per-layer metrics with ``--trace 1``: the cells a metric lists under
``workloads``, or, without that key, every cell that reports the
end-to-end metric it ``moves``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# what may not be loaded in the process that prints a result, by
# top-level module name compared whole (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# per-process caches of the program and of the libraries it may use,
# at fixed paths inside the checkout (``build/`` is ignored by git)
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "build/bench-cache/triton",
    "TORCH_EXTENSIONS_DIR": "build/bench-cache/torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "build/bench-cache/inductor",
    "CUDA_CACHE_PATH": "build/bench-cache/nv",
}


class BenchError(RuntimeError):
    """A run that cannot give a result (exit code 2)."""


def set_environment(root: Path = ROOT) -> None:
    """Caches at fixed paths inside the checkout; no JAX through a
    library that could load it by itself."""
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(root / rel)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (ticks since boot), so interpreter start-up is counted."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, IndexError, ValueError, AttributeError):
        return time.perf_counter() - _IMPORTED_AT


_IMPORTED_AT = time.perf_counter()


# -- the cell -----------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def resolve(bench: dict, workload: str, trace: bool, root: Path = ROOT
            ) -> dict:
    """The cell's workload entry, configuration, traffic and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    from schedule import load as load_traffic
    traffic = load_traffic(cell["traffic"], root / "bench" / "traffic")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise BenchError(f"no program at {ROOT / 'src' / 'repro_torch'}")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if workload in cells if cells is not None else m["moves"] in names:
            layer.append(m)
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "metrics": layer if trace else e2e}


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py``, loaded once per process."""
    key = f"bench_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    return load_module("metrics", name).read


# -- the card -----------------------------------------------------------------


def require_card(chips: int):
    """The card this run measures on; raises where there is none."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, this machine has "
                         f"{torch.cuda.device_count()}")
    name = torch.cuda.get_device_name(0)
    if "H100" not in name:
        raise BenchError(f"the card is {name!r}, not an H100")
    return torch.device("cuda", 0)


def nvidia_smi() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def diag(**fields) -> None:
    print(json.dumps({"bench": fields}, default=str), file=sys.stderr,
          flush=True)


# -- one run ------------------------------------------------------------------


class Run:
    """What the metric readers read: the window's record, the counters
    before and after it, the reduced device trace, the uncoded work of
    the window's calls (``System.work`` summed), the set-up time."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def delta(self, group: str, key: str) -> float:
        return self.after[group][key] - self.before[group][key]


def total_work(system, items) -> dict:
    """``System.work`` summed over the window's completed calls."""
    out: dict = {}
    for item in items:
        for key, value in system.work(item).items():
            out[key] = out.get(key, 0.0) + value
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device=None, bench: dict | None = None,
             keep: dict | None = None) -> dict:
    """Run one cell and return the result line's object.  ``device``
    skips the look for a card (tests on the CPU pass ``cpu``); ``keep``,
    when given, gets the system (its inputs; the program's state is
    released) and the compared samples, for ``calibrate.py``."""
    import torch

    spec = resolve(bench or load_benchmark(root), workload, trace, root)
    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    readers = {m["name"]: (m, load_reader(m["name"]))
               for m in spec["metrics"]}
    generator = load_module("generators", traffic["generator"])
    dev = torch.device(device) if device is not None \
        else require_card(cell["chips"])
    on_card = dev.type == "cuda"

    stages = {"to_card_s": process_age_s()}
    system = load_module("systems", cfg["system"]).System(cfg, seed, dev)
    from repro_torch.kernels import _build, launch_counts
    if on_card:
        _build.library()                # built once; later runs load it
        diag(build=dict(_build.build_info))
    stages["system_s"] = process_age_s() - stages["to_card_s"]
    generator.warm(system, traffic, seed)
    if on_card:
        torch.cuda.synchronize(dev)

    tracer = None
    if trace and on_card:
        from devtrace import DeviceTrace
        tracer = DeviceTrace(dev)
        tracer.warm()
    window = tracer.window if tracer is not None else contextlib.nullcontext
    before = system.counters()
    launches_before = launch_counts()
    setup_s = process_age_s()
    stages["warm_s"] = setup_s - stages["system_s"] - stages["to_card_s"]
    diag(setup_s=setup_s, stages=stages)

    pauses = _GcPauses()
    rec = generator.measure(system, traffic, seconds, seed, dev, window,
                            label=tracer is not None)
    pauses.stop()
    after = system.counters()
    launches = {k: v - launches_before[k] for k, v in launch_counts().items()}
    reduced = tracer.reduce() if tracer is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    work = total_work(system, rec.items)
    kernel_bounds = system.kernel_bounds(
        [s[0] for s in rec.samples]) if reduced is not None else {}

    run = Run(record=rec, before=before, after=after, trace=reduced,
              work=work, setup_s=setup_s)
    metrics = {}
    for name, (entry, read) in readers.items():
        value = read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}

    diag(window_s=rec.window_s, attempted=rec.attempted, failed=rec.failed,
         errors=rec.errors, completed_in_window=rec.completed_in_window,
         launches=launches, counters_before=before, counters_after=after,
         work=work, gc=pauses.summary())
    if reduced is not None:
        per_kernel = {k: {"launches": reduced["launches"].get(k, 0),
                          "device_s": s} for k, s in reduced["ops"][:10]}
        ops = dict(reduced["ops"])
        for kernel, bound in kernel_bounds.items():
            names = [n for n in reduced["launches"]
                     if n.startswith(system.kernel_rows[kernel])]
            if names:
                launched = sum(reduced["launches"][n] for n in names)
                secs = sum(ops[n] for n in names)
                per_kernel[kernel] = {"launches": launched,
                                      "device_s": secs,
                                      "bound_s_per_launch": bound,
                                      "roofline": bound * launched / secs}
        diag(kernels=per_kernel, n_gaps=reduced["n_gaps"])

    # the program's state goes before the reference runs
    samples = rec.samples
    system.release()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    found = system.check(samples)
    diag(compared={k: v for k, v in found.items()
                   if not k.startswith("per_call")})
    if keep is not None:
        keep.update(system=system, samples=samples, found=found)
    checks = {name: {"value": found[name], "limit": limit}
              for name, limit in cfg["correct"].items()}
    checks["failed_calls"] = {"value": rec.failed, "limit": 0}
    checks["checked_calls"] = {"value": found["checked_calls"],
                               "limit_min": 1}
    correct = (all(c["value"] <= c["limit"] for c in checks.values()
                   if "limit" in c)
               and found["checked_calls"] >= 1)

    bad = forbidden_modules()
    if bad:
        raise BenchError(f"modules loaded in the measuring process: {bad}")

    result = {"workload": workload, "seed": seed, "trace": int(trace),
              "correct": bool(correct), "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": torch.cuda.get_device_name(dev)
                         if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if reduced is not None:
        result["device"]["busy_s"] = reduced["busy_s"]
        result["device"]["window_s"] = reduced["window_s"]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in reduced["ops"][:10]],
            "idle_gaps": [[k, v] for k, v in reduced["gaps"][:10]]}
    if on_card:
        # after the window, so that set-up does not wait for it
        diag(card=nvidia_smi(), torch=torch.__version__,
             cuda=torch.version.cuda)
    result["checks"] = checks
    return result


class _GcPauses:
    """The interpreter's garbage collections while the window runs: how
    many, their summed and longest pause (a diagnostic of host stalls)."""

    def __init__(self):
        import gc
        self._gc = gc
        self.pauses: list[float] = []
        self._t0 = None
        gc.callbacks.append(self._note)

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append(time.perf_counter() - self._t0)
            self._t0 = None

    def stop(self) -> None:
        if self._note in self._gc.callbacks:
            self._gc.callbacks.remove(self._note)

    def summary(self) -> dict:
        return {"collections": len(self.pauses),
                "total_ms": 1e3 * sum(self.pauses),
                "max_ms": 1e3 * max(self.pauses, default=0.0)}
