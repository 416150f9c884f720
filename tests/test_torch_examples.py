"""The ten examples: each port example (``examples/torch/<name>.py``,
``--device cpu``) against the reference's (``examples/<name>.py``,
``JAX_PLATFORMS=cpu``).

Both run as subprocesses from a temporary working directory with
``PYTHONPATH=<repo>/src``, so the reference's ``sys.path.insert(0,
"src")`` is harmless and ``trace_round.json`` lands in the temporary
directory.  A module fixture starts all twenty runs, a few at a time;
each case reads its pair.  ``train_lm`` runs 20 steps in both packages,
each with its own ``--ckpt-dir``.

Compared, line for line and in order: every printed line, once the
fields below are masked.  That holds the scheme list; n, k, s, ω and
``min_weight``; densities and the drawn straggler sets; ``edge_offload``'s
Monte-Carlo p50/p99 table (numpy in both, so equal); wire sizes, tile
and row counts, decoded-from counts; the router's paused-burst dispatch
(rounds, fair shares, width ramp) and tenant counters; the param count;
and each example's closing line.

Masked, because the clock or the weights set them: times, rates and
latencies (the chaos recovery lines are dropped: which kinds have one
follows the clock too); ``backend=`` and ``device`` where the reference says
``auto``; generated tokens and loss values (the port draws its weights
from a ``torch.Generator``); the router's replica choice, the
autoscaler's peak, decisions and grown code, the attribution table and
capacity levels, the chaos journal, the per-round
coalescing of ``fleet_serve`` and the trace's event count.  Of the chaos
outcome counts the total and the failures are compared (none may fail);
the clean/degraded split follows the clock, as do the final plan id
and whether the joiner served (extra suspicions re-encode), and
``edge_cluster``'s fail-stop deaths and silent-hang counts.  Every recovered-result
error is held to the examples' own assertion, 1e-3, but for
``edge_cluster``'s, whose racing rounds decode from whichever workers
finished first (it asserts nothing of them).
"""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 600       # each run's own; ~5-25 s alone here
ERR_BOUND = 1e-3
# edge_cluster asserts nothing of its errors: each round decodes from
# whichever workers finished first, and some of the C(12, 3) patterns
# are ill-conditioned (the reference has printed 0.07 there)
UNBOUNDED = {"edge_cluster"}
FLOAT = r"[-+]?[0-9.]+(?:e[-+]?[0-9]+)?"

# name -> extra arguments for both packages
ARGS = {"train_lm": ["--steps", "20"]}

# an error printed by an example: masked and held to ERR_BOUND
ERRS = [rf"(?:max rel err = |rel err |err=|err |\|err\| = |"
        rf"\|coded - direct\| = |uncoded head = |sum exact to )({FLOAT})"]

# name -> [(pattern, replacement)] masking what the clock or the weights set
MASKS = {
    "quickstart": [(r"'backend': '\w+'", "'backend': _"),
                   (r", 'device': '\w+'", "")],
    "edge_offload": [(r"backend=\w+", "backend=_")],
    "edge_cluster": [(rf"wall=\s*{FLOAT} ms", "wall=_"),
                     (rf"decode=\s*{FLOAT} us", "decode=_"),
                     (r"decoded from \d+ rows, partial hosts \[[\d, ]*\]",
                      "decoded from _ rows, partial hosts _"),
                     (r"deaths=\d+ requeues=\d+", "deaths=_ requeues=_"),
                     (r"on \d+ survivors", "on _ survivors"),
                     (r"suspected=\d+ requeues=\d+ decoded_from=\d+",
                      "suspected=_ requeues=_ decoded_from=_")],
    "fleet_serve": [(rf"in {FLOAT} ms \({FLOAT} calls/s\)", "in _"),
                    (r"head rounds: \d+ for", "head rounds: _ for"),
                    (r"coalesced: \[[\d, ]*\]", "coalesced: _")],
    "serve_coded": [(r"'backend': '\w+'", "'backend': _"),
                    (r", 'device': '\w+'", ""),
                    (r"-> \[[\d, ]*\]", "-> _")],
    "chaos_fleet": [(r"futures: \d+ clean, \d+ degraded-but-correct, ",
                     "futures: "),
                    (r"fleet journal: .*", "fleet journal: _"),
                    (r"plan_id=\d+ ", ""),
                    (r"^joiner serving the attached plan: .*", ""),
                    (r"^recovery after \w+: .*", ""),
                    (r"\{'clean': \d+, 'degraded': \d+, ", "{")],
    "router_serve": [(rf"in {FLOAT} ms over", "in _ over"),
                     (r"replicas used: \[[\d, ]*\]", "replicas used: _"),
                     (rf"p50 {FLOAT} ms", "p50 _")],
    "trace_round": [(r"^\s+\d+\s+\d+\s+\d+\s+.*", "_row"),
                    (rf"^  \w+\s+{FLOAT} ms total", "  _ ms total"),
                    (rf"wasted work \(computed but not decoded\): {FLOAT}",
                     "wasted work _"),
                    (rf"worker (\d+):\s+(?:{FLOAT} work/s|\(no sample\))"
                     rf" -> level \d+", r"worker \1: _"),
                    (r"wrote \d+ events", "wrote _ events")],
    "autoscale_serve": [(r"replicas 1 -> \d+", "replicas 1 -> _"),
                        (rf"after {FLOAT}s", "after _"),
                        (r"decisions: .*", "decisions: _"),
                        (r"measured rates \{.*\}", "measured rates _"),
                        (r"-> \(\d+, \d+, \d+\) scheme=[\w-]+", "-> _"),
                        (r"worker: \{.*\}", "worker: _")],
    "train_lm": [(rf"loss {FLOAT}\s+{FLOAT} ms/step", "loss _"),
                 (rf"loss: {FLOAT} -> {FLOAT}", "loss: _")],
}
NAMES = sorted(MASKS)


def _command(name: str, package: str, tmp: Path) -> list[str]:
    script = ROOT / "examples" / ("torch" if package == "port" else "") \
        / f"{name}.py"
    cmd = [sys.executable, str(script), *ARGS.get(name, [])]
    if name == "train_lm":
        cmd += ["--ckpt-dir", str(tmp / "ckpt")]
    if package == "port":
        cmd += ["--device", "cpu"]
    return cmd


def _run(name: str, package: str, tmp: Path):
    tmp.mkdir(parents=True)
    # one thread each (torch's and XLA's pools would take every core):
    # the other test files' cases are paced by the clock
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    env.pop("REPRO_CODED_BACKEND", None)
    try:
        p = subprocess.run(_command(name, package, tmp), cwd=tmp, env=env,
                           capture_output=True, text=True,
                           timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        return ("timeout", e.stdout or "", e.stderr or "", tmp)
    return (p.returncode, p.stdout, p.stderr, tmp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("examples")
    jobs = [(name, pkg) for name in NAMES for pkg in ("port", "ref")]
    # the slow ones first
    jobs.sort(key=lambda j: j[0] not in ("train_lm", "chaos_fleet"))
    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = {job: pool.submit(_run, job[0], job[1],
                                 base / f"{job[0]}-{job[1]}")
                for job in jobs}
        return {job: f.result() for job, f in futs.items()}


def _lines(out: str, name: str) -> tuple[list[str], list[float]]:
    """The printed lines with ``name``'s fields masked, and the errors
    they printed."""
    errs, lines = [], []
    for line in out.splitlines():
        line = line.rstrip()
        if not line:
            continue
        for pat in ERRS:
            errs += [float(m) for m in re.findall(pat, line)]
            line = re.sub(pat, lambda m: m.group(0).replace(m.group(1), "_"),
                          line)
        for pat, rep in MASKS[name]:
            line = re.sub(pat, rep, line)
        if line:            # a line masked whole is dropped
            lines.append(line)
    return lines, errs


@pytest.mark.parametrize("name", NAMES)
def test_port_example_prints_the_reference_narrative(runs, name):
    port_rc, port_out, port_err, port_dir = runs[(name, "port")]
    ref_rc, ref_out, ref_err, ref_dir = runs[(name, "ref")]
    assert ref_rc == 0, ref_err[-3000:]
    assert port_rc == 0, port_err[-3000:]
    got, got_errs = _lines(port_out, name)
    want, want_errs = _lines(ref_out, name)
    assert got == want
    assert len(got_errs) == len(want_errs)
    if name not in UNBOUNDED:
        assert all(e < ERR_BOUND for e in got_errs + want_errs), \
            (got_errs, want_errs)
    if name == "chaos_fleet":
        for out in (port_out, ref_out):
            clean, degraded, failed = map(int, re.search(
                r"futures: (\d+) clean, (\d+) degraded-but-correct, "
                r"(\d+) failed", out).groups())
            assert (clean + degraded, failed) == (24, 0)
            clean, degraded, failed = map(int, re.search(
                r"'clean': (\d+), 'degraded': (\d+), 'failed': (\d+)",
                out).groups())
            assert (clean + degraded, failed) == (16, 0)
    if name == "trace_round":
        assert (port_dir / "trace_round.json").is_file()
        assert (ref_dir / "trace_round.json").is_file()
    if name == "train_lm":
        assert any((port_dir / "ckpt").iterdir())
