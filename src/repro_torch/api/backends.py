"""Automatic backend choice from the operand's device and block density.

``backend="auto"`` resolves per operator:

  * operand on a CUDA device              -> ``cuda`` (the kernels' home);
  * block-zero fraction >= crossover      -> ``packed``;
  * otherwise                             -> ``reference``.

The crossover is ``DEFAULT_DENSITY_CROSSOVER`` until the port has a
benchmark of its own; ``density_crossover(path)`` parses a runtime bench
file of the reference's format when a caller passes one explicitly.

Interaction with ``REPRO_CODED_BACKEND``: the env var *wins over auto*
-- setting it forces that backend for every plan regardless of device
or density.  ``REPRO_CODED_BACKEND=auto`` explicitly re-enables the
pick.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..runtime import ENV_BACKEND, resolve_backend

AUTO = "auto"

# Block-zero-fraction threshold above which the packed host path is
# taken on the CPU.
DEFAULT_DENSITY_CROSSOVER = 0.97

_BLOCK = 8   # tile edge used for the density measurement (host packer's)


def density_crossover(bench_path: str | None = None) -> float:
    """The packed-vs-reference crossover as a block-zero fraction.

    With ``bench_path`` pointing at a runtime bench file (``results``
    rows with ``zeros`` and ``speedup_vs_reference``), the midpoint of
    the last losing and first winning sparsity level; otherwise the
    default.
    """
    if bench_path is None or not os.path.exists(bench_path):
        return DEFAULT_DENSITY_CROSSOVER
    try:
        with open(bench_path) as fh:
            payload = json.load(fh)
        lose, win = [], []
        for row in payload.get("results", ()):
            speedup = row.get("speedup_vs_reference")
            if speedup is None:
                continue
            (win if speedup >= 1.0 else lose).append(float(row["zeros"]))
        if lose and win:
            return (max(lose) + min(win)) / 2.0
        if win:
            return min(win)
    except (OSError, ValueError, KeyError):
        pass
    return DEFAULT_DENSITY_CROSSOVER


def block_zero_fraction(A, block: int = _BLOCK) -> float:
    """Fraction of (block x block) tiles of ``A`` that are entirely zero.

    Measured with tensor ops on ``A``'s own device.  This -- not the
    element-wise zero fraction -- is what the packed paths' win scales
    with: a tile is skipped iff every entry is zero.
    """
    a = A.detach() if isinstance(A, torch.Tensor) else torch.as_tensor(
        np.asarray(A))
    if a.ndim != 2:
        a = a.reshape(a.shape[0], -1)
    t, r = a.shape
    # every tile of the rounded-up grid still intersects the real
    # extent, so the padded count is the true tile occupancy
    a = torch.nn.functional.pad(a, (0, (-r) % block, 0, (-t) % block))
    tp, rp = a.shape
    tiles = a.reshape(tp // block, block, rp // block, block)
    nz = tiles.abs().amax(dim=(1, 3)) > 0
    real = (tp // block) * (rp // block)
    return float(1.0 - int(nz.sum()) / max(real, 1))


def choose_backend(A=None, backend: str | None = None, *,
                   crossover: float | None = None, device=None) -> str:
    """Resolve ``backend="auto"`` (or None) to a concrete backend name.

    Precedence: ``REPRO_CODED_BACKEND`` env var (unless set to "auto")
    > explicit non-auto ``backend=`` > device / density pick.  The device
    is ``device`` when given, else ``A``'s when it is a tensor.
    """
    env = os.environ.get(ENV_BACKEND)
    choice = env if env else backend
    if choice is not None and choice != AUTO:
        # delegate validation + env semantics to the runtime resolver
        return resolve_backend(choice if env is None else None)
    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    if device is not None and torch.device(device).type == "cuda":
        return "cuda"
    if A is None:
        return "reference"
    thr = DEFAULT_DENSITY_CROSSOVER if crossover is None else crossover
    return "packed" if block_zero_fraction(A) >= thr else "reference"
