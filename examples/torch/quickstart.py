"""Quickstart: sparsity-preserving coded matrix multiplication in 40 lines.

Builds the paper's Alg. 2 scheme for n=20 devices with gamma_A =
gamma_B = 1/4 (Fig. 4's system) through the scheme registry, compiles a
plan once (encoding + packed shards + automatic backend), knocks out
the worst-case s = 4 stragglers, and recovers A^T B exactly from the
fastest 16 workers.

The PyTorch port of ``examples/quickstart.py``: on the card ``auto``
picks the ``cuda`` backend (``cyclic_encode``, ``bcsr_matmul`` and
``decode_matmul``); ``--device cpu`` runs their plain versions.

    python examples/torch/quickstart.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.api import compile_plan, list_schemes
from repro_torch.core import min_weight

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the card, default) or cpu")
dev = torch.device(ap.parse_args().device)

rng = np.random.default_rng(0)

# --- pick a scheme from the registry ------------------------------------
print("registered mm schemes:",
      ", ".join(i.name for i in list_schemes("mm")))

# --- the paper's Fig. 4 system ------------------------------------------
n, k_A, k_B = 20, 4, 4
t, r, w = 400, 320, 240
A = rng.standard_normal((t, r)) * (rng.random((t, r)) < 0.05)
B = rng.standard_normal((t, w)) * (rng.random((t, w)) < 0.05)
print(f"A: {A.shape}, density {np.mean(A != 0):.3f}; "
      f"B: {B.shape}, density {np.mean(B != 0):.3f}")

# compile once: scheme + encoding + shards + backend (auto: cuda on the
# card, else the density pick)
plan = compile_plan(torch.as_tensor(A, dtype=torch.float32, device=dev),
                    scheme="proposed", n=n, k_A=k_A, k_B=k_B,
                    backend="auto")
scheme, s = plan.scheme, plan.s
print(f"system: n={n} devices, k_A=k_B=4 -> resilient to s={s} stragglers")
print(f"weight: omega_A*omega_B = {scheme.omega_A}*{scheme.omega_B} "
      f"= {scheme.weight()} (lower bound {min_weight(n, s)})")
print(f"dense MDS codes would use weight k_A*k_B = {k_A * k_B}")
print(f"compiled plan: {plan.describe()}\n")

# each coded submatrix mixes only omega block-columns -> density grows by
# ~omega, not by k (the paper's whole point)
per_worker_density = 1 - (1 - 0.05) ** scheme.omega_A
print(f"coded submatrix density ~{per_worker_density:.3f} "
      f"(dense coding would give ~{1 - 0.95 ** k_A:.3f})\n")

# --- straggle any s devices, still decode exactly -------------------------
done = np.ones(n, bool)
stragglers = rng.choice(n, size=s, replace=False)
done[stragglers] = False
print(f"stragglers this round: {sorted(stragglers.tolist())}")

Bt = torch.as_tensor(B, dtype=torch.float32, device=dev)
out = plan.matmat(Bt, done)
err = np.max(np.abs(out.cpu().numpy() - A.T @ B)) / np.max(np.abs(A.T @ B))
print(f"recovered A^T B from the fastest {n - s} workers; "
      f"max rel err = {err:.2e}")
assert err < 1e-3

# the plan is compiled once -- a second round with a different straggler
# set reuses the encoded shards and hits the decode cache
done2 = np.ones(n, bool)
done2[rng.choice(n, size=s, replace=False)] = False
out2 = plan.matmat(Bt, done2)
err2 = np.max(np.abs(out2.cpu().numpy() - A.T @ B)) / np.max(np.abs(A.T @ B))
assert err2 < 1e-3
print("OK")
