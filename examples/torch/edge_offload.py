"""The paper's deployment scenario: an edge server offloads a sparse
matrix product to a heterogeneous fleet with partial stragglers.

Reproduces the Example 4 system (n_bar = 8 physical devices with
capacities 3,2,2,1,1,1,1,1 -> n = 12 virtual workers, k_A = 9, s = 3),
runs a Monte-Carlo straggler simulation with per-worker compute cost
proportional to the encoded nnz, and compares job completion across
schemes -- including the partial-straggler case where strong devices
finish only some of their virtual tasks.

The PyTorch port of ``examples/edge_offload.py``: the plan lives on
the card (``auto`` picks ``cuda``) unless ``--device cpu``; the
Monte-Carlo simulation is numpy, as in the reference.

    python examples/torch/edge_offload.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.api import compile_plan, make_scheme
from repro_torch.core import ShiftedExponential, make_hetero_system, simulate_job

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the card, default) or cpu")
dev = torch.device(ap.parse_args().device)

rng = np.random.default_rng(0)

# --- Example 4's heterogeneous system --------------------------------------
capacities = [3, 2, 2, 1, 1, 1, 1, 1]
system = make_hetero_system(capacities)
k_A = sum(system.capacities[:5])      # 9
s = system.n - k_A                    # 3
print(f"physical devices: {system.n_bar}, capacities {system.capacities}")
print(f"virtual workers: n={system.n}, k_A={k_A}, s={s}")

# --- sparse job, plan compiled once over the virtualised system -------------
t, r = 1800, 1350
A = rng.standard_normal((t, r)) * (rng.random((t, r)) < 0.02)
x = rng.standard_normal(t)
op = compile_plan(torch.as_tensor(A, dtype=torch.float32, device=dev),
                  scheme="proposed-hetero", capacities=capacities, k_A=k_A,
                  seed=0, backend="auto")
scheme = op.scheme
print(f"weight omega_A = {scheme.omega_A} "
      f"(cyclic[31] would use {min(s + 1, k_A)}); "
      f"backend={op.backend}\n")
xt = torch.as_tensor(x, dtype=torch.float32, device=dev)

# --- full straggler: any one strong device (3 virtual workers) dies ---------
done = np.ones(system.n, bool)
done[list(system.virtual_of[0])] = False     # the capacity-3 device dies
y = op.matvec(xt, done).cpu().numpy()
err = np.max(np.abs(y - A.T @ x)) / np.max(np.abs(A.T @ x))
print(f"strong device (3 virtual workers) fails -> rel err {err:.2e}")

# --- partial stragglers: strong devices finish SOME virtual tasks -----------
done = np.ones(system.n, bool)
done[system.virtual_of[0][2:]] = False       # W0 finishes 2/3
done[system.virtual_of[1][1:]] = False       # W1 finishes 1/2
done[system.virtual_of[2][1:]] = False       # W2 finishes 1/2
assert done.sum() >= k_A
y = op.matvec(xt, done).cpu().numpy()
err = np.max(np.abs(y - A.T @ x)) / np.max(np.abs(A.T @ x))
print(f"partial stragglers (2/3, 1/2, 1/2 done) -> rel err {err:.2e}\n")

# --- Monte-Carlo job-completion comparison ----------------------------------
print("job completion time (p50 over 500 rounds, shifted-exp model):")
nnz_blocks = [(np.abs(A[:, c * (r // k_A):(c + 1) * (r // k_A)]) > 0).sum()
              for c in range(k_A)]
base = float(np.mean(nnz_blocks))
for name in ("poly", "rkrp", "cyclic31", "proposed"):
    sch = make_scheme(name, n=system.n, k_A=k_A)
    work = np.array([sum(nnz_blocks[q] for q in sch.supports[i])
                     for i in range(system.n)]) / base
    stats = simulate_job(work, k=k_A, model=ShiftedExponential(),
                         rng=np.random.default_rng(1), n_rounds=500)
    print(f"  {name:10s} p50={stats['p50']:.2f}  p99={stats['p99']:.2f}  "
          f"(mean worker load {work.mean():.2f}x uncoded)")
