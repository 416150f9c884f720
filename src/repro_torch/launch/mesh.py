"""Production mesh construction.

FUNCTIONS (not module-level constants) so importing this module never
touches a process group: the dry run sets up its own (a ``fake``
backend of 256 or 512 ranks in one process), tests and benches set up
theirs.  Each needs ``torch.distributed`` initialised with the mesh's
world size first.

Production target: NVIDIA H100 SXM nodes of 8 cards joined by NVLink,
nodes joined by InfiniBand NDR.  Axes (the reference's names):
  pod   -- a second group of 32 nodes (multi-pod proof)
  data  -- data parallel / ZeRO / context parallel, across the 32 nodes
           of a pod (InfiniBand)
  model -- tensor / expert parallel, the 8 cards of one node (NVLink)

Single pod: (32, 8) = 256 cards, artifacts named ``32x8``; multi-pod:
(2, 32, 8) = 512 cards, ``2x32x8``.
"""

from __future__ import annotations

SINGLE_POD = (32, 8)
MULTI_POD = (2, 32, 8)


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, MULTI_POD if multi_pod else SINGLE_POD))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh  # noqa: PLC0415

    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(devices: int | None = None, device_type: str = "cpu"):
    """Small (data, model) mesh over the process group's ranks (CPU
    tests): 'model' takes 4, 2 or 1 of them, the first that divides."""
    import torch.distributed as dist  # noqa: PLC0415
    from torch.distributed.device_mesh import init_device_mesh  # noqa: PLC0415

    n = devices or dist.get_world_size()
    model = 1
    for m in (4, 2, 1):
        if n % m == 0:
            model = m
            break
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


# Hardware constants for the roofline: NVIDIA H100 SXM data-sheet
# figures (dense, at the 700 W power limit), per card
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
NVLINK_BW = 450e9                 # bytes/s each way, to the node's cards
IB_BW = 50e9                      # bytes/s, InfiniBand NDR 400 Gb/s per card
